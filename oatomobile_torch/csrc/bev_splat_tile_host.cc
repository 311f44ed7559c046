// Host build of the BEV splat kernel's per-slot and per-pixel math
// (bev_splat_tile.cuh), with a plain C interface for ctypes.  The CPU
// tests (tests/test_torch_bev_tiles.py) build it with
//
//   g++ -O2 -ffp-contract=off -std=c++17 -shared -fPIC -I csrc \
//       -o libbev_splat_tile_host.so csrc/bev_splat_tile_host.cc
//
// and hold it against the plain PyTorch version of the kernel.  Arrays are
// contiguous float32 / int32 / uint8, laid out as the kernel's inputs.

#include <cstdint>

#include "bev_splat_tile.cuh"

namespace {

using bev_tile::kBev;

// The kernel's bands and tiles (bev_splat.cu).
constexpr int kBlockRows = 40;

struct Slot {
  float cr, sr, cu, cv, hl, hw;
  unsigned box;
};

// Stages the live slots of rects [n, 6] whose box meets rows
// [row0, row0 + kBlockRows) into `list`, as a kernel block does.
int stage(const float* hero, const float* rects, int n, int row0,
          Slot* list) {
  int count = 0;
  for (int k = 0; k < n; ++k) {
    const float* r = rects + 6 * k;
    bev_tile::Box box;
    if (!bev_tile::slot_box(hero, r, &box) || box.r0 >= row0 + kBlockRows ||
        box.r1 < row0) {
      continue;
    }
    Slot& s = list[count++];
    s.cr = r[4];
    s.sr = r[5];
    bev_tile::slot_constants(r[0], r[1], r[4], r[5], &s.cu, &s.cv);
    s.hl = r[2];
    s.hw = r[3];
    s.box = bev_tile::pack_box(box);
  }
  return count;
}

}  // namespace

extern "C" {

// boxes [n, 4] (r0, r1, c0, c1) and live [n] of rects [batch, m, 6] seen
// from hero [batch, 4], n = batch * m; a box is written only where live.
void bev_tile_boxes(const float* hero, const float* rects, int batch, int m,
                    int32_t* boxes, uint8_t* live) {
  for (int b = 0; b < batch; ++b) {
    for (int k = 0; k < m; ++k) {
      const long i = static_cast<long>(b) * m + k;
      bev_tile::Box box;
      live[i] = bev_tile::slot_box(hero + 4 * b, rects + 6 * i, &box);
      if (live[i]) {
        boxes[4 * i + 0] = box.r0;
        boxes[4 * i + 1] = box.r1;
        boxes[4 * i + 2] = box.c0;
        boxes[4 * i + 3] = box.c1;
      }
    }
  }
}

// inside [batch, m, 200, 200]: the exact test of every pixel against every
// slot (false for empty slots, hl <= 0), by the header's arithmetic.
void bev_tile_inside(const float* hero, const float* rects, int batch,
                     int m, const float* centers, uint8_t* inside) {
  for (int b = 0; b < batch; ++b) {
    const float* h = hero + 4 * b;
    for (int k = 0; k < m; ++k) {
      const long i = static_cast<long>(b) * m + k;
      const float* r = rects + 6 * i;
      uint8_t* dst = inside + i * kBev * kBev;
      float cu, cv;
      bev_tile::slot_constants(r[0], r[1], r[4], r[5], &cu, &cv);
      for (int row = 0; row < kBev; ++row) {
        for (int col = 0; col < kBev; ++col) {
          float wx, wy;
          bev_tile::pixel_world(h[0], h[1], h[2], h[3], centers[row],
                                centers[col], &wx, &wy);
          dst[row * kBev + col] =
              (r[2] > 0.0f) &&
              bev_tile::inside(r[4], r[5], cu, cv, r[2], r[3], wx, wy);
        }
      }
    }
  }
}

// cu, cv [n] of rects [n, 6].
void bev_tile_constants(const float* rects, int n, float* cu, float* cv) {
  for (int i = 0; i < n; ++i) {
    const float* r = rects + 6 * i;
    bev_tile::slot_constants(r[0], r[1], r[4], r[5], cu + i, cv + i);
  }
}

// The splat as the kernel runs it: per block of 40 rows the live slots
// that reach it, per 8 x 40 tile only the slots whose box meets the tile,
// roads only for pixels not occupied.  Writes out [batch, 200, 200, 2] and
// returns the number of pixel-slot tests made.
long long bev_tile_splat(const float* hero, const float* walls, int nw,
                         const float* roads, int nr, const float* boxes,
                         int nv, const float* centers, const float* counts,
                         const float* ground, float* out, int batch) {
  using bev_tile::kTileCols;
  using bev_tile::kTileRows;
  long long tests = 0;
  Slot occ[32 + 40], open[24];
  for (int b = 0; b < batch; ++b) {
    const float* h = hero + 4 * b;
    for (int row0 = 0; row0 < kBev; row0 += kBlockRows) {
      int n_occ = stage(h, walls + 6L * b * nw, nw, row0, occ);
      n_occ += stage(h, boxes + 6L * b * nv, nv, row0, occ + n_occ);
      const int n_open = stage(h, roads + 6L * b * nr, nr, row0, open);
      for (int tr0 = row0; tr0 < row0 + kBlockRows; tr0 += kTileRows) {
        for (int tc0 = 0; tc0 < kBev; tc0 += kTileCols) {
          const int tr1 = tr0 + kTileRows - 1, tc1 = tc0 + kTileCols - 1;
          for (int row = tr0; row <= tr1; ++row) {
            for (int col = tc0; col <= tc1; ++col) {
              float wx, wy;
              bev_tile::pixel_world(h[0], h[1], h[2], h[3], centers[row],
                                    centers[col], &wx, &wy);
              bool occupied = false, is_open = false;
              for (int k = 0; k < n_occ; ++k) {
                const Slot& s = occ[k];
                if (!bev_tile::box_meets(s.box, tr0, tr1, tc0, tc1)) continue;
                ++tests;
                occupied |= bev_tile::inside(s.cr, s.sr, s.cu, s.cv, s.hl,
                                             s.hw, wx, wy);
              }
              for (int k = 0; k < n_open && !occupied; ++k) {
                const Slot& s = open[k];
                if (!bev_tile::box_meets(s.box, tr0, tr1, tc0, tc1)) continue;
                ++tests;
                is_open |= bev_tile::inside(s.cr, s.sr, s.cu, s.cv, s.hl,
                                            s.hw, wx, wy);
              }
              const long pix = row * kBev + col;
              float* dst = out + 2 * (static_cast<long>(b) * kBev * kBev + pix);
              dst[0] = (is_open && !occupied) ? ground[pix] : 0.0f;
              dst[1] = occupied ? counts[pix] : 0.0f;
            }
          }
        }
      }
    }
  }
  return tests;
}

}  // extern "C"
