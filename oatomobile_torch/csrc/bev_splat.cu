// BEV LIDAR splat for Hopper (sm_90a): the hand-written counterpart of the
// Pallas TPU kernel oatomobile_tpu/ops/bev_pallas.py::_kernel (launched by
// splat_lidar_batch there).
//
// What it computes, per scene b and BEV pixel (row, col):
//   - the pixel centre in the hero frame (lx, ly) from the shared float32
//     centre table, rotated into world coordinates (wx, wy);
//   - occupied = OR over the wall rects and actor boxes of the half-plane
//     inside-test |u| <= hl && |v| <= hw with
//       u = cr*wx + sr*wy - cu,  v = cr*wy - sr*wx - cv,
//       cu = cr*cx + sr*cy,      cv = -sr*cx + cr*cy;
//   - open = the same OR over the (already sidewalk-inflated) road rects;
//   - slots with hl <= 0 are empty and skipped;
//   - out[b, row, col] = (below, above) with
//       below = (open && !occupied) ? ground[row, col] : 0,
//       above = occupied ? counts[row, col] : 0,
//     written straight into the interleaved [B, 200, 200, 2] layout.
// The per-slot and per-pixel math lives in bev_splat_tile.cuh, which g++
// also builds for the CPU tests.
//
// Bound on an H100 at the bench configuration (1024 scenes, Town01, 16
// NPCs): the output is 1024 x 200 x 200 x 2 floats = 328 MB, 0.098 ms at
// 3.35 TB/s; the kernel is bound by the bytes it writes.  Tested densely,
// every pixel against every live slot (~13-15.5 a scene), the tests cost
// as much again in FP32 operations, and more again in instructions (no
// FMA, slot loads, the loop), which is what held the first design to 6.4x
// its bound.  Tensor cores do not apply: there is no product to batch, and
// the exact-rounding rule forbids fused arithmetic.
//
// Design.
//   - Grid: one block per (scene, band of 40 rows): 5 blocks a scene, 5,120
//     at B = 1024, several waves over the 132 SMs.  A block stages its
//     scene's live slots once, in shared memory: cu/cv precomputed and a
//     conservative pixel box (slot_box), as structure-of-arrays so a slot
//     is one 16-byte and one 8-byte shared load.  Slots whose box misses
//     the band are dropped there.
//   - Tile culling: the block walks its band 8 rows at a time; each of its
//     5 warps owns an 8 x 40 tile.  Before testing, the warp ballots which
//     staged slots' boxes overlap its tile and loops over those bits only
//     (~1 test a pixel at the bench's data instead of ~13).  A lane holds 5
//     pixel pairs, so one slot load serves 10 tests.  Road rects are tested
//     only by lanes with a pixel not yet occupied.
//   - Stores: a pixel pair is one float4 (below, above, below, above),
//     written with a streaming store (__stcs); a warp's store covers whole
//     32-byte sectors of its tile's rows.  Composing each 8-row band (12,800
//     contiguous bytes) in shared memory and writing it with a
//     double-buffered 1-D bulk copy (cp.async.bulk.global.shared::cta) was
//     slower on the H100, and was dropped; the kernel runs within ~15% of
//     a plain fill of the same 328 MB (PERF.md).
//   - One launch a splat, no host synchronisation, no device state to
//     reset between launches, static shared memory under 48 KB: a CUDA
//     graph can capture it.
//
// Rounding.  nvcc contracts a*b + c into one FMA by default, which rounds
// edge pixels differently from the plain version's separate multiply and
// add.  Every product and sum of the exact test is written with
// __fmul_rn / __fadd_rn / __fsub_rn (bev_splat_tile.cuh), never
// contracted, in the association of bev_pallas.py:67-93, so the kernel
// matches its plain PyTorch version bit for bit.
//
// Interface: a plain C entry point (no PyTorch headers), loaded with
// ctypes; it launches on the caller's stream and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "bev_splat_tile.cuh"

namespace {

using bev_tile::kBev;
using bev_tile::kTileCols;
using bev_tile::kTileRows;

constexpr int kMaxWalls = 32;    // ops/bev.py MAX_BEV_WALLS
constexpr int kMaxRoads = 24;    // ops/bev.py MAX_BEV_ROADS
constexpr int kMaxBoxes = 40;    // MAX_BEV_VEHICLES + MAX_BEV_PEDESTRIANS
constexpr int kMaxOcc = kMaxWalls + kMaxBoxes;   // occupied list: 0..71
constexpr int kMaxSlots = kMaxOcc + kMaxRoads;   // open list: 72..95
constexpr int kOccWords = (kMaxOcc + 31) / 32;

constexpr int kWarps = kBev / kTileCols;               // 5 tiles a band
constexpr int kThreads = 32 * kWarps;                  // 160
constexpr int kBlockRows = 40;
constexpr int kBlocksPerScene = kBev / kBlockRows;     // 5
constexpr int kBands = kBlockRows / kTileRows;         // 5 bands a block
constexpr int kPairs = kTileRows * kTileCols / 2 / 32; // 5 pairs a lane
constexpr int kPairsPerRow = kTileCols / 2;            // 20
constexpr unsigned kAllPixels = (1u << (2 * kPairs)) - 1;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads >= kMaxSlots, "one staging thread a slot");
static_assert(kMaxRoads <= 32, "one ballot for the open list");
static_assert(kTileRows * kTileCols == 64 * kPairs, "whole pairs a lane");

__global__ void __launch_bounds__(kThreads)
bev_splat_kernel(const float* __restrict__ hero,     // [B, 4]
                 const float* __restrict__ walls,    // [B, nw, 6]
                 int nw,
                 const float* __restrict__ roads,    // [B, nr, 6]
                 int nr,
                 const float* __restrict__ boxes,    // [B, nv, 6]
                 int nv,
                 const float* __restrict__ centers,  // [200]
                 const float* __restrict__ counts,   // [200, 200]
                 const float* __restrict__ ground,   // [200, 200]
                 float* __restrict__ out) {          // [B, 200, 200, 2]
  __shared__ float4 geo[kMaxSlots];     // cr, sr, cu, cv
  __shared__ float2 extent[kMaxSlots];  // hl, hw
  __shared__ unsigned box[kMaxSlots];   // packed pixel box
  __shared__ int n_occ, n_open;

  const int b = blockIdx.x / kBlocksPerScene;
  const int row0 = (blockIdx.x % kBlocksPerScene) * kBlockRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tc0 = (tid >> 5) * kTileCols;  // this warp's first column

  float h[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = hero[4 * b + i];

  // -- Stage the live slots that can reach this band. -----------------------
  if (tid == 0) {
    n_occ = 0;
    n_open = 0;
  }
  __syncthreads();
  const float* src = nullptr;
  if (tid < nw) {
    src = walls + (static_cast<long>(b) * nw + tid) * 6;
  } else if (tid < nw + nv) {
    src = boxes + (static_cast<long>(b) * nv + tid - nw) * 6;
  } else if (tid >= kMaxOcc && tid < kMaxOcc + nr) {
    src = roads + (static_cast<long>(b) * nr + tid - kMaxOcc) * 6;
  }
  if (src != nullptr) {
    float r[6];
    #pragma unroll
    for (int i = 0; i < 6; ++i) r[i] = src[i];
    bev_tile::Box bx;
    if (bev_tile::slot_box(h, r, &bx) && bx.r0 < row0 + kBlockRows &&
        bx.r1 >= row0) {
      const int k = tid < kMaxOcc ? atomicAdd(&n_occ, 1)
                                  : kMaxOcc + atomicAdd(&n_open, 1);
      float cu, cv;
      bev_tile::slot_constants(r[0], r[1], r[4], r[5], &cu, &cv);
      geo[k] = make_float4(r[4], r[5], cu, cv);
      extent[k] = make_float2(r[2], r[3]);
      box[k] = bev_tile::pack_box(bx);
    }
  }
  __syncthreads();

  // This lane's pixels: pair q is tile row q_row, columns col, col + 1.
  int q_row[kPairs], q_col[kPairs];
  float ly[2 * kPairs];
  #pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int p = lane + 32 * q;
    q_row[q] = p / kPairsPerRow;
    q_col[q] = tc0 + 2 * (p % kPairsPerRow);
    ly[2 * q] = centers[q_col[q]];
    ly[2 * q + 1] = centers[q_col[q] + 1];
  }
  const int occ_count = n_occ, open_count = n_open;

  for (int band = 0; band < kBands; ++band) {
    const int tr0 = row0 + band * kTileRows;
    const int tr1 = tr0 + kTileRows - 1;
    const int tc1 = tc0 + kTileCols - 1;

    // -- Cull: the staged slots whose box overlaps this warp's tile. -------
    unsigned occ_mask[kOccWords];
    #pragma unroll
    for (int w = 0; w < kOccWords; ++w) {
      const int k = lane + 32 * w;
      occ_mask[w] = __ballot_sync(
          kFull, k < occ_count && bev_tile::box_meets(box[k], tr0, tr1, tc0,
                                                      tc1));
    }
    const unsigned open_mask = __ballot_sync(
        kFull, lane < open_count &&
                   bev_tile::box_meets(box[kMaxOcc + lane], tr0, tr1, tc0,
                                       tc1));

    float wx[2 * kPairs], wy[2 * kPairs];
    #pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const float lx = centers[tr0 + q_row[q]];
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        bev_tile::pixel_world(h[0], h[1], h[2], h[3], lx, ly[2 * q + e],
                              &wx[2 * q + e], &wy[2 * q + e]);
      }
    }

    // -- Exact tests, only against the culled slots. ------------------------
    unsigned occupied = 0, open = 0;  // one bit a pixel
    #pragma unroll
    for (int w = 0; w < kOccWords; ++w) {
      for (unsigned m = occ_mask[w]; m != 0; m &= m - 1) {
        const int k = 32 * w + __ffs(m) - 1;
        const float4 g = geo[k];
        const float2 e = extent[k];
        #pragma unroll
        for (int i = 0; i < 2 * kPairs; ++i) {
          occupied |= static_cast<unsigned>(bev_tile::inside(
                          g.x, g.y, g.z, g.w, e.x, e.y, wx[i], wy[i]))
                      << i;
        }
      }
    }
    if (occupied != kAllPixels) {
      for (unsigned m = open_mask; m != 0; m &= m - 1) {
        const int k = kMaxOcc + __ffs(m) - 1;
        const float4 g = geo[k];
        const float2 e = extent[k];
        #pragma unroll
        for (int i = 0; i < 2 * kPairs; ++i) {
          open |= static_cast<unsigned>(bev_tile::inside(
                      g.x, g.y, g.z, g.w, e.x, e.y, wx[i], wy[i]))
                  << i;
        }
      }
    }

    // -- Values: (below, above) of a pixel pair as one float4. --------------
    float4* dst = reinterpret_cast<float4*>(out) +
                  (static_cast<long>(b) * kBev + tr0) * (kBev / 2);
    #pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int pix = (tr0 + q_row[q]) * kBev + q_col[q];
      float v[4];
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const unsigned bit = 1u << (2 * q + e);
        v[2 * e] = (open & ~occupied & bit) ? ground[pix + e] : 0.0f;
        v[2 * e + 1] = (occupied & bit) ? counts[pix + e] : 0.0f;
      }
      __stcs(dst + q_row[q] * (kBev / 2) + q_col[q] / 2,
             make_float4(v[0], v[1], v[2], v[3]));
    }
  }
}

}  // namespace

extern "C" {

// Launches the splat for `batch` scenes on `stream`; returns the CUDA error
// code of the launch (0 on success).  Slot counts above the kernel's
// shared-memory capacity, a grid beyond 2^31 - 1 blocks and an output not
// 16-byte aligned are refused with cudaErrorInvalidValue.
int bev_splat_launch(const float* hero, const float* walls, int nw,
                     const float* roads, int nr, const float* boxes, int nv,
                     const float* centers, const float* counts,
                     const float* ground, float* out, int batch,
                     void* stream) {
  if (nw < 0 || nr < 0 || nv < 0 || nw > kMaxWalls || nr > kMaxRoads ||
      nv > kMaxBoxes || batch < 0 || batch > 0x7fffffff / kBlocksPerScene ||
      reinterpret_cast<std::uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  bev_splat_kernel<<<batch * kBlocksPerScene, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      hero, walls, nw, roads, nr, boxes, nv, centers, counts, ground, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
