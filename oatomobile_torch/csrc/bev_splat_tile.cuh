// Per-slot and per-pixel math of the BEV splat kernel (bev_splat.cu), as
// __host__ __device__ functions so that g++ builds the same code for the
// CPU tests (bev_splat_tile_host.cc, tests/test_torch_bev_tiles.py).
//
//   - pixel_world: a pixel centre (lx, ly) in the hero frame to world
//     coordinates (wx, wy);
//   - slot_constants / inside: the exact half-plane inside-test of
//     bev_pallas.py:86-92, every product and sum rounded on its own
//     (no FMA) in the association of the plain version;
//   - slot_box: a conservative pixel box of a slot, for culling;
//   - box_meets: whether a box overlaps a tile of pixels.
//
// Rounding.  On the card mul/add/sub are __fmul_rn/__fadd_rn/__fsub_rn,
// which nvcc never contracts into an FMA; on the host they are plain float
// operations, to be compiled with -ffp-contract=off.  The box math needs no
// such care: its margin covers its own rounding and the test's.

#pragma once

#ifdef __CUDACC__
#define BEV_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#define BEV_HD inline
#endif

namespace bev_tile {

constexpr int kBev = 200;        // pixels per side
constexpr int kTileRows = 8;     // a warp's tile: 8 rows x 40 columns
constexpr int kTileCols = 40;
// Pixel i's centre lies at kBinLow + (i + 0.5) * kBinWidth (ops/bev.py).
constexpr float kBinLow = -50.0f;
constexpr float kBinWidth = 0.505f;
// Margin of a slot box beyond the rect's own extent: one pixel, plus a
// relative term far above the few float32 ulps by which the exact test
// and the box math can each be off at these coordinates.
constexpr float kRelMargin = 1e-5f;
constexpr float kFixedSpan = 150.0f;  // metres: the image's reach, and more

BEV_HD float mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

BEV_HD float add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

BEV_HD float sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

// wx = hx + cos*lx - sin*ly ; wy = hy + sin*lx + cos*ly (left to right).
BEV_HD void pixel_world(float hx, float hy, float cos_y, float sin_y,
                        float lx, float ly, float* wx, float* wy) {
  *wx = sub(add(hx, mul(cos_y, lx)), mul(sin_y, ly));
  *wy = add(add(hy, mul(sin_y, lx)), mul(cos_y, ly));
}

// cu = cr*cx + sr*cy ; cv = -sr*cx + cr*cy.
BEV_HD void slot_constants(float cx, float cy, float cr, float sr, float* cu,
                           float* cv) {
  *cu = add(mul(cr, cx), mul(sr, cy));
  *cv = add(mul(-sr, cx), mul(cr, cy));
}

// |cr*wx + sr*wy - cu| <= hl && |cr*wy - sr*wx - cv| <= hw.
BEV_HD bool inside(float cr, float sr, float cu, float cv, float hl,
                   float hw, float wx, float wy) {
  const float u = sub(add(mul(cr, wx), mul(sr, wy)), cu);
  const float v = sub(sub(mul(cr, wy), mul(sr, wx)), cv);
  return (fabsf(u) <= hl) & (fabsf(v) <= hw);
}

// Rows r0..r1 and columns c0..c1 (inclusive, in [0, 199]).
struct Box {
  int r0, r1, c0, c1;
};

// Float pixel bounds to int, clamped in float to [-1, 200] first so the
// conversion is always defined; NaN widens the bound to the image's edge.
BEV_HD int low_index(float x) {
  return static_cast<int>(fminf(fmaxf(floorf(x), -1.0f), float(kBev)));
}
BEV_HD int high_index(float x) {
  return static_cast<int>(fmaxf(fminf(ceilf(x), float(kBev)), -1.0f));
}

// Conservative pixel box of slot `rect` (cx, cy, hl, hw, cos, sin) seen
// from `hero` (x, y, cos, sin): every pixel whose exact test passes lies in
// it.  Returns false when the slot is empty (hl <= 0 or NaN) or its box
// misses the image.
//
// The test is |(cr, sr).d| <= hl, |(-sr, cr).d| <= hw with d = w - c, and
// a pixel's world point is w = h + Rot(cos, sin) (lx, ly).  So in the hero
// frame the slot is a rect centred at Rot^T (c - h) / |(cos, sin)|^2 with
// half extents (|cd| hl + |sd| hw, |sd| hl + |cd| hw) / (kh kr), where
// (cd, sd) is the rect's axis relative to the hero's; kh and kr are the
// squared norms of the two (cos, sin) pairs, 1 up to rounding.
BEV_HD bool slot_box(const float* hero, const float* rect, Box* box) {
  const float hl = rect[2];
  if (!(hl > 0.0f)) return false;
  const float hx = hero[0], hy = hero[1], ch = hero[2], sh = hero[3];
  const float cx = rect[0], cy = rect[1], cr = rect[4], sr = rect[5];
  const float hw = fmaxf(rect[3], 0.0f);
  const float kh = ch * ch + sh * sh;
  const float kr = cr * cr + sr * sr;
  const float cd = fabsf(ch * cr + sh * sr);
  const float sd = fabsf(ch * sr - sh * cr);
  const float dx = cx - hx, dy = cy - hy;
  const float lx = (ch * dx + sh * dy) / kh;
  const float ly = (ch * dy - sh * dx) / kh;
  const float margin =
      kBinWidth + kRelMargin * (fabsf(hx) + fabsf(hy) + fabsf(cx) +
                                fabsf(cy) + kFixedSpan);
  const float ex = (cd * hl + sd * hw) / (kh * kr) + margin;
  const float ey = (sd * hl + cd * hw) / (kh * kr) + margin;
  // Pixel i is centred at kBinLow + (i + 0.5) kBinWidth.
  box->r0 = low_index((lx - ex - kBinLow) / kBinWidth - 0.5f);
  box->r1 = high_index((lx + ex - kBinLow) / kBinWidth - 0.5f);
  box->c0 = low_index((ly - ey - kBinLow) / kBinWidth - 0.5f);
  box->c1 = high_index((ly + ey - kBinLow) / kBinWidth - 0.5f);
  if (box->r1 < 0 || box->r0 > kBev - 1 || box->c1 < 0 ||
      box->c0 > kBev - 1) {
    return false;
  }
  box->r0 = box->r0 < 0 ? 0 : box->r0;
  box->c0 = box->c0 < 0 ? 0 : box->c0;
  box->r1 = box->r1 > kBev - 1 ? kBev - 1 : box->r1;
  box->c1 = box->c1 > kBev - 1 ? kBev - 1 : box->c1;
  return true;
}

// A box in one 32-bit word, a byte a bound (each in [0, 199]).
BEV_HD unsigned pack_box(const Box& box) {
  return static_cast<unsigned>(box.r0) |
         (static_cast<unsigned>(box.r1) << 8) |
         (static_cast<unsigned>(box.c0) << 16) |
         (static_cast<unsigned>(box.c1) << 24);
}

// Whether packed box `box` overlaps rows [r0, r1] and columns [c0, c1].
BEV_HD bool box_meets(unsigned box, int r0, int r1, int c0, int c1) {
  return (static_cast<int>(box & 0xff) <= r1) &
         (static_cast<int>((box >> 8) & 0xff) >= r0) &
         (static_cast<int>((box >> 16) & 0xff) <= c1) &
         (static_cast<int>(box >> 24) >= c0);
}

}  // namespace bev_tile
