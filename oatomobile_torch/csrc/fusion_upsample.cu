// Fusion upsample-and-add (NCHW float32) for Hopper (sm_90a): each of
// TransFuser's four fusions adds its GPT's two 8 x 8 anchor maps, upsampled
// bilinearly, to the camera trunk's and the BEV trunk's maps.
//
// It replaces no Pallas kernel: the JAX package has no TransFuser, and a
// fusion written in JAX would be a resize and an add that XLA compiles.  In
// PyTorch each fusion was two F.interpolate calls (ATen's
// upsample_bilinear2d_out_frame: one thread an output pixel, each looping
// over all N x C planes; 86 ms of a 306 ms TransFuser step at 256 scenes)
// and two adds.  The work is memory traffic: both trunks' maps read once,
// the anchors read once and the sums written once, at 256 scenes over the
// four fusions 1.01 GB + 0.126 GB + 1.01 GB = 2.14 GB a step, 0.64 ms at
// the H100's 3.35 TB/s, the bound (a few operations an output are nothing
// beside it).
//
// What it computes, for each of the two trunks, at output (n, c, h2, w2) of
// a map of S = 8 * scale pixels, anchors x [N, C, 8, 8]:
//   scale 1: out = trunk + x[n][c][h2][w2]   (ATen's equal-size case copies)
//   else, in float32 as ATen's kernel (aten/src/ATen/native/cuda/
//   UpSampleBilinear2d.cu) with align_corners false and the scale factor
//   given:
//     r = (float)(1.0 / scale)                (area_pixel_compute_scale)
//     h1r = max(0, r * (h2 + 0.5) - 0.5)      (area_pixel_compute_source_index)
//     h1 = (int)h1r; h1p = h1 < 7 ? 1 : 0; h1lambda = h1r - h1;
//     h0lambda = 1 - h1lambda; the same for w
//     val = h0lambda * (w0lambda * x[h1][w1] + w1lambda * x[h1][w1 + w1p]) +
//           h1lambda * (w0lambda * x[h1 + h1p][w1] +
//                       w1lambda * x[h1 + h1p][w1 + w1p])
//     out = trunk + val                       (one float32 add)
// The result is PyTorch's trunk + F.interpolate(x, scale_factor=scale,
// mode="bilinear", align_corners=False) on CUDA bit for bit, because the
// closed loop amplifies last-bit differences of the plan.  ATen is built
// with nvcc's default contraction, and in its kernel each sum of two
// products p * x + q * y is one fused multiply-add of the first product
// over the second, rounded: fmaf(p, x, q * y); the source index is
// fmaf(r, h2 + 0.5, -0.5).  On an H100 with PyTorch 2.11 (CUDA 12.8), of
// the 54 candidates (each of the three sums as two rounded products and a
// sum, or fused over either product; the index fused or not) only this
// one equals F.interpolate on every output at scales 2 to 16 (8 x 64
// random 8 x 8 maps of spreads e^(3 N(0, 1)) a scale); each of the 53
// others differs on some (those that round both inner sums alike, on 11%
// to 54%).  This source is built with -fmad=false
// and spells those contractions out as fmaf, so that the host build of
// the tests (tests/cuda_emulation) runs the same arithmetic.  No
// fast-math: IEEE float32 throughout.
//
// Design.
//   - One launch takes both trunks of a fusion (they have the same shape):
//     the first half of the grid the camera's, the second the BEV's.  So a
//     TransFuser step makes 4 launches where ATen made 8 upsamples and 8
//     adds, and writes a new tensor for each trunk, as the add did.
//   - A trunk is a run of N x C x S rows of S floats.  A block of 256
//     threads takes a tile of consecutive rows: a thread owns one 16-byte
//     column group of a row (S / 4 groups a row) and up to 4 rows, 256 / (S
//     / 4) rows apart; at S = 64 a tile is one plane, at 32 four, at 16
//     sixteen, at 8 sixty-four.  Each thread reads 16 bytes of the trunk a
//     row (streaming loads, every one issued before the first add) and
//     writes 16 bytes of the sum (streaming stores): each trunk byte read
//     once, each sum written once.
//   - The tile's planes' anchors (64 floats a plane) go to shared memory;
//     the four columns' source indices and lambdas are the same for every
//     plane and row, so each thread computes them once; a row's are a few
//     operations.  At scale 1 the anchors are read as the trunk is, with
//     16-byte loads, and added.
//   - The tiling follows from the map's size alone; nothing asks which
//     fusion it is.  Scales 1 to 128 (maps up to 1,024 pixels, a row of at
//     most 256 column groups).
//   - On the H100 (700 W, 256 scenes) one encode's 4 launches take 0.730
//     ms, 87.5% of the bound (by map: 64 x 64 89%, 32 x 32 87%, 16 x 16
//     and 8 x 8 84%), against 86.8 ms for ATen's upsamplings and adds; 58
//     registers, no spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kAnchors = 8;                              // the anchor map's side
constexpr int kPlaneFloat4s = kAnchors * kAnchors / 4;   // one plane's anchors
constexpr int kMaxScale = kThreads * 4 / kAnchors;

struct Args {
  const float4* trunk0;
  const float4* anchors0;
  float4* out0;
  const float4* trunk1;
  const float4* anchors1;
  float4* out1;
  long long rows;      // N x C x S rows of each trunk
  long long tiles;     // tiles of each trunk
  int map;             // S, the trunk map's side
  int groups;          // 16-byte column groups of a row, S / 4
  int rows_per_pass;   // rows the block's threads take at once
  int tile_rows;       // rows_per_pass * kRowsPerThread
  float rscale;        // 1 / scale as ATen rounds it
};

// ATen's area_pixel_compute_source_index (align_corners false, not cubic):
// the output index's centre in the input, clamped at 0.
__device__ __forceinline__ float source_index(float rscale, int dst) {
  const float src = fmaf(rscale, static_cast<float>(dst) + 0.5f, -0.5f);
  return src < 0.0f ? 0.0f : src;
}

// p * x + q * y rounded as ATen's build rounds it.
__device__ __forceinline__ float products(float p, float x, float q,
                                          float y) {
  return fmaf(p, x, q * y);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void __launch_bounds__(kThreads) upsample_add(Args a) {
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x;
  const int side = blockIdx.x < a.tiles ? 0 : 1;
  const long long tile = blockIdx.x - side * a.tiles;
  const float4* trunk = side ? a.trunk1 : a.trunk0;
  const float4* anchors = side ? a.anchors1 : a.anchors0;
  float4* out = side ? a.out1 : a.out0;
  const long long row0 = tile * a.tile_rows;
  const long long left = a.rows - row0;
  const int tile_rows = left < a.tile_rows ? static_cast<int>(left)
                                           : a.tile_rows;
  // The thread's column group and first row; threads past the last whole
  // pass of rows take none.
  const int g = t % a.groups;
  const int r = t < a.rows_per_pass * a.groups ? t / a.groups : tile_rows;
  const long long first = row0 * a.groups + g;   // row0's group g

  float4 held[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int rr = r + k * a.rows_per_pass;
    if (rr < tile_rows)
      held[k] = __ldcs(trunk + first + static_cast<long long>(rr) * a.groups);
  }

  if (a.map == kAnchors) {
    // ATen's equal-size case: the anchors as they are.
    float4 same[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int rr = r + k * a.rows_per_pass;
      if (rr < tile_rows)
        same[k] = __ldcs(anchors + first +
                         static_cast<long long>(rr) * a.groups);
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int rr = r + k * a.rows_per_pass;
      if (rr < tile_rows)
        __stcs(out + first + static_cast<long long>(rr) * a.groups,
               add4(held[k], same[k]));
    }
    return;
  }

  // The anchors of the planes the tile's rows lie in.
  const long long p0 = row0 / a.map;
  const int h0 = static_cast<int>(row0 - p0 * a.map);   // row0's h2
  const int planes = (h0 + tile_rows - 1) / a.map + 1;
  const float4* src = anchors + p0 * kPlaneFloat4s;
  for (int i = t; i < planes * kPlaneFloat4s; i += kThreads) smem4[i] = src[i];
  __syncthreads();
  const float* anchor = reinterpret_cast<const float*>(smem4);

  // The thread's four columns: ATen's source columns and weights.
  int w1[4], w1p[4];
  float w0lambda[4], w1lambda[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float w1r = source_index(a.rscale, 4 * g + j);
    w1[j] = static_cast<int>(w1r);
    w1p[j] = w1[j] < kAnchors - 1 ? 1 : 0;
    w1lambda[j] = w1r - static_cast<float>(w1[j]);
    w0lambda[j] = 1.0f - w1lambda[j];
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int rr = r + k * a.rows_per_pass;
    if (rr >= tile_rows) break;
    const int hh = h0 + rr;
    const int q = hh / a.map;
    const int h2 = hh - q * a.map;
    const float h1r = source_index(a.rscale, h2);
    const int h1 = static_cast<int>(h1r);
    const int h1p = h1 < kAnchors - 1 ? kAnchors : 0;
    const float h1lambda = h1r - static_cast<float>(h1);
    const float h0lambda = 1.0f - h1lambda;
    const float* top = anchor + (q * kAnchors + h1) * kAnchors;
    const float* bottom = top + h1p;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float upper = products(w0lambda[j], top[w1[j]], w1lambda[j],
                                   top[w1[j] + w1p[j]]);
      const float lower = products(w0lambda[j], bottom[w1[j]], w1lambda[j],
                                   bottom[w1[j] + w1p[j]]);
      v[j] = products(h0lambda, upper, h1lambda, lower);
    }
    __stcs(out + first + static_cast<long long>(rr) * a.groups,
           add4(held[k], make_float4(v[0], v[1], v[2], v[3])));
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// out0 = trunk0 + the bilinear upsampling of anchors0 by `scale`, and out1
// likewise from trunk1 and anchors1: trunks and outs [N, C, 8 * scale, 8 *
// scale], anchors [N, C, 8, 8], planes = N * C, each a contiguous float32
// tensor on the stream's device at a 16-byte-aligned address.  Returns a
// CUDA error code (cudaSuccess, or cudaErrorInvalidValue for what the
// kernel does not take: a scale outside 1 to 128, a misaligned pointer).
int fusion_upsample_launch(const float* trunk0, const float* anchors0,
                           float* out0, const float* trunk1,
                           const float* anchors1, float* out1,
                           long long planes, int scale,
                           cudaStream_t stream) {
  if (planes < 0 || scale < 1 || scale > kMaxScale || !aligned(trunk0) ||
      !aligned(anchors0) || !aligned(out0) || !aligned(trunk1) ||
      !aligned(anchors1) || !aligned(out1))
    return cudaErrorInvalidValue;
  if (planes == 0) return cudaSuccess;
  Args a;
  a.trunk0 = reinterpret_cast<const float4*>(trunk0);
  a.anchors0 = reinterpret_cast<const float4*>(anchors0);
  a.out0 = reinterpret_cast<float4*>(out0);
  a.trunk1 = reinterpret_cast<const float4*>(trunk1);
  a.anchors1 = reinterpret_cast<const float4*>(anchors1);
  a.out1 = reinterpret_cast<float4*>(out1);
  a.map = kAnchors * scale;
  a.groups = a.map / 4;
  a.rows_per_pass = kThreads / a.groups;
  a.tile_rows = a.rows_per_pass * kRowsPerThread;
  a.rows = planes * a.map;
  a.tiles = ceil_div(a.rows, a.tile_rows);
  a.rscale = static_cast<float>(1.0 / scale);
  if (2 * a.tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // A tile's rows lie in at most (tile_rows - 1) / S + 2 planes.
  const int smem = scale == 1 ? 0
                              : ((a.tile_rows - 1) / a.map + 2) *
                                    kPlaneFloat4s *
                                    static_cast<int>(sizeof(float4));
  upsample_add<<<2 * a.tiles, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
