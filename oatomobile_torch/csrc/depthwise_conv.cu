// Depthwise 3x3 convolution (NCHW float32, no bias, stride 1 or 2, a
// padding of 0 to 2 on each side) for Hopper (sm_90a): the encoder's 17
// depthwise layers.
//
// It replaces no Pallas kernel: the JAX package's depthwise layers are
// flax convolutions (feature_group_count = C) that XLA compiles.  In
// PyTorch they were ATen's conv_depthwise2d_forward, one thread an output
// reading its nine taps through L1, 5.31 ms a DIM step at 1024 scenes;
// before the one uneven stride-2 layer (50 x 50 -> 25 x 25, padding
// (0, 1)) F.pad copied the input, 2.0 GB more.  The 17 layers' inputs and
// outputs are 1.32 M floats a sample: 5.40 GB a forward at 1024 scenes,
// 1.61 ms at the H100's 3.35 TB/s, the bound (9 multiply-adds an output
// are nothing beside it).  This kernel reads the unpadded input once,
// with 16-byte loads, and writes each output once.
//
// What it computes, for output (n, c, oh, ow):
//   acc = +0; for kh in 0..2, for kw in 0..2 (that order):
//     ih = oh * stride - top + kh, iw = ow * stride - left + kw;
//     if 0 <= ih < H and 0 <= iw < W:
//       acc = fmaf(w[c][kh][kw], x[n][c][ih][iw], acc)
//   y[n][c][oh][ow] = acc
// The result is PyTorch's F.conv2d (after F.pad where the padding is
// uneven) on CUDA bit for bit, because the DIM and RIP policies are
// chaotic downstream: the plan's bridge switches between throttle and
// brake on its last bits.  ATen's kernel (aten/src/ATen/native/cuda/
// DepthwiseConv2d.cu, conv_depthwise2d_forward_kernel) starts each output
// at 0 (these layers have no bias), adds weight * input for the taps in
// this order and leaves out the taps outside its input; nvcc contracts its
// `value += w * x` into one fused multiply-add.  Where F.pad made the
// padding, ATen reads the pad's zeros instead of leaving the taps out:
// fmaf(w, 0, acc) is acc, so the sum is the same (unless acc is -0, which
// a sum started at +0 reaches only where a product underflows; -0 and +0
// compare equal).  This source is built with -fmad=false and spells the
// one contraction out as fmaf, so that the host build of the tests
// (tests/cuda_emulation) runs the same arithmetic.  No fast-math: IEEE
// float32 throughout.
//
// Design.
//   - A block of 128 threads takes one tile: as many whole planes (n, c)
//     as fit in 4,096 floats (16 KB), their outputs too, and 128 planes,
//     chosen between that and half of it so that the block's columns keep
//     its threads' rounds full: at the encoder's 100 x 100 input, 50 x 50
//     maps one plane, 25 x 25 five (stride 1) or three (stride 2), 13 x 13
//     nineteen or eighteen, 7 x 7 seventy-three or sixty-four, 4 x 4 128.
//     A plane past 4,096 floats is cut into bands of output rows, each
//     with its input rows and halo (an input past 128 x 128).  Either way
//     the tile's input is one contiguous run of memory, and so is its
//     output.
//   - The block reads the input run into shared memory with 16-byte loads
//     (a scalar head and tail around the aligned body), every load of a
//     thread issued before the first store so that it waits for memory
//     once, and its planes' nine weights beside it.
//   - A thread then walks one column of a plane, over a run of output
//     rows (the tile's rows cut so that the block's threads have work),
//     keeping the 3 x 3 window in registers: a new output row reads 3
//     (stride 1) or 6 (stride 2) floats from shared memory, not 9.  The
//     outputs go to shared memory, and the block writes its output run
//     with 16-byte stores: a 4 x 4 or 7 x 7 plane's columns would store a
//     few floats at a time.
//   - 128 threads, not 256, and the outputs staged: on the H100 the 17
//     layers took 2.49 ms with 256 threads storing from registers, 2.23
//     with the outputs staged, 2.17 with at most 128 planes a tile (the 4
//     x 4 tiles' shared memory held fewer blocks on an SM); tiles of 8,192
//     floats read 2.48, of 2,048 2.61.  74% of the bound: the 7 x 7 and 4
//     x 4 maps stay furthest from it (63%, 52%), their columns short.
//   - The tiling is chosen from the map's size and the stride in the
//     launcher; nothing asks which layer it is.  Shared memory stays under
//     the 48 KB a launch gets without opting in: at most 4,096 input
//     floats, 1,152 weights and 4,096 output floats a tile, or one plane
//     of at most 6,836 output floats.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileFloats = 4096;   // a tile's input or output floats
constexpr int kMaxPlanes = 128;     // planes a tile (their 9 weights staged)
constexpr int kTaps = 9;
// The widest row a band can take: three input rows in a tile.
constexpr int kMaxWidth = kTileFloats / 3;
// A thread's 16-byte loads of a tile.
constexpr int kLoads = kTileFloats / 4 / kThreads;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

struct Args {
  long long planes;          // N * C
  int channels, h, w, ho, wo, top, left;
  int tile_planes;           // whole planes a tile (1 when bands > 1)
  int bands, band_rows;      // output rows of a plane cut into bands
  int runs, run_rows;        // a band's output rows cut into a thread's runs
  int in_floats;             // shared floats of a tile's input
};

// One input row of a thread's window: its three columns (0 where the
// column or the row lies outside the input; those taps are left out).
__device__ __forceinline__ bool load_row(const float* in, int ih, int h,
                                         int w, int iw, const bool (&cols)[3],
                                         float (&v)[3]) {
  const bool ok = ih >= 0 && ih < h;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    v[j] = ok && cols[j] ? in[ih * w + iw + j] : 0.0f;
  return ok;
}

// The window row kh's taps added to acc in ATen's order.
__device__ __forceinline__ float taps(float acc, bool row,
                                      const bool (&cols)[3], const float* wt,
                                      const float (&v)[3]) {
  if (row) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (cols[j]) acc = fmaf(wt[j], v[j], acc);
  }
  return acc;
}

template <int kStride>
__global__ void __launch_bounds__(kThreads)
    depthwise3x3(const float* __restrict__ x, const float* __restrict__ weight,
                 float* __restrict__ y, Args a) {
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x;
  const long long tile = blockIdx.x / a.bands;
  const int band = static_cast<int>(blockIdx.x - tile * a.bands);
  const long long p0 = tile * a.tile_planes;
  const long long left_planes = a.planes - p0;
  const int np = left_planes < a.tile_planes ? static_cast<int>(left_planes)
                                             : a.tile_planes;
  const int oh0 = band * a.band_rows, oh1 = imin(a.ho, oh0 + a.band_rows);
  // The tile's input rows: all of each plane's, or a band's with its halo.
  int ih_lo = 0, ih_hi = a.h;
  if (a.bands > 1) {
    ih_lo = imax(0, oh0 * kStride - a.top);
    ih_hi = imin(a.h, (oh1 - 1) * kStride - a.top + 3);
  }
  const int plane = a.h * a.w;
  const int n = (np - 1) * plane + (ih_hi - ih_lo) * a.w;
  const float* src = x + p0 * plane + static_cast<long long>(ih_lo) * a.w;

  // Shared memory: the planes' weights, then the input run placed so that
  // its 16-byte-aligned floats land on 16-byte-aligned slots.
  float* sw = reinterpret_cast<float*>(smem4);
  const int lead =
      static_cast<int>((reinterpret_cast<unsigned long long>(src) >> 2) & 3);
  float* in_tile = sw + ((a.tile_planes * kTaps + 3) & ~3) + lead;
  const int head = imin(n, (4 - lead) & 3);
  const int body = (n - head) >> 2;
  if (t < head) in_tile[t] = src[t];
  // Every load of the thread is issued before the first store, so that the
  // block waits for memory once.
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  float4* tile4 = reinterpret_cast<float4*>(in_tile + head);
  float4 held[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u)
    if (t + u * kThreads < body) held[u] = src4[t + u * kThreads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u)
    if (t + u * kThreads < body) tile4[t + u * kThreads] = held[u];
  for (int i = head + 4 * body + t; i < n; i += kThreads) in_tile[i] = src[i];
  const int c0 = static_cast<int>(p0 % a.channels);
  for (int i = t; i < np * kTaps; i += kThreads) {
    const int q = i / kTaps;
    sw[i] = weight[((c0 + q) % a.channels) * kTaps + i - q * kTaps];
  }
  __syncthreads();

  // The output run, staged in shared memory after the input as the input
  // is.
  float* dst = y + p0 * a.ho * a.wo + static_cast<long long>(oh0) * a.wo;
  const int olead =
      static_cast<int>((reinterpret_cast<unsigned long long>(dst) >> 2) & 3);
  float* out_tile = sw + ((a.tile_planes * kTaps + 3) & ~3) +
                    ((a.in_floats + 4 + 3) & ~3) + olead;
  // Row ih of the tile's plane q at planes_in + q * plane + ih * w.
  const float* planes_in = in_tile - ih_lo * a.w;
  const int items = np * a.runs * a.wo;
  for (int i = t; i < items; i += kThreads) {
    const int k = i / a.wo;
    const int ow = i - k * a.wo;
    const int q = k / a.runs;
    const int r0 = oh0 + (k - q * a.runs) * a.run_rows;
    const int r1 = imin(oh1, r0 + a.run_rows);
    if (r0 >= r1) continue;
    float wt[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) wt[j] = sw[q * kTaps + j];
    const float* in = planes_in + q * plane;
    const int iw = ow * kStride - a.left;
    bool cols[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) cols[j] = iw + j >= 0 && iw + j < a.w;
    int ih = r0 * kStride - a.top;
    float v0[3], v1[3], v2[3];
    bool rv0 = load_row(in, ih, a.h, a.w, iw, cols, v0);
    bool rv1 = load_row(in, ih + 1, a.h, a.w, iw, cols, v1);
    bool rv2 = load_row(in, ih + 2, a.h, a.w, iw, cols, v2);
    float* out = out_tile + (q * (oh1 - oh0) - oh0) * a.wo + ow;
    for (int oh = r0;;) {
      float acc = 0.0f;
      acc = taps(acc, rv0, cols, wt, v0);
      acc = taps(acc, rv1, cols, wt + 3, v1);
      acc = taps(acc, rv2, cols, wt + 6, v2);
      out[oh * a.wo] = acc;
      if (++oh == r1) break;
      ih += kStride;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        v0[j] = kStride == 1 ? v1[j] : v2[j];
        if (kStride == 1) v1[j] = v2[j];
      }
      rv0 = kStride == 1 ? rv1 : rv2;
      if (kStride == 1) {
        rv1 = rv2;
      } else {
        rv1 = load_row(in, ih + 1, a.h, a.w, iw, cols, v1);
      }
      rv2 = load_row(in, ih + 2, a.h, a.w, iw, cols, v2);
    }
  }
  __syncthreads();
  const int m = np * (oh1 - oh0) * a.wo;
  const int ohead = imin(m, (4 - olead) & 3);
  const int obody = (m - ohead) >> 2;
  if (t < ohead) dst[t] = out_tile[t];
  const float4* out4 = reinterpret_cast<const float4*>(out_tile + ohead);
  float4* dst4 = reinterpret_cast<float4*>(dst + ohead);
  for (int i = t; i < obody; i += kThreads) dst4[i] = out4[i];
  for (int i = ohead + 4 * obody + t; i < m; i += kThreads)
    dst[i] = out_tile[i];
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Cuts a band of `rows` output rows of `columns` columns (over the tile's
// planes) into runs, so that the block's threads have about one run each.
void cut_runs(int columns, int rows, Args& a) {
  int runs = kThreads / columns;
  runs = runs < 1 ? 1 : runs > rows ? rows : runs;
  a.run_rows = static_cast<int>(ceil_div(rows, runs));
  a.runs = static_cast<int>(ceil_div(rows, a.run_rows));
}

// The tiling, from the map's size and the stride.
void choose_tiling(int stride, Args& a) {
  const int plane = a.h * a.w;
  if (plane <= kTileFloats) {
    // Whole planes: from as many as fit (inputs and outputs) down to half
    // of that, the count whose threads' last round is fullest (the most
    // planes on a tie).
    long long most = kTileFloats / plane;
    const long long most_out =
        kTileFloats / (static_cast<long long>(a.ho) * a.wo);
    most = most > most_out ? most_out : most;
    most = most < 1 ? 1 : most > kMaxPlanes ? kMaxPlanes : most;
    most = most > a.planes ? a.planes : most;
    a.bands = 1;
    a.band_rows = a.ho;
    double best = -1.0;
    int chosen = static_cast<int>(most);
    for (int p = static_cast<int>(most); 2 * p >= most; --p) {
      cut_runs(p * a.wo, a.ho, a);
      const long long items = static_cast<long long>(p) * a.wo * a.runs;
      const double full =
          static_cast<double>(items) / (ceil_div(items, kThreads) * kThreads);
      if (full > best) {
        best = full;
        chosen = p;
      }
    }
    a.tile_planes = chosen;
  } else {
    // One plane a tile, in bands whose input and output rows fit.
    a.tile_planes = 1;
    a.band_rows = (kTileFloats / a.w - 3) / stride + 1;
    if (a.band_rows > kTileFloats / a.wo) a.band_rows = kTileFloats / a.wo;
    a.bands = static_cast<int>(ceil_div(a.ho, a.band_rows));
  }
  cut_runs(a.tile_planes * a.wo, a.band_rows, a);
}

}  // namespace

extern "C" {

// y [N, C, Ho, Wo] = the depthwise 3x3 convolution of x [N, C, H, W] by
// weight [C, 1, 3, 3] (planes = N * C), stride 1 or 2, top and left rows
// and columns of padding (the bottom and right ones follow from Ho and
// Wo), each at most 2.  Every pointer a contiguous float32 tensor on the
// stream's device.  Returns a CUDA error code (cudaSuccess, or
// cudaErrorInvalidValue for what the kernel does not take: W past 1,365).
int depthwise_conv_launch(const float* x, const float* weight, float* y,
                          long long planes, int channels, int h, int w,
                          int ho, int wo, int stride, int top, int left,
                          cudaStream_t stream) {
  if (planes < 0 || channels < 1 || planes % channels != 0 || h < 1 ||
      w < 1 || w > kMaxWidth || ho < 1 || wo < 1 ||
      (stride != 1 && stride != 2) || top < 0 || top > 2 || left < 0 ||
      left > 2 || static_cast<long long>(h) * w > 0x7fffffffLL ||
      ho > (h + top - 1) / stride + 1 || wo > (w + left - 1) / stride + 1 ||
      static_cast<long long>(ho) * wo > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (planes == 0) return cudaSuccess;
  Args a{planes, channels, h, w, ho, wo, top, left, 0, 0, 0, 0, 0, 0};
  choose_tiling(stride, a);
  const long long blocks = ceil_div(planes, a.tile_planes) * a.bands;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.in_floats = a.bands > 1 ? ((a.band_rows - 1) * stride + 3) * w
                            : a.tile_planes * h * w;
  const int out_floats =
      a.bands > 1 ? a.band_rows * wo : a.tile_planes * ho * wo;
  const int smem = 4 * (((a.tile_planes * kTaps + 3) & ~3) +
                        ((a.in_floats + 4 + 3) & ~3) + 4 + out_floats);
  if (stride == 1)
    depthwise3x3<1><<<blocks, kThreads, smem, stream>>>(x, weight, y, a);
  else
    depthwise3x3<2><<<blocks, kThreads, smem, stream>>>(x, weight, y, a);
  return cudaGetLastError();
}

}  // extern "C"
