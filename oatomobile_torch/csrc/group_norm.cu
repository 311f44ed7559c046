// GroupNorm (groups of 8 channels, NCHW float32) and its epilogue in one
// pass for Hopper (sm_90a): the encoder's normalisation layers.
//
// It replaces no Pallas kernel: the JAX package's GroupNorm and ReLU6 are
// flax operations that XLA fuses.  In PyTorch a GroupNorm and what follows
// it were four to five kernels (the moments, the per-channel scale and
// bias, the broadcast apply, then the ReLU6 clamp or the residual add),
// each a pass over the tensor: at 1024 scenes the encoder's 52 norms move
// 29.6 GB a forward for 6.0 GB of normalised data.  This kernel reads each
// group once, keeps it in registers, and writes the result once: 12.2 GB a
// forward with the residuals read, 3.64 ms at the H100's 3.35 TB/s, its
// bound.  On an H100 the 52 launches of a forward take 5.18 ms (70% of
// it; PyTorch's kernels 14.75 ms); rows of 1,352 floats, 512 threads for
// ~3 elements each, stay furthest from it (44%): the block reduce's
// latency, which PyTorch's order fixes.
//
// What it computes, per (sample, group) row of n = 8 x HW contiguous
// floats with channels c = g*8 .. g*8+7:
//   mean, var = the row's Welford moments, rstd = rsqrt(var + eps)
//   y = a_c * x + b_c with a_c = rstd * gamma_c, b_c = -a_c * mean + beta_c
//     (HW = 1: y = (x - mean) * rstd * gamma_c + beta_c)
//   then one epilogue: none, ReLU6 (clamp to [0, 6], NaN kept), or
//   residual + y.
//
// The result is PyTorch's F.group_norm (then F.relu6, or x + h) on CUDA
// bit for bit, because the DIM and RIP policies are chaotic downstream:
// the plan's bridge switches between throttle and brake on its last bits.
// So the kernel repeats PyTorch's kernels operation by operation
// (aten/src/ATen/native/cuda/group_norm_kernel.cu, with WelfordOps from
// ATen/native/SharedReduceOps.h and BlockReduce from block_reduce.cuh):
//   - RowwiseMomentsCUDAKernel's order: a row takes 32 threads when n <
//     512, else 512; thread t folds elements t, t + threads, ... into its
//     Welford state (mean += delta / count with IEEE division, m2 +=
//     delta * (x - mean) as one FMA); then a shuffle-down tree over the
//     warp (offsets 16 .. 1), and with 512 threads the 16 warps' results
//     through shared memory into warp 0 and the same tree again (lanes
//     past the 16th hold the empty state, which the combine passes over);
//     the combine is WelfordOps::combine with its two FMAs;
//   - var = m2 / count, rstd = rsqrtf(var + eps) (c10's compat rsqrt);
//   - ComputeFusedParamsCUDAKernel's scale and bias, the bias rounded
//     twice (-scale * mean, then + beta: PyTorch's build leaves that sum,
//     whose addend is 0 where beta is null, uncontracted; on the H100 an
//     FMA there differs in the last bit of ~40% of the outputs), the apply
//     a * x + b as one FMA, GroupNorm1dForward's expression for HW = 1,
//     hardtanh's clamp, and the residual add rounded on its own.
// nvcc compiles PyTorch with contraction on; this source is built with
// -fmad=false and spells each FMA that contraction makes out as fmaf, so
// the host build of the tests (tests/cuda_emulation) runs the same
// arithmetic.  No fast-math, no TF32: IEEE float32 throughout.
//
// Design.
//   - n < 512 (the encoder's 7x7 and 4x4 stages, and HW = 1): one warp a
//     row, 8 rows a block of 256 threads (PyTorch's one-warp blocks cap an
//     SM at 32 of them); a lane holds 4 elements (n <= 128) or 16.
//   - n >= 512: one block of 512 threads a row; a thread holds 4, 10 or 40
//     elements (rows up to 2,048, 5,120 or 20,480 floats; the encoder's
//     are 1,352, 5,000 and 20,000 at its 100 x 100 input): the fewest
//     registers for the row, so that as many rows as fit are in flight on
//     an SM.
//   - Rows past 20,480 floats (an input past 100 x 100) take 512 threads
//     too, and read the row twice from memory, for the statistics and for
//     the apply, in the same order and arithmetic (group_norm_long).
//   - Up to 20,480 floats every element is loaded once into a register
//     before the statistics;
//     the row's mean and rstd, then its 8 scales and biases, go through
//     shared memory to the apply, which walks each thread's elements with
//     its channel kept by an increment (no division an element).
//   - The epilogue is a template argument, so each kernel holds only the
//     registers its epilogue needs (the residual is read in the apply).
//   - mean and rstd are written only where the caller asks (the encoder
//     does not): the card's checks hold them against
//     torch.native_group_norm's, which tells a difference in the
//     statistics from one in the apply; a training forward's backward
//     would read them.
//   - Tried on the H100 and dropped (the same bits, slower): 2 to 8 rows a
//     block interleaved, and the next row's loads issued before the
//     current row's statistics; each held about twice the registers and
//     lost 10-50% of the rate.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGroup = 8;           // channels a group
constexpr int kWarp = 32;
constexpr int kRowThreads = 512;    // cuda_utils::kCUDABlockReduceNumThreads
constexpr int kRowWarps = kRowThreads / kWarp;
constexpr int kWarpRows = 8;        // rows a block of the one-warp kernel
constexpr int kMaxPer = 40;         // a thread's registers: rows <= 20,480
// Shared floats: a warp's row in the one-warp kernel (mean, rstd, 8
// scales, 8 biases); a row in the 512-thread kernel (the warps' states,
// then the same).
constexpr int kWarpSlot = 2 + 2 * kGroup;
constexpr int kWarpSmem = kWarpRows * kWarpSlot * 4;
constexpr int kRowSmem = (3 * kRowWarps + kWarpSlot) * 4;

enum Epilogue { kNone = 0, kRelu6 = 1, kResidual = 2 };

// WelfordData without its integer count, which only reduce reads (there
// it is the element's index in the thread's sequence plus one).
struct Welford {
  float mean, m2, nf;
};

__device__ __forceinline__ Welford combine(Welford a, Welford b) {
  if (a.nf == 0.0f) return b;
  if (b.nf == 0.0f) return a;
  const float delta = b.mean - a.mean;
  const float new_count = a.nf + b.nf;
  const float nb_over_n = b.nf / new_count;
  return {fmaf(delta, nb_over_n, a.mean),
          fmaf(delta * delta * a.nf, nb_over_n, a.m2 + b.m2), new_count};
}

__device__ __forceinline__ Welford warp_reduce(Welford v) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    const Welford other{__shfl_down_sync(0xffffffffu, v.mean, offset),
                        __shfl_down_sync(0xffffffffu, v.m2, offset),
                        __shfl_down_sync(0xffffffffu, v.nf, offset)};
    v = combine(v, other);
  }
  return v;
}

// Thread t's elements t, t + kThreads, ... of a row of n.
template <int kThreads, int kPer>
__device__ __forceinline__ void load(const float* __restrict__ x, int n,
                                     int t, float (&v)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (t + i * kThreads < n) v[i] = x[t + i * kThreads];
}

// Thread t's elements folded into its Welford state in their order.
template <int kThreads, int kPer>
__device__ __forceinline__ Welford fold(const float (&v)[kPer], int n,
                                        int t) {
  Welford w{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (t + i * kThreads < n) {
      const float nf = static_cast<float>(i + 1);
      const float delta = v[i] - w.mean;
      const float mean = w.mean + delta / nf;
      w = {mean, fmaf(delta, v[i] - mean, w.m2), nf};
    }
  }
  return w;
}

// The projection of WelfordOps (correction 0) and the moments kernel's
// rstd: (mean, rstd) of a row's state.
__device__ __forceinline__ float2 moments(Welford w, float eps) {
  const float var = w.m2 / w.nf;
  return {w.mean, rsqrtf(var + eps)};
}

// Writes channel c's (a, b) of a row into ab[c], ab[kGroup + c]: the
// fused scale and bias, or gamma and beta themselves where HW = 1.
__device__ __forceinline__ void fused_params(float2 stats, float gamma,
                                             float beta, bool one_d,
                                             float* ab, int c) {
  if (one_d) {
    ab[c] = gamma;
    ab[kGroup + c] = beta;
  } else {
    const float scale = stats.y * gamma;
    ab[c] = scale;
    ab[kGroup + c] = __fadd_rn(__fmul_rn(-scale, stats.x), beta);
  }
}

// y[j] for thread t's elements j = t + i * kThreads < n of a row, its
// channel c = j / hw kept by an increment.
template <int kThreads, int kPer, int kEpi>
__device__ __forceinline__ void apply(const float (&v)[kPer], float2 stats,
                                      const float* ab, int n, int hw, int t,
                                      const float* __restrict__ residual,
                                      float* __restrict__ y) {
  const int step_c = kThreads / hw, step_r = kThreads - step_c * hw;
  int c = t / hw, r = t - c * hw;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = t + i * kThreads;
    if (j < n) {
      float out = hw == 1
                      ? fmaf((v[i] - stats.x) * stats.y, ab[c], ab[kGroup + c])
                      : fmaf(ab[c], v[i], ab[kGroup + c]);
      if (kEpi == kRelu6) out = isnan(out) ? out : fminf(fmaxf(out, 0.0f), 6.0f);
      if (kEpi == kResidual) out = residual[j] + out;
      y[j] = out;
    }
    c += step_c;
    r += step_r;
    if (r >= hw) {
      r -= hw;
      ++c;
    }
  }
}

// Rows of n = 8 * hw < 512: one warp a row, kWarpRows rows a block,
// kPer elements a lane.
template <int kPer, int kEpi>
__global__ void __launch_bounds__(kWarpRows * kWarp)
    group_norm_warp(const float* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const float* __restrict__ residual,
                    float* __restrict__ y, float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, long long rows, int groups,
                    int hw, float eps) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x % kWarp, slot = threadIdx.x / kWarp;
  // The warp's row: its mean and rstd, then its scales and biases.
  float* sm = reinterpret_cast<float*>(smem4) + slot * kWarpSlot;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpRows + slot;
  if (row >= rows) return;  // the whole warp
  const int n = kGroup * hw;
  const long long base = row * n;
  const int channel = static_cast<int>(row % groups) * kGroup + lane % kGroup;
  const float g = lane < kGroup ? gamma[channel] : 0.0f;
  const float b = lane < kGroup ? beta[channel] : 0.0f;
  float v[kPer];
  load<kWarp, kPer>(x + base, n, lane, v);
  const Welford w = warp_reduce(fold<kWarp, kPer>(v, n, lane));
  if (lane == 0) {
    const float2 stats = moments(w, eps);
    sm[0] = stats.x;
    sm[1] = stats.y;
    if (mean_out != nullptr) {
      mean_out[row] = stats.x;
      rstd_out[row] = stats.y;
    }
  }
  __syncwarp();
  const float2 stats{sm[0], sm[1]};
  if (lane < kGroup) fused_params(stats, g, b, hw == 1, sm + 2, lane);
  __syncwarp();
  apply<kWarp, kPer, kEpi>(v, stats, sm + 2, n, hw, lane,
                           residual + (kEpi == kResidual ? base : 0),
                           y + base);
}

// Rows of n = 8 * hw >= 512: one block of 512 threads a row, kPer
// elements a thread.
template <int kPer, int kEpi>
__global__ void __launch_bounds__(kRowThreads)
    group_norm_row(const float* __restrict__ x,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   const float* __restrict__ residual, float* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   int groups, int hw, float eps) {
  extern __shared__ float4 smem4[];
  // The warps' Welford states (mean, m2, count), then the row's mean and
  // rstd, its scales and biases.
  float* warp_state = reinterpret_cast<float*>(smem4);
  float* sm = warp_state + 3 * kRowWarps;
  const int t = threadIdx.x, lane = t % kWarp, warp = t / kWarp;
  const long long row = blockIdx.x;
  const int n = kGroup * hw;
  const long long base = row * n;
  const int channel = static_cast<int>(row % groups) * kGroup + t % kGroup;
  const float g = t < kGroup ? gamma[channel] : 0.0f;
  const float b = t < kGroup ? beta[channel] : 0.0f;
  float v[kPer];
  load<kRowThreads, kPer>(x + base, n, t, v);
  Welford w = warp_reduce(fold<kRowThreads, kPer>(v, n, t));
  if (lane == 0) {
    warp_state[warp] = w.mean;
    warp_state[kRowWarps + warp] = w.m2;
    warp_state[2 * kRowWarps + warp] = w.nf;
  }
  __syncthreads();
  if (warp == 0) {
    w = warp_reduce(lane < kRowWarps
                        ? Welford{warp_state[lane],
                                  warp_state[kRowWarps + lane],
                                  warp_state[2 * kRowWarps + lane]}
                        : Welford{0.0f, 0.0f, 0.0f});
    if (lane == 0) {
      const float2 stats = moments(w, eps);
      sm[0] = stats.x;
      sm[1] = stats.y;
      if (mean_out != nullptr) {
        mean_out[row] = stats.x;
        rstd_out[row] = stats.y;
      }
    }
  }
  __syncthreads();
  if (t < kGroup) fused_params({sm[0], sm[1]}, g, b, false, sm + 2, t);
  __syncthreads();
  apply<kRowThreads, kPer, kEpi>(v, {sm[0], sm[1]}, sm + 2, n, hw, t,
                                 residual + (kEpi == kResidual ? base : 0),
                                 y + base);
}

// Rows of n = 8 * hw > 512 * kMaxPer: group_norm_row's order and
// arithmetic, each thread's elements read once for the statistics and
// once for the apply instead of held in registers.  It repeats
// group_norm_row's block reduce: the two sharing it as a function cost
// group_norm_row registers on the H100 (40-float rows 64 -> 100-114,
// 4-float rows 32 -> 36) and the encoder's forward 5.17 -> 5.44-5.86 ms.
template <int kEpi>
__global__ void __launch_bounds__(kRowThreads)
    group_norm_long(const float* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const float* __restrict__ residual,
                    float* __restrict__ y, float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int groups, int hw,
                    float eps) {
  extern __shared__ float4 smem4[];
  float* warp_state = reinterpret_cast<float*>(smem4);
  float* sm = warp_state + 3 * kRowWarps;
  const int t = threadIdx.x, lane = t % kWarp, warp = t / kWarp;
  const long long row = blockIdx.x;
  const int n = kGroup * hw;
  const float* xr = x + row * n;
  const int channel = static_cast<int>(row % groups) * kGroup + t % kGroup;
  const float g = t < kGroup ? gamma[channel] : 0.0f;
  const float b = t < kGroup ? beta[channel] : 0.0f;
  Welford w{0.0f, 0.0f, 0.0f};
  for (int j = t, i = 1; j < n; j += kRowThreads, ++i) {
    const float nf = static_cast<float>(i);
    const float delta = xr[j] - w.mean;
    const float mean = w.mean + delta / nf;
    w = {mean, fmaf(delta, xr[j] - mean, w.m2), nf};
  }
  w = warp_reduce(w);
  if (lane == 0) {
    warp_state[warp] = w.mean;
    warp_state[kRowWarps + warp] = w.m2;
    warp_state[2 * kRowWarps + warp] = w.nf;
  }
  __syncthreads();
  if (warp == 0) {
    w = warp_reduce(lane < kRowWarps
                        ? Welford{warp_state[lane],
                                  warp_state[kRowWarps + lane],
                                  warp_state[2 * kRowWarps + lane]}
                        : Welford{0.0f, 0.0f, 0.0f});
    if (lane == 0) {
      const float2 stats = moments(w, eps);
      sm[0] = stats.x;
      sm[1] = stats.y;
      if (mean_out != nullptr) {
        mean_out[row] = stats.x;
        rstd_out[row] = stats.y;
      }
    }
  }
  __syncthreads();
  if (t < kGroup) fused_params({sm[0], sm[1]}, g, b, false, sm + 2, t);
  __syncthreads();
  const float* ab = sm + 2;
  const int step_c = kRowThreads / hw, step_r = kRowThreads - step_c * hw;
  int c = t / hw, r = t - c * hw;
  for (int j = t; j < n; j += kRowThreads) {
    float out = fmaf(ab[c], xr[j], ab[kGroup + c]);
    if (kEpi == kRelu6) out = isnan(out) ? out : fminf(fmaxf(out, 0.0f), 6.0f);
    if (kEpi == kResidual) out = residual[row * n + j] + out;
    y[row * n + j] = out;
    c += step_c;
    r += step_r;
    if (r >= hw) {
      r -= hw;
      ++c;
    }
  }
}

struct Args {
  const float *x, *gamma, *beta, *residual;
  float *y, *mean, *rstd;
  long long rows;
  int groups, hw;
  float eps;
};

template <int kPer, int kEpi>
void launch_warps(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.rows + kWarpRows - 1) / kWarpRows;
  group_norm_warp<kPer, kEpi><<<blocks, kWarpRows * kWarp, kWarpSmem, stream>>>(
      a.x, a.gamma, a.beta, a.residual, a.y, a.mean, a.rstd, a.rows,
      a.groups, a.hw, a.eps);
}

template <int kPer, int kEpi>
void launch_rows(const Args& a, cudaStream_t stream) {
  group_norm_row<kPer, kEpi><<<a.rows, kRowThreads, kRowSmem, stream>>>(
      a.x, a.gamma, a.beta, a.residual, a.y, a.mean, a.rstd, a.groups,
      a.hw, a.eps);
}

template <int kEpi>
void launch_long(const Args& a, cudaStream_t stream) {
  group_norm_long<kEpi><<<a.rows, kRowThreads, kRowSmem, stream>>>(
      a.x, a.gamma, a.beta, a.residual, a.y, a.mean, a.rstd, a.groups,
      a.hw, a.eps);
}

// The kernel and the elements a thread holds, by the row's n floats (the
// fewest registers for the row: more rows in flight on an SM).
template <int kEpi>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n = kGroup * a.hw;
  if (n <= 4 * kWarp)
    launch_warps<4, kEpi>(a, stream);
  else if (n < kRowThreads)
    launch_warps<kRowThreads / kWarp, kEpi>(a, stream);
  else if (n <= 4 * kRowThreads)
    launch_rows<4, kEpi>(a, stream);
  else if (n <= 10 * kRowThreads)
    launch_rows<10, kEpi>(a, stream);
  else if (n <= kMaxPer * kRowThreads)
    launch_rows<kMaxPer, kEpi>(a, stream);
  else
    launch_long<kEpi>(a, stream);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y [N, C, H, W] = GroupNorm(x) with groups of 8 channels (rows = N * C / 8,
// groups = C / 8, hw = H * W), then the epilogue (0 none, 1 ReLU6, 2 the
// residual added; residual is read only for 2); mean and rstd [rows] are
// written too unless null.  Every pointer a contiguous float32 tensor on
// the stream's device.  Returns a CUDA error code (cudaSuccess, or
// cudaErrorInvalidValue for what the kernel does not take).
int group_norm_launch(const float* x, const float* gamma, const float* beta,
                      const float* residual, float* y, float* mean,
                      float* rstd, long long rows, int groups, int hw,
                      float eps, int epilogue, cudaStream_t stream) {
  if (rows < 0 || groups < 1 || hw < 1 || (mean == nullptr) != (rstd == nullptr) ||
      static_cast<long long>(kGroup) * hw > 0x7fffffffLL - kRowThreads ||
      (epilogue == kResidual) != (residual != nullptr) ||
      rows > 0x7fffffffLL || (rows > 0 && rows % groups != 0))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const Args a{x, gamma, beta, residual, y, mean, rstd, rows, groups, hw, eps};
  switch (epilogue) {
    case kNone:
      return launch<kNone>(a, stream);
    case kRelu6:
      return launch<kRelu6>(a, stream);
    case kResidual:
      return launch<kResidual>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
