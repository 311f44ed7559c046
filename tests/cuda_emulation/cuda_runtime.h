// A stand-in for the CUDA runtime that lets g++ build a kernel source of
// the port for the CPU, to check its indexing and arithmetic there: each
// CUDA thread of a block is a std::thread, __syncthreads a barrier, a warp
// shuffle an exchange through memory between barriers of the warp, and
// blocks run one after another.  A launch `k<<<grid, block, smem,
// stream>>>(args)` is written `emulate_launch(k, grid, block, smem, stream,
// args)` (the tests rewrite it so).  The dynamic shared memory is
// `smem4`, which the including file defines in the kernel's namespace.
//
// Float arithmetic: built with -ffp-contract=off, so a*b + c rounds twice
// as nvcc's -fmad=false makes it, and fmaf is a fused multiply-add; the
// libm of the host stands in for CUDA's expf, logf, log1pf and tanhf, which
// may differ from them in the last bit.
#pragma once

#include <math.h>

#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct dim3_ { int x, y, z; };

inline thread_local dim3_ threadIdx{0, 0, 0};
inline thread_local dim3_ blockIdx{0, 0, 0};

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

template <class Kernel>
inline cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace cuda_emulation {

constexpr int kMaxWarps = 32;
inline std::barrier<>* block_barrier = nullptr;
inline std::barrier<>* warp_barriers[kMaxWarps];
inline float exchange[kMaxWarps][32];

inline float shuffle(float v, int src_lane) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  exchange[warp][lane] = v;
  warp_barriers[warp]->arrive_and_wait();
  const float got = exchange[warp][src_lane];
  warp_barriers[warp]->arrive_and_wait();
  return got;
}

}  // namespace cuda_emulation

inline void __syncthreads() {
  cuda_emulation::block_barrier->arrive_and_wait();
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  cuda_emulation::warp_barriers[threadIdx.x >> 5]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  return cuda_emulation::shuffle(v, (threadIdx.x & 31) ^ mask);
}
inline float __shfl_down_sync(unsigned, float v, int delta) {
  const int lane = threadIdx.x & 31;
  return cuda_emulation::shuffle(v, lane + delta < 32 ? lane + delta : lane);
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return sqrtf(a); }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}

// Runs `kernel(args...)` on `grid` blocks of `block` threads (a multiple
// of 32), one block after another.
template <class Kernel, class... Args>
void emulate_launch(Kernel kernel, int grid, int block, int smem_bytes,
                    cudaStream_t, Args... args) {
  extern std::size_t emulated_smem_bytes();
  if (block % 32 != 0 || block / 32 > cuda_emulation::kMaxWarps ||
      static_cast<std::size_t>(smem_bytes) > emulated_smem_bytes())
    std::abort();
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int w = 0; w < block / 32; ++w) {
      warps.push_back(std::make_unique<std::barrier<>>(32));
      cuda_emulation::warp_barriers[w] = warps.back().get();
    }
    cuda_emulation::block_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
