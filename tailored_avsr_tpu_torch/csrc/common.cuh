// Helpers shared by the kernels in this directory: dtype conversion to and
// from the f32 that every kernel computes in, a warp-wide sum, the
// asynchronous global -> shared copies (cp.async), and the once-only
// dynamic shared memory attribute of a kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace avsr {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (16, 8 or 4) from global src to shared dst without passing through
// registers; with pred false nothing is read and dst is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred) {
  static_assert(BYTES == 16 || BYTES == 8 || BYTES == 4, "cp.async copies 4, 8 or 16 bytes");
  const int n = pred ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(BYTES), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The opt-in above 48 KB of dynamic shared memory, set once per kernel and
// device (the first launch on a device pays one cudaFuncSetAttribute; later
// launches a cudaGetDevice). max_bytes is the most the kernel will take.
template <auto Kernel>
cudaError_t allow_dynamic_smem(size_t max_bytes) {
  if (max_bytes <= 48 * 1024) return cudaSuccess;
  static std::atomic<unsigned long long> done{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(max_bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace avsr
