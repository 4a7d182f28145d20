// Helpers shared by the kernels in this directory: dtype conversion to and
// from the f32 that every kernel computes in, and a warp-wide sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace avsr
