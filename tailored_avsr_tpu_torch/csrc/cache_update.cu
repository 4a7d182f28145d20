// In-place beam KV-cache column write (K5, and K5' as its one-tensor case).
//
// Replaces tailored_avsr_tpu/ops/cache_update.py:_rmw_col_kv_kernel
// (write_cache_columns_kv) and :_rmw_col_kernel (write_cache_column). Writes
// the (B, H, K, dk) key column, and the value column where given, into
// column `col` of the (B, H, K, Lc, dk) caches, converting to the cache's
// type in the kernel (f32 -> bf16 rounds to nearest even, as torch does).
// An int8 cache (the payload of cache_dtype: int8) takes int8 columns,
// already quantised by the caller, and copies them bit for bit; the TPU
// kernel's 32-row int8 block read-modify-write was a Mosaic constraint.
//
// What bounds it on the H100: launch overhead. A write moves B*H*K*dk
// elements per tensor (a few hundred KB at the flagship shape), a microsecond
// of bandwidth. The TPU kernel read-modified-wrote an 8-column block because
// Mosaic slices a tiled axis only at tile boundaries; the GPU writes the
// column's elements directly, one thread per element of each 64-wide row
// (consecutive threads write consecutive addresses). One launch covers K and
// V, as on the TPU, which halves the launches per layer.

#include <stdint.h>

#include "common.cuh"

namespace {

enum ElemType { F32 = 0, BF16 = 1, I8 = 2 };  // the type codes of the entry point

template <typename C>
__device__ __forceinline__ C convert(float x);
template <>
__device__ __forceinline__ float convert<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

template <typename C, typename S>
__device__ __forceinline__ C cast(S x) { return convert<C>(avsr::to_f32(x)); }
template <>
__device__ __forceinline__ __nv_bfloat16 cast<__nv_bfloat16, __nv_bfloat16>(__nv_bfloat16 x) { return x; }
template <>
__device__ __forceinline__ int8_t cast<int8_t, int8_t>(int8_t x) { return x; }

template <typename C, typename S>
__global__ void write_columns_kernel(C* __restrict__ kcache, C* __restrict__ vcache,
                                     const S* __restrict__ kcol, const S* __restrict__ vcol,
                                     long long n, int lc, int col, int dk) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / dk;
    const long long dst = (row * lc + col) * dk + (idx - row * dk);
    kcache[dst] = cast<C>(kcol[idx]);
    if (vcache != nullptr) vcache[dst] = cast<C>(vcol[idx]);
  }
}

template <typename C, typename S>
cudaError_t launch(void* kcache, void* vcache, const void* kcol, const void* vcol, long long rows,
                   int lc, int col, int dk, cudaStream_t stream) {
  constexpr int threads = 256;
  const long long n = rows * dk;
  const long long blocks = (n + threads - 1) / threads;
  write_columns_kernel<C, S><<<int(blocks < 8192 ? blocks : 8192), threads, 0, stream>>>(
      static_cast<C*>(kcache), static_cast<C*>(vcache), static_cast<const S*>(kcol),
      static_cast<const S*>(vcol), n, lc, col, dk);
  return cudaGetLastError();
}

}  // namespace

// kcache, vcache: (rows, Lc, dk) contiguous, vcache may be null (K5');
// kcol, vcol: (rows, dk); rows = B*H*K; 0 <= col < Lc. cache_type, col_type:
// 0 f32, 1 bf16, 2 int8 (an int8 cache takes only int8 columns). Returns the
// launch's cudaError_t.
extern "C" int avsr_write_cache_columns(void* kcache, void* vcache, const void* kcol,
                                        const void* vcol, int rows, int lc, int col, int dk,
                                        int cache_type, int col_type, void* stream) {
  if (rows <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if ((cache_type == I8) != (col_type == I8)) return int(cudaErrorInvalidValue);
  switch (cache_type * 3 + col_type) {
    case BF16 * 3 + BF16: return int(launch<bf16, bf16>(kcache, vcache, kcol, vcol, rows, lc, col, dk, s));
    case BF16 * 3 + F32: return int(launch<bf16, float>(kcache, vcache, kcol, vcol, rows, lc, col, dk, s));
    case F32 * 3 + BF16: return int(launch<float, bf16>(kcache, vcache, kcol, vcol, rows, lc, col, dk, s));
    case F32 * 3 + F32: return int(launch<float, float>(kcache, vcache, kcol, vcol, rows, lc, col, dk, s));
    case I8 * 3 + I8: return int(launch<int8_t, int8_t>(kcache, vcache, kcol, vcol, rows, lc, col, dk, s));
    default: return int(cudaErrorInvalidValue);
  }
}
