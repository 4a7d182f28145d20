// HBM streaming probe (P1): the sum of |x| over each batch row.
//
// Replaces scripts/bench_int8_stream.py:stream_kernel (stream_time), the
// Pallas reduction that asked whether an int8 (..., 64)-minor KV cache
// really streams at half the bytes of a bf16 one on the TPU, where int8
// tiles at (32, 128) and a 64-wide minor axis might be lane-padded. On the
// H100 memory is linear, so the question becomes whether a reduction over
// an int8 tensor reaches the same bytes per second as over a bf16 one.
//
// What bounds it on the H100: bytes. One add and one abs per element, read
// once; nothing is reused.
//
// Design: pass 1 gives each 256-thread block one chunk of one batch row
// (32 KB at most), read with 16-byte loads (4 f32, 8 bf16 or 16 int8
// elements), four loads in flight per thread; each block writes its f32
// partial sum. Pass 2 gives each batch row one warp that adds the row's
// partials in a fixed order, so the result does not change from run to run
// (no atomics). Rows whose length or base is not 16-byte aligned take the
// same kernel with one element per load.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int UNROLL = 4;

__device__ __forceinline__ float abs_sum16(const uint4& u, float) {
  return fabsf(__uint_as_float(u.x)) + fabsf(__uint_as_float(u.y)) + fabsf(__uint_as_float(u.z)) +
         fabsf(__uint_as_float(u.w));
}

__device__ __forceinline__ float abs_sum16(const uint4& u, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    s += fabsf(f.x) + fabsf(f.y);
  }
  return s;
}

__device__ __forceinline__ float abs_sum16(const uint4& u, int8_t) {
  const char4* c = reinterpret_cast<const char4*>(&u);
  int s = 0;  // at most 16 * 128: exact
#pragma unroll
  for (int e = 0; e < 4; ++e) s += abs(int(c[e].x)) + abs(int(c[e].y)) + abs(int(c[e].z)) + abs(int(c[e].w));
  return float(s);
}

__device__ __forceinline__ float abs1(float x) { return fabsf(x); }
__device__ __forceinline__ float abs1(__nv_bfloat16 x) { return fabsf(__bfloat162float(x)); }
__device__ __forceinline__ float abs1(int8_t x) { return fabsf(float(x)); }

// One unit is one 16-byte vector (VEC) or one element (!VEC).
template <typename T, bool VEC>
__device__ __forceinline__ float unit_abs_sum(const T* row, long long u) {
  if constexpr (VEC) {
    return abs_sum16(__ldg(reinterpret_cast<const uint4*>(row) + u), T());
  } else {
    return abs1(row[u]);
  }
}

// grid (nblk, rows): block (blk, r) sums units [blk * chunk, (blk + 1) * chunk)
// of row r, plus (block 0 of a vector row) the elements past the last vector.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
    abs_sum_partial(const T* __restrict__ x, long long row_len, long long n_units, int chunk,
                    float* __restrict__ partial) {
  const int r = blockIdx.y, blk = blockIdx.x, tid = threadIdx.x;
  const T* row = x + size_t(r) * size_t(row_len);
  const long long begin = (long long)blk * chunk;
  const long long end = begin + chunk < n_units ? begin + chunk : n_units;
  float acc = 0.f;
  long long u = begin + tid;
  for (; u + (UNROLL - 1) * NTHREADS < end; u += UNROLL * NTHREADS) {
    float s[UNROLL];
#pragma unroll
    for (int e = 0; e < UNROLL; ++e) s[e] = unit_abs_sum<T, VEC>(row, u + e * NTHREADS);
#pragma unroll
    for (int e = 0; e < UNROLL; ++e) acc += s[e];
  }
  for (; u < end; u += NTHREADS) acc += unit_abs_sum<T, VEC>(row, u);
  if constexpr (VEC) {
    if (blk == 0) {
      for (long long i = n_units * (16 / sizeof(T)) + tid; i < row_len; i += NTHREADS) acc += abs1(row[i]);
    }
  }
  __shared__ float s_red[NWARPS];
  acc = avsr::warp_sum(acc);
  if ((tid & 31) == 0) s_red[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) total += s_red[w];
    partial[size_t(r) * gridDim.x + blk] = total;
  }
}

// one warp per row: the row's nblk partials in a fixed order
__global__ void abs_sum_final(const float* __restrict__ partial, int nblk, int rows,
                              float* __restrict__ out) {
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (r >= rows) return;
  float s = 0.f;
  for (int i = lane; i < nblk; i += 32) s += partial[size_t(r) * nblk + i];
  s = avsr::warp_sum(s);
  if (lane == 0) out[r] = s;
}

template <typename T>
cudaError_t launch(const void* x, float* partial, float* out, int rows, long long row_len, int vec,
                   int chunk, int nblk, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const dim3 grid(nblk, rows);
  if (vec) {
    const long long n_units = row_len / (16 / sizeof(T));
    abs_sum_partial<T, true><<<grid, NTHREADS, 0, stream>>>(xp, row_len, n_units, chunk, partial);
  } else {
    abs_sum_partial<T, false><<<grid, NTHREADS, 0, stream>>>(xp, row_len, row_len, chunk, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  abs_sum_final<<<(rows + 7) / 8, 256, 0, stream>>>(partial, nblk, rows, out);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, row_len) contiguous, elem_type 0 f32, 1 bf16, 2 int8; vec: 1 when
// x and row_len * sizeof(elem) are 16-byte aligned (16-byte loads), else 0;
// chunk: units (vectors or elements) per block; nblk = ceil(units / chunk);
// partial: (rows, nblk) f32 scratch; out: (rows,) f32. Two launches (the
// per-block sums, then the per-row sums). Returns the first failing launch's
// cudaError_t.
extern "C" int avsr_stream_abs_sum(const void* x, void* partial, void* out, int rows,
                                   long long row_len, int elem_type, int vec, int chunk, int nblk,
                                   void* stream) {
  if (rows <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  switch (elem_type) {
    case 0: return int(launch<float>(x, p, o, rows, row_len, vec, chunk, nblk, s));
    case 1: return int(launch<__nv_bfloat16>(x, p, o, rows, row_len, vec, chunk, nblk, s));
    case 2: return int(launch<int8_t>(x, p, o, rows, row_len, vec, chunk, nblk, s));
    default: return int(cudaErrorInvalidValue);
  }
}
