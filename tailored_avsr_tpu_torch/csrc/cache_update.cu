// In-place beam KV-cache column writes: the step write, one launch for every
// cached layer of a beam step, with K5 and K5' as its one-layer and
// one-tensor cases.
//
// Replaces tailored_avsr_tpu/ops/cache_update.py:_rmw_col_kv_kernel
// (write_cache_columns_kv, K5) and :_rmw_col_kernel (write_cache_column,
// K5'), as the JAX beam search calls them once per layer
// (tailored_avsr_tpu/decode/beam_search.py:write_beam_columns_kv). A leaf
// is one layer: its (B, H, K, Lc, dk) K cache and, where given, V cache,
// into whose column `col` the step's K and V columns are written, converted
// to the cache's type in the kernel (f32 -> bf16 rounds to nearest even, as
// torch does). An int8 cache (the payload of cache_dtype: int8) takes int8
// columns, already quantised by the caller, and copies them bit for bit;
// its (B, H, K, Lc) f32 scale caches take the step's scales at the same
// column. The TPU kernel's 8/32-row block read-modify-write was a Mosaic
// constraint.
//
// The step's columns are read where they lie, by strides: element
// (b, h, i, d) of a source at b*sb + h*sh + i*si + d. A beam step's
// (N, H, 1, dk) projections, rows n = b*K + i, have sb = K*sn, si = sn; a
// (B, H, K, dk) group-layout column has si = dk. So no copy into the group
// layout precedes the write: the transpose is index arithmetic here.
//
// What bounds it on the H100: launch overhead, then bytes. One layer moves a
// few hundred KB (a microsecond of bandwidth) and one launch costs ~7 us;
// a beam step of the flagship (6 decoder and 16 LM layers, batch 32, beam
// 10) reads ~12.5 MB and writes ~12.5 MB in bf16, ~7.5 us at 3.35 TB/s.
// So the leaf table goes by value as a kernel parameter (no host-to-device
// copy: the int8 payloads and scales are new tensors every step), blockIdx.y
// picks the leaf, and each thread copies 16-byte vectors (8 bf16, 4 f32 or
// 16 int8 elements; one element a copy where a pointer or stride is not
// aligned to that), consecutive threads along a cache row.

#include <stdint.h>

#include "common.cuh"

namespace {

enum ElemType { F32 = 0, BF16 = 1, I8 = 2 };  // the type codes of the entry point

constexpr int MAX_LEAVES = 32;  // 32 x 120 bytes: within the 4 KB of kernel parameters
constexpr int THREADS = 256;

// One cached layer. Strides in elements; v_cache (and then v_src) may be
// null; the scale pointers are null unless the cache is int8.
struct StepLeaf {
  void* k_cache;
  void* v_cache;
  const void* k_src;
  const void* v_src;
  float* k_scale;
  float* v_scale;
  const float* k_scale_src;
  const float* v_scale_src;
  int heads, beam, lc, col, rows;  // rows = B * H * K
  int k_sb, k_sh, k_si, v_sb, v_sh, v_si;
  int s_sb, s_sh, s_si;            // the step scales, (b, h, i)
};
static_assert(sizeof(StepLeaf) == 120, "ops/cache_update.py's LEAF_DTYPE mirrors this layout");

struct StepTable {
  StepLeaf leaf[MAX_LEAVES];
};

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

template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

template <typename C, typename S, int E>
__device__ __forceinline__ void copy_vec(C* dst, const S* src) {
  const Vec<S, E> x = *reinterpret_cast<const Vec<S, E>*>(src);
  Vec<C, E> y;
#pragma unroll
  for (int e = 0; e < E; ++e) y.v[e] = cast<C>(x.v[e]);
  *reinterpret_cast<Vec<C, E>*>(dst) = y;
}

// blockIdx.y = leaf; threads of the x dimension stride over the leaf's
// rows * dk / E vectors; the thread that copies a row's first vector also
// writes its scales
template <typename C, typename S, int E>
__global__ void __launch_bounds__(THREADS)
    write_step_columns_kernel(const __grid_constant__ StepTable table, int dk) {
  const StepLeaf& f = table.leaf[blockIdx.y];
  const int per_row = dk / E;
  const long long n = (long long)f.rows * per_row;
  const int hk = f.heads * f.beam;
  for (long long idx = blockIdx.x * (long long)THREADS + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * THREADS) {
    const int r = int(idx / per_row), p = int(idx - (long long)r * per_row);
    const int b = r / hk, rem = r - b * hk, h = rem / f.beam, i = rem - h * f.beam;
    const size_t dst = ((size_t)r * f.lc + f.col) * dk + (size_t)p * E;
    copy_vec<C, S, E>(static_cast<C*>(f.k_cache) + dst,
                      static_cast<const S*>(f.k_src) + (size_t)b * f.k_sb + (size_t)h * f.k_sh +
                          (size_t)i * f.k_si + (size_t)p * E);
    if (f.v_cache != nullptr)
      copy_vec<C, S, E>(static_cast<C*>(f.v_cache) + dst,
                        static_cast<const S*>(f.v_src) + (size_t)b * f.v_sb + (size_t)h * f.v_sh +
                            (size_t)i * f.v_si + (size_t)p * E);
    if (p == 0 && f.k_scale != nullptr) {
      const size_t s = (size_t)b * f.s_sb + (size_t)h * f.s_sh + (size_t)i * f.s_si;
      f.k_scale[(size_t)r * f.lc + f.col] = f.k_scale_src[s];
      if (f.v_scale != nullptr) f.v_scale[(size_t)r * f.lc + f.col] = f.v_scale_src[s];
    }
  }
}

template <typename C, typename S>
cudaError_t launch(const StepTable& table, int n_leaves, int max_rows, int dk, int vec,
                   cudaStream_t stream) {
  constexpr int E = 16 / (sizeof(C) > sizeof(S) ? sizeof(C) : sizeof(S));
  const int e = vec ? E : 1;
  const long long units = (long long)max_rows * (dk / e);
  const long long blocks = (units + THREADS - 1) / THREADS;
  const dim3 grid(unsigned(blocks < 4096 ? blocks : 4096), unsigned(n_leaves));
  if (vec)
    write_step_columns_kernel<C, S, E><<<grid, THREADS, 0, stream>>>(table, dk);
  else
    write_step_columns_kernel<C, S, 1><<<grid, THREADS, 0, stream>>>(table, dk);
  return cudaGetLastError();
}

}  // namespace

// leaves: n_leaves (1 to 32) StepLeaf records in host memory, copied into
// the launch's parameters; 0 <= col < lc and rows >= 1 in each. cache_type,
// col_type: 0 f32, 1 bf16, 2 int8 (an int8 cache takes only int8 columns),
// the same for every leaf. vec: 1 when every pointer is 16-byte aligned and
// dk and every stride are multiples of the vector's elements. Returns the
// launch's cudaError_t.
extern "C" int avsr_write_step_columns(const void* leaves, int n_leaves, int max_rows, int dk,
                                       int cache_type, int col_type, int vec, void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || max_rows < 1 || dk < 1) return int(cudaErrorInvalidValue);
  StepTable table{};
  const StepLeaf* src = static_cast<const StepLeaf*>(leaves);
  for (int j = 0; j < n_leaves; ++j) table.leaf[j] = src[j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if ((cache_type == I8) != (col_type == I8)) return int(cudaErrorInvalidValue);
  switch (cache_type * 3 + col_type) {
    case BF16 * 3 + BF16: return int(launch<bf16, bf16>(table, n_leaves, max_rows, dk, vec, s));
    case BF16 * 3 + F32: return int(launch<bf16, float>(table, n_leaves, max_rows, dk, vec, s));
    case F32 * 3 + BF16: return int(launch<float, bf16>(table, n_leaves, max_rows, dk, vec, s));
    case F32 * 3 + F32: return int(launch<float, float>(table, n_leaves, max_rows, dk, vec, s));
    case I8 * 3 + I8: return int(launch<int8_t, int8_t>(table, n_leaves, max_rows, dk, vec, s));
    default: return int(cudaErrorInvalidValue);
  }
}
