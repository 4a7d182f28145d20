// Ancestry-group attention for one beam decode step: K4, and K6 over an int8
// cache.
//
// Replaces tailored_avsr_tpu/ops/group_attend.py:_group_attend_kernel
// (group_attend_anc, K4) and :_group_attend_q_kernel (group_attend_anc_q,
// K6). Each of the K queries of a beam group attends over the group's
// never-reordered (B, H, K, Lc, dk) cache: column (j, t) counts for query i
// iff anc[b, i, t] == j and t < n_live (= min(pos - 1, width)); the step's own
// column (k_new, v_new) joins the max and the normaliser. Softmax and sums in
// f32; q, k_new, v_new and out f32 or bf16, dk = 64. K4's cache has the query's
// type. K6's cache is an int8 payload with one f32 scale per (b, h, j, t)
// column: the logit is (q . k_int8) * k_scale / sqrt(dk) and the value scale
// folds into the column's softmax weight (p * v_scale). With no live column
// the output is exactly v_new.
//
// What bounds it on the H100: bytes. A step reads each live cache row of K
// and V once and does 2 * dk multiply-adds per row, far below the card's
// operations-per-byte line; the flagship LM's bf16 cache is 34 MB per leaf at
// batch 32, beam 10, Lc 104, its int8 payload half that, plus 4 bytes of
// scale per 64-byte row.
//
// Design: the TPU kernel multiplies each query densely against all K * Lc
// columns of its group and masks K - 1 of every K, because the MXU wants
// dense tiles. Exactly one slot j is live per column t, so here each query
// gathers instead: query i reads row anc[b, i, t] of its group for each live
// t. That is the same bytes as the dense form (K queries read K * Lc rows,
// the whole group block once) with K times fewer multiply-adds, and every
// masked column of the dense form contributes exactly 0, so the two differ
// only in the order of the sums. One 128-thread block owns one (b, h, i)
// query: B * H * K blocks (1,280 for the decoder, 2,560 for the LM at the
// flagship shape), enough to fill 132 SMs. Pass 1 gives each live column to
// 8 lanes that read its 64-wide key row (16-byte loads of bf16 or f32, 8-byte
// loads of int8; coalesced) and reduce by shuffles; scores stay in shared
// memory (the TPU kernel's VMEM logits). The max and the normaliser are block
// reductions; pass 2 gives each warp every fourth live column and each lane
// two of the 64 output dims, so a warp reads one value row per column,
// coalesced. An anc entry outside [0, K) matches nothing, as in the TPU
// kernel. K6 is the same template with an int8 element type and the two
// scale pointers set (null for K4): the int8 payload halves the bytes of a
// bf16 cache, and the scales add 1/16 of the payload.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using avsr::store;
using avsr::to_f32;

constexpr int DK = 64;
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int LANES_PER_COL = 8;                          // pass 1: 8 lanes x 8 dims per key row
constexpr int COLS_PER_ITER = NTHREADS / LANES_PER_COL;  // 16 columns per block iteration

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const char4 a = *reinterpret_cast<const char4*>(&u.x);
  const char4 b = *reinterpret_cast<const char4*>(&u.y);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(c.x, c.y);
}

// C: the cache's element type (T for K4, int8_t for K6); T: q, k_new, v_new, out.
// k_scale, v_scale: (B, H, K, Lc) f32 column scales for K6, null for K4.
template <typename C, typename T>
__global__ void __launch_bounds__(NTHREADS)
    group_attend_kernel(const C* __restrict__ k, const float* __restrict__ k_scale,
                        const C* __restrict__ v, const float* __restrict__ v_scale,
                        const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, const int* __restrict__ anc,
                        T* __restrict__ out, int heads, int beam, int lc, int n_live, float scale) {
  constexpr bool QUANT = std::is_same<C, int8_t>::value;
  extern __shared__ float smem[];
  float* s_q = smem;                     // DK: the query, f32
  float* s_acc = s_q + DK;               // NWARPS * DK: pass-2 partial outputs
  float* s_red = s_acc + NWARPS * DK;    // 2 * NWARPS + 1: reductions, self logit
  float* s_p = s_red + 2 * NWARPS + 1;   // lc: scores, then probabilities
  int* s_anc = reinterpret_cast<int*>(s_p + lc);  // lc: slots of this query's history

  const int query = blockIdx.x;  // ((b * heads + h) * beam + i)
  const int i = query % beam;
  const int bh = query / beam;
  const int b = bh / heads;
  const size_t group_off = size_t(bh) * beam * lc * DK;
  const size_t scale_off = size_t(bh) * beam * lc;  // (B, H, K, Lc) column scales
  const size_t qoff = size_t(query) * DK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid < DK) s_q[tid] = to_f32(q[qoff + tid]);
  for (int t = tid; t < n_live; t += NTHREADS) s_anc[t] = anc[(size_t(b) * beam + i) * lc + t];
  __syncthreads();

  // pass 1: scores of the live columns (-inf where no slot matches)
  const int sub = tid % LANES_PER_COL, col = tid / LANES_PER_COL;
  float qv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) qv[e] = s_q[sub * 8 + e];
  for (int t0 = 0; t0 < n_live; t0 += COLS_PER_ITER) {  // uniform bound: every lane shuffles
    const int t = t0 + col;
    const int j = t < n_live ? s_anc[t] : -1;
    const bool live = j >= 0 && j < beam;
    float dot = 0.f;
    if (live) {
      float x[8];
      load8(k + group_off + (size_t(j) * lc + t) * DK + sub * 8, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(qv[e], x[e], dot);
    }
#pragma unroll
    for (int off = LANES_PER_COL / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (sub == 0 && t < n_live) {
      float col_scale = scale;
      if constexpr (QUANT) {
        if (live) col_scale = k_scale[scale_off + size_t(j) * lc + t] * scale;
      }
      s_p[t] = live ? dot * col_scale : -INFINITY;
    }
  }
  if (warp == 0) {
    const float x = avsr::warp_sum(s_q[lane] * to_f32(k_new[qoff + lane]) +
                                   s_q[lane + 32] * to_f32(k_new[qoff + lane + 32]));
    if (lane == 0) s_red[2 * NWARPS] = x * scale;
  }
  __syncthreads();

  // max over the live columns and the self logit
  const float s_new = s_red[2 * NWARPS];
  float mx = s_new;
  for (int t = tid; t < n_live; t += NTHREADS) mx = fmaxf(mx, s_p[t]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) s_red[warp] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, s_red[w]);

  // probabilities (each thread rewrites the entries it read) and the
  // normaliser; K6 stores each column's weight times its value scale
  float sum = 0.f;
  for (int t = tid; t < n_live; t += NTHREADS) {
    const float p = expf(s_p[t] - mx);  // exp(-inf) = 0 for a column no slot matches
    sum += p;
    if constexpr (QUANT) {
      s_p[t] = p != 0.f ? p * v_scale[scale_off + size_t(s_anc[t]) * lc + t] : 0.f;
    } else {
      s_p[t] = p;
    }
  }
  sum = avsr::warp_sum(sum);
  if (lane == 0) s_red[NWARPS + warp] = sum;
  __syncthreads();
  const float p_new = expf(s_new - mx);
  float l = p_new;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) l += s_red[NWARPS + w];

  // pass 2: sum of p * value row; warp w takes columns t = w mod NWARPS
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int t = warp; t < n_live; t += NWARPS) {
    const float p = s_p[t];
    if (p != 0.f) {  // warp-uniform; a column no slot matches has p = 0 exactly (K6: or scale 0)
      const float2 x = load2(v + group_off + (size_t(s_anc[t]) * lc + t) * DK + 2 * lane);
      acc.x = fmaf(p, x.x, acc.x);
      acc.y = fmaf(p, x.y, acc.y);
    }
  }
  s_acc[warp * DK + 2 * lane] = acc.x;
  s_acc[warp * DK + 2 * lane + 1] = acc.y;
  __syncthreads();
  if (tid < DK) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) a += s_acc[w * DK + tid];
    store(&out[qoff + tid], (a + p_new * to_f32(v_new[qoff + tid])) / l);
  }
}

template <typename C, typename T>
cudaError_t launch(const void* k, const float* k_scale, const void* v, const float* v_scale,
                   const void* q, const void* k_new, const void* v_new, const int* anc, void* out,
                   int groups, int heads, int beam, int lc, int n_live, cudaStream_t stream) {
  const size_t smem = (DK + NWARPS * DK + 2 * NWARPS + 1 + size_t(lc)) * sizeof(float) +
                      size_t(lc) * sizeof(int);
  auto kernel = group_attend_kernel<C, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<groups * beam, NTHREADS, smem, stream>>>(
      static_cast<const C*>(k), k_scale, static_cast<const C*>(v), v_scale,
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new), anc,
      static_cast<T*>(out), heads, beam, lc, n_live, float(1.0 / sqrt(double(DK))));
  return cudaGetLastError();
}

}  // namespace

// K4. k, v: (B*H, K, Lc, 64) contiguous; q, k_new, v_new, out: (B*H, K, 64),
// all of one type; anc: (B, K, Lc) int32; groups = B*H. Columns t < n_live
// are read. Returns the launch's cudaError_t.
extern "C" int avsr_group_attend(const void* k, const void* v, const void* q, const void* k_new,
                                 const void* v_new, const void* anc, void* out, int groups,
                                 int heads, int beam, int lc, int n_live, int is_bf16,
                                 void* stream) {
  const int* a = static_cast<const int*>(anc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(is_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(k, nullptr, v, nullptr, q, k_new,
                                                             v_new, a, out, groups, heads, beam,
                                                             lc, n_live, s)
                     : launch<float, float>(k, nullptr, v, nullptr, q, k_new, v_new, a, out,
                                            groups, heads, beam, lc, n_live, s));
}

// K6. k, v: (B*H, K, Lc, 64) int8 contiguous; k_scale, v_scale: (B*H, K, Lc)
// f32; q, k_new, v_new, out: (B*H, K, 64) f32 or bf16 (is_bf16); the rest as
// K4. Returns the launch's cudaError_t.
extern "C" int avsr_group_attend_q(const void* k, const void* k_scale, const void* v,
                                   const void* v_scale, const void* q, const void* k_new,
                                   const void* v_new, const void* anc, void* out, int groups,
                                   int heads, int beam, int lc, int n_live, int is_bf16,
                                   void* stream) {
  const int* a = static_cast<const int*>(anc);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(is_bf16 ? launch<int8_t, __nv_bfloat16>(k, ks, v, vs, q, k_new, v_new, a, out,
                                                     groups, heads, beam, lc, n_live, s)
                     : launch<int8_t, float>(k, ks, v, vs, q, k_new, v_new, a, out, groups,
                                             heads, beam, lc, n_live, s));
}
