// Flash attention for the tailored encoder's relative-position self-attention.
//
// One kernel template replaces two TPU kernels:
//   MODE_NONE, MODE_DENSE  tailored_avsr_tpu/ops/flash_attention.py:_attn_kernel
//                          (flash_attention: optional additive (B,H,T,T) bias)
//   MODE_RELPOS            tailored_avsr_tpu/ops/flash_attention.py:_attn_rel_kernel
//                          (flash_attention_relpos: the Transformer-XL term
//                          rel_shift(q_rel . pos^T) is computed in the kernel)
// out = softmax((q . k^T + bias) / sqrt(dk)) . v with a key-side (B, T) mask.
// A query row whose keys are all masked gives exactly 0. Inputs are f32 or
// bf16; everything is computed and accumulated in f32; out has the input type.
//
// What bounds it on the H100: per (batch, head) the kernel does 4*T^2*dk
// FLOPs (6*T^2*dk with the in-kernel rel-pos term) on O(T*dk) bytes, so it is
// bound by arithmetic. This first version computes with f32 FMA loops from
// shared memory, without tensor cores, so it runs far below the card's bf16
// tensor-core rate; the dense-bias form also streams B*H*T^2 bias elements
// from HBM. Moving the two products to mma/wgmma is later work.
//
// Design: one block owns a (batch*head, 64-query tile) pair and loops over
// 64-key tiles with an online softmax (running max m, running sum l and the
// f32 output accumulator stay in registers). That loop takes the place of
// the TPU kernel's sequential key grid axis and its persistent scratch. The
// 256 threads form a 16x16 grid; each owns 4 query rows and 4 key columns of
// the score tile, and 4 rows by dk/16 columns of the accumulator. The rel-pos
// tile is index arithmetic: bias[i, j] = q_rel[i] . pos[T-1-i+j], so a tile
// reads a span of BQ+BK-1 rows of the per-head table (no barrel shifter and no
// block-aligned re-basing: those were Mosaic workarounds). The ragged edge
// (T not a multiple of 64) is masked in the kernel.

#include <math.h>

#include "common.cuh"

namespace {

using avsr::store;
using avsr::to_f32;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1.0e30f;  // finite, as in the TPU kernel

enum { MODE_NONE = 0, MODE_DENSE = 1, MODE_RELPOS = 2 };

template <int DK, int MODE>
constexpr size_t smem_floats() {
  return size_t(BQ) * (DK + 1)                  // q tile
         + 2 * size_t(BK) * (DK + 1)            // k, v tiles
         + size_t(BQ) * (BK + 1)                // probabilities
         + BK                                   // key validity
         + (MODE == MODE_RELPOS                 // q_rel tile, table span
                ? size_t(BQ) * (DK + 1) + size_t(BQ + BK - 1) * (DK + 1)
                : 0);
}

// Rows [row0, row0 + nrows) of a (rows_total, DK) matrix into shared memory
// with row stride DK + 1 (conflict-free column reads); rows outside
// [0, rows_total) read as 0.
template <typename T, int DK>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int row0,
                                          int nrows, int rows_total) {
  for (int idx = threadIdx.x; idx < nrows * DK; idx += NTHREADS) {
    const int r = idx / DK, d = idx - r * DK;
    const int row = row0 + r;
    dst[r * (DK + 1) + d] =
        (row >= 0 && row < rows_total) ? to_f32(src[size_t(row) * DK + d]) : 0.f;
  }
}

template <typename T, int DK, int MODE>
__global__ void __launch_bounds__(NTHREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ bias,
                           const T* __restrict__ q_rel, const T* __restrict__ pos,
                           const unsigned char* __restrict__ mask, T* __restrict__ out,
                           int t_len, int heads, float scale) {
  static_assert(DK % 16 == 0, "dk must be a multiple of 16");
  static_assert(BQ == 64 && BK == 64 && NTHREADS == 256, "thread map assumes 64x64 tiles");
  constexpr int LD = DK + 1;
  constexpr int SLD = BK + 1;
  constexpr int NDC = DK / 16;  // accumulator columns per thread

  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_k = s_q + BQ * LD;
  float* s_v = s_k + BK * LD;
  float* s_p = s_v + BK * LD;
  float* s_valid = s_p + BQ * SLD;
  float* s_qr = s_valid + BK;  // MODE_RELPOS only
  float* s_pos = s_qr + BQ * LD;  // MODE_RELPOS only

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const size_t head_off = size_t(bh) * t_len * DK;
  const int n_pos = 2 * t_len - 1;

  load_rows<T, DK>(s_q, q + head_off, q0, BQ, t_len);
  if constexpr (MODE == MODE_RELPOS) load_rows<T, DK>(s_qr, q_rel + head_off, q0, BQ, t_len);

  float m[4], l[4], acc[4][NDC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NDC; ++c) acc[a][c] = 0.f;
  }

  for (int k0 = 0; k0 < t_len; k0 += BK) {
    __syncthreads();  // every reader of the previous tile is done
    load_rows<T, DK>(s_k, k + head_off, k0, BK, t_len);
    load_rows<T, DK>(s_v, v + head_off, k0, BK, t_len);
    if (tid < BK) {
      const int j = k0 + tid;
      s_valid[tid] = (j < t_len && mask[size_t(b) * t_len + j]) ? 1.f : 0.f;
    }
    if constexpr (MODE == MODE_RELPOS) {
      // query i = q0 + r and key j = k0 + c read table row T-1-i+j,
      // which is row (BQ-1-r+c) of the span starting at `base`
      const int base = t_len - q0 - BQ + k0;
      load_rows<T, DK>(s_pos, pos + size_t(h) * n_pos * DK, base, BQ + BK - 1, n_pos);
    }
    __syncthreads();

    // scores for rows ty+16a, columns tx+16c
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = s_q[(ty + 16 * a) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = s_k[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
    }

    if constexpr (MODE == MODE_RELPOS) {
      // (a, c) reads span row u0 + 16*(c - a): seven distinct rows per thread
      const int u0 = BQ - 1 - ty + tx;
      float r[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) r[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DK; ++d) {
        float qa[4], pe[7];
#pragma unroll
        for (int a = 0; a < 4; ++a) qa[a] = s_qr[(ty + 16 * a) * LD + d];
#pragma unroll
        for (int e = 0; e < 7; ++e) pe[e] = s_pos[(u0 + 16 * (e - 3)) * LD + d];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) r[a][c] = fmaf(qa[a], pe[c - a + 3], r[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = (s[a][c] + r[a][c]) * scale;
    } else if constexpr (MODE == MODE_DENSE) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = q0 + ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = k0 + tx + 16 * c;
          const float bv =
              (i < t_len && j < t_len) ? to_f32(bias[(size_t(bh) * t_len + i) * t_len + j]) : 0.f;
          s[a][c] = s[a][c] * scale + bv * scale;
        }
      }
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] *= scale;
    }

    // online softmax; the 16 threads of a row are one half-warp
    float valid[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) valid[c] = s_valid[tx + 16 * c];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (valid[c] == 0.f) s[a][c] = NEG_INF;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float corr = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // a fully masked tile has m_new == NEG_INF and exp(0) == 1: the
        // validity factor keeps those probabilities at 0
        const float p = valid[c] * expf(s[a][c] - m_new);
        s_p[(ty + 16 * a) * SLD + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[a] = l[a] * corr + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NDC; ++c) acc[a][c] *= corr;
    }
    __syncthreads();

    // acc += P . V
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pa[4], vc[NDC];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = s_p[(ty + 16 * a) * SLD + j];
#pragma unroll
      for (int c = 0; c < NDC; ++c) vc[c] = s_v[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NDC; ++c) acc[a][c] = fmaf(pa[a], vc[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= t_len) continue;
#pragma unroll
    for (int c = 0; c < NDC; ++c)
      store(&out[head_off + size_t(i) * DK + tx + 16 * c], l[a] > 0.f ? acc[a][c] / l[a] : 0.f);
  }
}

struct AttnArgs {
  const void *q, *k, *v, *bias, *q_rel, *pos;
  const unsigned char* mask;
  void* out;
  int batch, heads, t_len;
  cudaStream_t stream;
};

template <typename T, int DK, int MODE>
cudaError_t launch(const AttnArgs& a) {
  const size_t smem = smem_floats<DK, MODE>() * sizeof(float);
  auto kernel = flash_attention_kernel<T, DK, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + BQ - 1) / BQ, a.batch * a.heads);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.bias), static_cast<const T*>(a.q_rel),
      static_cast<const T*>(a.pos), a.mask, static_cast<T*>(a.out), a.t_len, a.heads,
      float(1.0 / sqrt(double(DK))));
  return cudaGetLastError();
}

template <typename T, int DK>
cudaError_t dispatch_mode(int mode, const AttnArgs& a) {
  switch (mode) {
    case MODE_NONE: return launch<T, DK, MODE_NONE>(a);
    case MODE_DENSE: return launch<T, DK, MODE_DENSE>(a);
    case MODE_RELPOS: return launch<T, DK, MODE_RELPOS>(a);
  }
  return cudaErrorInvalidValue;
}

// dk = 64 is the head size of every config in the repository (256-d, 4 heads)
template <typename T>
cudaError_t dispatch_dk(int dk, int mode, const AttnArgs& a) {
  if (dk == 64) return dispatch_mode<T, 64>(mode, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, q_rel, out: (B*H, T, dk) contiguous; bias: (B*H, T, T) for
// mode 1; pos: (H, 2T-1, dk) for mode 2; mask: (B, T) bytes, nonzero = valid
// key. Unused pointers may be null. Returns the launch's cudaError_t.
extern "C" int avsr_flash_attention(const void* q, const void* k, const void* v,
                                    const void* bias, const void* q_rel, const void* pos,
                                    const void* mask, void* out, int batch, int heads, int t_len,
                                    int dk, int is_bf16, int mode, void* stream) {
  const AttnArgs a{q,   k,    v,     bias,  q_rel, pos, static_cast<const unsigned char*>(mask),
                   out, batch, heads, t_len, static_cast<cudaStream_t>(stream)};
  return int(is_bf16 ? dispatch_dk<__nv_bfloat16>(dk, mode, a) : dispatch_dk<float>(dk, mode, a));
}
