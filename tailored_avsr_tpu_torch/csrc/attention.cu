// Flash attention for the tailored encoder's relative-position self-attention.
//
// Two kernel templates replace two TPU kernels:
//   MODE_NONE, MODE_DENSE  tailored_avsr_tpu/ops/flash_attention.py:_attn_kernel
//                          (flash_attention, K2: optional additive (B,H,T,T) bias)
//   MODE_RELPOS            tailored_avsr_tpu/ops/flash_attention.py:_attn_rel_kernel
//                          (flash_attention_relpos, K1: the Transformer-XL term
//                          rel_shift(q_rel . pos^T) is computed in the kernel)
// out = softmax((q . k^T + bias) / sqrt(dk)) . v with a key-side (B, T) mask.
// A query row whose keys are all masked gives exactly 0. Inputs are f32 or
// bf16; softmax and sums in f32; out has the input type.
//
// What bounds it on the H100: per (batch, head) the kernel does 4*T^2*dk
// FLOPs (6*T^2*dk with the in-kernel rel-pos term) on O(T*dk) bytes, plus
// B*H*T^2 bias elements streamed from HBM in the dense-bias form. At the
// encoder's T = 100 the bf16 bias form is bound by its bytes (~9 MB); at
// T = 500 K1's bytes (31 MB) and products (9.2 GFLOP at B=24, H=4) bound it
// about equally (~9 us each).
//
// bf16 K1 and K2 (all three modes) run on the tensor cores
// (flash_attention_tc_kernel): one 128-thread block owns a (batch*head,
// 64-query tile); each warp owns 16 query rows and walks 64-key tiles with an
// online softmax. Both products are mma.sync.m16n8k16 bf16 -> f32: Q and K
// fragments come from shared memory by ldmatrix, V's by ldmatrix.trans; the
// scores stay in registers, the row max and sum are quad shuffles, and P is
// packed to bf16 in registers as the A operand of P . V (no shared-memory
// round trip). K, V and bias tiles come in as cp.async copies (16 bytes; the
// bias in 8 or 4 when T is not a multiple of 8, element by element when T
// is odd), double-buffered: tile j+1 is in flight while tile j is
// multiplied. Shared rows are padded by 16 bytes, so the 8 rows of an
// ldmatrix (or of the bias reads) fall in distinct banks. Warps whose 16
// rows lie past T and 16-key steps past T skip their products: at T = 100
// the products cover 112 x 112 of the 100 x 100 scores (1.25x), against
// 128 x 128 (1.64x) for whole 64 x 64 tiles.
//
// K1's rel-pos term on the tensor cores: bias[i, j] = q_rel[i] . pos[T-1-i+j]
// is a Toeplitz product. For query rows q0 + r and keys k0 + c it reads span
// row 63 - r + c of the 127 table rows from T - q0 - 64 + k0; the table
// comes in as 64-row chunks by cp.async into a ring of three (tile j uses
// chunks j and j+1 while chunk j+2 is in flight), rows outside [0, 2T-1)
// zero-filled (they feed only masked keys or rows past T). Warp w (rows
// 16w + lr) needs span rows [48 - 16w, 48 - 16w + 79): it multiplies its
// 16 Q_rel rows by that 80-row window with mma.sync (10 n8 tiles, against 8
// for q . k^T), writes the 16 x 80 f32 product to its own strip of shared
// memory, and reads it back skewed, entry (lr, c) from column 15 - lr + c,
// into the score fragment before the softmax. The skew is a per-row shift
// that the mma fragment layout cannot do by shuffles; strip rows of 88
// floats keep the 8-byte stores conflict-free and the skewed reads at two
// ways. The Q and Q_rel fragments stay in registers for the whole key loop
// (Q_rel's tile is loaded into the strips' space). 96.8 KB of shared memory
// a block: two blocks an SM. What bounds bf16 K1 now: mma.sync fed by
// ldmatrix (52 ldmatrix.x4 and 104 mma a warp and key tile) at 8 warps an
// SM, plus the strip round trip; wgmma and TMA would be next.
//
// f32 K1 and K2 keep the first template (flash_attention_kernel), f32 FMA
// loops from shared memory: f32 is the parity dtype (the greedy f32 gate
// wants ids identical to the eager path, which TF32 products would spend).
// There one block owns a (batch*head, 64-query tile) pair and loops over
// 64-key tiles with an online softmax; the 256 threads form a 16x16 grid,
// each owning 4 query rows and 4 key columns of the score tile and 4 rows by
// dk/16 columns of the accumulator. The rel-pos tile is index arithmetic
// over the same span of BQ+BK-1 table rows (no barrel shifter and no
// block-aligned re-basing: those were Mosaic workarounds). The ragged edge
// (T not a multiple of 64) is masked in both kernels.

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

// bf16 K1 and K2 on the tensor cores (see the header)
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int DK = 64;
constexpr int BQ = 64;            // query rows a block: a warp each 16
constexpr int BK = 64;            // keys a tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = 32 * NWARPS;
static_assert(BQ % 16 == 0 && NTHREADS >= BK, "a warp owns 16 rows; a thread a key's validity");
constexpr int LDS = DK + 8;       // padded shared row (bf16): 144 bytes, 16-byte skew per row
static_assert(BK == DK, "one padded row length serves q, k, v, bias and table tiles");
constexpr float LOG2E = 1.4426950408889634f;
// rel-pos (MODE_RELPOS): table chunks of BK rows in a ring of NCH; a warp's
// window of WROWS span rows (79 needed) and its f32 strip of 16 x SLD
constexpr int NCH = 3;
constexpr int WROWS = 80;
constexpr int SLD = WROWS + 8;    // 8-byte stores of a half-warp in distinct banks
static_assert(BQ * LDS * sizeof(bf16) <= NWARPS * 16 * SLD * sizeof(float),
              "the Q_rel tile is staged in the strips' space");

constexpr size_t smem_bytes(int mode) {
  return (size_t(BQ) * LDS                                       // q tile, then the output staging
          + 2 * 2 * size_t(BK) * LDS                             // k, v: two stages
          + (mode == MODE_DENSE ? 2 * size_t(BQ) * LDS : 0)      // bias: two stages
          + (mode == MODE_RELPOS ? NCH * size_t(BK) * LDS : 0)) * sizeof(bf16)  // table ring
         + (mode == MODE_RELPOS ? size_t(NWARPS) * 16 * SLD * sizeof(float) : 0)  // strips
         + 2 * BK * sizeof(float);                               // key validity: two stages
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(avsr::smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(avsr::smem_addr(p)));
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows [row0, row0 + NROWS) of a (rows_total, 64) bf16 matrix into a padded
// shared tile by 16-byte copies; rows outside [0, rows_total) are zero-filled.
template <int NROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int rows_total) {
  for (int c = threadIdx.x; c < NROWS * (DK / 8); c += NTHREADS) {
    const int r = c / (DK / 8), p = c % (DK / 8), row = row0 + r;
    const bool ok = row >= 0 && row < rows_total;
    avsr::cp_async<16>(dst + r * LDS + p * 8, src + size_t(ok ? row : 0) * DK + p * 8, ok);
  }
}

// The (BQ, BK) bias tile at (q0, k0) of a (t_len, t_len) matrix, VEC
// elements a copy (t_len % VEC == 0, so a copy is all inside or all past
// the edge); past the edge zero-filled. VEC == 1 (odd t_len) copies by plain
// loads and stores.
template <int VEC>
__device__ __forceinline__ void load_bias(bf16* dst, const bf16* __restrict__ src, int q0, int k0,
                                          int t_len) {
  constexpr int PER_ROW = BK / VEC;
  for (int c = threadIdx.x; c < BQ * PER_ROW; c += NTHREADS) {
    const int r = c / PER_ROW, col = k0 + (c % PER_ROW) * VEC, row = q0 + r;
    const bool ok = row < t_len && col < t_len;
    bf16* d = dst + r * LDS + (c % PER_ROW) * VEC;
    const bf16* g = src + (ok ? size_t(row) * t_len + col : 0);
    if constexpr (VEC == 1) {
      *d = ok ? *g : __float2bfloat16(0.f);
    } else {
      avsr::cp_async<VEC * 2>(d, g, ok);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
    flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ bias,
                              const bf16* __restrict__ q_rel, const bf16* __restrict__ pos,
                              const unsigned char* __restrict__ mask, bf16* __restrict__ out,
                              int t_len, int heads, int bias_vec, float scale_log2) {
  constexpr float NEG = -1.0e30f;  // finite, as in the TPU kernel
  constexpr bool REL = MODE == MODE_RELPOS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_k = s_q + BQ * LDS;          // stage st at s_k + st * BK * LDS
  bf16* s_v = s_k + 2 * BK * LDS;
  bf16* s_b = s_v + 2 * BK * LDS;      // MODE_DENSE only
  bf16* s_pos = s_b + (MODE == MODE_DENSE ? 2 * BQ * LDS : 0);  // REL only: chunk c in slot c % NCH
  float* s_strip = reinterpret_cast<float*>(s_pos + (REL ? NCH * BK * LDS : 0));  // REL only
  float* s_valid = s_strip + (REL ? NWARPS * 16 * SLD : 0);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group and column pair
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const size_t head_off = size_t(bh) * t_len * DK;
  const bf16* bias_head = MODE == MODE_DENSE ? bias + size_t(bh) * t_len * t_len : nullptr;
  const int n_pos = 2 * t_len - 1;
  const bf16* pos_head = REL ? pos + size_t(bh - b * heads) * n_pos * DK : nullptr;
  const int table0 = t_len - q0 - BQ;  // REL: table row of chunk 0's first row
  const int n_tiles = (t_len + BK - 1) / BK;
  const bool active = q0 + 16 * warp < t_len;  // warp-uniform: some of its rows are real

  // REL: table chunk c (rows table0 + 64c ..) into its ring slot
  auto load_chunk = [&](int c) {
    load_rows<BK>(s_pos + (c % NCH) * BK * LDS, pos_head, table0 + c * BK, n_pos);
  };
  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * BK;
    load_rows<BK>(s_k + st * BK * LDS, k + head_off, k0, t_len);
    load_rows<BK>(s_v + st * BK * LDS, v + head_off, k0, t_len);
    if constexpr (MODE == MODE_DENSE) {
      bf16* d = s_b + st * BQ * LDS;
      switch (bias_vec) {
        case 8: load_bias<8>(d, bias_head, q0, k0, t_len); break;
        case 4: load_bias<4>(d, bias_head, q0, k0, t_len); break;
        case 2: load_bias<2>(d, bias_head, q0, k0, t_len); break;
        default: load_bias<1>(d, bias_head, q0, k0, t_len); break;
      }
    }
    if constexpr (REL) load_chunk(kt + 1);  // tile kt reads chunks kt and kt + 1
  };
  // key validity of tile kt for thread tid < BK; read a tile ahead, stored
  // to shared memory at the top of the tile's iteration
  auto key_valid = [&](int kt) {
    const int j = kt * BK + tid;
    return tid < BK && j < t_len && mask[size_t(b) * t_len + j] != 0;
  };

  uint32_t qf[DK / 16][4];      // this warp's 16 query rows as A fragments
  uint32_t qrf[DK / 16][4];     // REL: its 16 Q_rel rows
  float o[DK / 8][4];           // output accumulator: 8 n-tiles of 8 dims
  float m[2] = {NEG, NEG};      // running max (base-2 logits) of rows g, g + 8
  float l[2] = {0.f, 0.f};      // this thread's part of the running sums
#pragma unroll
  for (int n = 0; n < DK / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  load_rows<BQ>(s_q, q + head_off, q0, t_len);
  if constexpr (REL) {
    // Q and Q_rel first (Q_rel in the strips' space), then the first tile;
    // both fragments go to registers before any warp writes a strip (the
    // loop's first barrier)
    bf16* s_qr = reinterpret_cast<bf16*>(s_strip);
    load_rows<BQ>(s_qr, q_rel + head_off, q0, t_len);
    avsr::cp_async_commit();
    load_chunk(0);
    load_tile(0, 0);
    avsr::cp_async_commit();
    avsr::cp_async_wait<1>();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const int off = (16 * warp + (lane & 15)) * LDS + 16 * kk + (lane >> 4) * 8;
        ldmatrix_x4(qf[kk], s_q + off);
        ldmatrix_x4(qrf[kk], s_qr + off);
      }
    }
  } else {
    load_tile(0, 0);
    avsr::cp_async_commit();
  }
  bool valid_next = key_valid(0);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    if (tid < BK) s_valid[st * BK + tid] = valid_next ? 1.f : 0.f;
    if (kt + 1 < n_tiles) {
      load_tile(kt + 1, st ^ 1);
      avsr::cp_async_commit();
      valid_next = key_valid(kt + 1);
      avsr::cp_async_wait<1>();
    } else {
      avsr::cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      if (!REL && kt == 0) {
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          ldmatrix_x4(qf[kk], s_q + (16 * warp + (lane & 15)) * LDS + 16 * kk + (lane >> 4) * 8);
      }
      const bf16* sk = s_k + st * BK * LDS;
      const bf16* sv = s_v + st * BK * LDS;
      const int n_steps = min(BK, t_len - k0 + 15) / 16;  // 16-key steps with a real key
      float* strip = s_strip + warp * 16 * SLD;

      if constexpr (REL) {
        // R = Q_rel . W^T over the warp's window (span rows 48 - 16w + u,
        // u < 80, in chunks kt and kt + 1); n8 tile t of R holds window rows
        // 8t.. 8t+7, and keys of 16-key step s read tiles up to 2s + 3
        float r[WROWS / 8][4];
#pragma unroll
        for (int t = 0; t < WROWS / 8; ++t) r[t][0] = r[t][1] = r[t][2] = r[t][3] = 0.f;
#pragma unroll
        for (int p = 0; p < WROWS / 16; ++p) {
          if (p <= n_steps) {
            const int sr = 48 - 16 * warp + 16 * p + (lane & 7) + (lane >> 4) * 8;
            const bf16* row = s_pos + (((kt + (sr >> 6)) % NCH) * BK + (sr & (BK - 1))) * LDS +
                              ((lane >> 3) & 1) * 8;
#pragma unroll
            for (int kk = 0; kk < DK / 16; ++kk) {
              uint32_t wf[4];
              ldmatrix_x4(wf, row + 16 * kk);
              mma_bf16(r[2 * p], qrf[kk], wf[0], wf[1]);
              mma_bf16(r[2 * p + 1], qrf[kk], wf[2], wf[3]);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < WROWS / 8; ++t) {
          if (t / 2 <= n_steps) {
            *reinterpret_cast<float2*>(strip + g * SLD + 8 * t + 2 * tig) = make_float2(r[t][0], r[t][1]);
            *reinterpret_cast<float2*>(strip + (g + 8) * SLD + 8 * t + 2 * tig) =
                make_float2(r[t][2], r[t][3]);
          }
        }
        __syncwarp();
      }

      // S = Q . K^T: n-tile n holds keys 8n + 2 tig (+1) of rows g (s[n][0..1]) and g + 8 ([2..3])
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        if (ks < n_steps) {
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk) {
            uint32_t kf[4];  // keys 16ks.. +7 and +8.. +15, dims 16kk.. +7 and +8.. +15
            ldmatrix_x4(kf, sk + (16 * ks + (lane & 7) + (lane >> 4) * 8) * LDS + 16 * kk +
                                ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * ks], qf[kk], kf[0], kf[1]);
            mma_bf16(s[2 * ks + 1], qf[kk], kf[2], kf[3]);
          }
        }
      }

      // bias, scale (to base-2 logits), key mask, online softmax
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int c = 8 * n + 2 * tig;
        const float v0 = s_valid[st * BK + c], v1 = s_valid[st * BK + c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x0 = s[n][2 * h], x1 = s[n][2 * h + 1];
          if constexpr (MODE == MODE_DENSE) {
            const int r = 16 * warp + g + 8 * h;
            const float2 bv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(s_b + st * BQ * LDS + r * LDS + c));
            x0 += bv.x;
            x1 += bv.y;
          } else if constexpr (REL) {
            if (n < 2 * n_steps) {  // the strip holds the columns of real keys only
              const int lr = g + 8 * h;
              const float* e = strip + lr * SLD + 15 - lr + c;
              x0 += e[0];
              x1 += e[1];
            }
          }
          x0 = v0 != 0.f ? x0 * scale_log2 : NEG;
          x1 = v1 != 0.f ? x1 * scale_log2 : NEG;
          s[n][2 * h] = x0;
          s[n][2 * h + 1] = x1;
          mx[h] = fmaxf(mx[h], fmaxf(x0, x1));
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
#pragma unroll
      for (int n = 0; n < DK / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      // probabilities; a masked key is exactly 0 (its logit is NEG, and
      // while every key so far is masked the max is NEG too)
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[n][e] == NEG ? 0.f : exp2f(s[n][e] - m[e >> 1]);
          s[n][e] = p;
          l[e >> 1] += p;
        }
      }

      // O += P . V, P as bf16 A fragments straight from the score registers
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        if (ks < n_steps) {
          const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                                  pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                                  pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                                  pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
          for (int dp = 0; dp < DK / 16; ++dp) {
            uint32_t vf[4];  // keys 16ks.. +7 / +8.. +15 of dims 16dp.. +7, then of dims +8.. +15
            ldmatrix_x4_trans(vf, sv + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                      16 * dp + (lane >> 4) * 8);
            mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
            mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // every reader of stage st (and of the strips) is done before reuse
  }

  if (!active) return;
  // normalise (a row whose keys are all masked has l = 0 and gives 0), stage
  // the warp's rows as bf16 in its own rows of s_q, store 16 bytes a copy
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
  }
  bf16* stage = s_q + 16 * warp * LDS;
#pragma unroll
  for (int n = 0; n < DK / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    *reinterpret_cast<uint32_t*>(stage + g * LDS + c) = pack_bf16(o[n][0] * l[0], o[n][1] * l[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LDS + c) =
        pack_bf16(o[n][2] * l[1], o[n][3] * l[1]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * (DK / 8) / 32; ++it) {
    const int idx = lane + 32 * it, r = idx / (DK / 8), p = idx % (DK / 8);
    const int row = q0 + 16 * warp + r;
    if (row < t_len)
      *reinterpret_cast<uint4*>(out + head_off + size_t(row) * DK + p * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LDS + p * 8);
  }
}

template <int MODE>
cudaError_t launch(const AttnArgs& a) {
  constexpr size_t smem = smem_bytes(MODE);
  constexpr auto kernel = &flash_attention_tc_kernel<MODE>;
  const cudaError_t err = avsr::allow_dynamic_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  // widest bias copy that keeps every row start aligned
  const int t = a.t_len;
  const int bias_vec = t % 8 == 0 ? 8 : t % 4 == 0 ? 4 : t % 2 == 0 ? 2 : 1;
  const dim3 grid((t + BQ - 1) / BQ, a.batch * a.heads);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.bias), static_cast<const bf16*>(a.q_rel),
      static_cast<const bf16*>(a.pos), a.mask, static_cast<bf16*>(a.out), t, a.heads, bias_vec,
      float(LOG2E / sqrt(double(DK))));
  return cudaGetLastError();
}

}  // namespace tc

template <typename T, int DK, int MODE>
cudaError_t launch(const AttnArgs& a) {
  constexpr size_t smem = smem_floats<DK, MODE>() * sizeof(float);
  constexpr auto kernel = &flash_attention_kernel<T, DK, MODE>;
  const cudaError_t err = avsr::allow_dynamic_smem<kernel>(smem);
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

cudaError_t dispatch_bf16(int dk, int mode, const AttnArgs& a) {
  if (dk != tc::DK) return cudaErrorInvalidValue;
  if (mode == MODE_NONE) return tc::launch<MODE_NONE>(a);
  if (mode == MODE_DENSE) return tc::launch<MODE_DENSE>(a);
  if (mode == MODE_RELPOS) return tc::launch<MODE_RELPOS>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, q_rel, out: (B*H, T, dk) contiguous; bias: (B*H, T, T) for
// mode 1; pos: (H, 2T-1, dk) for mode 2; mask: (B, T) bytes, nonzero = valid
// key. Unused pointers may be null; in bf16 q, k, v, bias, q_rel, pos and
// out 16-byte aligned.
// Returns the launch's cudaError_t.
extern "C" int avsr_flash_attention(const void* q, const void* k, const void* v,
                                    const void* bias, const void* q_rel, const void* pos,
                                    const void* mask, void* out, int batch, int heads, int t_len,
                                    int dk, int is_bf16, int mode, void* stream) {
  const AttnArgs a{q,   k,    v,     bias,  q_rel, pos, static_cast<const unsigned char*>(mask),
                   out, batch, heads, t_len, static_cast<cudaStream_t>(stream)};
  return int(is_bf16 ? dispatch_bf16(dk, mode, a) : dispatch_dk<float>(dk, mode, a));
}
