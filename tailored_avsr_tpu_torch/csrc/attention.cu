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
// encoder's T = 100 the bias form is bound by its bytes (~9 MB in bf16,
// ~18 MB in f32); at T = 500 K1's bytes (31 MB in bf16) and products
// (9.2 GFLOP at B=24, H=4) bound bf16 about equally (~9 us each), while
// f32 K1, on the CUDA cores' 67 TFLOP/s, is bound by its products (0.138
// ms against 0.018 ms of bytes).
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
// f32 K1 and K2 (all three modes) run on the CUDA cores in exact IEEE f32
// (f32::flash_attention_f32_kernel): f32 is the parity dtype (the greedy
// f32 gate wants ids identical to the eager path, which TF32 products would
// spend), so every product and sum is an f32 FMA and no operand is rounded
// to TF32. One 256-thread block owns a (batch*head, 128-query tile); its 8
// warps are 4 row warps (32 query rows each) by 2 key halves (32 keys of
// every 64-key tile each). Each warp keeps its own online softmax over its
// half of the keys; at the end the two halves of a row warp merge through
// shared memory. Register blocking: a thread owns 8 consecutive rows x 4
// consecutive keys of the score tile and 8 rows x 8 dims of the output.
// Every tile stays row-major (64 floats a row) and is read along d as
// float4s, so a step of 4 dims costs 8 Q and 4 K reads of 16 bytes for 128
// FMAs; the 16-byte chunks of a row are XOR-swizzled by (row / 4) % 8, so
// the 8 lanes of a quarter warp read distinct banks or one broadcast
// address. The rel-pos term is Toeplitz: a thread's rows r0..r0+7 and keys
// c0..c0+3 need table rows T-1-i+j from only 11 consecutive span rows, so
// per 4 dims it adds 8 Q_rel and 11 table reads for another 128 FMAs into
// the same score registers. K, V, the bias and the table come in by
// cp.async (16 bytes; the f32 bias in 8 or 4 when T is not a multiple of
// 4), double-buffered: tile j+1 is in flight while tile j is multiplied.
// The table is a ring of four 64-row chunks, each fetched once: tile j
// reads span row 127 - r + c, chunks j..j+2, while chunk j+3 is in flight;
// rows outside [0, 2T-1) are zero-filled (they feed only masked keys or
// rows past T). P makes a warp-local trip through a 32 x 32 key-major strip
// (the owner of an output row and dim needs P over all 32 keys, which 8
// lanes hold): per key 2 P and 2 V float4 reads for 64 FMAs. Logits are
// base-2 (log2 e folded into the scale) and go through the SFU's ex2 with
// subnormal results flushed to 0. Row warps whose 32 rows lie past T and
// key halves past T skip their products, and P . V stops after the half's
// last real key (4 at a time): at T = 100 the products cover 128 x 128
// scores for Q . K^T and 128 x 100 for P . V; at T = 500, 512 x 512
// (1.05x). Shared memory a block: 224.5 KB in mode 2 (Q, Q_rel, two K and
// V stages, the table ring, strips), 192.5 KB in mode 1, 128.5 KB in mode
// 0: one block of 8 warps an SM; 250, 248 and 234 registers a thread, no
// spills (ptxas, sm_90a). What bounds it (cut-out timings, H100): the
// three product loops run at ~55-65 % of the FMA rate, held by their
// shared reads (the rel-pos term's 19 reads a 4-dim step make it cost
// ~1.4x Q . K^T) and the FMA issue slots they share with addresses and
// loads; around them, with one block an SM and two barriers a tile, the
// softmax and the first tile's loads of each wave do not overlap any
// product (~0.1 of K1's 0.31 ms at B=24 H=4 T=500), and at T = 100 those
// fixed costs are most of the time.

#include <math.h>

#include "common.cuh"

namespace {

enum { MODE_NONE = 0, MODE_DENSE = 1, MODE_RELPOS = 2 };

struct AttnArgs {
  const void *q, *k, *v, *bias, *q_rel, *pos;
  const unsigned char* mask;
  void* out;
  int batch, heads, t_len;
  cudaStream_t stream;
};

// f32 K1 and K2 on the CUDA cores, exact f32 (see the header)
namespace f32 {

constexpr int DK = 64;
constexpr int BQ = 128;            // query rows a block: 32 a row warp
constexpr int BK = 64;             // keys a tile: 32 a key half
constexpr int NWARPS = 8;          // 4 row warps x 2 key halves
constexpr int NTHREADS = 32 * NWARPS;
constexpr int CH = DK / 4;         // 16-byte chunks a row
constexpr int NSLOT = 4;           // MODE_RELPOS: 64-row table chunks in the ring
constexpr int STRIP = 32 * 32;     // a warp's P: 32 keys x 32 rows
constexpr float NEG = -1.0e30f;    // finite, as in the TPU kernel
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BQ == 4 * 32 && BK == 2 * 32 && NTHREADS >= BK && DK == 64,
              "the warp map assumes 4 row warps and 2 key halves of 32, and 64-float rows");

constexpr size_t smem_bytes(int mode) {
  return (size_t(BQ) * DK                                                         // q tile
          + (mode == MODE_RELPOS ? size_t(BQ) * DK + size_t(NSLOT) * BK * DK : 0)  // q_rel, table ring
          + 2 * 2 * size_t(BK) * DK                                               // k, v: two stages
          + (mode == MODE_DENSE ? 2 * size_t(BQ) * BK : 0)                        // bias: two stages
          + size_t(NWARPS) * STRIP                                                // P strips
          + 2 * BK) * sizeof(float);                                              // key validity: two stages
}

// Float offset of 16-byte chunk p of row r in a swizzled 64-float-row tile.
__device__ __forceinline__ int swz(int r, int p) { return r * DK + 4 * (p ^ ((r >> 2) & 7)); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// 2^x by the SFU's ex2 (exp2f's instruction), results below 2^-126 flushed
// to 0: a probability that small is below every row sum's last bit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc + a . b over 4 dims, in order
__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// Rows [row0, row0 + NROWS) of a (rows_total, 64) f32 matrix into a swizzled
// tile by 16-byte copies; rows outside [0, rows_total) are zero-filled.
template <int NROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int rows_total) {
  for (int c = threadIdx.x; c < NROWS * CH; c += NTHREADS) {
    const int r = c / CH, p = c % CH, row = row0 + r;
    const bool ok = row >= 0 && row < rows_total;
    avsr::cp_async<16>(dst + swz(r, p), src + size_t(ok ? row : 0) * DK + 4 * p, ok);
  }
}

// The (BQ, BK) bias tile at (q0, k0) of a (t_len, t_len) matrix, row-major,
// VEC floats a copy (t_len % VEC == 0, so a copy is all inside or all past
// the edge); past the edge zero-filled.
template <int VEC>
__device__ __forceinline__ void load_bias(float* dst, const float* __restrict__ src, int q0, int k0,
                                          int t_len) {
  constexpr int PER_ROW = BK / VEC;
  for (int c = threadIdx.x; c < BQ * PER_ROW; c += NTHREADS) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * VEC, row = q0 + r;
    const bool ok = row < t_len && k0 + col < t_len;
    avsr::cp_async<VEC * 4>(dst + r * BK + col, src + (ok ? size_t(row) * t_len + k0 + col : 0), ok);
  }
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ bias,
                               const float* __restrict__ q_rel, const float* __restrict__ pos,
                               const unsigned char* __restrict__ mask, float* __restrict__ out,
                               int t_len, int heads, int bias_vec, float scale_log2) {
  constexpr bool REL = MODE == MODE_RELPOS, DENSE = MODE == MODE_DENSE;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_qr = s_q + BQ * DK;                       // REL only
  float* s_pos = s_qr + (REL ? BQ * DK : 0);         // REL only: chunk c in slot c % NSLOT
  float* s_k = s_pos + (REL ? NSLOT * BK * DK : 0);  // stage st at s_k + st * BK * DK
  float* s_v = s_k + 2 * BK * DK;
  float* s_b = s_v + 2 * BK * DK;                    // DENSE only
  float* s_p = s_b + (DENSE ? 2 * BQ * BK : 0);      // warp w's strip at s_p + w * STRIP
  float* s_valid = s_p + NWARPS * STRIP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 3, kg = lane & 7;  // row group; key group (the dims group in P . V)
  const int r0 = 32 * (warp & 3) + 8 * rg;  // this thread's rows r0.. r0+7 of the tile
  const int c0 = 32 * (warp >> 2);          // this warp's key half: keys c0.. c0+31 of a tile
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, b = bh / heads;
  const size_t head_off = size_t(bh) * t_len * DK;
  const float* bias_head = DENSE ? bias + size_t(bh) * t_len * t_len : nullptr;
  const int n_pos = 2 * t_len - 1;
  const float* pos_head = REL ? pos + size_t(bh - b * heads) * n_pos * DK : nullptr;
  const int table0 = t_len - q0 - BQ;  // REL: table row of chunk 0's first row
  const int n_tiles = (t_len + BK - 1) / BK;
  const bool rows_real = q0 + 32 * (warp & 3) < t_len;  // warp-uniform: some of its rows are real

  auto load_chunk = [&](int c) {
    load_rows<BK>(s_pos + (c % NSLOT) * BK * DK, pos_head, table0 + c * BK, n_pos);
  };
  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * BK;
    load_rows<BK>(s_k + st * BK * DK, k + head_off, k0, t_len);
    load_rows<BK>(s_v + st * BK * DK, v + head_off, k0, t_len);
    if constexpr (DENSE) {
      float* d = s_b + st * BQ * BK;
      switch (bias_vec) {
        case 4: load_bias<4>(d, bias_head, q0, k0, t_len); break;
        case 2: load_bias<2>(d, bias_head, q0, k0, t_len); break;
        default: load_bias<1>(d, bias_head, q0, k0, t_len); break;
      }
    }
    if constexpr (REL) load_chunk(kt + 2);  // tile kt reads chunks kt.. kt + 2
  };
  // key validity of tile kt for thread tid < BK; read a tile ahead, stored
  // to shared memory at the top of the tile's iteration
  auto key_valid = [&](int kt) {
    const int j = kt * BK + tid;
    return tid < BK && j < t_len && mask[size_t(b) * t_len + j] != 0;
  };

  load_rows<BQ>(s_q, q + head_off, q0, t_len);
  if constexpr (REL) {
    load_rows<BQ>(s_qr, q_rel + head_off, q0, t_len);
    load_chunk(0);
    load_chunk(1);
  }
  load_tile(0, 0);
  avsr::cp_async_commit();
  bool valid_next = key_valid(0);

  float o[8][8];  // output rows r0 + a, dims 4 kg.. +3 and 32 + 4 kg.. +3
  float m[8], l[8];  // running max (base-2 logits) of rows r0 + a; this thread's part of the sums
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d) o[a][d] = 0.f;
  }
  // swizzle keys of rows r0.. r0+3 and r0+4.. r0+7 (r0 is a multiple of 8)
  const int qkey0 = (r0 >> 2) & 7, qkey1 = qkey0 ^ 1;

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

    if (rows_real && k0 + c0 < t_len) {
      // S = Q . K^T (+ the rel-pos term) for rows r0 + a, keys c0 + 4 kg + e
      // (key rows c0 + 4 kg.. +3 share swizzle key kg: c0 / 4 is 0 or 8)
      const float* qrow = s_q + r0 * DK;
      const float* krow = s_k + st * BK * DK + (c0 + 4 * kg) * DK;
      // REL: pair (a, e) reads span row u0 + 7 - a + e; the 12 rows from u0
      // (a multiple of 4) are three groups of 4 in one chunk each
      const int u0 = BQ - 8 - r0 + c0 + 4 * kg;
      const float* trow[3];
      int tkey[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const int u = u0 + 4 * g;
        trow[g] = s_pos + ((kt + (u >> 6)) % NSLOT) * BK * DK + (u & (BK - 1)) * DK;
        tkey[g] = (u >> 2) & 7;
      }
      float s[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a) s[a][0] = s[a][1] = s[a][2] = s[a][3] = 0.f;
#pragma unroll 2
      for (int p = 0; p < CH; ++p) {
        float4 qa[8], kc[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) qa[a] = ld4(qrow + a * DK + 4 * (p ^ (a < 4 ? qkey0 : qkey1)));
#pragma unroll
        for (int e = 0; e < 4; ++e) kc[e] = ld4(krow + e * DK + 4 * (p ^ kg));
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[a][e] = dot4(s[a][e], qa[a], kc[e]);
        if constexpr (REL) {
#pragma unroll
          for (int a = 0; a < 8; ++a)
            qa[a] = ld4(s_qr + r0 * DK + a * DK + 4 * (p ^ (a < 4 ? qkey0 : qkey1)));
#pragma unroll
          for (int mm = 0; mm < 11; ++mm) {
            const float4 w = ld4(trow[mm >> 2] + (mm & 3) * DK + 4 * (p ^ tkey[mm >> 2]));
#pragma unroll
            for (int a = 0; a < 8; ++a) {
              const int e = mm + a - 7;
              if (e >= 0 && e < 4) s[a][e] = dot4(s[a][e], qa[a], w);
            }
          }
        }
      }

      // bias, scale (to base-2 logits), key mask, online softmax over the
      // half; the 8 lanes of a row group hold a row's 32 keys
      const float4 vk = ld4(s_valid + st * BK + c0 + 4 * kg);
      const float valid[4] = {vk.x, vk.y, vk.z, vk.w};
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        float add[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (DENSE) {
          const float4 bv = ld4(s_b + st * BQ * BK + (r0 + a) * BK + c0 + 4 * kg);
          add[0] = bv.x;
          add[1] = bv.y;
          add[2] = bv.z;
          add[3] = bv.w;
        }
        float mx = m[a];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[a][e] = valid[e] != 0.f ? (s[a][e] + add[e]) * scale_log2 : NEG;
          mx = fmaxf(mx, s[a][e]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float corr = ex2(m[a] - mx);
        m[a] = mx;
        l[a] *= corr;
#pragma unroll
        for (int d = 0; d < 8; ++d) o[a][d] *= corr;
        // a masked key is exactly 0 (its logit is NEG, and while every key
        // so far is masked the max is NEG too)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[a][e] = s[a][e] == NEG ? 0.f : ex2(s[a][e] - mx);
          l[a] += s[a][e];
        }
      }

      // P into the warp's strip: key row 4 kg + e (swizzle key kg), rows r0.. in chunks 2 rg, 2 rg + 1
      float* strip = s_p + warp * STRIP;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* row = strip + (4 * kg + e) * 32;
        *reinterpret_cast<float4*>(row + 4 * ((2 * rg) ^ kg)) = make_float4(s[0][e], s[1][e], s[2][e], s[3][e]);
        *reinterpret_cast<float4*>(row + 4 * ((2 * rg + 1) ^ kg)) =
            make_float4(s[4][e], s[5][e], s[6][e], s[7][e]);
      }
      __syncwarp();

      // O += P . V over the half's real keys, 4 at a time (P is 0 past them
      // and V's rows there are zero-filled); key j's strip row and V row
      // c0 + j share swizzle key j / 4
      const float* vrow = s_v + st * BK * DK + c0 * DK;
      const int n4 = (min(32, t_len - k0 - c0) + 3) >> 2;
      for (int j4 = 0; j4 < n4; ++j4) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * j4 + jj;
          const float4 p0 = ld4(strip + j * 32 + 4 * ((2 * rg) ^ j4));
          const float4 p1 = ld4(strip + j * 32 + 4 * ((2 * rg + 1) ^ j4));
          const float4 v0 = ld4(vrow + j * DK + 4 * (kg ^ j4));
          const float4 v1 = ld4(vrow + j * DK + 4 * ((8 + kg) ^ j4));
          const float pa[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            o[a][0] = fmaf(pa[a], v0.x, o[a][0]);
            o[a][1] = fmaf(pa[a], v0.y, o[a][1]);
            o[a][2] = fmaf(pa[a], v0.z, o[a][2]);
            o[a][3] = fmaf(pa[a], v0.w, o[a][3]);
            o[a][4] = fmaf(pa[a], v1.x, o[a][4]);
            o[a][5] = fmaf(pa[a], v1.y, o[a][5]);
            o[a][6] = fmaf(pa[a], v1.z, o[a][6]);
            o[a][7] = fmaf(pa[a], v1.w, o[a][7]);
          }
        }
      }
    }
    __syncthreads();  // every reader of stage st (and of the ring's chunk kt) is done before reuse
  }

  // the two key halves of a row warp merge: half 1 hands its (m, l, O) to
  // half 0 through the k stages (free after the last barrier); a row whose
  // keys are all masked has l = 0 in both and gives exactly 0
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 1);
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 2);
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 4);
  }
  float* x_o = s_k;   // (BQ, DK) row-major
  float* x_ml = s_v;  // m of row r at [r], l at [BQ + r]
  if (c0 != 0 && rows_real) {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float* row = x_o + (r0 + a) * DK;
      *reinterpret_cast<float4*>(row + 4 * kg) = make_float4(o[a][0], o[a][1], o[a][2], o[a][3]);
      *reinterpret_cast<float4*>(row + 32 + 4 * kg) = make_float4(o[a][4], o[a][5], o[a][6], o[a][7]);
      if (kg == 0) {
        x_ml[r0 + a] = m[a];
        x_ml[BQ + r0 + a] = l[a];
      }
    }
  }
  __syncthreads();
  if (c0 != 0 || !rows_real) return;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = q0 + r0 + a;
    if (i >= t_len) continue;
    const float m1 = x_ml[r0 + a], l1 = x_ml[BQ + r0 + a], mn = fmaxf(m[a], m1);
    const float f0 = ex2(m[a] - mn), f1 = ex2(m1 - mn), lt = l[a] * f0 + l1 * f1;
    const float* row = x_o + (r0 + a) * DK;
    const float4 h0 = ld4(row + 4 * kg), h1 = ld4(row + 32 + 4 * kg);
    const float x[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    float y[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) y[d] = lt > 0.f ? fmaf(o[a][d], f0, x[d] * f1) / lt : 0.f;
    float* dst = out + head_off + size_t(i) * DK;
    *reinterpret_cast<float4*>(dst + 4 * kg) = make_float4(y[0], y[1], y[2], y[3]);
    *reinterpret_cast<float4*>(dst + 32 + 4 * kg) = make_float4(y[4], y[5], y[6], y[7]);
  }
}

template <int MODE>
cudaError_t launch(const AttnArgs& a) {
  constexpr size_t smem = smem_bytes(MODE);
  constexpr auto kernel = &flash_attention_f32_kernel<MODE>;
  const cudaError_t err = avsr::allow_dynamic_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  // widest bias copy that keeps every row start aligned
  const int t = a.t_len;
  const int bias_vec = t % 4 == 0 ? 4 : t % 2 == 0 ? 2 : 1;
  const dim3 grid((t + BQ - 1) / BQ, a.batch * a.heads);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.bias), static_cast<const float*>(a.q_rel),
      static_cast<const float*>(a.pos), a.mask, static_cast<float*>(a.out), t, a.heads, bias_vec,
      float(LOG2E / sqrt(double(DK))));
  return cudaGetLastError();
}

}  // namespace f32

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

using avsr::ldmatrix_x4;
using avsr::ldmatrix_x4_trans;
using avsr::mma_bf16;
using avsr::pack_bf16;

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

cudaError_t dispatch_f32(int dk, int mode, const AttnArgs& a) {
  if (dk != f32::DK) return cudaErrorInvalidValue;
  if (mode == MODE_NONE) return f32::launch<MODE_NONE>(a);
  if (mode == MODE_DENSE) return f32::launch<MODE_DENSE>(a);
  if (mode == MODE_RELPOS) return f32::launch<MODE_RELPOS>(a);
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
// key. Unused pointers may be null; q, k, v, bias, q_rel, pos and out
// 16-byte aligned (both types copy 16 bytes at a time). dk = 64, the head
// size of every config in the repository.
// Returns the launch's cudaError_t.
extern "C" int avsr_flash_attention(const void* q, const void* k, const void* v,
                                    const void* bias, const void* q_rel, const void* pos,
                                    const void* mask, void* out, int batch, int heads, int t_len,
                                    int dk, int is_bf16, int mode, void* stream) {
  const AttnArgs a{q,   k,    v,     bias,  q_rel, pos, static_cast<const unsigned char*>(mask),
                   out, batch, heads, t_len, static_cast<cudaStream_t>(stream)};
  return int(is_bf16 ? dispatch_bf16(dk, mode, a) : dispatch_f32(dk, mode, a));
}
