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
// and V that some query's ancestry names once and does 2 * dk multiply-adds
// per (query, row), far below the card's operations-per-byte line; the
// flagship LM's bf16 cache is 34 MB per leaf at batch 32, beam 10, Lc 104,
// its int8 payload half that, plus 4 bytes of scale per 64-byte row. At
// these sizes a launch is short, so what sets its time is how many memory
// round trips each block waits for in a row.
//
// Design: the TPU kernel multiplies each query densely against all K * Lc
// columns of its group and masks K - 1 of every K, because the MXU wants
// dense tiles. Exactly one slot j is live per (query, column), so here each
// query gathers instead, and every masked column of the dense form
// contributes exactly 0: the two differ only in the order of the sums.
// One block serves all K queries of a group (b, h) over a range of its live
// columns (the host splits the columns over `split` blocks only when the
// group's ancestry does not fit one block's shared memory). The block reads its queries and the
// ancestry of its columns once, marks which cache rows (j, t) some query
// names, and then streams the named rows in chunks of `chunk` (<= 32)
// columns, K rows chunk by chunk and then V rows, through a ring of four
// buffers: each chunk's rows are 16-byte cp.async copies issued all at
// once, a row named by several queries is copied once (K6's scale beside
// it), neighbouring threads copy neighbouring bytes, and up to three chunks
// are in flight while one is consumed. A block thus waits about one memory
// round trip per ring, not one per gathered row, and an int8 row (64 bytes
// = 4 copies) costs half a bf16 row's copies; int8 is widened to f32 by
// byte permutes, not by the quarter-rate integer conversion. Each warp owns
// queries (one at beam 10): in a K chunk four lanes a column score its row
// against the query from shared memory; after the last K chunk the warp
// takes the exact max, the weights and their sum; in a V chunk each group
// of 8 lanes adds every fourth column into 8 output dims a lane. The logits
// wait in shared memory for the exact max, which an online softmax would
// not need: it keeps the f32 arithmetic and the order of every sum of the
// first design (one block per query, see the note in the kernel), and so
// the beam's results. With one block a
// group the output is written at once; otherwise each block writes its
// (max, sum, accumulator) triple per query and a second small kernel
// combines the triples in a fixed order (deterministic, no atomics). An anc
// entry outside [0, K) matches nothing, as in the TPU kernel. K6 is the
// same template with an int8 element type and the two scale pointers set
// (null for K4): the key scale multiplies the column's logit and the value
// scale its weight in the accumulator (not in the sum).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using avsr::store;
using avsr::to_f32;

constexpr int DK = 64;
constexpr int MAX_WARPS = 10;               // a block: 32 * min(beam, 10) threads, a warp per query
constexpr int MAX_BEAM = 64;
constexpr int RING = 4;                     // chunk buffers: up to 3 chunks in flight
constexpr int VWARPS = 4;                   // the reduction order's virtual warps (see below)
constexpr int SMEM_LIMIT = 232448;          // the most shared memory a block may take
constexpr float NEG = -1.0e30f;             // below any block's max: the combine's start
constexpr int PARTIAL = DK + 2;             // a (max, sum, accumulator) triple: acc, m, l

template <typename C>
__host__ __device__ constexpr int row_stride() {  // bytes a shared row: 16-byte skew per row
  return DK * int(sizeof(C)) + 16;
}

// Shared layout of one block (bytes): a ring of RING chunk buffers of
// cache rows (K or V), one slot per (j, column of the chunk); the queries
// in f32; K6's scales beside each buffer; the logits, then weights, of the
// block's columns; the value accumulators of the VWARPS orders; per query
// (max, sum, own-column weight); the ancestry of the block's columns; a
// byte per (j, column): some query names the row.
template <typename C>
size_t smem_bytes(int beam, int chunk, int per) {
  const size_t slots = size_t(beam) * chunk;
  constexpr bool QUANT = std::is_same<C, int8_t>::value;
  return RING * slots * row_stride<C>() + size_t(beam) * DK * sizeof(float) +
         (QUANT ? RING * slots * sizeof(float) : 0) + size_t(beam) * per * sizeof(float) +
         size_t(beam) * VWARPS * DK * sizeof(float) + size_t(beam) * 3 * sizeof(float) +
         size_t(beam) * per * (sizeof(int) + 1);
}

// 8 elements from shared memory as f32
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

// int8 -> f32 without the quarter-rate I2F: byte k of x (offset by 0x80)
// becomes the low byte of 2^23 + byte, exact in f32, minus 2^23 + 128
__device__ __forceinline__ float s8_to_f32(uint32_t biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u + k)) - 8388736.f;
}

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t a = u.x ^ 0x80808080u, b = u.y ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[e] = s8_to_f32(a, e);
    x[4 + e] = s8_to_f32(b, e);
  }
}

// C: the cache's element type (T for K4, int8_t for K6); T: q, k_new, v_new, out.
// k_scale, v_scale: (B, H, K, Lc) f32 column scales for K6, null for K4.
// Block x = group * split + s serves columns [s * per, min(n_live, (s + 1) * per)).
template <typename C, typename T>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2)  // <= 96 registers: two blocks an SM at beam 10
    group_attend_kernel(const C* __restrict__ k, const float* __restrict__ k_scale,
                        const C* __restrict__ v, const float* __restrict__ v_scale,
                        const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, const int* __restrict__ anc,
                        T* __restrict__ out, float* __restrict__ partial, int heads, int beam,
                        int lc, int n_live, int chunk, int per, int split, float scale) {
  constexpr bool QUANT = std::is_same<C, int8_t>::value;
  constexpr int RS = row_stride<C>();
  constexpr int PIECES = DK * int(sizeof(C)) / 16;  // 16-byte copies a row
  constexpr int PIECE_ELEMS = 16 / int(sizeof(C));

  const int slots = beam * chunk;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_rows = smem;                                   // [RING][slot][RS]
  float* s_q = reinterpret_cast<float*>(smem + size_t(RING) * slots * RS);  // [beam][DK]
  float* s_scale = s_q + beam * DK;                               // [RING][slot], K6 only
  float* s_logit = s_scale + (QUANT ? RING * slots : 0);          // [beam][per]
  float* s_acc = s_logit + beam * per;                            // [beam][VWARPS][DK]
  float* s_stat = s_acc + beam * VWARPS * DK;                     // [beam][max, sum, own weight]
  int* s_anc = reinterpret_cast<int*>(s_stat + 3 * beam);         // [beam][per]
  unsigned char* s_need = reinterpret_cast<unsigned char*>(s_anc + beam * per);  // [beam][per]

  const int group = blockIdx.x / split, part = blockIdx.x - group * split;
  const int b = group / heads;
  const int c_begin = part * per;
  const int ncols = max(0, min(n_live, c_begin + per) - c_begin);
  const int nchunks = (ncols + chunk - 1) / chunk;
  const int jobs = 2 * nchunks;  // K chunks 0 .. n-1, then V chunks 0 .. n-1
  const size_t group_off = size_t(group) * beam * lc * DK;
  const size_t scale_off = size_t(group) * beam * lc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int cshift = 31 - __clz(chunk);  // chunk is a power of two

  // the step's own column for the warp's first query, read ahead (used
  // after the K chunks and at the end)
  const size_t own = (size_t(group) * beam + warp) * DK;
  const T kn_lo = k_new[own + lane], kn_hi = k_new[own + lane + 32];
  const T vn_lo = v_new[own + 2 * lane], vn_hi = v_new[own + 2 * lane + 1];

  // the queries, the ancestry of the block's columns, which rows (j, t) some
  // query names (each is then copied once), zeroed value accumulators; each
  // thread issues its loads of q and anc before it stores any (one memory
  // round trip at beam 10)
  const int nq = beam * DK, na = beam * per;
  for (int x0 = tid; x0 < max(nq, na); x0 += 2 * blockDim.x) {
    T qx[2];
    int ax[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int x = x0 + u * blockDim.x, i = x / per, c = x - i * per;
      if (x < nq) qx[u] = q[size_t(group) * beam * DK + x];
      ax[u] = x < na && c < ncols ? anc[(size_t(b) * beam + i) * lc + c_begin + c] : -1;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int x = x0 + u * blockDim.x;
      if (x < nq) s_q[x] = to_f32(qx[u]);
      if (x < na) {
        s_anc[x] = ax[u];
        s_need[x] = 0;
      }
    }
  }
  for (int x = tid; x < beam * VWARPS * DK; x += blockDim.x) s_acc[x] = 0.f;
  __syncthreads();
  for (int x = tid; x < beam * ncols; x += blockDim.x) {
    const int i = x / ncols, c = x - i * ncols, j = s_anc[i * per + c];
    if (j >= 0 && j < beam) s_need[j * per + c] = 1;
  }
  __syncthreads();

  auto row_ptr = [&](int buf, int slot) {
    return reinterpret_cast<const C*>(s_rows + (size_t(buf) * slots + slot) * RS);
  };
  // job g's named rows (K for g < nchunks, else V) -> buffer g % RING, slot
  // j * chunk + (t - t0), 16 bytes a thread; neighbouring threads copy
  // neighbouring pieces of rows (j, t), (j, t + 1)
  auto issue = [&](int g) {
    const bool is_k = g < nchunks;
    const int buf = g % RING, c0 = (is_k ? g : g - nchunks) * chunk, nc = min(chunk, ncols - c0);
    const C* src_base = is_k ? k : v;
    for (int x = tid; x < slots * PIECES; x += blockDim.x) {
      const int slot = x / PIECES, p = x - slot * PIECES;
      const int j = slot >> cshift, tc = slot - (j << cshift);
      if (tc >= nc || !s_need[j * per + c0 + tc]) continue;
      const size_t row = size_t(j) * lc + c_begin + c0 + tc;
      avsr::cp_async<16>(s_rows + (size_t(buf) * slots + slot) * RS + 16 * p,
                         src_base + group_off + row * DK + p * PIECE_ELEMS, true);
      if constexpr (QUANT) {
        if (p == 0)
          avsr::cp_async<4>(s_scale + buf * slots + slot, (is_k ? k_scale : v_scale) + scale_off + row,
                            true);
      }
    }
  };

  // The arithmetic, and the order of every sum, is that of a block of 4
  // warps (VWARPS) serving one query: the dot of 64 dims as 8 partial dots
  // of 8 dims added as a butterfly over 8 lanes; the exact max; the sum of
  // the weights taken by 128 virtual threads (column t to thread t mod 128),
  // each virtual warp's butterfly, then the virtual warps in order after the
  // step's own column; each output dim summed by virtual warp t mod 4 in
  // increasing t, then over the virtual warps in order. So f32 results do
  // not depend on the chunk or the ring, and a beam's int8 roundings (which
  // amplify any f32 difference) see one fixed arithmetic.

  // K job: logits of query i, 8 columns a pass, 4 lanes a column; lane h
  // of a column adds the partial dots of dims 8h .. 8h + 7 and 8h + 32 ..
  // 8h + 39, and two shuffles finish the 8-lane butterfly's sum
  auto score = [&](int buf, int c0, int nc) {
    const int h = lane & 3, col = lane >> 2;
    for (int i = warp; i < beam; i += nwarps) {
      const float* qv = s_q + i * DK;
      for (int t0 = 0; t0 < nc; t0 += 8) {
        const int tc = t0 + col;
        const int j = tc < nc ? s_anc[i * per + c0 + tc] : -1;
        const bool live = j >= 0 && j < beam;
        const int slot = live ? (j << cshift) + tc : 0;
        float v = 0.f;
        if (live) {
          const C* row = row_ptr(buf, slot);
          float d[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int sub = h + 4 * u;
            float x[8];
            load8(row + sub * 8, x);
            d[u] = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) d[u] = fmaf(qv[sub * 8 + e], x[e], d[u]);
          }
          v = d[0] + d[1];
        }
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if (h == 0 && tc < nc) {
          float col_scale = scale;
          if constexpr (QUANT) {
            if (live) col_scale = s_scale[buf * slots + slot] * scale;
          }
          s_logit[i * per + c0 + tc] = live ? v * col_scale : -INFINITY;
        }
      }
    }
  };

  // after the last K job: per query the max (own column included in the
  // first range), the weights in place of the logits, and their sum
  auto softmax = [&]() {
    for (int i = warp; i < beam; i += nwarps) {
      const size_t off = (size_t(group) * beam + i) * DK;
      float s_new = -INFINITY;
      if (part == 0) {
        const float* qv = s_q + i * DK;
        T k_lo = kn_lo, k_hi = kn_hi;
        if (i != warp) {
          k_lo = k_new[off + lane];
          k_hi = k_new[off + lane + 32];
        }
        s_new = avsr::warp_sum(qv[lane] * to_f32(k_lo) + qv[lane + 32] * to_f32(k_hi)) * scale;
      }
      float* lg = s_logit + i * per;
      float mx = s_new;
      for (int t = lane; t < ncols; t += 32) mx = fmaxf(mx, lg[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      __syncwarp();
      float sums[VWARPS];  // virtual warp w: threads 32 w + lane, columns t = 32 w + lane + 128 n
#pragma unroll
      for (int w = 0; w < VWARPS; ++w) {
        float sum = 0.f;
        for (int t = 32 * w + lane; t < ncols; t += 32 * VWARPS) {
          const float p = mx == -INFINITY ? 0.f : expf(lg[t] - mx);  // exp(-inf) = 0: a dead column
          sum += p;
          lg[t] = p;
        }
        sums[w] = avsr::warp_sum(sum);
      }
      const float p_new = part == 0 ? expf(s_new - mx) : 0.f;
      float l = p_new;
#pragma unroll
      for (int w = 0; w < VWARPS; ++w) l += sums[w];
      if (lane == 0) {
        s_stat[3 * i] = mx;
        s_stat[3 * i + 1] = l;
        s_stat[3 * i + 2] = p_new;
      }
    }
  };

  // V job: the lanes of group cg = lane / 8 keep the accumulator of
  // virtual warp cg (columns t = cg mod 4) for dims 8 dg .. 8 dg + 7, dg =
  // lane mod 8; K6 weighs the column by its value scale
  auto accumulate = [&](int buf, int c0, int nc) {
    const int cg = lane >> 3, dg = lane & 7;
    for (int i = warp; i < beam; i += nwarps) {
      float* acc = s_acc + (i * VWARPS + cg) * DK + 8 * dg;
      float a[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = acc[e];
      const float* wt = s_logit + i * per + c0;
      const int* ai = s_anc + i * per + c0;
#pragma unroll 2
      for (int t = (cg - c0) & 3; t < nc; t += 4) {
        float p = wt[t];
        if (p != 0.f) {  // a column no slot matches has weight 0 exactly
          const int slot = (ai[t] << cshift) + t;
          if constexpr (QUANT) p *= s_scale[buf * slots + slot];
          float x[8];
          load8(row_ptr(buf, slot) + 8 * dg, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) a[e] = fmaf(p, x[e], a[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = a[e];
    }
  };

  for (int g = 0; g < RING - 1; ++g) {
    if (g < jobs) issue(g);
    avsr::cp_async_commit();
  }
  for (int g = 0; g < jobs; ++g) {
    if (g + RING - 1 < jobs) issue(g + RING - 1);
    avsr::cp_async_commit();
    avsr::cp_async_wait<RING - 1>();  // job g's copies have landed
    __syncthreads();
    if (g < nchunks) {
      score(g % RING, g * chunk, min(chunk, ncols - g * chunk));
    } else {
      if (g == nchunks) {
        softmax();
        __syncwarp();  // the warp's weights, written lane by lane, are read by every lane
      }
      const int c0 = (g - nchunks) * chunk;
      accumulate(g % RING, c0, min(chunk, ncols - c0));
    }
    __syncthreads();  // every reader of buffer g % RING is done before it is refilled
  }
  if (jobs == 0) {
    softmax();
    __syncwarp();
  }

  for (int i = warp; i < beam; i += nwarps) {
    const size_t off = (size_t(group) * beam + i) * DK;
    const float* acc = s_acc + i * VWARPS * DK;
    const float mx = s_stat[3 * i], l = s_stat[3 * i + 1], p_new = s_stat[3 * i + 2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 2 * lane + h;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < VWARPS; ++w) a += acc[w * DK + d];
      const float vn = to_f32(i == warp ? (h == 0 ? vn_lo : vn_hi) : v_new[off + d]);
      if (split == 1) {
        store(&out[off + d], (a + p_new * vn) / l);
      } else {
        float* pp = partial + ((size_t(group) * split + part) * beam + i) * PARTIAL;
        pp[d] = part == 0 ? a + p_new * vn : a;
        if (d == 0) {
          pp[DK] = mx;
          pp[DK + 1] = l;
        }
      }
    }
  }
}

// One warp per (group, query): out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,
// over the split blocks' triples in order s = 0, 1, ... (the first holds the
// step's own column, so M is finite and the sum positive).
template <typename T>
__global__ void __launch_bounds__(256)
    group_attend_combine_kernel(const float* __restrict__ partial, T* __restrict__ out,
                                int queries, int beam, int split) {
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (w >= queries) return;
  const int group = w / beam, i = w - group * beam;
  const float* pp = partial + (size_t(group) * split * beam + i) * PARTIAL;
  const size_t stride = size_t(beam) * PARTIAL;  // from one block's triple to the next
  float mx = NEG;
  for (int s = 0; s < split; ++s) mx = fmaxf(mx, pp[s * stride + DK]);
  float2 a = make_float2(0.f, 0.f);
  float lsum = 0.f;
  for (int s = 0; s < split; ++s) {
    const float* t = pp + s * stride;
    const float f = expf(t[DK] - mx);
    lsum += f * t[DK + 1];
    a.x = fmaf(f, t[2 * lane], a.x);
    a.y = fmaf(f, t[2 * lane + 1], a.y);
  }
  store(&out[size_t(w) * DK + 2 * lane], a.x / lsum);
  store(&out[size_t(w) * DK + 2 * lane + 1], a.y / lsum);
}

struct GroupArgs {
  const void *k, *v, *q, *k_new, *v_new;
  const float *k_scale, *v_scale;
  const int* anc;
  void* out;
  float* partial;
  int groups, heads, beam, lc, n_live, chunk, per, split;
  cudaStream_t stream;
};

template <typename C, typename T>
cudaError_t launch(const GroupArgs& a) {
  if (a.beam < 1 || a.beam > MAX_BEAM || a.chunk < 1 || a.chunk > 32 || (a.chunk & (a.chunk - 1)) ||
      a.per < a.chunk || a.per % a.chunk ||
      a.split < 1 || (a.split > 1 && a.partial == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<C>(a.beam, a.chunk, a.per);
  if (smem > size_t(SMEM_LIMIT)) return cudaErrorInvalidValue;
  constexpr auto kernel = &group_attend_kernel<C, T>;
  cudaError_t err = avsr::allow_dynamic_smem<kernel>(SMEM_LIMIT);
  if (err != cudaSuccess) return err;
  const int threads = 32 * (a.beam < MAX_WARPS ? a.beam : MAX_WARPS);
  kernel<<<a.groups * a.split, threads, smem, a.stream>>>(
      static_cast<const C*>(a.k), a.k_scale, static_cast<const C*>(a.v), a.v_scale,
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_new), static_cast<const T*>(a.v_new),
      a.anc, static_cast<T*>(a.out), a.partial, a.heads, a.beam, a.lc, a.n_live, a.chunk, a.per,
      a.split, float(1.0 / sqrt(double(DK))));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.split == 1) return err;
  const int queries = a.groups * a.beam;
  group_attend_combine_kernel<T><<<(queries + 7) / 8, 256, 0, a.stream>>>(
      a.partial, static_cast<T*>(a.out), queries, a.beam, a.split);
  return cudaGetLastError();
}

}  // namespace

// K4. k, v: (B*H, K, Lc, 64) contiguous; q, k_new, v_new, out: (B*H, K, 64),
// all of one type; anc: (B, K, Lc) int32; groups = B*H. Columns t < n_live
// are read, in `split` blocks a group of `per` columns each (a multiple of
// `chunk`, the columns of one double-buffered copy); with split > 1,
// partial is (groups, split, K, 66) f32 scratch. Returns the first failed
// launch's cudaError_t.
extern "C" int avsr_group_attend(const void* k, const void* v, const void* q, const void* k_new,
                                 const void* v_new, const void* anc, void* out, void* partial,
                                 int groups, int heads, int beam, int lc, int n_live, int chunk,
                                 int per, int split, int is_bf16, void* stream) {
  const GroupArgs a{k, v, q, k_new, v_new, nullptr, nullptr, static_cast<const int*>(anc), out,
                    static_cast<float*>(partial), groups, heads, beam, lc, n_live, chunk, per,
                    split, static_cast<cudaStream_t>(stream)};
  return int(is_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a) : launch<float, float>(a));
}

// K6. k, v: (B*H, K, Lc, 64) int8 contiguous; k_scale, v_scale: (B*H, K, Lc)
// f32; q, k_new, v_new, out: (B*H, K, 64) f32 or bf16 (is_bf16); the rest as
// K4. Returns the first failed launch's cudaError_t.
extern "C" int avsr_group_attend_q(const void* k, const void* k_scale, const void* v,
                                   const void* v_scale, const void* q, const void* k_new,
                                   const void* v_new, const void* anc, void* out, void* partial,
                                   int groups, int heads, int beam, int lc, int n_live, int chunk,
                                   int per, int split, int is_bf16, void* stream) {
  const GroupArgs a{k, v, q, k_new, v_new, static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale), static_cast<const int*>(anc), out,
                    static_cast<float*>(partial), groups, heads, beam, lc, n_live, chunk, per,
                    split, static_cast<cudaStream_t>(stream)};
  return int(is_bf16 ? launch<int8_t, __nv_bfloat16>(a) : launch<int8_t, float>(a));
}
