// Fused Convolutional Spatial Gating Unit: the cgMLP gate, forward only.
//
// Replaces tailored_avsr_tpu/ops/fused_csgu.py:_csgu_kernel (fused_csgu).
// x = [x_r | x_g] is (B, T, 2C); out is (B, T, C) in the input type:
//   ln[b, t, :]  = LayerNorm(x_g[b, t, :]) * gamma + beta   (eps 1e-6, f32)
//   out[b, t, c] = x_r[b, t, c] * (conv_b[c] + sum_j w[j, c] * ln[b, t + j - (k-1)/2, c])
// with ln = 0 outside [0, T) (SAME zero padding) and an identity gate. The LN
// output stays in f32 into the conv, as in the TPU kernel. The eager path
// (ops/cgmlp.py) rounds it to the input type before the conv, so the two agree
// in f32 and differ by rounding in bf16.
//
// What bounds it on the H100: memory, but the CUDA cores come close. At the
// flagship's request (a) (B=32, T=100, C=1024, k=31, bf16) it must read
// 13.1 MB and write 6.6 MB: 5.9 us at 3.35 TB/s; its ~b*t*C*(2k+10) = 236
// MFLOP of f32 FMAs (no tensor core computes a depthwise conv) take 3.5 us at
// 67 TFLOP/s. So the conv must not spend issue slots on shared-memory loads,
// and every row must be read from device memory once.
//
// The first port (one block per 256-channel tile, 32-row time tile and batch
// row; 0.0920 ms at (a), 0.064 of its bound) lost that in four ways: each of
// the C/256 channel tiles recomputed the LN statistics of its rows and their
// halo from device memory in two passes, the conv read shared memory once per
// FMA, every global access moved 2 bytes a thread, and 64 KB of shared memory
// a block left 3 blocks an SM for 1.3 waves.
//
// Design:
// - A thread block cluster of C/256 blocks (4 for the flagship) owns one
//   32-row time tile of one batch row; block q of the cluster owns channels
//   [256q, 256q + 256), one per thread. The LN statistics need all C channels
//   of a row: each block reduces its 256 channels of each staged row to a
//   partial (mean, M2) (two passes over shared memory, one warp a row), and
//   after one cluster barrier every block combines the cluster's partials
//   through distributed shared memory (Chan's parallel variance, ranks in
//   order, so every block gets the same mean and 1/std). No row goes to
//   device memory twice for its statistics; a halo row is staged by the two
//   tiles that need it (62 staged rows for 32 outputs at k = 31).
// - x_g's 32 + k - 1 rows (the tile and its halo) and x_r's 32 rows are
//   staged once in the input type by 16-byte cp.async copies, x_r in a
//   second group that lands while the statistics and the conv run; rows
//   outside [0, T) are zero-filled and carry a 0 in the statistics'
//   validity slot.
// - The conv (k = 31 as a template parameter) keeps the thread's 31 weights
//   and 32 output accumulators in registers and walks its channel down the
//   staged rows once: each value is read from shared memory once, normalised
//   in registers and fed to every accumulator it touches (one shared load
//   per up to 31 FMAs, all indices resolved at compile time). Other odd k up
//   to 127 take a generic loop that reads the staged value once per FMA.
// - The gated result is written over the staged x_r tile in the input type
//   and leaves in 16-byte vectors, consecutive threads on consecutive
//   addresses.
// - 256 threads, 80 registers and ~50 KB of shared memory a block (bf16,
//   k = 31): three blocks an SM. Request (a) launches 512 blocks (3.9 an
//   SM), request (b) 1,536 (11.6 an SM); a block is a quarter of a
//   cluster's work, so no round of blocks is long.
//
// Measured (chip_smoke.py --ab and --k3-phases, NVIDIA H100 80GB HBM3,
// 700 W, L2 cold): bf16 (a) 0.0380-0.0383 ms against 0.0929-0.0935 for the
// first port in the same run (0.15 of the bound), (b) 0.0899-0.0905
// against 0.2066-0.2072 (0.24). Taking phases out one at a time at (a) /
// (b): the conv costs 15.0 / 38.7 us (its 101.6 / 381 M FMAs need 3.0 /
// 11.4 us at the f32 rate), the statistics 5.0 / 5.8, the cluster
// barriers 2.8 / 6.8, and what is left, staging and stores, takes 15.4 /
// 38.8 us (0.38 / 0.57 of the byte bound). A cluster that walks a chunk
// of tiles through a ring of rows, prefetching the next tile's rows during
// this tile's conv, was tried and lost: it needs 128 registers, so two
// blocks an SM. PERF.md section 6 has the numbers.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using avsr::cp_async;
using avsr::store;
using avsr::to_f32;
using avsr::warp_sum;

constexpr int CB = 256;          // channels per block, one per thread
constexpr int TT = 32;           // output rows per cluster: the register accumulators
constexpr int MAX_CLUSTER = 8;   // the portable cluster size: C <= 2048
constexpr int MAX_KSIZE = 127;   // ops/fused_csgu.py's _MAX_KERNEL_SIZE
constexpr float LN_EPS = 1e-6f;

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared memory: per staged row its statistics (mean, 1/std, validity) and
// the block's partial (mean, M2), then the x_g rows and the x_r rows.
__host__ __device__ constexpr size_t stat_bytes(int rows) {
  return align16(rows * sizeof(float4)) + align16(rows * sizeof(float2));
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int ksize) {
  return stat_bytes(TT + ksize - 1) + size_t(TT + ksize - 1 + TT) * CB * sizeof(T);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The 8 channels [8 * lane, 8 * lane + 8) of a staged row, in f32.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// KS = the kernel size as a template parameter (31), or 0 for any odd size
// up to MAX_KSIZE given at run time.
template <typename T, int KS>
__global__ void __launch_bounds__(CB, 3)
    fused_csgu_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ beta, const T* __restrict__ w,
                      const T* __restrict__ conv_b, T* __restrict__ out, int t_len,
                      int channels, int ksize_rt) {
  constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte copy moves
  constexpr int CPR = CB / VEC;        // 16-byte chunks of a staged row
  const int ksize = KS ? KS : ksize_rt;
  const int half = (ksize - 1) / 2;
  const int rows = TT + ksize - 1;

  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_stat = reinterpret_cast<float4*>(smem);
  float2* s_part = reinterpret_cast<float2*>(smem + align16(rows * sizeof(float4)));
  T* s_g = reinterpret_cast<T*>(smem + stat_bytes(rows));  // (rows, CB)
  T* s_r = s_g + size_t(rows) * CB;                        // (TT, CB): x_r, then the output

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x, n_rank = gridDim.x;  // the cluster spans grid x
  const int cb0 = rank * CB, c = cb0 + tid;
  const bool live = c < channels;
  const int t0 = blockIdx.y * TT, tt = min(TT, t_len - t0);
  const int b = blockIdx.z;
  const size_t row_stride = 2 * size_t(channels);
  const T* xb = x + size_t(b) * t_len * row_stride;

  // 1) stage x_g rows t0 - half .. t0 + TT - 1 + half and x_r rows t0 .. t0 + TT - 1
  for (int q = tid; q < rows * CPR; q += CB) {
    const int r = q / CPR, ch = (q % CPR) * VEC, t = t0 - half + r;
    const bool ok = t >= 0 && t < t_len && cb0 + ch < channels;
    cp_async<16>(s_g + r * CB + ch, ok ? xb + size_t(t) * row_stride + channels + cb0 + ch : x, ok);
  }
  avsr::cp_async_commit();  // x_g first: the statistics wait for it alone
  for (int q = tid; q < TT * CPR; q += CB) {
    const int r = q / CPR, ch = (q % CPR) * VEC, t = t0 + r;
    const bool ok = t < t_len && cb0 + ch < channels;
    cp_async<16>(s_r + r * CB + ch, ok ? xb + size_t(t) * row_stride + cb0 + ch : x, ok);
  }
  avsr::cp_async_commit();
  float wr[KS ? KS : 1];
  if constexpr (KS > 0) {
#pragma unroll
    for (int j = 0; j < KS; ++j) wr[j] = live ? to_f32(w[size_t(j) * channels + c]) : 0.f;
  }
  const float gm = live ? to_f32(gamma[c]) : 0.f, be = live ? to_f32(beta[c]) : 0.f;
  const float cbias = live ? to_f32(conv_b[c]) : 0.f;
  avsr::cp_async_wait<1>();
  __syncthreads();

  // 2) each staged row's partial (mean, M2) over this block's channels
  const int n_blk = min(CB, channels - cb0);
  for (int r = warp; r < rows; r += CB / 32) {
    float v[8];
    load8(s_g + r * CB + 8 * lane, v);
    const bool mine = cb0 + 8 * lane < channels;  // channels % 8 == 0: all 8 or none
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[e];
    const float mean = warp_sum(mine ? sum : 0.f) / n_blk;
    float sq = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) sq = fmaf(v[e] - mean, v[e] - mean, sq);
    sq = warp_sum(mine ? sq : 0.f);
    if (lane == 0) s_part[r] = make_float2(mean, sq);
  }
  cluster_arrive();  // the partials are written (release) ...
  cluster_wait();    // ... and every block's are visible (acquire)

  // 3) the row statistics from the cluster's partials, ranks in order
  if (tid < rows) {
    float2 p[MAX_CLUSTER];
    float mean = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) {
      if (q < n_rank) {
        p[q] = cluster.map_shared_rank(s_part, q)[tid];
        mean = fmaf(float(min(CB, channels - q * CB)), p[q].x, mean);
      }
    }
    mean /= channels;
    float m2 = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) {
      if (q < n_rank) {
        const float d = p[q].x - mean;
        m2 += fmaf(float(min(CB, channels - q * CB)) * d, d, p[q].y);
      }
    }
    const int t = t0 - half + tid;
    const float valid = (t >= 0 && t < t_len) ? 1.f : 0.f;
    s_stat[tid] = make_float4(mean, rsqrtf(m2 / channels + LN_EPS), valid, 0.f);
  }
  cluster_arrive();  // done reading the other blocks' shared memory; waited on at the end
  __syncthreads();

  // 4) depthwise conv over time, f32 accumulators in registers
  float acc[TT];
#pragma unroll
  for (int i = 0; i < TT; ++i) acc[i] = cbias;
  const T* col = s_g + tid;
  if constexpr (KS > 0) {
    // the register window: staged row r feeds output rows i = r - j, j < KS
#pragma unroll
    for (int r = 0; r < TT + KS - 1; ++r) {
      if (r < tt + KS - 1) {  // a short last tile stops early
        const float4 st = s_stat[r];
        const float v = fmaf((to_f32(col[r * CB]) - st.x) * st.y, gm, be) * st.z;
#pragma unroll
        for (int j = 0; j < KS; ++j)  // constant trip count: unrolled before r, resolved after
          if (r - j >= 0 && r - j < TT) acc[r - j] = fmaf(wr[j], v, acc[r - j]);
      }
    }
  } else {
    for (int j = 0; j < ksize; ++j) {
      const float wj = live ? to_f32(w[size_t(j) * channels + c]) : 0.f;
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        const float4 st = s_stat[i + j];
        const float v = fmaf((to_f32(col[(i + j) * CB]) - st.x) * st.y, gm, be) * st.z;
        acc[i] = fmaf(wj, v, acc[i]);
      }
    }
  }

  // 5) identity gate times the residual half, over the staged x_r, then
  //    16-byte stores of the tile's rows
  avsr::cp_async_wait<0>();  // x_r, in flight since the start
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    T* p = s_r + i * CB + tid;
    if (i < tt) store(p, to_f32(*p) * acc[i]);
  }
  __syncthreads();
  T* ob = out + (size_t(b) * t_len + t0) * channels + cb0;
  for (int q = tid; q < tt * CPR; q += CB) {
    const int r = q / CPR, ch = (q % CPR) * VEC;
    if (cb0 + ch < channels)
      *reinterpret_cast<uint4*>(ob + size_t(r) * channels + ch) =
          *reinterpret_cast<const uint4*>(s_r + r * CB + ch);
  }
  cluster_wait();  // no block leaves while another may still read its partials
}

template <typename T, int KS>
cudaError_t launch_ks(const void* x, const void* gamma, const void* beta, const void* w,
                      const void* conv_b, void* out, int batch, int t_len, int channels,
                      int ksize, cudaStream_t stream) {
  auto kernel = fused_csgu_kernel<T, KS>;
  cudaError_t err =
      avsr::allow_dynamic_smem<fused_csgu_kernel<T, KS>>(smem_bytes<T>(KS ? KS : MAX_KSIZE));
  if (err != cudaSuccess) return err;
  const int cluster = (channels + CB - 1) / CB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (t_len + TT - 1) / TT, batch);
  cfg.blockDim = dim3(CB);
  cfg.dynamicSmemBytes = smem_bytes<T>(ksize);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(gamma),
                           static_cast<const T*>(beta), static_cast<const T*>(w),
                           static_cast<const T*>(conv_b), static_cast<T*>(out), t_len, channels,
                           ksize);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, const void* w,
                   const void* conv_b, void* out, int batch, int t_len, int channels, int ksize,
                   cudaStream_t stream) {
  if (ksize % 2 == 0 || ksize > MAX_KSIZE || channels % 8 || channels > MAX_CLUSTER * CB)
    return cudaErrorInvalidValue;
  return ksize == 31 ? launch_ks<T, 31>(x, gamma, beta, w, conv_b, out, batch, t_len, channels,
                                        ksize, stream)
                     : launch_ks<T, 0>(x, gamma, beta, w, conv_b, out, batch, t_len, channels,
                                       ksize, stream);
}

}  // namespace

// x: (B, T, 2C), 16-byte aligned; gamma, beta, conv_b: (C,); w: (k, 1, C) in
// the JAX layout; out: (B, T, C), 16-byte aligned; all contiguous and of one
// type. k is odd and at most 127, C a multiple of 8 and at most 2048.
// Returns the launch's cudaError_t.
extern "C" int avsr_fused_csgu(const void* x, const void* gamma, const void* beta, const void* w,
                               const void* conv_b, void* out, int batch, int t_len, int channels,
                               int ksize, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return int(is_bf16 ? launch<__nv_bfloat16>(x, gamma, beta, w, conv_b, out, batch, t_len,
                                             channels, ksize, s)
                     : launch<float>(x, gamma, beta, w, conv_b, out, batch, t_len, channels,
                                     ksize, s));
}
