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
// What bounds it on the H100: memory. Each output element needs one read of
// x_r and x_g and about 2k FLOPs (k = 31 in the flagship), far below the
// card's ratio of FLOPs to bytes. The LN statistics need the whole channel
// axis of a row, so a block cannot own a channel slice alone.
//
// Design: one block per (batch row, 32-row time tile, 256-channel tile), one
// thread per channel. The block first computes the LN mean and 1/std of its
// 32 rows plus the k-1 halo rows, over all C channels (one warp per row, two
// passes), and holds them in shared memory: the TPU kernel's whole (T, C)
// tile per batch row does not fit a block at T = 500, C = 1024 in f32. Each
// thread then normalises its channel over those rows into shared memory and
// runs the k taps down the time axis with 32 f32 accumulators in registers,
// then multiplies by x_r. The row statistics are recomputed by each of the
// C/256 channel tiles; those extra reads mostly hit L2.

#include "common.cuh"

namespace {

using avsr::store;
using avsr::to_f32;
using avsr::warp_sum;

constexpr int CT = 256;  // channels per block, one per thread
constexpr int TT = 32;   // output rows per block
constexpr float LN_EPS = 1e-6f;

size_t smem_bytes(int ksize) {
  const size_t rows = TT + ksize - 1;
  return (2 * rows + rows * CT) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(CT)
    fused_csgu_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ beta, const T* __restrict__ w,
                      const T* __restrict__ conv_b, T* __restrict__ out, int t_len,
                      int channels, int ksize) {
  extern __shared__ float smem[];
  const int half = (ksize - 1) / 2;
  const int rows = TT + ksize - 1;
  float* s_mean = smem;
  float* s_rstd = s_mean + rows;
  float* s_ln = s_rstd + rows;  // (rows, CT); each thread touches its own column only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x * CT + tid;
  const int t0 = blockIdx.y * TT;
  const int b = blockIdx.z;
  const size_t row_stride = 2 * size_t(channels);
  const T* xb = x + size_t(b) * t_len * row_stride;

  // 1) LN statistics of rows t0 - half .. t0 + TT - 1 + half
  for (int r = warp; r < rows; r += CT / 32) {
    const int t = t0 - half + r;
    float mean = 0.f, rstd = 0.f;
    if (t >= 0 && t < t_len) {
      const T* g = xb + size_t(t) * row_stride + channels;
      float sum = 0.f;
      for (int i = lane; i < channels; i += 32) sum += to_f32(g[i]);
      mean = warp_sum(sum) / channels;
      float sq = 0.f;
      for (int i = lane; i < channels; i += 32) {
        const float d = to_f32(g[i]) - mean;
        sq = fmaf(d, d, sq);
      }
      rstd = rsqrtf(warp_sum(sq) / channels + LN_EPS);
    }
    if (lane == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rstd;
    }
  }
  __syncthreads();
  if (c >= channels) return;  // no barrier follows

  // 2) normalised gate half of this channel, zero outside [0, T)
  const float g = to_f32(gamma[c]), be = to_f32(beta[c]);
  for (int r = 0; r < rows; ++r) {
    const int t = t0 - half + r;
    s_ln[r * CT + tid] =
        (t >= 0 && t < t_len)
            ? (to_f32(xb[size_t(t) * row_stride + channels + c]) - s_mean[r]) * s_rstd[r] * g + be
            : 0.f;
  }

  // 3) depthwise conv over time
  float acc[TT];
  const float cb = to_f32(conv_b[c]);
#pragma unroll
  for (int i = 0; i < TT; ++i) acc[i] = cb;
  for (int j = 0; j < ksize; ++j) {
    const float wj = to_f32(w[size_t(j) * channels + c]);
#pragma unroll
    for (int i = 0; i < TT; ++i) acc[i] = fmaf(wj, s_ln[(i + j) * CT + tid], acc[i]);
  }

  // 4) identity gate times the residual half
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int t = t0 + i;
    if (t < t_len)
      store(&out[(size_t(b) * t_len + t) * channels + c],
            to_f32(xb[size_t(t) * row_stride + c]) * acc[i]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, const void* w,
                   const void* conv_b, void* out, int batch, int t_len, int channels, int ksize,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(ksize);
  cudaError_t err = cudaFuncSetAttribute(fused_csgu_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((channels + CT - 1) / CT, (t_len + TT - 1) / TT, batch);
  fused_csgu_kernel<T><<<grid, CT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const T*>(w), static_cast<const T*>(conv_b), static_cast<T*>(out), t_len,
      channels, ksize);
  return cudaGetLastError();
}

}  // namespace

// x: (B, T, 2C); gamma, beta, conv_b: (C,); w: (k, 1, C) in the JAX layout;
// out: (B, T, C); all contiguous and of one type. k is odd. Returns the
// launch's cudaError_t.
extern "C" int avsr_fused_csgu(const void* x, const void* gamma, const void* beta, const void* w,
                               const void* conv_b, void* out, int batch, int t_len, int channels,
                               int ksize, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return int(is_bf16 ? launch<__nv_bfloat16>(x, gamma, beta, w, conv_b, out, batch, t_len,
                                             channels, ksize, s)
                     : launch<float>(x, gamma, beta, w, conv_b, out, batch, t_len, channels,
                                     ksize, s));
}
