// The lip frontend's stem (models/frontends.py, Conv3dResNet18) in one pass:
//   out = max_pool(1x3x3, stride 1x2x2, pad 0x1x1, -inf padding)(
//           act(BN_eval(conv3d(video, w; 5x7x7, stride 1x2x2, pad 2x3x3))))
// for a (B, T, H, W) bf16 video and the (64, 1, 5, 7, 7) bf16 weight,
// written as the ResNet trunk takes it: (B*T, 64, ceil(H/4), ceil(W/4)) bf16,
// contiguous. The conv's products are summed in f32, BatchNorm (eval: scale
// and shift from the weight, bias and running statistics, computed in f32 in
// the prologue) and the activation (swish, relu or leaky relu) run in f32,
// and each value is rounded to bf16 once, before the max (rounding is
// monotonic, so the max of rounded values is the rounded max).
//
// It replaces no Pallas kernel: the JAX package leaves this stem to XLA (on
// the TPU as its space-to-depth form, tailored_avsr_tpu/models/frontends.py
// stem_s2d). cuDNN finds no tensor-core kernel for a one-channel Conv3d in
// bf16: it converts the input to f32 and runs an f32 implicit GEMM on the
// CUDA cores, and BatchNorm, the activation, the max-pool and the trunk's
// layout copy each make one more pass over the (B, 64, T, H/2, W/2) tensor.
//
// What bounds it on the H100: 2 * 64 * 245 operations a conv position. At
// 24 x 500 frames of 88 x 88 that is 728.6 GFLOP, 0.74 ms at 989 TFLOP/s,
// against 0.28 ms for its bytes (186 MB of video read once, 743 MB of pooled
// output written once): bound by its operations.
//
// Design: an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulators): M the conv positions of a conv row, N the 64 channels,
// K the 245 taps laid out as 18 k16 slabs. A slab holds two (kt, ky) tap
// rows of 8 kx taps, kx = -1..6 with the first weighted 0, so that the 8
// inputs of a tap row at conv column x are input columns 2x-4 .. 2x+3: four
// 32-bit words of the input row in shared memory (the conv's stride 2 is one
// word). An A fragment is four 32-bit shared loads and no im2col: the 16 rows
// of an m-tile read a sliding window of 18 words of one row, free of bank
// conflicts. The 35 tap rows pad to 36 (the last weighted 0): K = 288 for
// 245 taps (1.18x), and a conv row's 44 columns take three m-tiles, 48
// (1.09x). B fragments come from the weights in shared memory by ldmatrix
// (rows padded by 16 bytes: conflict-free).
//
// The rows of an m-tile map to conv columns in pairs: row g to column 2q,
// row g + 8 to 2q + 1 (q = 8 xt + g), so a thread holds both columns of a
// pooling window's pair for two channels and max-pools across them in
// registers; the window's third column (2q - 1) comes from the lane of q - 1
// by one shuffle of a bf16 pair. The conv output never reaches device
// memory, nor shared memory: only the rows pooled across columns do.
//
// An 8-warp block is persistent: it stages the weights (64 x 288) and the
// BatchNorm's scale and shift once, then walks its frames (b, t) in steps of
// 4 conv rows, two warps a row (32 channels each: 48 f32 accumulators, so
// two blocks of 8 warps fit an SM's registers). The 5 frames x 13 input rows
// a step reads come in as one box of a tensor map (TMA; an mbarrier counts
// its bytes) into one of two buffers while the step before computes; frames
// outside [0, T) and rows and columns outside the image read 0, as the conv
// pads (rows whose bytes are no multiple of 16 come in element by element).
// The epilogue applies scale, shift and the activation, rounds to bf16 pairs
// of channels, pools across columns and writes the row into a ring of 9 rows
// in shared memory (16-byte groups swizzled, so both the epilogue's stores
// and the pooling's loads are free of bank conflicts). A step then pools
// down the rows of the step before it (rows 4s - 1 .. 4s + 3 for pooled rows
// 2s, 2s + 1) and writes them as bf16 pairs along x, coalesced: with the
// ring holding three steps' rows, one barrier a step orders it all. Two
// blocks an SM (93 KB of shared memory each at W = 88).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W), 24 x 500 frames: 3.65 ms, 20 % of
// the bound; the cuDNN chain it replaces 60.3 ms. What bounds it now: the
// products (~1.7 ms with the rest cut out: mma.sync fed by shared loads, A
// fragments loaded by both warps of a row), then the epilogue's activation
// (two MUFU operations a value) and the pooling's loads and stores.
#include <cuda.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;                 // output channels
constexpr int KT = 5, KY = 7, KX = 7;  // conv taps over t, y, x
constexpr int TAPS = KT * KY * KX;
constexpr int TAP_ROWS = KT * KY;     // (kt, ky) rows of KX taps
constexpr int NSLAB = (TAP_ROWS + 1) / 2;  // k16 slabs: two tap rows of 8 each
constexpr int KP = 16 * NSLAB;        // padded K: 288
constexpr int WLD = KP + 8;           // padded weight row (bf16): 592 bytes
constexpr int ROWS = 4;               // conv rows a step
constexpr int HALVES = 2;             // warps a conv row, 32 channels each
constexpr int NWARPS = ROWS * HALVES;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int CW = C / HALVES;        // channels a warp
constexpr int NT = CW / 8;            // n-tiles (8 channels) a warp
constexpr int XT = 3;                 // m-tiles of 16 conv columns a warp unit
constexpr int XG = 16 * XT;           // conv columns a unit
constexpr int XQ = XG / 2;            // pooled columns a unit
constexpr int IN_ROWS = 2 * ROWS + KY - 2;  // input rows a frame and step: 13
constexpr int NRING = 2 * ROWS + 1;   // rows in the ring: a step's, the step before's, the one before that
constexpr int MAX_SMEM = 232448;      // the H100's 227 KB a block
static_assert(KX + 1 == 8 && TAP_ROWS % 2 == 1, "a tap row fills 8 k, and the last slab is half padding");
static_assert(ROWS % 2 == 0, "a step completes ROWS / 2 pooled rows");

enum Activation { ACT_SWISH = 0, ACT_RELU = 1, ACT_LEAKY_RELU = 2 };

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ __forceinline__ __nv_bfloat162 from_bits(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

struct StemArgs {
  const bf16* video;  // (frames = B*T, H, W)
  const bf16* weight;  // (64, 1, 5, 7, 7)
  const bf16* bn_w;
  const bf16* bn_b;
  const bf16* mean;
  const bf16* var;
  bf16* out;          // (frames, 64, h4, w4)
  int frames, t_len, h, w;
  float eps;
  int h2, w2, h4, w4;  // conv and pooled sizes
  int n_xg;            // units of XG conv columns a conv row
  int iw;              // input row in shared memory (bf16): columns -8 .. 96 n_xg + 7
  int nq;              // pooled columns of a row in the ring: XQ n_xg
  int steps;           // steps a frame
  int in_stride;       // elements from one input buffer to the next (128-byte multiples)
  int tma;             // the input comes in by the tensor map (else element by element)
};

// Shared memory: scale and shift (f32), the weights, two input buffers (each
// 128-byte aligned, for the tensor copies), the ring, two mbarriers.
size_t smem_bytes(const StemArgs& a) {
  return 2 * C * sizeof(float) + (size_t(C) * WLD + 2 * size_t(a.in_stride) + size_t(NRING) * a.nq * C) * sizeof(bf16)
         + 2 * sizeof(uint64_t);
}
static_assert((2 * C * sizeof(float) + C * WLD * sizeof(bf16)) % 128 == 0, "the input buffers start 128-byte aligned");

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(avsr::smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}

// The box of input rows at (column x, row y, frame t, batch b) of the tensor
// map into dst, its bytes counted on bar; coordinates outside the video
// (columns, rows, frames) read 0.
__device__ __forceinline__ void tma_box(bf16* dst, const CUtensorMap* map, uint64_t* bar, uint32_t bytes,
                                        int x, int y, int t, int b) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(avsr::smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, "
      "%4, %5}], [%6];\n" ::"r"(avsr::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(t), "r"(b), "r"(avsr::smem_addr(bar))
      : "memory");
}

// The ring's word of channel pair cp at pooled column q: 32 words a column,
// XOR-swizzled by q in 16-byte groups, so the 8 columns of an epilogue store
// and the even columns of a pooling load fall in distinct banks.
__device__ __forceinline__ int ring_word(int q, int cp) { return q * 32 + (cp ^ (4 * ((q ^ (q >> 3)) & 7))); }

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == ACT_SWISH)
    return __fdividef(v, 1.f + __expf(-v));  // -0 where exp(-v) overflows
  else if constexpr (ACT == ACT_RELU)
    return fmaxf(v, 0.f);
  else
    return v > 0.f ? v : 0.01f * v;  // leaky relu, torch's default slope
}

// The input rows of conv rows y0 .. y0 + ROWS - 1 (input rows 2 y0 - 3 ..
// 2 y0 + 2 ROWS + 1) of the 5 frames t - 2 .. t + 2 around frame f, into buf:
// row r of frame slot kt at (kt * IN_ROWS + r) * iw, input column c at c + 8.
// By the tensor map, one box issued by thread 0 and counted on bar; else
// element by element (a row whose bytes are no multiple of 16).
__device__ void load_step(const StemArgs& a, const CUtensorMap& map, bf16* buf, uint64_t* bar, int f, int y0) {
  const int t = f % a.t_len;
  if (a.tma) {
    if (threadIdx.x == 0)
      tma_box(buf, &map, bar, KT * IN_ROWS * a.iw * sizeof(bf16), -8, 2 * y0 - 3, t - 2, f / a.t_len);
    return;
  }
  for (int i = threadIdx.x; i < KT * IN_ROWS * a.iw; i += NTHREADS) {
    const int col = i % a.iw - 8, row = i / a.iw, kt = row / IN_ROWS;
    const int tt = t + kt - 2, iy = 2 * y0 - 3 + row - kt * IN_ROWS;
    const bool ok = tt >= 0 && tt < a.t_len && iy >= 0 && iy < a.h && col >= 0 && col < a.w;
    buf[i] = ok ? a.video[(size_t(f - t + tt) * a.h + iy) * a.w + col] : __float2bfloat16(0.f);
  }
}

// acc += the conv of one unit: XG columns from x0 of the conv row whose
// first input row is local row lr of the step's buffer in, the CW channels
// whose weights are wsm's first rows
__device__ __forceinline__ void conv_unit(float (&acc)[XT][NT][4], const bf16* wsm,
                                          const bf16* in, int lr, int x0, int iw, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  // m-tile rows g and g + 8 are conv columns 2g and 2g + 1 of the tile's 16;
  // conv column x reads input columns 2x - 4 .. 2x + 3, from word x + 2
  const uint32_t* inw = reinterpret_cast<const uint32_t*>(in) + x0 + 2 * g + tig + 2;
  const int iww = iw / 2;
  const bf16* wl = wsm + ((lane & 7) + (lane >> 4) * 8) * WLD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int s = 0; s < NSLAB; ++s) {
    uint32_t bfr[NT][2];
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t r[4];
      avsr::ldmatrix_x4(r, wl + 16 * p * WLD + 16 * s);
      bfr[2 * p][0] = r[0];
      bfr[2 * p][1] = r[1];
      bfr[2 * p + 1][0] = r[2];
      bfr[2 * p + 1][1] = r[3];
    }
    // the slab's tap rows q0, q1 = (kt, ky) = (q / 7, q % 7); the padding
    // row reads q0's inputs against zero weights
    const int q0 = 2 * s, q1 = 2 * s + 1 < TAP_ROWS ? 2 * s + 1 : 2 * s;
    const uint32_t* r0 = inw + ((q0 / KY) * IN_ROWS + lr + q0 % KY) * iww;
    const uint32_t* r1 = inw + ((q1 / KY) * IN_ROWS + lr + q1 % KY) * iww;
#pragma unroll
    for (int xt = 0; xt < XT; ++xt) {
      const uint32_t af[4] = {r0[16 * xt], r0[16 * xt + 1], r1[16 * xt], r1[16 * xt + 1]};
#pragma unroll
      for (int n = 0; n < NT; ++n) avsr::mma_bf16(acc[xt][n], af, bfr[n][0], bfr[n][1]);
    }
  }
}

template <int ACT>
__global__ void __launch_bounds__(NTHREADS, 2)
    visual_stem_kernel(const StemArgs a, const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);
  float* sh = sc + C;
  bf16* wsm = reinterpret_cast<bf16*>(sh + C);
  bf16* inb = wsm + C * WLD;
  bf16* ring = inb + 2 * a.in_stride;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + NRING * a.nq * C);  // one an input buffer
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(avsr::smem_addr(bars + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int f = blockIdx.x, step = 0, buf = 0;
  uint32_t parity = 0;  // bit b: the phase of buffer b's next completion
  load_step(a, map, inb, bars, f, 0);  // in flight while the weights are staged

  // weights as 18 slabs: k = 16 s + 8 h + (kx + 1), tap row q = 2 s + h
  for (int i = threadIdx.x; i < C * WLD; i += NTHREADS) {
    const int n = i / WLD, k = i % WLD;
    const int q = 2 * (k >> 4) + ((k >> 3) & 1), kx = (k & 7) - 1;
    const bool tap = k < KP && kx >= 0 && q < TAP_ROWS;
    wsm[i] = tap ? a.weight[n * TAPS + q * KX + kx] : __float2bfloat16(0.f);
  }
  if (threadIdx.x < C) {
    const int c = threadIdx.x;
    const float s = avsr::to_f32(a.bn_w[c]) / sqrtf(avsr::to_f32(a.var[c]) + a.eps);
    sc[c] = s;
    sh[c] = avsr::to_f32(a.bn_b[c]) - avsr::to_f32(a.mean[c]) * s;
  }

  const uint32_t NEG_INF2 = 0xff80ff80u;  // a pair of bf16 -inf
  uint32_t* ring_w = reinterpret_cast<uint32_t*>(ring);
  // the pooling's tasks (channel pairs and rows cj, column pairs k), walked NTHREADS at a time
  const int npairs = (a.w4 + 1) / 2;
  const int task_q = threadIdx.x / npairs, task_k = threadIdx.x % npairs;
  const int task_dq = NTHREADS / npairs, task_dk = NTHREADS % npairs;
  const int src = g > 0 ? lane - 4 : lane + 28;  // the lane of pooled column q - 1 (same channels)

  // Pooled rows 2 step and 2 step + 1 of frame pf, from ring rows 4 step - 1 ..
  // 4 step + 3: row y0 + r of that step at slot (base + r) % NRING. A task is
  // channel pair cp, pooled row p and pooled columns 2k, 2k + 1.
  auto pool = [&](int pf, int pstep, int base) {
    const int y0 = pstep * ROWS;
    for (int cj = task_q, k = task_k; cj < (ROWS / 2) * (C / 2);) {
      const int cp = cj / (ROWS / 2), p = pstep * (ROWS / 2) + cj % (ROWS / 2);
      const int q0 = 2 * k, q1 = 2 * k + 1;
      if (p < a.h4) {
        __nv_bfloat162 w0 = from_bits(NEG_INF2), w1 = from_bits(NEG_INF2);
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
          const int yy = 2 * p + dy;
          if (yy < 0 || yy >= a.h2) continue;
          const uint32_t* r = ring_w + (base + yy - y0 + NRING) % NRING * a.nq * 32;
          w0 = __hmax2(w0, from_bits(r[ring_word(q0, cp)]));
          if (q1 < a.w4) w1 = __hmax2(w1, from_bits(r[ring_word(q1, cp)]));
        }
        // channel 2 cp: the low halves, at columns q0, q1; channel 2 cp + 1: the high
        const uint32_t lo = __byte_perm(bits(w0), bits(w1), 0x5410);
        const uint32_t hi = __byte_perm(bits(w0), bits(w1), 0x7632);
        bf16* o = a.out + ((size_t(pf) * C + 2 * cp) * a.h4 + p) * a.w4 + q0;
        bf16* o1 = o + size_t(a.h4) * a.w4;
        if (q1 < a.w4 && (a.w4 & 1) == 0) {
          *reinterpret_cast<uint32_t*>(o) = lo;
          *reinterpret_cast<uint32_t*>(o1) = hi;
        } else {
          o[0] = from_bits(lo).x;
          o1[0] = from_bits(hi).x;
          if (q1 < a.w4) {
            o[1] = from_bits(lo).y;
            o1[1] = from_bits(hi).y;
          }
        }
      }
      k += task_dk;
      cj += task_dq;
      if (k >= npairs) {
        k -= npairs;
        ++cj;
      }
    }
  };

  // A step pools the step before it, whose rows the barrier at its top made
  // visible; its own rows go to slots that pooling leaves alone.
  int base = 0, pf = -1, pstep = 0, pbase = 0;
  while (true) {
    int nf = f, nstep = step + 1;
    if (nstep == a.steps) {
      nf += gridDim.x;
      nstep = 0;
    }
    const bool more = nf < a.frames;
    if (a.tma) {
      while (!mbar_try_wait(bars + buf, (parity >> buf) & 1)) {
      }
      parity ^= 1u << buf;
    }
    // this step's input has landed, the step before's rows are in the ring,
    // and its products have all read buffer buf ^ 1: the next step's input may go there
    __syncthreads();
    if (more) load_step(a, map, inb + (buf ^ 1) * a.in_stride, bars + (buf ^ 1), nf, nstep * ROWS);

    const int y0 = step * ROWS, y = y0 + warp % ROWS, half = warp / ROWS;
    if (y < a.h2) {
      uint32_t* row = ring_w + (base + y - y0) % NRING * a.nq * 32;
      uint32_t carry[NT];  // the odd column before the unit's first: padding, then the last unit's
#pragma unroll
      for (int n = 0; n < NT; ++n) carry[n] = NEG_INF2;
      for (int xg = 0; xg < a.n_xg; ++xg) {
        float acc[XT][NT][4];
#pragma unroll
        for (int xt = 0; xt < XT; ++xt)
#pragma unroll
          for (int n = 0; n < NT; ++n) acc[xt][n][0] = acc[xt][n][1] = acc[xt][n][2] = acc[xt][n][3] = 0.f;
        conv_unit(acc, wsm + CW * half * WLD, inb + buf * a.in_stride, 2 * (y - y0), XG * xg, a.iw, lane);
        // acc[xt][n]: conv columns 2q ([0], [1]) and 2q + 1 ([2], [3]) of pooled
        // column q = XQ xg + 8 xt + g, channels CW half + 8 n + 2 tig and + 1; columns
        // past the conv's last are -inf, the pool's padding
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c = CW * half + 8 * n + 2 * tig;
          const float s0 = sc[c], s1 = sc[c + 1], h0 = sh[c], h1 = sh[c + 1];
          uint32_t even[XT], odd[XT], prev[XT];
#pragma unroll
          for (int xt = 0; xt < XT; ++xt) {
            const float* v = acc[xt][n];
            const int x = 2 * (XQ * xg + 8 * xt + g);
            even[xt] = x < a.w2 ? avsr::pack_bf16(activate<ACT>(fmaf(v[0], s0, h0)),
                                                  activate<ACT>(fmaf(v[1], s1, h1)))
                                : NEG_INF2;
            odd[xt] = x + 1 < a.w2 ? avsr::pack_bf16(activate<ACT>(fmaf(v[2], s0, h0)),
                                                     activate<ACT>(fmaf(v[3], s1, h1)))
                                   : NEG_INF2;
            prev[xt] = __shfl_sync(0xffffffffu, odd[xt], src);
          }
#pragma unroll
          for (int xt = 0; xt < XT; ++xt) {
            const uint32_t left = g > 0 ? prev[xt] : (xt > 0 ? prev[xt - 1] : carry[n]);
            const uint32_t m = bits(__hmax2(__hmax2(from_bits(even[xt]), from_bits(odd[xt])), from_bits(left)));
            row[ring_word(XQ * xg + 8 * xt + g, c / 2)] = m;
          }
          carry[n] = prev[XT - 1];
        }
      }
    }
    if (pf >= 0) pool(pf, pstep, pbase);
    pf = f;
    pstep = step;
    pbase = base;
    base = (base + ROWS) % NRING;
    if (!more) break;
    f = nf;
    step = nstep;
    buf ^= 1;
  }
  __syncthreads();
  pool(pf, pstep, pbase);
}

// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The video as a (B, T, H, W) tensor map whose box is one step's input rows.
cudaError_t make_map(const StemArgs& a, CUtensorMap* map) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t row = cuuint64_t(a.w) * sizeof(bf16);
  const cuuint64_t dims[4] = {cuuint64_t(a.w), cuuint64_t(a.h), cuuint64_t(a.t_len), cuuint64_t(a.frames / a.t_len)};
  const cuuint64_t strides[3] = {row, row * a.h, row * a.h * a.t_len};
  const cuuint32_t box[4] = {cuuint32_t(a.iw), IN_ROWS, KT, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(a.video), dims, strides,
                              box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A persistent grid: as many blocks as fit on the card at once, or one a frame.
template <int ACT>
cudaError_t launch(const StemArgs& a, const CUtensorMap& map, cudaStream_t stream) {
  const size_t smem = smem_bytes(a);
  cudaError_t err = avsr::allow_dynamic_smem<visual_stem_kernel<ACT>>(MAX_SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, visual_stem_kernel<ACT>, NTHREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = a.frames < per_sm * sms ? a.frames : per_sm * sms;
  visual_stem_kernel<ACT><<<grid, NTHREADS, smem, stream>>>(a, map);
  return cudaGetLastError();
}

}  // namespace

extern "C" int avsr_visual_stem(const void* video, const void* w, const void* bn_w,
                                const void* bn_b, const void* mean, const void* var, void* out,
                                int frames, int t_len, int h, int wd, float eps, int act,
                                void* stream) {
  StemArgs a{static_cast<const bf16*>(video), static_cast<const bf16*>(w),
             static_cast<const bf16*>(bn_w),  static_cast<const bf16*>(bn_b),
             static_cast<const bf16*>(mean),  static_cast<const bf16*>(var),
             static_cast<bf16*>(out),         frames, t_len, h, wd, eps};
  if (frames < 1 || t_len < 1 || frames % t_len || h < 1 || wd < 1 || act < 0 || act > 2)
    return int(cudaErrorInvalidValue);
  a.h2 = (h + 1) / 2;
  a.w2 = (wd + 1) / 2;
  a.h4 = (a.h2 + 1) / 2;
  a.w4 = (a.w2 + 1) / 2;
  a.n_xg = (a.w2 + XG - 1) / XG;
  a.iw = 2 * XG * a.n_xg + 16;
  a.in_stride = (KT * IN_ROWS * a.iw + 63) / 64 * 64;
  a.nq = XQ * a.n_xg;
  a.steps = (a.h2 + ROWS - 1) / ROWS;
  // a tensor map takes rows of 16-byte multiples from a 16-byte aligned
  // address, and boxes of at most 256 columns
  a.tma = wd % 8 == 0 && reinterpret_cast<uintptr_t>(video) % 16 == 0 && a.iw <= 256;
  CUtensorMap map{};
  if (a.tma) {
    const cudaError_t err = make_map(a, &map);
    if (err != cudaSuccess) return int(err);
  }
  if (smem_bytes(a) > MAX_SMEM) return int(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (act == ACT_SWISH) return int(launch<ACT_SWISH>(a, map, s));
  if (act == ACT_RELU) return int(launch<ACT_RELU>(a, map, s));
  return int(launch<ACT_LEAKY_RELU>(a, map, s));
}
