// 3x3 stride-1 convolution of the score U-Net's Blocks in f32:
//   y[b, f, t, n] = bias[n] + sum over (df, dt) in 3x3 and c of
//                   w[df, dt, c, n] * (x * mask)[b, f + df - 1, t + dt - 1, c]
// with zero padding 1, activations channels-last [B, F, T, C] and the
// weights tap-major [3, 3, C_in, C_out] (ops/conv3x3.py tap_major).
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to
// lax.conv (gradtts_tpu/models/diffusion.py Block, :251). It exists because
// cuDNN, asked for full f32 (TF32 off), takes FFT algorithms for them whose
// frequency-domain products are complex-f32 GEMMs: ~100,000 launches and
// ~2.5 s of device time an evaluation of the U-Net in forward mode at
// n-best's B 50 x 512 frames. Here a Block's convolution is one launch, in
// the primal and in the tangent (ops/conv3x3.py Conv3x3Fn).
//
// What bounds it on the H100: operations. At n-best's 64 -> 64 level
// (B 50, F 80, T 512) it is 151 GFLOP against 0.31 ms of bytes: 2.25 ms at
// the 67 TFLOP/s of f32 FMA on the CUDA cores. So the design serves the FMA
// pipes, as an implicit GEMM over M = B*F*T positions, N = C_out and
// K = 9 * C_in, with plain f32 FMA chains (no TF32, no transform):
//   - a block owns BF x BT positions (4 rows of F, 64 frames) and BN = 64
//     output channels; its input tile with a one-position halo, (BF + 2) x
//     (BT + 2) positions of KC = 8 channels, lands in shared memory once a
//     chunk and serves all nine taps; the chunk's 9 x KC x 64 weights beside
//     it; both by cp.async in a ring of 3 stages that runs ahead of the math;
//   - the time mask is multiplied into the tile as it lands (each thread
//     multiplies the vectors it copied), the bias added in the epilogue;
//   - each thread keeps an 8 x 8 register tile of accumulators: 8
//     consecutive frames of one row by 8 output channels. For a row tap df
//     and a channel pair it reads the 10 frames its 8 outputs see (LDS.64)
//     once and uses them for the three column taps dt, and per (dt, c) 8
//     weights (two LDS.128): 22 shared loads a 384 FMAs;
//   - a warp's 32 lanes are 4 groups of 8 frames by 8 channel lanes, so in
//     each quarter warp the frames are one address (a broadcast) and the
//     weights 8 consecutive 16-byte vectors; 4 padding floats after every
//     8 positions of the tile put the 4 groups' frames in distinct banks;
//   - one block of 8 warps an SM: the tile, the next channel pair's
//     operands in flight and the addresses take ~240 registers a thread.
//     Capped at 128 for two blocks an SM, the tile spilled and ran 10%
//     slower; 16 frames a thread in blocks of 4 warps, 10% slower too.
// Measured on the H100 at 1980 MHz: ~41 TFLOP/s, 61% of the FMA peak, at
// every width of the n-best and generate cells (PERF.md's kernel table).
// C_in 2 or 3 (the U-Net's first convolution: x and mu, and a speaker
// channel where there is one; under 0.3% of its FLOPs) takes a direct
// kernel with the weights in shared memory.

#include "common.cuh"

namespace {

constexpr int TM = 8;                 // frames a thread
constexpr int BN = 64;                // output channels a block
constexpr int BF = 4;                 // rows of F a block
constexpr int BT = 64;                // frames a block
constexpr int KC = 8;                 // input channels a stage
constexpr int STAGES = 3;             // depth of the cp.async ring
constexpr int HF = BF + 2, HT = BT + 2;  // the tile with its halo
constexpr int WARPS_ROW = BT / (4 * TM);   // warps a row of the block
constexpr int THREADS = 32 * BF * WARPS_ROW;
constexpr int SMALL_THREADS = 256;
constexpr int SMALL_FRAMES = SMALL_THREADS / 8;  // frames a block of the direct kernel

// float offset of halo position p in a tile row: KC floats a position and
// 4 more after every 8 (bank skew; 16-byte alignment kept)
__host__ __device__ constexpr int pos_off(int p) { return p * KC + (p >> 3) * 4; }
constexpr int ROW = pos_off(HT);                 // floats a tile row
constexpr int X_STAGE = HF * ROW;                // floats of input a stage
constexpr int W_STAGE = 9 * KC * BN;             // floats of weights a stage
constexpr int STAGE = X_STAGE + W_STAGE;
constexpr int SMEM_BYTES = STAGES * STAGE * (int)sizeof(float);
constexpr int X_UNITS = HF * HT * (KC / 4);      // 16-byte copies of input a stage
constexpr int W_UNITS = 9 * KC * (BN / 4);       // 16-byte copies of weights a stage
static_assert(ROW % 4 == 0 && STAGE % 4 == 0, "16-byte alignment");

// The TM x 8 tile += one KC chunk: rows df of the halo tile, channel
// pairs, column taps dt. xr: the thread's first halo position of its row,
// ws: the stage's weights at its channel lane. The channel pairs are
// unrolled, so that the compiler loads one pair's operands while the last
// pair's FMAs run (fewer registers, one pair at a time, ran 10-20% slower
// on the H100).
__device__ __forceinline__ void chunk_fma(const float* __restrict__ xr,
                                          const float* __restrict__ ws, float (&acc)[TM][8]) {
#pragma unroll 1
  for (int df = 0; df < 3; ++df) {
    const float* xd = xr + df * ROW;
    const float* wd = ws + df * 3 * KC * BN;
#pragma unroll
    for (int cp = 0; cp < KC / 2; ++cp) {
      float2 a[TM + 2];
#pragma unroll
      for (int i = 0; i < TM + 2; ++i) a[i] = *reinterpret_cast<const float2*>(xd + pos_off(i) + 2 * cp);
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float* w = wd + (dt * KC + 2 * cp + cc) * BN;
          const float4 w0 = *reinterpret_cast<const float4*>(w);
          const float4 w1 = *reinterpret_cast<const float4*>(w + 32);
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            const float v = cc ? a[j + dt].y : a[j + dt].x;
            acc[j][0] = fmaf(v, w0.x, acc[j][0]);
            acc[j][1] = fmaf(v, w0.y, acc[j][1]);
            acc[j][2] = fmaf(v, w0.z, acc[j][2]);
            acc[j][3] = fmaf(v, w0.w, acc[j][3]);
            acc[j][4] = fmaf(v, w1.x, acc[j][4]);
            acc[j][5] = fmaf(v, w1.y, acc[j][5]);
            acc[j][6] = fmaf(v, w1.z, acc[j][6]);
            acc[j][7] = fmaf(v, w1.w, acc[j][7]);
          }
        }
      }
    }
  }
}

// grid: one block per (b, row band, frame band, channel block), the channel
// block fastest so that the blocks sharing an input tile run together.
// Thread: warp w owns row w / 2 and frames 32 (w % 2) .. + 31 of the block;
// lane l owns frames 8 (l / 8) .. + 7 of those and channels 4 (l % 8) .. + 3
// and 32 + 4 (l % 8) .. + 3 of the block's 64.
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ mask,
               const float* __restrict__ w, const float* __restrict__ bias,
               float* __restrict__ y, int F, int T, int C_in, int C_out, int FT, int TT,
               int NT) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float ms[HT];
  int idx = blockIdx.x;
  const int nt = idx % NT;
  idx /= NT;
  const int tt = idx % TT;
  idx /= TT;
  const int ft = idx % FT, b = idx / FT;
  const int f0 = ft * BF, t0 = tt * BT, n0 = nt * BN;
  const int tid = threadIdx.x;

  for (int i = tid; i < HT; i += THREADS) {
    const int t = t0 - 1 + i;
    ms[i] = (t >= 0 && t < T) ? mask[(size_t)b * T + t] : 0.f;
  }

  auto load = [&](int k, int s) {  // chunk k (channels 8k ..) into stage s
    float* xs = smem + s * STAGE;
    float* ws = xs + X_STAGE;
    const int c0 = k * KC;
    for (int u = tid; u < X_UNITS; u += THREADS) {
      const int half = u & 1, pos = (u >> 1) % HT, row = (u >> 1) / HT;
      const int f = f0 - 1 + row, t = t0 - 1 + pos;
      const bool ok = f >= 0 && f < F && t >= 0 && t < T;
      const float* src = ok ? x + (((size_t)b * F + f) * T + t) * C_in + c0 + 4 * half : x;
      gtt::cp_async16(xs + row * ROW + pos_off(pos) + 4 * half, src, ok ? 16 : 0);
    }
    for (int u = tid; u < W_UNITS; u += THREADS) {
      const int col = u % (BN / 4), r = (u / (BN / 4)) % KC, tap = u / (KC * BN / 4);
      gtt::cp_async16(ws + (tap * KC + r) * BN + 4 * col,
                      w + ((size_t)tap * C_in + c0 + r) * C_out + n0 + 4 * col, 16);
    }
  };
  auto apply_mask = [&](int s) {  // the input vectors this thread copied
    float* xs = smem + s * STAGE;
    for (int u = tid; u < X_UNITS; u += THREADS) {
      const int half = u & 1, pos = (u >> 1) % HT, row = (u >> 1) / HT;
      float4* p = reinterpret_cast<float4*>(xs + row * ROW + pos_off(pos) + 4 * half);
      const float m = ms[pos];
      float4 v = *p;
      v.x *= m;
      v.y *= m;
      v.z *= m;
      v.w *= m;
      *p = v;
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wrow = warp / WARPS_ROW, nj = lane % 8;
  const int tbase = 4 * TM * (warp % WARPS_ROW) + TM * (lane / 8);
  float acc[TM][8];
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[j][q] = 0.f;

  const int nk = C_in / KC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    gtt::cp_async_commit();
  }
  __syncthreads();  // the mask tile
  for (int k = 0; k < nk; ++k) {
    const int s = k % STAGES;
    gtt::cp_async_wait<STAGES - 2>();  // this thread's copies of chunk k landed
    apply_mask(s);
    __syncthreads();  // chunk k whole; chunk k - 1's stage free
    if (k + STAGES - 1 < nk) load(k + STAGES - 1, (k + STAGES - 1) % STAGES);
    gtt::cp_async_commit();
    const float* xs = smem + s * STAGE;
    chunk_fma(xs + wrow * ROW + pos_off(tbase), xs + X_STAGE + 4 * nj, acc);
  }

  const int f = f0 + wrow;
  if (f >= F) return;
  float4 b0 = make_float4(0.f, 0.f, 0.f, 0.f), b1 = b0;
  if (bias != nullptr) {
    b0 = *reinterpret_cast<const float4*>(bias + n0 + 4 * nj);
    b1 = *reinterpret_cast<const float4*>(bias + n0 + 32 + 4 * nj);
  }
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int t = t0 + tbase + j;
    if (t < T) {
      float* dst = y + (((size_t)b * F + f) * T + t) * C_out + n0 + 4 * nj;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[j][0] + b0.x, acc[j][1] + b0.y, acc[j][2] + b0.z, acc[j][3] + b0.w);
      *reinterpret_cast<float4*>(dst + 32) =
          make_float4(acc[j][4] + b1.x, acc[j][5] + b1.y, acc[j][6] + b1.z, acc[j][7] + b1.w);
    }
  }
}

// C_in = CIN, 2 or 3: one thread per (frame, 8 output channels), the 9 * CIN
// masked inputs read from global memory, the block's weights in shared
// memory. grid: (b, row, 32-frame band, channel block), channel block fastest.
template <int CIN>
__global__ void __launch_bounds__(SMALL_THREADS)
conv3x3_small_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     float* __restrict__ y, int F, int T, int C_out, int TT, int NT) {
  __shared__ float ws[9 * CIN * BN];
  int idx = blockIdx.x;
  const int nt = idx % NT;
  idx /= NT;
  const int tt = idx % TT;
  idx /= TT;
  const int f = idx % F, b = idx / F;
  const int n0 = nt * BN, tid = threadIdx.x;
  for (int i = tid; i < 9 * CIN * BN; i += SMALL_THREADS)
    ws[i] = w[(size_t)(i / BN) * C_out + n0 + i % BN];
  __syncthreads();
  const int t = tt * SMALL_FRAMES + tid / 8, nj = tid % 8;
  if (t >= T) return;
  float xv[9 * CIN];
#pragma unroll
  for (int df = 0; df < 3; ++df)
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      const int ff = f + df - 1, tq = t + dt - 1;
      const bool ok = ff >= 0 && ff < F && tq >= 0 && tq < T;
      const float m = ok ? mask[(size_t)b * T + tq] : 0.f;
#pragma unroll
      for (int c = 0; c < CIN; ++c)
        xv[(df * 3 + dt) * CIN + c] = ok ? x[(((size_t)b * F + ff) * T + tq) * CIN + c] * m : 0.f;
    }
  float acc[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    acc[q] = bias != nullptr ? bias[n0 + 4 * nj + q] : 0.f;
    acc[4 + q] = bias != nullptr ? bias[n0 + 32 + 4 * nj + q] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < 9 * CIN; ++k) {
    const float4 w0 = *reinterpret_cast<const float4*>(ws + k * BN + 4 * nj);
    const float4 w1 = *reinterpret_cast<const float4*>(ws + k * BN + 32 + 4 * nj);
    acc[0] = fmaf(xv[k], w0.x, acc[0]);
    acc[1] = fmaf(xv[k], w0.y, acc[1]);
    acc[2] = fmaf(xv[k], w0.z, acc[2]);
    acc[3] = fmaf(xv[k], w0.w, acc[3]);
    acc[4] = fmaf(xv[k], w1.x, acc[4]);
    acc[5] = fmaf(xv[k], w1.y, acc[5]);
    acc[6] = fmaf(xv[k], w1.z, acc[6]);
    acc[7] = fmaf(xv[k], w1.w, acc[7]);
  }
  float* dst = y + (((size_t)b * F + f) * T + t) * C_out + n0 + 4 * nj;
  *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(dst + 32) = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

template <int CIN>
cudaError_t launch_small(const float* x, const float* mask, const float* w, const float* bias,
                         float* y, int B, int F, int T, int C_out, cudaStream_t stream) {
  const int TT = (T + SMALL_FRAMES - 1) / SMALL_FRAMES, NT = C_out / BN;
  const long long blocks = (long long)B * F * TT * NT;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv3x3_small_kernel<CIN><<<(unsigned)blocks, SMALL_THREADS, 0, stream>>>(x, mask, w, bias, y, F, T,
                                                                      C_out, TT, NT);
  return cudaGetLastError();
}

}  // namespace

// x [B, F, T, C_in] and y [B, F, T, C_out] f32, 16-byte aligned; mask
// [B, T] f32; w [3, 3, C_in, C_out] f32; bias [C_out] f32 or NULL (no
// bias: the tangent). C_in 2, 3 or a multiple of 8, C_out a multiple of 64.
// Returns the launch's cudaError_t.
extern "C" int gtt_conv3x3(const void* x, const void* mask, const void* w, const void* bias,
                           void* y, int B, int F, int T, int C_in, int C_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0 || T <= 0 || C_in <= 0 || C_out <= 0 || C_out % BN != 0)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mask);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  switch (C_in) {
    case 2: return (int)launch_small<2>(xf, mf, wf, bf, yf, B, F, T, C_out, st);
    case 3: return (int)launch_small<3>(xf, mf, wf, bf, yf, B, F, T, C_out, st);
    default: break;
  }
  if (C_in % KC != 0) return (int)cudaErrorInvalidValue;
  const int FT = (F + BF - 1) / BF, TT = (T + BT - 1) / BT, NT = C_out / BN;
  const long long blocks = (long long)B * FT * TT * NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  conv3x3_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, st>>>(xf, mf, wf, bf, yf, F, T, C_in,
                                                                 C_out, FT, TT, NT);
  return (int)cudaGetLastError();
}
