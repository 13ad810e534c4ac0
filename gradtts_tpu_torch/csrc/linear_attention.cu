// Linear attention (+ ReZero residual) forward for the Grad-TTS U-Net:
// K2, the context statistics, and K3, the apply pass.
//
// Replaces the Pallas TPU kernels gradtts_tpu/ops/pallas/linear_attention.py
// _stats_kernel (:58, driven by _forward :146) and _apply_kernel (:113).
//
// Function, for x [B, N = F*T, C] and H = heads * dim_head = 128:
//   K2: per batch item, k = x Wk, v = x Wv (f32 accumulation), and with an
//       online running max m over the rows: ctx = sum_rows exp(k - m) v^T
//       [H, H] and den = sum_rows exp(k - m) [H], all f32.
//   K3: out = x + (x Wq rounded to x's dtype) ctx2 + bias, where ctx2
//       [B, H, C] and bias [C] are the tiny host fold of (ctx, den) with the
//       head block-diagonal mask, Wout and the ReZero gain.
//
// What bounds it on the H100: per row, K2 does C*2H + H*H multiply-adds and
// K3 does 2*C*H, against C input elements read (and C written by K3). At
// the top U-Net level (C = 64, bf16) K2 does 256 FMAs per byte of x, far
// above the ~10 FMAs (20 flops) per byte at which the CUDA cores' 67 TFLOP/s
// meets 3.35 TB/s: this simple version runs on the CUDA cores in f32 and is
// bound by that arithmetic, not by memory. On the bf16 tensor cores (989
// TFLOP/s, ~150 FMAs per byte) the same work would sit near the balance
// point; that, and skipping the off-diagonal head blocks of the context,
// is the next step.
//
// Design: the TPU grid walked each batch item's rows in order on one core
// and carried the running max in scratch. Here a grid of (S splits, B)
// blocks fills the 132 SMs: each block walks a contiguous chunk of rows in
// tiles of R, keeps its running (m, den) per column in registers and its
// [H, H] context as an 8x8 register block per thread, and writes one
// partial (m_s, ctx_s, den_s); the wrapper merges the S partials with the
// same exp(m_s - m) rescale. Weights are staged once per block in shared
// memory (when they fit), x tiles are staged as f32, and every shared read
// in the inner loops is a broadcast or a 16-byte vector.

#include "common.cuh"

namespace {

using gtt::from_f32;
using gtt::to_f32;

constexpr int H = 128;          // heads * dim_head of every U-Net attention
constexpr int R = 32;           // rows per tile
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;   // running-max initial value (Pallas _NEG)
constexpr int SMEM_LIMIT = 200 * 1024;

__host__ __device__ constexpr size_t stats_smem_f32(int C) {
  return ((size_t)R * C + 2 * (size_t)R * H + H) * sizeof(float);
}
__host__ __device__ constexpr size_t apply_smem_f32(int C) {
  return ((size_t)R * C + (size_t)R * H) * sizeof(float);
}

// K2. grid (S, B); block THREADS. Threads [0, H) own k column tid, threads
// [H, 2H) own v column tid - H; for the context every thread owns the 8x8
// block d in [8*(tid/16), +8), e in [8*(tid%16), +8).
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
la_stats_kernel(const T* __restrict__ x, const T* __restrict__ wk_g, const T* __restrict__ wv_g,
                float* __restrict__ m_out, float* __restrict__ ctx_out,
                float* __restrict__ den_out, int N, int chunk, int S, int w_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [R, C]
  float* eks = xs + R * C;                         // [R, H] exp(k - m)
  float* vs = eks + R * H;                         // [R, H]
  float* alpha_s = vs + R * H;                     // [H] rescale of this tile
  T* w_s = reinterpret_cast<T*>(alpha_s + H);      // [2, C, H] if staged

  const int tid = threadIdx.x;
  const int s = blockIdx.x, b = blockIdx.y;
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  x += (size_t)b * N * C;

  const T* wk = wk_g;
  const T* wv = wv_g;
  if (w_in_smem) {
    gtt::copy_vec16(wk_g, w_s, C * H);
    gtt::copy_vec16(wv_g, w_s + C * H, C * H);
    wk = w_s;
    wv = w_s + C * H;
  }
  const bool is_k = tid < H;
  const int col = tid % H;
  const T* w = is_k ? wk : wv;
  const int dg = tid / 16, eg = tid % 16;

  float m_run = NEG, den_run = 0.f;  // used by the k threads
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int row0 = row_begin; row0 < row_end; row0 += R) {
    __syncthreads();  // weights staged; previous tile's shared reads done
    gtt::load_rows_f32<T, C, R, THREADS>(x, row0, row_end, xs);
    __syncthreads();
    const int nvalid = min(R, row_end - row0);

    float kv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) kv[r] = 0.f;
#pragma unroll 2
    for (int c = 0; c < C; c += 4) {
      const float w0 = to_f32(w[(c + 0) * H + col]);
      const float w1 = to_f32(w[(c + 1) * H + col]);
      const float w2 = to_f32(w[(c + 2) * H + col]);
      const float w3 = to_f32(w[(c + 3) * H + col]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * C + c);
        kv[r] = fmaf(xv.x, w0, kv[r]);
        kv[r] = fmaf(xv.y, w1, kv[r]);
        kv[r] = fmaf(xv.z, w2, kv[r]);
        kv[r] = fmaf(xv.w, w3, kv[r]);
      }
    }

    if (is_k) {
      float tmax = NEG;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nvalid) tmax = fmaxf(tmax, kv[r]);
      const float m_new = fmaxf(m_run, tmax);
      const float a = expf(m_run - m_new);
      float dsum = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float e = r < nvalid ? expf(kv[r] - m_new) : 0.f;
        eks[r * H + col] = e;
        dsum += e;
      }
      den_run = den_run * a + dsum;
      m_run = m_new;
      alpha_s[col] = a;
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) vs[r * H + col] = r < nvalid ? kv[r] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = alpha_s[dg * 8 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= a;
    }
    for (int r = 0; r < nvalid; ++r) {
      const float4 e0 = *reinterpret_cast<const float4*>(eks + r * H + dg * 8);
      const float4 e1 = *reinterpret_cast<const float4*>(eks + r * H + dg * 8 + 4);
      const float4 v0 = *reinterpret_cast<const float4*>(vs + r * H + eg * 8);
      const float4 v1 = *reinterpret_cast<const float4*>(vs + r * H + eg * 8 + 4);
      const float ev[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ev[i], vv[j], acc[i][j]);
    }
  }

  const size_t bs = (size_t)b * S + s;
  float* ctx_p = ctx_out + bs * H * H;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* dst = ctx_p + (dg * 8 + i) * H + eg * 8;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (is_k) {
    m_out[bs * H + col] = m_run;
    den_out[bs * H + col] = den_run;
  }
}

// K3. grid (S, B); block THREADS. For q every thread owns column tid % H of
// R/2 rows; for the output every thread owns column tid % C of R*C/THREADS
// consecutive rows.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
la_apply_kernel(const T* __restrict__ x, const T* __restrict__ wq_g, const T* __restrict__ ctx2_g,
                const float* __restrict__ bias, T* __restrict__ out, int N, int chunk,
                int w_in_smem) {
  constexpr int RQ = R * H / THREADS;  // q rows per thread
  constexpr int RPT = R * C / THREADS; // output rows per thread
  static_assert(THREADS % C == 0 && RPT >= 1, "unsupported channel count");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [R, C]
  float* qs = xs + R * C;                          // [R, H]
  T* w_s = reinterpret_cast<T*>(qs + R * H);       // Wq [C, H], ctx2[b] [H, C]

  const int tid = threadIdx.x;
  const int s = blockIdx.x, b = blockIdx.y;
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  x += (size_t)b * N * C;
  out += (size_t)b * N * C;
  ctx2_g += (size_t)b * H * C;

  const T* wq = wq_g;
  const T* ctx2 = ctx2_g;
  if (w_in_smem) {
    gtt::copy_vec16(wq_g, w_s, C * H);
    gtt::copy_vec16(ctx2_g, w_s + C * H, H * C);
    wq = w_s;
    ctx2 = w_s + C * H;
  }
  const int qcol = tid % H, qr0 = (tid / H) * RQ;
  const int oc = tid % C, or0 = (tid / C) * RPT;
  const float bias_c = bias[oc];

  for (int row0 = row_begin; row0 < row_end; row0 += R) {
    __syncthreads();
    gtt::load_rows_f32<T, C, R, THREADS>(x, row0, row_end, xs);
    __syncthreads();

    float q[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) q[r] = 0.f;
#pragma unroll 2
    for (int c = 0; c < C; c += 4) {
      const float w0 = to_f32(wq[(c + 0) * H + qcol]);
      const float w1 = to_f32(wq[(c + 1) * H + qcol]);
      const float w2 = to_f32(wq[(c + 2) * H + qcol]);
      const float w3 = to_f32(wq[(c + 3) * H + qcol]);
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + (qr0 + r) * C + c);
        q[r] = fmaf(xv.x, w0, q[r]);
        q[r] = fmaf(xv.y, w1, q[r]);
        q[r] = fmaf(xv.z, w2, q[r]);
        q[r] = fmaf(xv.w, w3, q[r]);
      }
    }
    // q is rounded to x's dtype before the second product (_apply_kernel :118)
#pragma unroll
    for (int r = 0; r < RQ; ++r) qs[(qr0 + r) * H + qcol] = to_f32(from_f32<T>(q[r]));
    __syncthreads();

    float o[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) o[r] = 0.f;
#pragma unroll 2
    for (int d = 0; d < H; d += 4) {
      const float c0 = to_f32(ctx2[(d + 0) * C + oc]);
      const float c1 = to_f32(ctx2[(d + 1) * C + oc]);
      const float c2 = to_f32(ctx2[(d + 2) * C + oc]);
      const float c3 = to_f32(ctx2[(d + 3) * C + oc]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (or0 + r) * H + d);
        o[r] = fmaf(qv.x, c0, o[r]);
        o[r] = fmaf(qv.y, c1, o[r]);
        o[r] = fmaf(qv.z, c2, o[r]);
        o[r] = fmaf(qv.w, c3, o[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + or0 + r;
      if (row < row_end)
        out[(size_t)row * C + oc] = from_f32<T>(o[r] + bias_c + xs[(or0 + r) * C + oc]);
    }
  }
}

template <typename T, int C>
cudaError_t launch_stats(const void* x, const void* wk, const void* wv, void* m, void* ctx,
                         void* den, int B, int N, int chunk, int S, cudaStream_t stream) {
  const size_t w_bytes = 2 * (size_t)C * H * sizeof(T);
  const int w_in_smem = stats_smem_f32(C) + w_bytes <= SMEM_LIMIT;
  const size_t smem = stats_smem_f32(C) + (w_in_smem ? w_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(la_stats_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  la_stats_kernel<T, C><<<dim3(S, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk), static_cast<const T*>(wv),
      static_cast<float*>(m), static_cast<float*>(ctx), static_cast<float*>(den), N, chunk, S,
      w_in_smem);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_apply(const void* x, const void* wq, const void* ctx2, const void* bias,
                         void* out, int B, int N, int chunk, int S, cudaStream_t stream) {
  const size_t w_bytes = 2 * (size_t)C * H * sizeof(T);
  const int w_in_smem = apply_smem_f32(C) + w_bytes <= SMEM_LIMIT;
  const size_t smem = apply_smem_f32(C) + (w_in_smem ? w_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(la_apply_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  la_apply_kernel<T, C><<<dim3(S, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wq), static_cast<const T*>(ctx2),
      static_cast<const float*>(bias), static_cast<T*>(out), N, chunk, w_in_smem);
  return cudaGetLastError();
}

}  // namespace

// x [B, N, C]; wk, wv [C, 128] in x's dtype; outputs f32 m [B, S, 128],
// ctx [B, S, 128, 128], den [B, S, 128]. Split s covers rows
// [s * chunk, min(N, (s + 1) * chunk)). Returns the launch's cudaError_t.
extern "C" int gtt_la_stats(const void* x, const void* wk, const void* wv, void* m, void* ctx,
                            void* den, int B, int N, int C, int chunk, int S, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gtt::kBFloat16) {
    GTT_DISPATCH_C(launch_stats, __nv_bfloat16, x, wk, wv, m, ctx, den, B, N, chunk, S, st)
  }
  if (dtype == gtt::kFloat32) {
    GTT_DISPATCH_C(launch_stats, float, x, wk, wv, m, ctx, den, B, N, chunk, S, st)
  }
  return (int)cudaErrorInvalidValue;
}

// x [B, N, C]; wq [C, 128] and ctx2 [B, 128, C] in x's dtype; bias [C] f32;
// out [B, N, C] in x's dtype. Returns the launch's cudaError_t.
extern "C" int gtt_la_apply(const void* x, const void* wq, const void* ctx2, const void* bias,
                            void* out, int B, int N, int C, int chunk, int S, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gtt::kBFloat16) {
    GTT_DISPATCH_C(launch_apply, __nv_bfloat16, x, wq, ctx2, bias, out, B, N, chunk, S, st)
  }
  if (dtype == gtt::kFloat32) {
    GTT_DISPATCH_C(launch_apply, float, x, wq, ctx2, bias, out, B, N, chunk, S, st)
  }
  return (int)cudaErrorInvalidValue;
}
