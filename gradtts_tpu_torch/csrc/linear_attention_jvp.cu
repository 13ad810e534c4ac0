// Forward-mode tangent of the linear attention (+ ReZero residual) for the
// Grad-TTS U-Net under the likelihood engine's Hutchinson jvp: K6, the
// statistics and their tangents, and K7, the apply pass and its tangent.
//
// Replaces the Pallas TPU kernels gradtts_tpu/ops/pallas/linear_attention.py
// _jvp_stats_kernel (:651, driven by _jvp_pallas :742) and _jvp_apply_kernel
// (:724).
//
// Function, for x and its tangent dx [B, N = F*T, C], H = 128 = 4 heads of
// DH = 32, the weights W* and their tangents dW* [C, H] (dW* may be absent):
//   K6: per batch item and split of the rows, k = x Wk, v = x Wv and their
//       tangents dk = dx Wk + x dWk, dv = dx Wv + x dWv (f32 accumulation,
//       never rounded), and under one online running max m over the rows
//       (stop-gradient): ek = exp(k - m), dek = ek * dk; the head-diagonal
//       blocks of ctx = sum ek v^T and dctx = sum dek v^T + ek dv^T
//       [4, 32, 32] each, den = sum ek and dden = sum dek [H], all f32.
//   K7: q = x Wq and dq = dx Wq + x dWq, each rounded to x's dtype;
//       y = q A + bias + x and dy = q dA + dq A + dbias + dx, where A, dA
//       [B, H, C] (x's dtype) and bias, dbias [C] (f32) are the host fold
//       of K6's merged statistics; y and dy rounded once, at the end.
//
// What bounds it on the H100: per row, K6 does (2 + 2 * has_dW) * C * H
// multiply-adds for the projections and 3 * DH * H for the two context
// blocks, against 2 * C input elements read; K7 does (3 + has_dW) * C * H
// + 3 * H * C against 2 * C read and 2 * C written. At the top U-Net level
// (C = 64, bf16) that is ~200 FMAs per byte, far above the ~10 FMAs a byte
// at which the CUDA cores' 67 TFLOP/s meet 3.35 TB/s: this simple version
// runs on the CUDA cores in f32 and is bound by that arithmetic. Against
// the bf16 tensor cores (989 TFLOP/s, ~150 FMAs a byte) the same work
// sits near the balance point; moving the products there is the next step.
//
// Design: the layouts of K2 and K3 (csrc/linear_attention.cu). A (S splits,
// B) grid fills the 132 SMs; each block walks its chunk of rows in tiles of
// R rows of x AND dx, staged as f32 in shared memory. In K6 threads [0, H)
// own a column of (k, dk) and threads [H, 2H) a column of (v, dv); the
// context is accumulated only on the four head-diagonal 32x32 blocks (the
// fold reads no other entry), each thread owning a 4x4 tile of ctx and the
// same of dctx: 32 accumulators, where K2's full context takes 64. Each
// split writes its partial (m, ctx, den, dctx, dden); the wrapper merges
// them with the exp(m_s - m) rescale, tangents alike. In K7 threads own a
// q column for the projections and an output column for y and dy. Weights
// (and in K7 this batch item's A and dA) are staged in shared memory when
// they fit and read from global memory (L2) when they do not.

#include "common.cuh"

namespace {

using gtt::from_f32;
using gtt::to_f32;

constexpr int H = 128;          // heads * dim_head of every U-Net attention
constexpr int DH = 32;          // dim_head
constexpr int NH = H / DH;      // heads
constexpr int R = 32;           // rows per tile
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;   // running-max initial value (Pallas _NEG)
constexpr int SMEM_LIMIT = 200 * 1024;

static_assert(THREADS == 2 * H, "K6: one thread per column of k and of v");
static_assert(NH * (DH / 4) * (DH / 4) == THREADS,
              "K6: one 4x4 tile of the head-diagonal blocks per thread");

__host__ __device__ constexpr size_t jstats_smem_f32(int C) {
  return (2 * (size_t)R * C + 4 * (size_t)R * H + H) * sizeof(float);
}
__host__ __device__ constexpr size_t japply_smem_f32(int C) {
  return (2 * (size_t)R * C + 2 * (size_t)R * H) * sizeof(float);
}

// K6. grid (S, B); block THREADS.
template <typename T, int C, bool DW>
__global__ void __launch_bounds__(THREADS)
la_jvp_stats_kernel(const T* __restrict__ x, const T* __restrict__ dx,
                    const T* __restrict__ wk_g, const T* __restrict__ wv_g,
                    const T* __restrict__ dwk_g, const T* __restrict__ dwv_g,
                    float* __restrict__ m_out, float* __restrict__ ctx_out,
                    float* __restrict__ den_out, float* __restrict__ dctx_out,
                    float* __restrict__ dden_out, int N, int chunk, int S, int w_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [R, C]
  float* dxs = xs + R * C;                         // [R, C]
  float* eks = dxs + R * C;                        // [R, H] exp(k - m)
  float* deks = eks + R * H;                       // [R, H] its tangent
  float* vs = deks + R * H;                        // [R, H]
  float* dvs = vs + R * H;                         // [R, H]
  float* alpha_s = dvs + R * H;                    // [H] rescale of this tile
  T* w_s = reinterpret_cast<T*>(alpha_s + H);      // [2 or 4, C, H] if staged

  const int tid = threadIdx.x;
  const int s = blockIdx.x, b = blockIdx.y;
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  x += (size_t)b * N * C;
  dx += (size_t)b * N * C;

  const T* wk = wk_g;
  const T* wv = wv_g;
  const T* dwk = dwk_g;
  const T* dwv = dwv_g;
  if (w_in_smem) {
    gtt::copy_vec16(wk_g, w_s, C * H);
    gtt::copy_vec16(wv_g, w_s + C * H, C * H);
    wk = w_s;
    wv = w_s + C * H;
    if (DW) {
      gtt::copy_vec16(dwk_g, w_s + 2 * C * H, C * H);
      gtt::copy_vec16(dwv_g, w_s + 3 * C * H, C * H);
      dwk = w_s + 2 * C * H;
      dwv = w_s + 3 * C * H;
    }
  }
  const bool is_k = tid < H;
  const int col = tid % H;
  const T* w = is_k ? wk : wv;
  const T* dw = is_k ? dwk : dwv;
  // this thread's 4x4 tile of the head-diagonal blocks: head hd, rows
  // [d0, d0 + 4) and columns [e0, e0 + 4) of the [H, H] context
  const int hd = tid / ((DH / 4) * (DH / 4));
  const int within = tid % ((DH / 4) * (DH / 4));
  const int d0 = hd * DH + 4 * (within / (DH / 4));
  const int e0 = hd * DH + 4 * (within % (DH / 4));

  float m_run = NEG, den_run = 0.f, dden_run = 0.f;  // used by the k threads
  float acc[4][4], dacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = dacc[i][j] = 0.f;

  for (int row0 = row_begin; row0 < row_end; row0 += R) {
    __syncthreads();  // weights staged; previous tile's shared reads done
    gtt::load_rows_f32<T, C, R, THREADS>(x, row0, row_end, xs);
    gtt::load_rows_f32<T, C, R, THREADS>(dx, row0, row_end, dxs);
    __syncthreads();
    const int nvalid = min(R, row_end - row0);

    float p[R], tp[R];  // this column's primal and tangent projections
#pragma unroll
    for (int r = 0; r < R; ++r) p[r] = tp[r] = 0.f;
    for (int c = 0; c < C; c += 4) {
      float wc[4], dwc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wc[i] = to_f32(w[(c + i) * H + col]);
        dwc[i] = DW ? to_f32(dw[(c + i) * H + col]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * C + c);
        const float4 dxv = *reinterpret_cast<const float4*>(dxs + r * C + c);
        p[r] = fmaf(xv.x, wc[0], p[r]);
        p[r] = fmaf(xv.y, wc[1], p[r]);
        p[r] = fmaf(xv.z, wc[2], p[r]);
        p[r] = fmaf(xv.w, wc[3], p[r]);
        tp[r] = fmaf(dxv.x, wc[0], tp[r]);
        tp[r] = fmaf(dxv.y, wc[1], tp[r]);
        tp[r] = fmaf(dxv.z, wc[2], tp[r]);
        tp[r] = fmaf(dxv.w, wc[3], tp[r]);
        if (DW) {
          tp[r] = fmaf(xv.x, dwc[0], tp[r]);
          tp[r] = fmaf(xv.y, dwc[1], tp[r]);
          tp[r] = fmaf(xv.z, dwc[2], tp[r]);
          tp[r] = fmaf(xv.w, dwc[3], tp[r]);
        }
      }
    }

    if (is_k) {
      float tmax = NEG;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nvalid) tmax = fmaxf(tmax, p[r]);
      const float m_new = fmaxf(m_run, tmax);
      const float a = expf(m_run - m_new);
      float dsum = 0.f, ddsum = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float e = r < nvalid ? expf(p[r] - m_new) : 0.f;
        const float de = e * tp[r];  // m is stop-gradient
        eks[r * H + col] = e;
        deks[r * H + col] = de;
        dsum += e;
        ddsum += de;
      }
      den_run = den_run * a + dsum;
      dden_run = dden_run * a + ddsum;
      m_run = m_new;
      alpha_s[col] = a;
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        vs[r * H + col] = r < nvalid ? p[r] : 0.f;
        dvs[r * H + col] = r < nvalid ? tp[r] : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[d0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= a;
        dacc[i][j] *= a;
      }
    }
    for (int r = 0; r < nvalid; ++r) {
      const float4 e4 = *reinterpret_cast<const float4*>(eks + r * H + d0);
      const float4 de4 = *reinterpret_cast<const float4*>(deks + r * H + d0);
      const float4 v4 = *reinterpret_cast<const float4*>(vs + r * H + e0);
      const float4 dv4 = *reinterpret_cast<const float4*>(dvs + r * H + e0);
      const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
      const float dev[4] = {de4.x, de4.y, de4.z, de4.w};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      const float dvv[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(ev[i], vv[j], acc[i][j]);
          dacc[i][j] = fmaf(dev[i], vv[j], dacc[i][j]);
          dacc[i][j] = fmaf(ev[i], dvv[j], dacc[i][j]);
        }
    }
  }

  // blocks [B, S, NH, DH, DH]: row d0 - hd*DH + i, columns e0 - hd*DH + [0, 4)
  const size_t bs = (size_t)b * S + s;
  const size_t blk = (bs * NH + hd) * DH * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t off = blk + (size_t)(d0 - hd * DH + i) * DH + (e0 - hd * DH);
    *reinterpret_cast<float4*>(ctx_out + off) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dctx_out + off) =
        make_float4(dacc[i][0], dacc[i][1], dacc[i][2], dacc[i][3]);
  }
  if (is_k) {
    m_out[bs * H + col] = m_run;
    den_out[bs * H + col] = den_run;
    dden_out[bs * H + col] = dden_run;
  }
}

// K7. grid (S, B); block THREADS. For q and dq every thread owns column
// tid % H of R/2 rows; for y and dy column tid % C of R*C/THREADS
// consecutive rows.
template <typename T, int C, bool DW>
__global__ void __launch_bounds__(THREADS)
la_jvp_apply_kernel(const T* __restrict__ x, const T* __restrict__ dx,
                    const T* __restrict__ wq_g, const T* __restrict__ dwq_g,
                    const T* __restrict__ a_g, const T* __restrict__ da_g,
                    const float* __restrict__ bias, const float* __restrict__ dbias,
                    T* __restrict__ y, T* __restrict__ dy, int N, int chunk, int w_in_smem) {
  constexpr int RQ = R * H / THREADS;  // q rows per thread
  constexpr int RPT = R * C / THREADS; // output rows per thread
  static_assert(THREADS % C == 0 && RPT >= 1, "unsupported channel count");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [R, C]
  float* dxs = xs + R * C;                         // [R, C]
  float* qs = dxs + R * C;                         // [R, H]
  float* dqs = qs + R * H;                         // [R, H]
  T* w_s = reinterpret_cast<T*>(dqs + R * H);      // Wq, A[b], dA[b] (, dWq)

  const int tid = threadIdx.x;
  const int s = blockIdx.x, b = blockIdx.y;
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  x += (size_t)b * N * C;
  dx += (size_t)b * N * C;
  y += (size_t)b * N * C;
  dy += (size_t)b * N * C;
  a_g += (size_t)b * H * C;
  da_g += (size_t)b * H * C;

  const T* wq = wq_g;
  const T* dwq = dwq_g;
  const T* a = a_g;
  const T* da = da_g;
  if (w_in_smem) {
    gtt::copy_vec16(wq_g, w_s, C * H);
    gtt::copy_vec16(a_g, w_s + C * H, H * C);
    gtt::copy_vec16(da_g, w_s + 2 * C * H, H * C);
    wq = w_s;
    a = w_s + C * H;
    da = w_s + 2 * C * H;
    if (DW) {
      gtt::copy_vec16(dwq_g, w_s + 3 * C * H, C * H);
      dwq = w_s + 3 * C * H;
    }
  }
  const int qcol = tid % H, qr0 = (tid / H) * RQ;
  const int oc = tid % C, or0 = (tid / C) * RPT;
  const float bias_c = bias[oc], dbias_c = dbias[oc];

  for (int row0 = row_begin; row0 < row_end; row0 += R) {
    __syncthreads();
    gtt::load_rows_f32<T, C, R, THREADS>(x, row0, row_end, xs);
    gtt::load_rows_f32<T, C, R, THREADS>(dx, row0, row_end, dxs);
    __syncthreads();

    float q[RQ], dq[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) q[r] = dq[r] = 0.f;
    for (int c = 0; c < C; c += 4) {
      float wc[4], dwc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wc[i] = to_f32(wq[(c + i) * H + qcol]);
        dwc[i] = DW ? to_f32(dwq[(c + i) * H + qcol]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + (qr0 + r) * C + c);
        const float4 dxv = *reinterpret_cast<const float4*>(dxs + (qr0 + r) * C + c);
        q[r] = fmaf(xv.x, wc[0], q[r]);
        q[r] = fmaf(xv.y, wc[1], q[r]);
        q[r] = fmaf(xv.z, wc[2], q[r]);
        q[r] = fmaf(xv.w, wc[3], q[r]);
        dq[r] = fmaf(dxv.x, wc[0], dq[r]);
        dq[r] = fmaf(dxv.y, wc[1], dq[r]);
        dq[r] = fmaf(dxv.z, wc[2], dq[r]);
        dq[r] = fmaf(dxv.w, wc[3], dq[r]);
        if (DW) {
          dq[r] = fmaf(xv.x, dwc[0], dq[r]);
          dq[r] = fmaf(xv.y, dwc[1], dq[r]);
          dq[r] = fmaf(xv.z, dwc[2], dq[r]);
          dq[r] = fmaf(xv.w, dwc[3], dq[r]);
        }
      }
    }
    // q and dq are rounded to x's dtype before their products (:731-732)
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      qs[(qr0 + r) * H + qcol] = to_f32(from_f32<T>(q[r]));
      dqs[(qr0 + r) * H + qcol] = to_f32(from_f32<T>(dq[r]));
    }
    __syncthreads();

    float o[RPT], od[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) o[r] = od[r] = 0.f;
    for (int d = 0; d < H; d += 4) {
      float ac[4], dac[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ac[i] = to_f32(a[(d + i) * C + oc]);
        dac[i] = to_f32(da[(d + i) * C + oc]);
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (or0 + r) * H + d);
        const float4 dqv = *reinterpret_cast<const float4*>(dqs + (or0 + r) * H + d);
        o[r] = fmaf(qv.x, ac[0], o[r]);
        o[r] = fmaf(qv.y, ac[1], o[r]);
        o[r] = fmaf(qv.z, ac[2], o[r]);
        o[r] = fmaf(qv.w, ac[3], o[r]);
        od[r] = fmaf(qv.x, dac[0], od[r]);
        od[r] = fmaf(qv.y, dac[1], od[r]);
        od[r] = fmaf(qv.z, dac[2], od[r]);
        od[r] = fmaf(qv.w, dac[3], od[r]);
        od[r] = fmaf(dqv.x, ac[0], od[r]);
        od[r] = fmaf(dqv.y, ac[1], od[r]);
        od[r] = fmaf(dqv.z, ac[2], od[r]);
        od[r] = fmaf(dqv.w, ac[3], od[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + or0 + r;
      if (row < row_end) {
        const int i = (or0 + r) * C + oc;
        y[(size_t)row * C + oc] = from_f32<T>(o[r] + bias_c + xs[i]);
        dy[(size_t)row * C + oc] = from_f32<T>(od[r] + dbias_c + dxs[i]);
      }
    }
  }
}

template <typename T, int C, bool DW>
cudaError_t launch_stats_dw(const void* x, const void* dx, const void* wk, const void* wv,
                            const void* dwk, const void* dwv, void* m, void* ctx, void* den,
                            void* dctx, void* dden, int B, int N, int chunk, int S,
                            cudaStream_t stream) {
  const size_t w_bytes = (DW ? 4 : 2) * (size_t)C * H * sizeof(T);
  const int w_in_smem = jstats_smem_f32(C) + w_bytes <= SMEM_LIMIT;
  const size_t smem = jstats_smem_f32(C) + (w_in_smem ? w_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(la_jvp_stats_kernel<T, C, DW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  la_jvp_stats_kernel<T, C, DW><<<dim3(S, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dx), static_cast<const T*>(wk),
      static_cast<const T*>(wv), static_cast<const T*>(dwk), static_cast<const T*>(dwv),
      static_cast<float*>(m), static_cast<float*>(ctx), static_cast<float*>(den),
      static_cast<float*>(dctx), static_cast<float*>(dden), N, chunk, S, w_in_smem);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_stats(const void* x, const void* dx, const void* wk, const void* wv,
                         const void* dwk, const void* dwv, void* m, void* ctx, void* den,
                         void* dctx, void* dden, int B, int N, int chunk, int S,
                         cudaStream_t stream) {
  if (dwk != nullptr)
    return launch_stats_dw<T, C, true>(x, dx, wk, wv, dwk, dwv, m, ctx, den, dctx, dden, B, N,
                                       chunk, S, stream);
  return launch_stats_dw<T, C, false>(x, dx, wk, wv, dwk, dwv, m, ctx, den, dctx, dden, B, N,
                                      chunk, S, stream);
}

template <typename T, int C, bool DW>
cudaError_t launch_apply_dw(const void* x, const void* dx, const void* wq, const void* dwq,
                            const void* a, const void* da, const void* bias, const void* dbias,
                            void* y, void* dy, int B, int N, int chunk, int S,
                            cudaStream_t stream) {
  const size_t w_bytes = (DW ? 4 : 3) * (size_t)C * H * sizeof(T);
  const int w_in_smem = japply_smem_f32(C) + w_bytes <= SMEM_LIMIT;
  const size_t smem = japply_smem_f32(C) + (w_in_smem ? w_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(la_jvp_apply_kernel<T, C, DW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  la_jvp_apply_kernel<T, C, DW><<<dim3(S, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dx), static_cast<const T*>(wq),
      static_cast<const T*>(dwq), static_cast<const T*>(a), static_cast<const T*>(da),
      static_cast<const float*>(bias), static_cast<const float*>(dbias), static_cast<T*>(y),
      static_cast<T*>(dy), N, chunk, w_in_smem);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_apply(const void* x, const void* dx, const void* wq, const void* dwq,
                         const void* a, const void* da, const void* bias, const void* dbias,
                         void* y, void* dy, int B, int N, int chunk, int S, cudaStream_t stream) {
  if (dwq != nullptr)
    return launch_apply_dw<T, C, true>(x, dx, wq, dwq, a, da, bias, dbias, y, dy, B, N, chunk,
                                       S, stream);
  return launch_apply_dw<T, C, false>(x, dx, wq, dwq, a, da, bias, dbias, y, dy, B, N, chunk,
                                      S, stream);
}

}  // namespace

// x, dx [B, N, C]; wk, wv and (both or neither NULL) dwk, dwv [C, 128] in
// x's dtype; outputs f32 m, den, dden [B, S, 128] and the head-diagonal
// blocks ctx, dctx [B, S, 4, 32, 32]. Split s covers rows
// [s * chunk, min(N, (s + 1) * chunk)). Returns the launch's cudaError_t.
extern "C" int gtt_la_jvp_stats(const void* x, const void* dx, const void* wk, const void* wv,
                                const void* dwk, const void* dwv, void* m, void* ctx, void* den,
                                void* dctx, void* dden, int B, int N, int C, int chunk, int S,
                                int dtype, void* stream) {
  if ((dwk == nullptr) != (dwv == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gtt::kBFloat16) {
    GTT_DISPATCH_C(launch_stats, __nv_bfloat16, x, dx, wk, wv, dwk, dwv, m, ctx, den, dctx, dden,
                   B, N, chunk, S, st)
  }
  if (dtype == gtt::kFloat32) {
    GTT_DISPATCH_C(launch_stats, float, x, dx, wk, wv, dwk, dwv, m, ctx, den, dctx, dden, B, N,
                   chunk, S, st)
  }
  return (int)cudaErrorInvalidValue;
}

// x, dx [B, N, C]; wq and (or NULL) dwq [C, 128], a, da [B, 128, C] in x's
// dtype; bias, dbias [C] f32; y, dy [B, N, C] in x's dtype. Returns the
// launch's cudaError_t.
extern "C" int gtt_la_jvp_apply(const void* x, const void* dx, const void* wq, const void* dwq,
                                const void* a, const void* da, const void* bias,
                                const void* dbias, void* y, void* dy, int B, int N, int C,
                                int chunk, int S, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gtt::kBFloat16) {
    GTT_DISPATCH_C(launch_apply, __nv_bfloat16, x, dx, wq, dwq, a, da, bias, dbias, y, dy, B, N,
                   chunk, S, st)
  }
  if (dtype == gtt::kFloat32) {
    GTT_DISPATCH_C(launch_apply, float, x, dx, wq, dwq, a, da, bias, dbias, y, dy, B, N, chunk,
                   S, st)
  }
  return (int)cudaErrorInvalidValue;
}
