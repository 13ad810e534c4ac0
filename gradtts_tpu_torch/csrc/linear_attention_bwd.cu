// Linear attention (+ ReZero residual) backward for Grad-TTS training:
// K4, the first sweep over (x, dy), and K5, the second.
//
// Replaces the Pallas TPU kernels gradtts_tpu/ops/pallas/linear_attention.py
// _bwd_sweep1_kernel (:329) and _bwd_sweep2_kernel (:381), driven by
// _backward_pallas (:444), in the phases=1 layout. The host algebra between
// the sweeps (dWout, dctx, dden from dA) is PyTorch, in
// gradtts_tpu_torch/ops/linear_attention.py.
//
// Function, for x, dy [B, N = F*T, C] and H = heads * dim_head = 128, with
// the Pallas kernels' rounding points (T = x's dtype, sums in f32):
//   K4, per row:  q = x Wq;  dA_b += q^T dy  (q and dy in f32)
//                 o = round_T(q) A_pre_b;  dgv += dy (o + b_out);  db += dy
//                 dq = dy A_full_b^T;  dWq += x^T round_T(dq)
//   K5, per row:  ek = exp(x Wk - m_b);  v = x Wv
//                 dk = round_T(ek (round_T(v) dctx_b^T + dden_b))
//                 dv = round_T(round_T(ek) dctx_b);  dq = round_T(dy A_full_b^T)
//                 dx = round_T(dy + [dq dk dv] [Wq Wk Wv]^T)
//                 dWk += x^T dk;  dWv += x^T dv
// dA is per batch item; dWq, db, dg, dWk and dWv are sums over the batch.
//
// What bounds it on the H100: per row K4 does 5*C*H multiply-adds and K5
// 8*C*H + 2*H*dim_head against 2*C input elements: at C 64 in bf16 that is
// ~160 (K4) and ~280 (K5) multiply-adds per byte, well above the ~10 at
// which the CUDA cores' 67 TFLOP/s meet 3.35 TB/s. This simple version
// does its products in f32 on the CUDA cores and is bound by that
// arithmetic; moving them to the bf16 tensor cores is the next step.
//
// Design. The TPU ran the grid in order and carried the batch-wide sums in
// scratch from the first grid step to the last. Here blocks run in any
// order on 132 SMs, so a grid of (S splits, B, roles) blocks each walks a
// contiguous chunk of one batch item's rows in tiles of R and writes its
// own partial sums; the wrapper adds the partials up in a fixed order (no
// atomics, so the result is deterministic). The accumulators live in
// registers, at most 64 per thread, so a block owns one slice of them (its
// role) and recomputes the row projections that slice needs:
//   K4: roles (dA, db, dgv) and (dWq), each split over column halves at
//       C 256: 2 * max(1, C / 128) roles;
//   K5: role 0 emits dx (no accumulators); role 1 + h accumulates head h's
//       columns of dWk and dWv ([C, 2 * dim_head]): 1 + H / dim_head roles.
//       dctx is block diagonal over the heads (the host masks it), so a
//       head's dk and dv need only its own columns of k, v and dctx: each
//       head role projects x onto its 32 columns alone, and role 0 sums
//       the dctx products over the head block of each column only.
// Row tiles, their projections and the dk|dv|dq tile sit in shared memory
// as f32; the weights are read from global memory through the caches.

#include "common.cuh"

namespace {

using gtt::from_f32;
using gtt::to_f32;

constexpr int H = 128;          // heads * dim_head of every U-Net attention
constexpr int DH = 32;          // dim_head of every U-Net attention
constexpr int R = 32;           // rows per tile
constexpr int THREADS = 256;
constexpr int RQ = R * H / THREADS;  // rows per thread of an [R, H] projection

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// N consecutive floats of shared memory into registers (16-byte loads when
// N is a multiple of 4; p is then 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// acc = a[R, K] (shared f32, row stride lda) @ w[K, H] (global T, row-major)
// for this thread's column tid % H and rows (tid / H) * RQ + [0, RQ). ROUND
// rounds each element of a to T first. HEAD_BLOCK sums only over the rows
// k of w in the head block of the column (w zero elsewhere; skipping the
// zero terms leaves every partial sum as it was).
template <typename T, int K, bool ROUND, bool HEAD_BLOCK = false>
__device__ __forceinline__ void project_h(const float* __restrict__ a, int lda,
                                          const T* __restrict__ w, float (&acc)[RQ]) {
  const int col = threadIdx.x % H, r0 = (threadIdx.x / H) * RQ;
  const int k_begin = HEAD_BLOCK ? col / DH * DH : 0;
  const int k_end = HEAD_BLOCK ? k_begin + DH : K;
#pragma unroll
  for (int r = 0; r < RQ; ++r) acc[r] = 0.f;
#pragma unroll 2
  for (int k = k_begin; k < k_end; k += 4) {
    const float w0 = to_f32(w[(k + 0) * H + col]);
    const float w1 = to_f32(w[(k + 1) * H + col]);
    const float w2 = to_f32(w[(k + 2) * H + col]);
    const float w3 = to_f32(w[(k + 3) * H + col]);
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      float4 av = *reinterpret_cast<const float4*>(a + (r0 + r) * lda + k);
      if (ROUND) {
        av.x = round_to<T>(av.x);
        av.y = round_to<T>(av.y);
        av.z = round_to<T>(av.z);
        av.w = round_to<T>(av.w);
      }
      acc[r] = fmaf(av.x, w0, acc[r]);
      acc[r] = fmaf(av.y, w1, acc[r]);
      acc[r] = fmaf(av.z, w2, acc[r]);
      acc[r] = fmaf(av.w, w3, acc[r]);
    }
  }
}

// o = s[R, K] (shared f32, row stride lds) @ w[K, NC] (global T, row stride
// ldw) for this thread's column tid % NC and rows (tid / NC) * RPT + [0, RPT).
template <typename T, int NC, int K, bool ROUND>
__device__ __forceinline__ void project_c(const float* __restrict__ s, int lds,
                                          const T* __restrict__ w, int ldw,
                                          float (&o)[R * NC / THREADS]) {
  constexpr int RPT = R * NC / THREADS;
  static_assert(THREADS % NC == 0 && RPT >= 1, "unsupported column count");
  const int oc = threadIdx.x % NC, or0 = (threadIdx.x / NC) * RPT;
#pragma unroll
  for (int r = 0; r < RPT; ++r) o[r] = 0.f;
#pragma unroll 2
  for (int d = 0; d < K; d += 4) {
    const float c0 = to_f32(w[(d + 0) * ldw + oc]);
    const float c1 = to_f32(w[(d + 1) * ldw + oc]);
    const float c2 = to_f32(w[(d + 2) * ldw + oc]);
    const float c3 = to_f32(w[(d + 3) * ldw + oc]);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float4 sv = *reinterpret_cast<const float4*>(s + (or0 + r) * lds + d);
      if (ROUND) {
        sv.x = round_to<T>(sv.x);
        sv.y = round_to<T>(sv.y);
        sv.z = round_to<T>(sv.z);
        sv.w = round_to<T>(sv.w);
      }
      o[r] = fmaf(sv.x, c0, o[r]);
      o[r] = fmaf(sv.y, c1, o[r]);
      o[r] = fmaf(sv.z, c2, o[r]);
      o[r] = fmaf(sv.w, c3, o[r]);
    }
  }
}

// acc[i][j] += sum over rows r < n of a[r, I*ty + i] * b[r, J*tx + j], with
// (ty, tx) = (tid / 16, tid % 16): the 256 threads tile a [16 I, 16 J]
// accumulator. a and b are shared f32 with row strides lda and ldb.
template <int I, int J>
__device__ __forceinline__ void outer_acc(float (&acc)[I][J], const float* __restrict__ a, int lda,
                                          const float* __restrict__ b, int ldb, int n) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  a += I * ty;
  b += J * tx;
  for (int r = 0; r < n; ++r) {
    float av[I], bv[J];
    load_vec<I>(a + r * lda, av);
    load_vec<J>(b + r * ldb, bv);
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T, int C>
struct Bwd1 {
  static constexpr int CP = C < 128 ? C : 128;  // accumulator columns of a block
  static constexpr int P = C / CP;
  static constexpr int ROLES = 2 * P;
  static constexpr size_t SMEM = ((size_t)2 * R * C + (size_t)R * H) * sizeof(float);
};

template <typename T, int C>
struct Bwd2 {
  static constexpr int ROLES = 1 + H / DH;
  static constexpr size_t SMEM = ((size_t)2 * R * C + (size_t)5 * R * H) * sizeof(float);
};

// K4. grid (S, B, Bwd1::ROLES); role z / P: 0 = (dA, db, dgv), 1 = dWq,
// each over the column slice z % P of width CP.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
la_bwd1_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ wq,
               const T* __restrict__ afullt, const T* __restrict__ apre,
               const float* __restrict__ bout, float* __restrict__ da_part,
               float* __restrict__ dwq_part, float* __restrict__ db_part,
               float* __restrict__ dgv_part, int N, int chunk, int S) {
  using K = Bwd1<T, C>;
  constexpr int CP = K::CP, P = K::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [R, C]
  float* dys = xs + R * C;                          // [R, C]
  float* hs = dys + R * C;                          // [R, H]: q, or round(dq)

  const int tid = threadIdx.x;
  const int s = blockIdx.x, b = blockIdx.y;
  const int role = blockIdx.z / P, p = blockIdx.z % P;
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  x += (size_t)b * N * C;
  dy += (size_t)b * N * C;
  afullt += (size_t)b * C * H;
  apre += (size_t)b * H * C;
  const int col = tid % H, r0 = (tid / H) * RQ;
  const size_t bs = (size_t)b * S + s;

  if (role == 0) {
    constexpr int I = 8, J = CP / 16;
    constexpr int RPT = R * CP / THREADS;
    const int oc = tid % CP, or0 = (tid / CP) * RPT;
    const float bo = bout[p * CP + oc];
    float acc[I][J];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
    float dgv = 0.f, db = 0.f;
    for (int row0 = row_begin; row0 < row_end; row0 += R) {
      __syncthreads();  // the previous tile's shared reads are done
      gtt::load_rows_f32<T, C, R, THREADS>(x, row0, row_end, xs);
      gtt::load_rows_f32<T, C, R, THREADS>(dy, row0, row_end, dys);
      __syncthreads();
      const int nvalid = min(R, row_end - row0);
      float q[RQ];
      project_h<T, C, false>(xs, C, wq, q);
#pragma unroll
      for (int r = 0; r < RQ; ++r) hs[(r0 + r) * H + col] = q[r];
      __syncthreads();
      outer_acc<I, J>(acc, hs, H, dys + p * CP, C, nvalid);
      float o[RPT];
      project_c<T, CP, H, true>(hs, H, apre + p * CP, C, o);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float d = dys[(or0 + r) * C + p * CP + oc];
        dgv = fmaf(d, o[r] + bo, dgv);
        db += d;
      }
    }
    const int ty = tid / 16, tx = tid % 16;
    float* dst = da_part + bs * H * C;
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) dst[(I * ty + i) * C + p * CP + J * tx + j] = acc[i][j];
    // sum dgv and db over the THREADS / CP row groups of each column
    __syncthreads();
    xs[tid] = dgv;
    xs[THREADS + tid] = db;
    __syncthreads();
    if (tid < CP) {
      float sg = 0.f, sb = 0.f;
      for (int grp = 0; grp < THREADS / CP; ++grp) {
        sg += xs[grp * CP + tid];
        sb += xs[THREADS + grp * CP + tid];
      }
      dgv_part[bs * C + p * CP + tid] = sg;
      db_part[bs * C + p * CP + tid] = sb;
    }
  } else {
    constexpr int I = CP / 16, J = 8;
    float acc[I][J];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
    for (int row0 = row_begin; row0 < row_end; row0 += R) {
      __syncthreads();
      gtt::load_rows_f32<T, C, R, THREADS>(x, row0, row_end, xs);
      gtt::load_rows_f32<T, C, R, THREADS>(dy, row0, row_end, dys);
      __syncthreads();
      const int nvalid = min(R, row_end - row0);
      float dq[RQ];
      project_h<T, C, false>(dys, C, afullt, dq);
#pragma unroll
      for (int r = 0; r < RQ; ++r) hs[(r0 + r) * H + col] = round_to<T>(dq[r]);
      __syncthreads();
      outer_acc<I, J>(acc, xs + p * CP, C, hs, H, nvalid);
    }
    const int ty = tid / 16, tx = tid % 16;
    float* dst = dwq_part + bs * C * H;
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) dst[(p * CP + I * ty + i) * H + J * tx + j] = acc[i][j];
  }
}

// K5. grid (S, B, Bwd2::ROLES); role 0 emits dx, role 1 + h accumulates
// head h's columns of [dWk dWv].
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
la_bwd2_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ wk,
               const T* __restrict__ wv, const T* __restrict__ afullt,
               const T* __restrict__ wqkv_t, const float* __restrict__ m,
               const T* __restrict__ dctx_t, const T* __restrict__ dctx,
               const float* __restrict__ dden, T* __restrict__ dx,
               float* __restrict__ dwkv_part, int N, int chunk, int S) {
  constexpr int H3 = 3 * H;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [R, C]
  float* dys = xs + R * C;                          // [R, C]
  float* eks = dys + R * C;                         // [R, H] exp(k - m), f32
  float* vs = eks + R * H;                          // [R, H] round(v)
  float* ds = vs + R * H;                           // [R, 3H] round(dq | dk | dv)

  const int tid = threadIdx.x;
  const int s = blockIdx.x, b = blockIdx.y;
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  x += (size_t)b * N * C;
  dy += (size_t)b * N * C;
  dx += (size_t)b * N * C;
  afullt += (size_t)b * C * H;
  dctx_t += (size_t)b * H * H;
  dctx += (size_t)b * H * H;

  if (blockIdx.z == 0) {
    const int col = tid % H, r0 = (tid / H) * RQ;
    const float m_c = m[b * H + col];
    const float dden_c = dden[b * H + col];
    constexpr int RPT = R * C / THREADS;
    const int oc = tid % C, or0 = (tid / C) * RPT;
    for (int row0 = row_begin; row0 < row_end; row0 += R) {
      __syncthreads();
      gtt::load_rows_f32<T, C, R, THREADS>(x, row0, row_end, xs);
      gtt::load_rows_f32<T, C, R, THREADS>(dy, row0, row_end, dys);
      __syncthreads();
      const int nvalid = min(R, row_end - row0);
      {
        float k[RQ], v[RQ];
        project_h<T, C, false>(xs, C, wk, k);
        project_h<T, C, false>(xs, C, wv, v);
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          eks[(r0 + r) * H + col] = r0 + r < nvalid ? expf(k[r] - m_c) : 0.f;
          vs[(r0 + r) * H + col] = round_to<T>(v[r]);
        }
      }
      __syncthreads();
      {
        float dek[RQ], dv[RQ], dq[RQ];
        project_h<T, H, false, true>(vs, H, dctx_t, dek);
        project_h<T, H, true, true>(eks, H, dctx, dv);
        project_h<T, C, false>(dys, C, afullt, dq);
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const float e = eks[(r0 + r) * H + col];
          ds[(r0 + r) * H3 + col] = round_to<T>(dq[r]);
          ds[(r0 + r) * H3 + H + col] = round_to<T>(e * (dek[r] + dden_c));
          ds[(r0 + r) * H3 + 2 * H + col] = round_to<T>(dv[r]);
        }
      }
      __syncthreads();
      float o[RPT];
      project_c<T, C, H3, false>(ds, H3, wqkv_t, C, o);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = row0 + or0 + r;
        if (row < row_end)
          dx[(size_t)row * C + oc] = from_f32<T>(dys[(or0 + r) * C + oc] + o[r]);
      }
    }
    return;
  }

  // head role: head hd's 32 columns of k, v, dk and dv, and its columns of
  // dWk, dWv accumulated over the rows
  const int hd = blockIdx.z - 1;
  float* ekh = eks;                                 // [R, DH] exp(k - m)
  float* vh = vs;                                   // [R, DH] round(v)
  float* dkv = ds;                                  // [R, 2 DH] round(dk | dv)
  constexpr int RPT = R * DH / THREADS;
  const int oc = tid % DH, or0 = (tid / DH) * RPT;
  const float m_c = m[b * H + hd * DH + oc];
  const float dden_c = dden[b * H + hd * DH + oc];
  const T* dctx_t_h = dctx_t + (size_t)hd * DH * H + hd * DH;  // its diagonal block
  const T* dctx_h = dctx + (size_t)hd * DH * H + hd * DH;
  constexpr int I = C / 16, J = 2 * DH / 16;
  float acc[I][J];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;

  for (int row0 = row_begin; row0 < row_end; row0 += R) {
    __syncthreads();
    gtt::load_rows_f32<T, C, R, THREADS>(x, row0, row_end, xs);
    __syncthreads();
    const int nvalid = min(R, row_end - row0);
    {
      float k[RPT], v[RPT];
      project_c<T, DH, C, false>(xs, C, wk + hd * DH, H, k);
      project_c<T, DH, C, false>(xs, C, wv + hd * DH, H, v);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        ekh[(or0 + r) * DH + oc] = or0 + r < nvalid ? expf(k[r] - m_c) : 0.f;
        vh[(or0 + r) * DH + oc] = round_to<T>(v[r]);
      }
    }
    __syncthreads();
    {
      float dek[RPT], dv[RPT];
      project_c<T, DH, DH, false>(vh, DH, dctx_t_h, H, dek);
      project_c<T, DH, DH, true>(ekh, DH, dctx_h, H, dv);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float e = ekh[(or0 + r) * DH + oc];
        dkv[(or0 + r) * 2 * DH + oc] = round_to<T>(e * (dek[r] + dden_c));
        dkv[(or0 + r) * 2 * DH + DH + oc] = round_to<T>(dv[r]);
      }
    }
    __syncthreads();
    outer_acc<I, J>(acc, xs, C, dkv, 2 * DH, nvalid);
  }
  // column j of acc: dWk column hd * DH + j for j < DH, else dWv column
  // hd * DH + j - DH (stored at H + that in [dWk dWv])
  const int ty = tid / 16, tx = tid % 16;
  float* dst = dwkv_part + ((size_t)b * S + s) * C * 2 * H;
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int jj = J * tx + j;
      const int out_col = (jj < DH ? 0 : H - DH) + hd * DH + jj;
      dst[(I * ty + i) * 2 * H + out_col] = acc[i][j];
    }
}

template <typename T, int C>
cudaError_t launch_bwd1(const void* x, const void* dy, const void* wq, const void* afullt,
                        const void* apre, const void* bout, void* da_part, void* dwq_part,
                        void* db_part, void* dgv_part, int B, int N, int chunk, int S,
                        cudaStream_t stream) {
  using K = Bwd1<T, C>;
  cudaError_t err = cudaFuncSetAttribute(la_bwd1_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (err != cudaSuccess) return err;
  la_bwd1_kernel<T, C><<<dim3(S, B, K::ROLES), THREADS, K::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(wq),
      static_cast<const T*>(afullt), static_cast<const T*>(apre), static_cast<const float*>(bout),
      static_cast<float*>(da_part), static_cast<float*>(dwq_part), static_cast<float*>(db_part),
      static_cast<float*>(dgv_part), N, chunk, S);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_bwd2(const void* x, const void* dy, const void* wk, const void* wv,
                        const void* afullt, const void* wqkv_t, const void* m, const void* dctx_t,
                        const void* dctx, const void* dden, void* dx, void* dwkv_part, int B,
                        int N, int chunk, int S, cudaStream_t stream) {
  using K = Bwd2<T, C>;
  cudaError_t err = cudaFuncSetAttribute(la_bwd2_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (err != cudaSuccess) return err;
  la_bwd2_kernel<T, C><<<dim3(S, B, K::ROLES), THREADS, K::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(wk),
      static_cast<const T*>(wv), static_cast<const T*>(afullt), static_cast<const T*>(wqkv_t),
      static_cast<const float*>(m), static_cast<const T*>(dctx_t), static_cast<const T*>(dctx),
      static_cast<const float*>(dden), static_cast<T*>(dx), static_cast<float*>(dwkv_part), N,
      chunk, S);
  return cudaGetLastError();
}

}  // namespace

// K4. x, dy [B, N, C]; wq [C, 128]; afullt [B, C, 128]; apre [B, 128, C], all
// in x's dtype; bout [C] f32. Partial outputs per split s of rows
// [s * chunk, min(N, (s + 1) * chunk)), all f32: da_part [B, S, 128, C],
// dwq_part [B, S, C, 128], db_part and dgv_part [B, S, C].
extern "C" int gtt_la_bwd1(const void* x, const void* dy, const void* wq, const void* afullt,
                           const void* apre, const void* bout, void* da_part, void* dwq_part,
                           void* db_part, void* dgv_part, int B, int N, int C, int chunk, int S,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gtt::kBFloat16) {
    GTT_DISPATCH_C(launch_bwd1, __nv_bfloat16, x, dy, wq, afullt, apre, bout, da_part, dwq_part,
                   db_part, dgv_part, B, N, chunk, S, st)
  }
  if (dtype == gtt::kFloat32) {
    GTT_DISPATCH_C(launch_bwd1, float, x, dy, wq, afullt, apre, bout, da_part, dwq_part, db_part,
                   dgv_part, B, N, chunk, S, st)
  }
  return (int)cudaErrorInvalidValue;
}

// K5. x, dy [B, N, C]; wk, wv [C, 128]; afullt [B, C, 128]; wqkv_t
// [3 * 128, C] (Wq^T, Wk^T, Wv^T stacked); dctx_t, dctx [B, 128, 128], all
// in x's dtype; m, dden [B, 128] f32. Outputs dx [B, N, C] in x's dtype and
// dwkv_part [B, S, C, 256] f32 (dWk | dWv per split).
extern "C" int gtt_la_bwd2(const void* x, const void* dy, const void* wk, const void* wv,
                           const void* afullt, const void* wqkv_t, const void* m,
                           const void* dctx_t, const void* dctx, const void* dden, void* dx,
                           void* dwkv_part, int B, int N, int C, int chunk, int S, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gtt::kBFloat16) {
    GTT_DISPATCH_C(launch_bwd2, __nv_bfloat16, x, dy, wk, wv, afullt, wqkv_t, m, dctx_t, dctx,
                   dden, dx, dwkv_part, B, N, chunk, S, st)
  }
  if (dtype == gtt::kFloat32) {
    GTT_DISPATCH_C(launch_bwd2, float, x, dy, wk, wv, afullt, wqkv_t, m, dctx_t, dctx, dden, dx,
                   dwkv_part, B, N, chunk, S, st)
  }
  return (int)cudaErrorInvalidValue;
}
