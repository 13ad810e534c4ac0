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
// ~160 (K4) and ~280 (K5) multiply-adds per byte, above the ~150 at which
// the tensor cores' 989 TFLOP/s meet 3.35 TB/s, and far above the ~10 of
// the CUDA cores' 67 TFLOP/s. So both are bound by their products.
//
// Design common to both. The TPU ran the grid in order and carried the
// batch-wide sums in scratch from the first grid step to the last. Here
// blocks run in any order on 132 SMs, so each block walks a contiguous
// chunk of one batch item's rows and writes its own partial sums; the
// wrapper adds the partials up in a fixed order (no atomics, so the result
// is deterministic).
//
// K5 in bf16 (the training path's): two kernels on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators, ldmatrix from
// swizzled shared tiles; every product the Pallas kernel takes in bf16 is
// one here, with the same rounding points).
//   la_bwd2_dx_kernel, grid (S, B), 4 warps: Wk, Wv, Wq and the batch
//     item's A_full^T [C, H] and dctx's four diagonal 32 x 32 blocks stay
//     in shared memory for the block's life; x and dy stream through a
//     cp.async ring of 64-row tiles, one m16 row block a warp. Head by
//     head, a warp projects its rows onto the head's columns of Wk and Wv,
//     forms ek, dk and dv there, and dq from dy; each, rounded to bf16,
//     stays in registers as an A fragment (96 registers for the four
//     heads). Then dx = dy + [dq dk dv] [Wq Wk Wv]^T over 64 output
//     columns at a time (the same weight tiles, read by ldmatrix without
//     .trans), rounded once, written over the dy tile and stored 16 bytes
//     a lane. At C 256 the four [C, H] operands would take 256 KB: Wq and
//     A_full are read from global memory (L2) as 4-byte fragments instead,
//     and the ring has one stage.
//   la_bwd2_dw_kernel, grid (S_w, B, 4 heads), 8 warps: the head's columns
//     of Wk and Wv and its dctx block in shared memory, x in a two-stage
//     ring of 128-row tiles. Each warp recomputes k, v, dk and dv of the
//     head for 16 rows (the recompute is cheap on the tensor cores) and
//     hands dk | dv to a bf16 exchange tile; then the block adds
//     x^T [dk | dv] ([C, 64], x by ldmatrix.trans) into f32 accumulators
//     split over its warps, and writes them once, as its split's partial.
//     Splitting the dW columns by head keeps the accumulators at C / 4 a
//     thread or fewer.
// K4 in bf16 (the training path's): one kernel on the tensor cores,
// la_bwd1_tc_kernel, grid (S, B, 4 heads), 8 warps. Every product of the
// sweep separates by head with no recompute: q_h = x Wq[:, h], dq_h = dy
// A_full^T[:, h], dA's rows of head h are q_h^T dy and dWq's columns of
// head h are x^T dq_h. So a block keeps its head's Wq and A_full^T columns
// ([C, 32] each) in shared memory and streams x and dy through a cp.async
// ring of 128-row (C <= 64) or 64-row tiles. Each warp projects 16 rows
// (q or dq) and hands them to bf16 exchange tiles; dA needs q in f32, so q
// goes as hi = round(q) and lo = round(q - hi) (hi + lo = q to ~2^-17 of
// it; dy is exact in bf16) and dA = hi^T dy + lo^T dy. The block then adds
// hi^T dy, lo^T dy and dq^T x over the tile's rows. dgv needs no o = round
// (q) A_pre product: summed over the rows, dy * o reassociates to
// sum_h A_pre[h, c] (round(q)^T dy)[h, c], which the epilogue forms from
// the hi^T dy sums; db comes from the dy fragments of the head-0 blocks.
// That is 5 C H multiply-adds a row, the function's own count. A thread
// holds 48 (C <= 128) or 96 (C 256) f32 accumulators for the three sums.
// Each block writes f32 partials; the wrapper adds them in a fixed order.
// K4 and K5 in f32 (the parity route; TF32 is off) keep the CUDA-core
// design: a grid of (S splits, B, roles) blocks each walks its chunk in
// tiles of R rows; the accumulators live in registers, at most 64 per
// thread, so a block owns one slice of them (its role) and recomputes the
// row projections that slice needs:
//   K4: roles (dA, db, dgv) and (dWq), each split over column halves at
//       C 256: 2 * max(1, C / 128) roles;
//   K5: role 0 emits dx (no accumulators); role 1 + h accumulates head h's
//       columns of dWk and dWv ([C, 2 * dim_head]): 1 + H / dim_head roles.
//       dctx is block diagonal over the heads (the host masks it), so a
//       head's dk and dv need only its own columns of k, v and dctx: each
//       head role projects x onto its 32 columns alone, and role 0 sums
//       the dctx products over the head block of each column only.
// Their row tiles, projections and the dk|dv|dq tile sit in shared memory
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

// ---- K5 in bf16: tensor cores -----------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int NH = H / DH;      // heads
constexpr int TR = 64;          // dx kernel: rows per tile, one m16 row block per warp
constexpr int DX_WARPS = TR / 16;
constexpr int TRW = 128;        // dW kernel: rows per tile, one m16 row block per warp
constexpr int DW_WARPS = TRW / 16;
constexpr int SMEM_MAX = 227 * 1024;

// The dx kernel's layout at channel count C: Wk and Wv [C, H] in shared
// memory, and Wq and this batch item's A_full^T [C, H] beside them where
// they fit (C <= 128); at C 256 the four would take 256 KB, so Wq and
// A_full are read from global memory (L2) as 4-byte fragments, and the
// ring has one stage.
template <int C>
struct Bwd2Dx {
  static constexpr bool WQA_SMEM = C <= 128;
  // C <= 128: dx [16, C] accumulates head by head (at most 64 registers);
  // C 256: the four heads' fragments are kept, and dx goes NC columns at a
  // time
  static constexpr bool PER_HEAD = C <= 128;
  static constexpr int STAGES = WQA_SMEM ? 2 : 1;
  static constexpr int NC = C < 64 ? C : 64;  // dx columns per pass
  using WT = gtt::RowTile<H>;
  using XT = gtt::RowTile<C>;
  using DT = gtt::RowTile<DH>;
  __host__ __device__ static constexpr size_t smem() {
    return (WQA_SMEM ? 4 : 2) * (size_t)WT::bytes(C) + DT::bytes(H) + 2 * H * sizeof(float) +
           STAGES * 2 * (size_t)XT::bytes(TR);
  }
};

// The dW kernel's layout at channel count C: head hd's columns of Wk and Wv
// side by side ([C, 64]), its diagonal block of dctx, a two-stage ring of x
// tiles and the [TRW, 64] bf16 exchange tile of dk | dv. dW_hd = x^T [dk |
// dv] is [C, 64]; its C / 16 row tiles and 8 column tiles are split over
// the warps, WM along the rows and WN along the columns.
template <int C>
struct Bwd2Dw {
  static constexpr int MT = C / 16;
  static constexpr int WM = MT < DW_WARPS ? MT : DW_WARPS;
  static constexpr int WN = DW_WARPS / WM;
  static constexpr int PM = MT / WM;  // row tiles per warp
  static constexpr int PN = 8 / WN;   // column tiles per warp
  static constexpr int STAGES = 2;
  using KT = gtt::RowTile<2 * DH>;
  using XT = gtt::RowTile<C>;
  using DT = gtt::RowTile<DH>;
  __host__ __device__ static constexpr size_t smem() {
    return (size_t)KT::bytes(C) + DT::bytes(DH) + 2 * DH * sizeof(float) +
           STAGES * (size_t)XT::bytes(TRW) + KT::bytes(TRW);
  }
  static_assert(WM * WN == DW_WARPS && PM * WM == MT && PN * WN == 8, "K5 dW: warp layout");
};

// Accumulators of a [16, 32] product (n-tile j = columns 8j..) as the bf16
// A fragments of the next product (k-step kk = columns 16kk..): one mma's
// accumulator layout is the next one's operand layout.
__device__ __forceinline__ void pack_a(const float (&p)[4][4], uint32_t (&f)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    f[kk][0] = gtt::pack_bf16x2(p[2 * kk][0], p[2 * kk][1]);
    f[kk][1] = gtt::pack_bf16x2(p[2 * kk][2], p[2 * kk][3]);
    f[kk][2] = gtt::pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    f[kk][3] = gtt::pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&p)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
}

// k and v of one head for a warp's 16 rows: x (A, from the x tile xt at
// row arow) times the head's 32 columns of Wk and Wv, which start at chunk
// column ck of wk_s and cv of wv_s, [C, *] tiles of type WT (B, by
// ldmatrix.trans).
template <int C, typename WT>
__device__ __forceinline__ void project_kv(unsigned char* xt, int arow, unsigned char* wk_s,
                                           int ck, unsigned char* wv_s, int cv, int lane,
                                           float (&pk)[4][4], float (&pv)[4][4]) {
  using XT = gtt::RowTile<C>;
  zero(pk);
  zero(pv);
#pragma unroll 4
  for (int ks = 0; ks < C / 16; ++ks) {
    uint32_t a[4];
    gtt::ldmatrix_x4(a, XT::at(xt, arow, 2 * ks + lane / 16));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t w[4];
      gtt::ldmatrix_x4_trans(w, WT::at(wk_s, 16 * ks + lane % 16, ck + 2 * np + lane / 16));
      gtt::mma_bf16_16816(pk[2 * np], a, w[0], w[1]);
      gtt::mma_bf16_16816(pk[2 * np + 1], a, w[2], w[3]);
      gtt::ldmatrix_x4_trans(w, WT::at(wv_s, 16 * ks + lane % 16, cv + 2 * np + lane / 16));
      gtt::mma_bf16_16816(pv[2 * np], a, w[0], w[1]);
      gtt::mma_bf16_16816(pv[2 * np + 1], a, w[2], w[3]);
    }
  }
}

// One head's dk and dv from its k and v (accumulators pk, pv; rows g and
// g + 8 of the warp's 16, nv of them valid) and its diagonal block of dctx
// (rows d0.. of the [*, DH] tile dctx_s), as _bwd_sweep2_kernel :401-408:
//   ek = exp(k - m) (0 past the valid rows),
//   dk = ek (round(v) dctx^T + dden),  dv = round(ek) dctx,
// in f32 accumulators (the caller rounds them). m_h, dden_h: the head's
// 32 columns. pk is left holding ek.
__device__ __forceinline__ void dk_dv(float (&pk)[4][4], const float (&pv)[4][4],
                                      unsigned char* dctx_s, int d0, const float* m_h,
                                      const float* dden_h, int nv, int lane, float (&dk)[4][4],
                                      float (&dv)[4][4]) {
  using DT = gtt::RowTile<DH>;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pk[j][e] = g + 8 * (e >> 1) < nv ? expf(pk[j][e] - m_h[8 * j + 2 * q + (e & 1)]) : 0.f;
  uint32_t vf[2][4], ekf[2][4];
  pack_a(pv, vf);
  pack_a(pk, ekf);
  zero(dk);
  zero(dv);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t w[4];
      // round(v) dctx^T: B[e][d] = dctx[d][e], the tile's rows are d
      gtt::ldmatrix_x4(w, DT::at(dctx_s, d0 + 16 * np + lane % 8 + 8 * (lane / 16),
                                 2 * kk + (lane / 8) % 2));
      gtt::mma_bf16_16816(dk[2 * np], vf[kk], w[0], w[1]);
      gtt::mma_bf16_16816(dk[2 * np + 1], vf[kk], w[2], w[3]);
      // round(ek) dctx: B[d][e] = dctx[d][e]
      gtt::ldmatrix_x4_trans(w, DT::at(dctx_s, d0 + 16 * kk + lane % 16, 2 * np + lane / 16));
      gtt::mma_bf16_16816(dv[2 * np], ekf[kk], w[0], w[1]);
      gtt::mma_bf16_16816(dv[2 * np + 1], ekf[kk], w[2], w[3]);
    }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dk[j][e] = pk[j][e] * (dk[j][e] + dden_h[8 * j + 2 * q + (e & 1)]);
}

// One head's dq, dk and dv [16, 32] for a warp's 16 rows (from row r_w of
// the x and dy tiles), rounded to bf16 (_bwd_sweep2_kernel :406-410) as
// the A fragments of dx's products. dq = dy A_full^T from the shared
// A_full^T tile af_s (WQA_SMEM) or from A_full [H, C] in global memory.
template <int C, bool WQA_SMEM>
__device__ __forceinline__ void head_grads(unsigned char* xt, unsigned char* dyt, int r_w,
                                           unsigned char* wk_s, unsigned char* wv_s,
                                           unsigned char* af_s, const bf16* __restrict__ afull,
                                           unsigned char* dctx_s, const float* m_s,
                                           const float* dden_s, int hd, int nv, int lane,
                                           uint32_t (&fq)[2][4], uint32_t (&fk)[2][4],
                                           uint32_t (&fv)[2][4]) {
  using WT = gtt::RowTile<H>;
  using XT = gtt::RowTile<C>;
  const int g = lane / 4, q = lane % 4;
  {
    float pk[4][4], pv[4][4], dk[4][4], dv[4][4];
    project_kv<C, WT>(xt, r_w + lane % 16, wk_s, hd * DH / 8, wv_s, hd * DH / 8, lane, pk, pv);
    dk_dv(pk, pv, dctx_s, hd * DH, m_s + hd * DH, dden_s + hd * DH, nv, lane, dk, dv);
    pack_a(dk, fk);
    pack_a(dv, fv);
  }
  float dq[4][4];
  zero(dq);
#pragma unroll 4
  for (int ks = 0; ks < C / 16; ++ks) {
    uint32_t a[4];
    gtt::ldmatrix_x4(a, XT::at(dyt, r_w + lane % 16, 2 * ks + lane / 16));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t w[4];
      if constexpr (WQA_SMEM) {
        gtt::ldmatrix_x4_trans(
            w, WT::at(af_s, 16 * ks + lane % 16, (hd * DH + 16 * np) / 8 + lane / 16));
      } else {  // B[c][h] = A_full[h][c]: two consecutive c are 4 bytes
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = __ldg(reinterpret_cast<const unsigned int*>(
              afull + (size_t)(hd * DH + 16 * np + 8 * (u / 2) + g) * C + 16 * ks + 8 * (u % 2) +
              2 * q));
      }
      gtt::mma_bf16_16816(dq[2 * np], a, w[0], w[1]);
      gtt::mma_bf16_16816(dq[2 * np + 1], a, w[2], w[3]);
    }
  }
  pack_a(dq, fq);
}

// o (NCOL columns of dx from column n_base, f32) += dq Wq^T + dk Wk^T + dv
// Wv^T over head hd's 32 columns. B[h][c] = W[c][h]: the [C, H] weight
// tiles w_s (Wq, Wk, Wv) are read by ldmatrix without .trans, their rows
// being dx's columns; without WQ_SMEM, Wq comes from global memory, two
// consecutive h in 4 bytes.
template <int C, int NCOL, bool WQ_SMEM>
__device__ __forceinline__ void dx_accum(float (&o)[NCOL / 8][4], int n_base,
                                         const uint32_t (&fq)[2][4], const uint32_t (&fk)[2][4],
                                         const uint32_t (&fv)[2][4], int hd,
                                         unsigned char* const (&w_s)[3],
                                         const bf16* __restrict__ wq, int lane) {
  using WT = gtt::RowTile<H>;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int src = 0; src < 3; ++src)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t(&a)[4] = src == 0 ? fq[kk] : src == 1 ? fk[kk] : fv[kk];
      const int k0 = hd * DH + 16 * kk;
#pragma unroll
      for (int np = 0; np < NCOL / 16; ++np) {
        const int n0 = n_base + 16 * np;
        uint32_t w[4];
        if (WQ_SMEM || src != 0) {
          gtt::ldmatrix_x4(w, WT::at(w_s[src], n0 + lane % 8 + 8 * (lane / 16),
                                     k0 / 8 + (lane / 8) % 2));
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            w[u] = __ldg(reinterpret_cast<const unsigned int*>(
                wq + (size_t)(n0 + 8 * (u / 2) + g) * H + k0 + 8 * (u % 2) + 2 * q));
        }
        gtt::mma_bf16_16816(o[2 * np], a, w[0], w[1]);
        gtt::mma_bf16_16816(o[2 * np + 1], a, w[2], w[3]);
      }
    }
}

// dx = o + dy for NCOL columns from n_base of the warp's 16 rows, rounded
// once (as the Pallas kernel) and written over the dy tile
template <int C, int NCOL>
__device__ __forceinline__ void dx_epilogue(const float (&o)[NCOL / 8][4], int n_base,
                                            unsigned char* dyt, int r_w, int lane) {
  using XT = gtt::RowTile<C>;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < NCOL / 8; ++j) {
    const int col = n_base + 8 * j + 2 * q;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
          XT::at(dyt, r_w + g + 8 * hi, col / 8) + (col % 8) * 2);
      const float2 d = __bfloat1622float2(*p);
      *p = __floats2bfloat162_rn(o[j][2 * hi] + d.x, o[j][2 * hi + 1] + d.y);
    }
  }
}

// K5's dx, bf16. grid (S, B); block DX_WARPS warps, warp w owning rows
// 16 w.. of every TR-row tile. (With the block count per SM left open,
// ptxas holds this kernel to 128 registers at C <= 64 and spills; at one
// block an SM it takes what it needs, 165-254 registers.)
template <int C>
__global__ void __launch_bounds__(DX_WARPS * 32, 1)
la_bwd2_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  const bf16* __restrict__ wq, const bf16* __restrict__ wk,
                  const bf16* __restrict__ wv, const bf16* __restrict__ afullt,
                  const bf16* __restrict__ afull, const float* __restrict__ m,
                  const bf16* __restrict__ dctx, const float* __restrict__ dden,
                  bf16* __restrict__ dx, int N, int chunk) {
  using L = Bwd2Dx<C>;
  using WT = typename L::WT;
  using XT = typename L::XT;
  using DT = typename L::DT;
  constexpr int STAGES = L::STAGES, NC = L::NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* wk_s = smem_raw;                  // Wk [C, H]
  unsigned char* wv_s = wk_s + WT::bytes(C);       // Wv [C, H]
  unsigned char* dctx_s = wv_s + WT::bytes(C);     // dctx's diagonal blocks [H, DH]
  float* m_s = reinterpret_cast<float*>(dctx_s + DT::bytes(H));        // [H]
  float* dden_s = m_s + H;                                             // [H]
  unsigned char* ring = reinterpret_cast<unsigned char*>(dden_s + H);  // {x, dy} [TR, C]
  unsigned char* wq_s = ring + STAGES * 2 * XT::bytes(TR);  // Wq [C, H] (C <= 128)
  unsigned char* af_s = wq_s + WT::bytes(C);                // A_full^T [C, H] (C <= 128)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_w = 16 * warp;
  const int s = blockIdx.x, b = blockIdx.y;
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  const int n_tiles = (row_end - row_begin + TR - 1) / TR;
  x += (size_t)b * N * C;
  dy += (size_t)b * N * C;
  dx += (size_t)b * N * C;
  afullt += (size_t)b * C * H;
  afull += (size_t)b * H * C;
  dctx += (size_t)b * H * H;

  // one commit group per tile, the operands in the first: tiles
  // [0, STAGES - 1) ahead, then one more per tile consumed
  auto load_xdy = [&](int t) {
    if (t < n_tiles) {
      const int r0 = row_begin + t * TR;
      const int valid = min(TR, row_end - r0);
      unsigned char* slot = ring + (t % STAGES) * 2 * XT::bytes(TR);
      gtt::load_tile_async<C>(x + (size_t)r0 * C, TR, valid, slot);
      gtt::load_tile_async<C>(dy + (size_t)r0 * C, TR, valid, slot + XT::bytes(TR));
    }
    gtt::cp_async_commit();
  };
  gtt::load_tile_async<H>(wk, C, C, wk_s);
  gtt::load_tile_async<H>(wv, C, C, wv_s);
  if constexpr (L::WQA_SMEM) {
    gtt::load_tile_async<H>(wq, C, C, wq_s);
    gtt::load_tile_async<H>(afullt, C, C, af_s);
  }
#pragma unroll
  for (int hd = 0; hd < NH; ++hd)
    gtt::load_tile_async<DH>(dctx + (size_t)hd * DH * H + hd * DH, DH, DH,
                             dctx_s + DT::bytes(hd * DH), H);
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    m_s[i] = m[b * H + i];
    dden_s[i] = dden[b * H + i];
  }
  for (int t = 0; t < STAGES - 1; ++t) load_xdy(t);

  for (int t = 0; t < n_tiles; ++t) {
    const int row0 = row_begin + t * TR;
    load_xdy(t + STAGES - 1);           // into the slot tile t - 1 left
    gtt::cp_async_wait<STAGES - 1>();   // tiles <= t (and the operands) landed
    __syncthreads();
    unsigned char* xt = ring + (t % STAGES) * 2 * XT::bytes(TR);
    unsigned char* dyt = xt + XT::bytes(TR);
    const int nv = min(TR, row_end - row0) - r_w;  // this warp's valid rows

    if (nv > 0) {
      unsigned char* w_s[3] = {wq_s, wk_s, wv_s};
      auto grads = [&](int hd, uint32_t(&fq)[2][4], uint32_t(&fk)[2][4], uint32_t(&fv)[2][4]) {
        head_grads<C, L::WQA_SMEM>(xt, dyt, r_w, wk_s, wv_s, af_s, afull, dctx_s, m_s, dden_s,
                                   hd, nv, lane, fq, fk, fv);
      };
      if constexpr (L::PER_HEAD) {
        // dx accumulates head by head over all C columns: one head's
        // fragments live at a time
        float o[C / 8][4];
#pragma unroll
        for (int j = 0; j < C / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll 1
        for (int hd = 0; hd < NH; ++hd) {
          uint32_t fq[2][4], fk[2][4], fv[2][4];
          grads(hd, fq, fk, fv);
          dx_accum<C, C, true>(o, 0, fq, fk, fv, hd, w_s, wq, lane);
        }
        dx_epilogue<C, C>(o, 0, dyt, r_w, lane);
      } else {
        // the four heads' fragments live at once (96 registers), and dx
        // goes NC columns at a time
        uint32_t fq[NH][2][4], fk[NH][2][4], fv[NH][2][4];
#pragma unroll
        for (int hd = 0; hd < NH; ++hd) grads(hd, fq[hd], fk[hd], fv[hd]);
#pragma unroll 1
        for (int cc = 0; cc < C / NC; ++cc) {
          float o[NC / 8][4];
#pragma unroll
          for (int j = 0; j < NC / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
          for (int hd = 0; hd < NH; ++hd)
            dx_accum<C, NC, L::WQA_SMEM>(o, cc * NC, fq[hd], fk[hd], fv[hd], hd, w_s, wq, lane);
          dx_epilogue<C, NC>(o, cc * NC, dyt, r_w, lane);
        }
      }
      __syncwarp();
      constexpr int CH = C / 8;
      for (int i = lane; i < 16 * CH; i += 32) {
        const int r = i / CH, c = i % CH;
        if (r < nv)
          *reinterpret_cast<uint4*>(dx + (size_t)(row0 + r_w + r) * C + c * 8) =
              *reinterpret_cast<const uint4*>(XT::at(dyt, r_w + r, c));
      }
    }
    __syncthreads();  // every warp is done with ring slot t % STAGES
  }
}

// K5's dWk and dWv, bf16. grid (S, B, NH): block (s, b, hd) sums head hd's
// columns x^T [dk | dv] over its rows into its partial. Block DW_WARPS
// warps; in phase 1 warp w owns rows 16 w.. of every TRW-row tile, in
// phase 2 a (PM, PN) share of the [C, 64] sum.
template <int C>
__global__ void __launch_bounds__(DW_WARPS * 32)
la_bwd2_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                  const bf16* __restrict__ wv, const float* __restrict__ m,
                  const bf16* __restrict__ dctx, const float* __restrict__ dden,
                  float* __restrict__ dwkv_part, int N, int chunk, int S) {
  using L = Bwd2Dw<C>;
  using KT = typename L::KT;
  using XT = typename L::XT;
  using DT = typename L::DT;
  constexpr int STAGES = L::STAGES, PM = L::PM, PN = L::PN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* wkv_s = smem_raw;                  // [Wk | Wv] head columns [C, 64]
  unsigned char* dctx_s = wkv_s + KT::bytes(C);     // dctx's diagonal block [DH, DH]
  float* m_s = reinterpret_cast<float*>(dctx_s + DT::bytes(DH));        // [DH]
  float* dden_s = m_s + DH;                                             // [DH]
  unsigned char* ring = reinterpret_cast<unsigned char*>(dden_s + DH);  // x [TRW, C]
  unsigned char* xch = ring + STAGES * XT::bytes(TRW);                  // [dk | dv] [TRW, 64]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int r_w = 16 * warp;
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int s = blockIdx.x, b = blockIdx.y, hd = blockIdx.z;
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  const int n_tiles = (row_end - row_begin + TRW - 1) / TRW;
  x += (size_t)b * N * C;
  dctx += (size_t)b * H * H + (size_t)hd * DH * H + hd * DH;

  auto load_x = [&](int t) {
    if (t < n_tiles) {
      const int r0 = row_begin + t * TRW;
      gtt::load_tile_async<C>(x + (size_t)r0 * C, TRW, min(TRW, row_end - r0),
                              ring + (t % STAGES) * XT::bytes(TRW));
    }
    gtt::cp_async_commit();
  };
  for (int i = threadIdx.x; i < C * 8; i += blockDim.x) {
    const int r = i / 8, c = i % 8;
    gtt::cp_async16(KT::at(wkv_s, r, c),
                    (c < 4 ? wk : wv) + (size_t)r * H + hd * DH + (c % 4) * 8, 16);
  }
  gtt::load_tile_async<DH>(dctx, DH, DH, dctx_s, H);
  for (int i = threadIdx.x; i < DH; i += blockDim.x) {
    m_s[i] = m[b * H + hd * DH + i];
    dden_s[i] = dden[b * H + hd * DH + i];
  }
  for (int t = 0; t < STAGES - 1; ++t) load_x(t);

  float acc[PM][PN][4];
#pragma unroll
  for (int i = 0; i < PM; ++i)
#pragma unroll
    for (int j = 0; j < PN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int row0 = row_begin + t * TRW;
    load_x(t + STAGES - 1);
    gtt::cp_async_wait<STAGES - 1>();
    __syncthreads();
    unsigned char* xt = ring + (t % STAGES) * XT::bytes(TRW);
    {
      // phase 1: dk and dv of the warp's 16 rows, rounded, into the
      // exchange tile; past the split's end ek = 0, so dk = dv = 0 there
      const int nv = min(TRW, row_end - row0) - r_w;
      float pk[4][4], pv[4][4], dk[4][4], dv[4][4];
      project_kv<C, KT>(xt, r_w + lane % 16, wkv_s, 0, wkv_s, DH / 8, lane, pk, pv);
      dk_dv(pk, pv, dctx_s, 0, m_s, dden_s, nv, lane, dk, dv);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = r_w + g + 8 * hi;
          *reinterpret_cast<uint32_t*>(KT::at(xch, r, j) + 4 * q) =
              gtt::pack_bf16x2(dk[j][2 * hi], dk[j][2 * hi + 1]);
          *reinterpret_cast<uint32_t*>(KT::at(xch, r, 4 + j) + 4 * q) =
              gtt::pack_bf16x2(dv[j][2 * hi], dv[j][2 * hi + 1]);
        }
    }
    __syncthreads();
    // phase 2: acc += x^T [dk | dv] over the tile's rows; A[c][r] = x[r][c]
    // and B[r][n] = xch[r][n], both by ldmatrix.trans
#pragma unroll 2
    for (int ks = 0; ks < TRW / 16; ++ks) {
      uint32_t a[PM][4];
#pragma unroll
      for (int i = 0; i < PM; ++i)
        gtt::ldmatrix_x4_trans(a[i], XT::at(xt, 16 * ks + lane % 8 + 8 * (lane / 16),
                                            2 * (wm * PM + i) + (lane / 8) % 2));
#pragma unroll
      for (int np = 0; np < (PN + 1) / 2; ++np) {
        uint32_t w[4];
        gtt::ldmatrix_x4_trans(
            w, KT::at(xch, 16 * ks + lane % 16, wn * PN + 2 * np + (PN > 1 ? lane / 16 : 0)));
#pragma unroll
        for (int i = 0; i < PM; ++i) {
          gtt::mma_bf16_16816(acc[i][2 * np], a[i], w[0], w[1]);
          if constexpr (PN > 1) gtt::mma_bf16_16816(acc[i][2 * np + 1], a[i], w[2], w[3]);
        }
      }
    }
    __syncthreads();  // the ring slot and the exchange tile are free
  }

  // column n of this head's [C, 64]: dWk column hd * DH + n for n < DH,
  // else dWv column hd * DH + n - DH (stored at H + that)
  float* dst = dwkv_part + ((size_t)b * S + s) * C * 2 * H;
#pragma unroll
  for (int i = 0; i < PM; ++i)
#pragma unroll
    for (int j = 0; j < PN; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int c = 16 * (wm * PM + i) + g + 8 * hi;
        const int n = 8 * (wn * PN + j) + 2 * q;
        const int col = (n < DH ? 0 : H - DH) + hd * DH + n;
        *reinterpret_cast<float2*>(dst + (size_t)c * 2 * H + col) =
            make_float2(acc[i][j][2 * hi], acc[i][j][2 * hi + 1]);
      }
}

// ---- K4 in bf16: tensor cores -----------------------------------------------

// K4's layout at channel count C: head hd's columns of Wq and A_full^T
// ([C, 32] each), a two-stage ring of x and dy tiles of TR rows, and three
// [TR, 32] bf16 exchange tiles: hi = round(q), lo = round(q - hi) and
// round(dq). The block's three sums hi^T dy, lo^T dy and dq^T x (dWq_hd
// transposed) are [32, C] each; their C / 8 column tiles go NT to a warp
// over WN warps, and where that leaves warps over, the WK warps of a column
// group take every WK-th 16-row k-step of each tile and add their partials
// once, at the end, in shared memory (over the ring, free by then).
template <int C>
struct Bwd1Tc {
  static constexpr int TR = C <= 64 ? 128 : 64;
  static constexpr int WARPS = 8;
  static constexpr int NT = C == 256 ? 4 : 2;   // column tiles of a warp
  static constexpr int WN = C / 8 / NT;
  static constexpr int WK = WARPS / WN;
  static constexpr int STAGES = 2;
  static constexpr int RS = C + 1;              // row stride of the f32 sums
  using XT = gtt::RowTile<C>;
  using HT = gtt::RowTile<DH>;
  __host__ __device__ static constexpr size_t ring() {
    return STAGES * 2 * (size_t)XT::bytes(TR);
  }
  __host__ __device__ static constexpr size_t sums() {
    return (size_t)WK * (3 * DH * RS + C) * sizeof(float);
  }
  __host__ __device__ static constexpr size_t smem() {
    return 2 * (size_t)HT::bytes(C) + 3 * (size_t)HT::bytes(TR) +
           (ring() > sums() ? ring() : sums());
  }
  static_assert(WN * WK == WARPS && (TR / 16) % WK == 0 && NT % 2 == 0, "K4: warp layout");
};

// p = the warp's 16 rows of the [*, C] tile at (tile, arow) times the
// [C, 32] head slice w_s (A by ldmatrix, B by ldmatrix.trans), f32.
template <int C>
__device__ __forceinline__ void project_head(unsigned char* tile, int arow, unsigned char* w_s,
                                             int lane, float (&p)[4][4]) {
  using XT = gtt::RowTile<C>;
  using HT = gtt::RowTile<DH>;
  zero(p);
#pragma unroll 4
  for (int ks = 0; ks < C / 16; ++ks) {
    uint32_t a[4];
    gtt::ldmatrix_x4(a, XT::at(tile, arow, 2 * ks + lane / 16));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t w[4];
      gtt::ldmatrix_x4_trans(w, HT::at(w_s, 16 * ks + lane % 16, 2 * np + lane / 16));
      gtt::mma_bf16_16816(p[2 * np], a, w[0], w[1]);
      gtt::mma_bf16_16816(p[2 * np + 1], a, w[2], w[3]);
    }
  }
}

// K4, bf16. grid (S, B, NH): block (s, b, hd) sums head hd's share of the
// sweep over its rows. Per tile, phase 1: each warp projects 16 rows of x
// onto the head's Wq columns (q, kept f32 as hi + lo) or of dy onto its
// A_full^T columns (dq, rounded), into the exchange tiles; phase 2: the
// block adds hi^T dy, lo^T dy and dq^T x over the tile's rows (A from the
// exchange tiles, B from the dy and x tiles, both by ldmatrix.trans), and
// the head-0 blocks the column sums of dy (db) from the dy fragments.
// Epilogue: dA_hd = hi^T dy + lo^T dy; dWq_hd; dgv's share of the head,
// sum_h A_pre[h, c] (hi^T dy)[h, c] (the sum over rows of dy * round(q)
// A_pre, reassociated), plus b_out db in head 0; all as f32 partials.
template <int C>
__global__ void __launch_bounds__(Bwd1Tc<C>::WARPS * 32, C <= 128 ? 2 : 1)
la_bwd1_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  const bf16* __restrict__ wq, const bf16* __restrict__ afullt,
                  const bf16* __restrict__ apre, const float* __restrict__ bout,
                  float* __restrict__ da_part, float* __restrict__ dwq_part,
                  float* __restrict__ db_part, float* __restrict__ dgv_part, int N, int chunk,
                  int S) {
  using L = Bwd1Tc<C>;
  using XT = typename L::XT;
  using HT = typename L::HT;
  constexpr int TR = L::TR, NT = L::NT, WK = L::WK, STAGES = L::STAGES, RS = L::RS;
  constexpr int RB = TR / 16;  // row blocks of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* wq_s = smem_raw;              // Wq[:, head] [C, 32]
  unsigned char* af_s = wq_s + HT::bytes(C);   // A_full^T[:, head] [C, 32]
  unsigned char* hi_s = af_s + HT::bytes(C);   // round(q) [TR, 32]
  unsigned char* lo_s = hi_s + HT::bytes(TR);  // round(q - round(q))
  unsigned char* dq_s = lo_s + HT::bytes(TR);  // round(dq)
  unsigned char* ring = dq_s + HT::bytes(TR);  // {x, dy} [TR, C] per stage
  float* sums = reinterpret_cast<float*>(ring);  // after the loop: [WK][3][32][RS]
  float* db_sums = sums + WK * 3 * DH * RS;      // and [WK][C]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wn = warp % L::WN, wk = warp / L::WN;
  const int s = blockIdx.x, b = blockIdx.y, hd = blockIdx.z;
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  const int n_tiles = (row_end - row_begin + TR - 1) / TR;
  x += (size_t)b * N * C;
  dy += (size_t)b * N * C;
  afullt += (size_t)b * C * H;
  apre += ((size_t)b * H + hd * DH) * C;

  auto load_xdy = [&](int t) {
    if (t < n_tiles) {
      const int r0 = row_begin + t * TR;
      const int valid = min(TR, row_end - r0);
      unsigned char* slot = ring + (t % STAGES) * 2 * XT::bytes(TR);
      gtt::load_tile_async<C>(x + (size_t)r0 * C, TR, valid, slot);
      gtt::load_tile_async<C>(dy + (size_t)r0 * C, TR, valid, slot + XT::bytes(TR));
    }
    gtt::cp_async_commit();
  };
  gtt::load_tile_async<DH>(wq + hd * DH, C, C, wq_s, H);
  gtt::load_tile_async<DH>(afullt + hd * DH, C, C, af_s, H);
  for (int t = 0; t < STAGES - 1; ++t) load_xdy(t);

  float acc[3][2][NT][4];  // [hi^T dy, lo^T dy, dq^T x][m tile][column tile]
  float dbp[NT];           // this lane's rows of column 8 (wn NT + j) + g of dy
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    dbp[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int md = 0; md < 2; ++md)
#pragma unroll
        for (int src = 0; src < 3; ++src) acc[src][md][j][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    load_xdy(t + STAGES - 1);
    gtt::cp_async_wait<STAGES - 1>();
    __syncthreads();
    unsigned char* xt = ring + (t % STAGES) * 2 * XT::bytes(TR);
    unsigned char* dyt = xt + XT::bytes(TR);
    // phase 1: job < RB projects x (q), else dy (dq), rows 16 (job % RB)..;
    // zero-filled rows past the split give q = dq = 0
#pragma unroll 1
    for (int job = warp; job < 2 * RB; job += L::WARPS) {
      const int r_w = 16 * (job % RB);
      const bool is_q = job < RB;
      float p[4][4];
      project_head<C>(is_q ? xt : dyt, r_w + lane % 16, is_q ? wq_s : af_s, lane, p);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = r_w + g + 8 * h2;
          if (is_q) {
            gtt::store_split(HT::at(hi_s, r, j) + 4 * q, HT::at(lo_s, r, j) + 4 * q,
                             p[j][2 * h2], p[j][2 * h2 + 1]);
          } else {
            *reinterpret_cast<uint32_t*>(HT::at(dq_s, r, j) + 4 * q) =
                gtt::pack_bf16x2(p[j][2 * h2], p[j][2 * h2 + 1]);
          }
        }
    }
    __syncthreads();
    // phase 2: A[h][r] = exchange[r][h], B[r][c] = dy or x [r][c]
#pragma unroll 1
    for (int ks = wk; ks < RB; ks += WK) {
      uint32_t a[3][2][4];
#pragma unroll
      for (int md = 0; md < 2; ++md) {
        const int r = 16 * ks + lane % 8 + 8 * (lane / 16), c = 2 * md + (lane / 8) % 2;
        gtt::ldmatrix_x4_trans(a[0][md], HT::at(hi_s, r, c));
        gtt::ldmatrix_x4_trans(a[1][md], HT::at(lo_s, r, c));
        gtt::ldmatrix_x4_trans(a[2][md], HT::at(dq_s, r, c));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int c8 = wn * NT + 2 * np;
        uint32_t bd[4], bx[4];
        gtt::ldmatrix_x4_trans(bd, XT::at(dyt, 16 * ks + lane % 16, c8 + lane / 16));
        gtt::ldmatrix_x4_trans(bx, XT::at(xt, 16 * ks + lane % 16, c8 + lane / 16));
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          const int j = 2 * np + n2;
#pragma unroll
          for (int md = 0; md < 2; ++md) {
            gtt::mma_bf16_16816(acc[0][md][j], a[0][md], bd[2 * n2], bd[2 * n2 + 1]);
            gtt::mma_bf16_16816(acc[1][md][j], a[1][md], bd[2 * n2], bd[2 * n2 + 1]);
            gtt::mma_bf16_16816(acc[2][md][j], a[2][md], bx[2 * n2], bx[2 * n2 + 1]);
          }
          if (hd == 0) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {  // bf16 -> f32 is a 16-bit shift
              const uint32_t w = bd[2 * n2 + u];
              dbp[j] += __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
            }
          }
        }
      }
    }
    __syncthreads();  // the ring slot and the exchange tiles are free
  }

  // the WK partials into shared memory, then added in a fixed order
  float* mine = sums + wk * 3 * DH * RS;
#pragma unroll
  for (int src = 0; src < 3; ++src)
#pragma unroll
    for (int md = 0; md < 2; ++md)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = 16 * md + g + 8 * (e >> 1), c = 8 * (wn * NT + j) + 2 * q + (e & 1);
          mine[(src * DH + h) * RS + c] = acc[src][md][j][e];
        }
  if (hd == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float v = dbp[j];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (q == 0) db_sums[wk * C + 8 * (wn * NT + j) + g] = v;
    }
  }
  __syncthreads();
  auto total = [&](int src, int h, int c) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w) v += sums[((w * 3 + src) * DH + h) * RS + c];
    return v;
  };
  const size_t bs = (size_t)b * S + s;
  for (int i = threadIdx.x; i < DH * C; i += blockDim.x) {
    const int h = i / C, c = i % C;
    da_part[(bs * H + hd * DH + h) * C + c] = total(0, h, c) + total(1, h, c);
  }
  for (int i = threadIdx.x; i < DH * C; i += blockDim.x) {
    const int c = i / DH, h = i % DH;
    dwq_part[(bs * C + c) * H + hd * DH + h] = total(2, h, c);
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float dg = 0.f;
    for (int h = 0; h < DH; ++h) dg = fmaf(__bfloat162float(apre[h * C + c]), total(0, h, c), dg);
    if (hd == 0) {
      float db = 0.f;
#pragma unroll
      for (int w = 0; w < WK; ++w) db += db_sums[w * C + c];
      db_part[bs * C + c] = db;
      dg = fmaf(bout[c], db, dg);
    }
    dgv_part[(bs * NH + hd) * C + c] = dg;
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

template <int C>
cudaError_t launch_bwd1_tc(const void* x, const void* dy, const void* wq, const void* afullt,
                           const void* apre, const void* bout, void* da_part, void* dwq_part,
                           void* db_part, void* dgv_part, int B, int N, int chunk, int S,
                           cudaStream_t stream) {
  using L = Bwd1Tc<C>;
  static_assert(L::smem() <= SMEM_MAX, "K4: shared memory over budget");
  if (chunk % L::TR != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(la_bwd1_tc_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::smem());
  if (err != cudaSuccess) return err;
  la_bwd1_tc_kernel<C><<<dim3(S, B, NH), L::WARPS * 32, L::smem(), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(afullt), static_cast<const bf16*>(apre),
      static_cast<const float*>(bout), static_cast<float*>(da_part),
      static_cast<float*>(dwq_part), static_cast<float*>(db_part), static_cast<float*>(dgv_part),
      N, chunk, S);
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

template <int C>
cudaError_t launch_bwd2_tc(const void* x, const void* dy, const void* wq, const void* wk,
                           const void* wv, const void* afullt, const void* afull, const void* m,
                           const void* dctx, const void* dden, void* dx, void* dwkv_part, int B,
                           int N, int chunk, int S, int chunk_w, int S_w, cudaStream_t stream) {
  using X = Bwd2Dx<C>;
  using W = Bwd2Dw<C>;
  static_assert(X::smem() <= SMEM_MAX && W::smem() <= SMEM_MAX, "K5: shared memory over budget");
  cudaError_t err = cudaFuncSetAttribute(la_bwd2_dx_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)X::smem());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(la_bwd2_dw_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)W::smem());
  if (err != cudaSuccess) return err;
  la_bwd2_dx_kernel<C><<<dim3(S, B), DX_WARPS * 32, X::smem(), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<const bf16*>(afullt), static_cast<const bf16*>(afull),
      static_cast<const float*>(m), static_cast<const bf16*>(dctx),
      static_cast<const float*>(dden), static_cast<bf16*>(dx), N, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  la_bwd2_dw_kernel<C><<<dim3(S_w, B, NH), DW_WARPS * 32, W::smem(), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<const float*>(m), static_cast<const bf16*>(dctx),
      static_cast<const float*>(dden), static_cast<float*>(dwkv_part), N, chunk_w, S_w);
  return cudaGetLastError();
}

}  // namespace

// K4 in f32. x, dy [B, N, C]; wq [C, 128]; afullt [B, C, 128]; apre
// [B, 128, C], all f32; bout [C] f32. Partial outputs per split s of rows
// [s * chunk, min(N, (s + 1) * chunk)), all f32: da_part [B, S, 128, C],
// dwq_part [B, S, C, 128], db_part and dgv_part [B, S, C].
extern "C" int gtt_la_bwd1(const void* x, const void* dy, const void* wq, const void* afullt,
                           const void* apre, const void* bout, void* da_part, void* dwq_part,
                           void* db_part, void* dgv_part, int B, int N, int C, int chunk, int S,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gtt::kFloat32) {
    GTT_DISPATCH_C(launch_bwd1, float, x, dy, wq, afullt, apre, bout, da_part, dwq_part, db_part,
                   dgv_part, B, N, chunk, S, st)
  }
  return (int)cudaErrorInvalidValue;
}

// K4 in bf16, on the tensor cores. x, dy [B, N, C]; wq [C, 128]; afullt
// [B, C, 128]; apre [B, 128, C], all bf16; bout [C] f32. Partial outputs
// per split s of chunk rows (a multiple of Bwd1Tc<C>::TR), all f32:
// da_part [B, S, 128, C], dwq_part [B, S, C, 128], db_part [B, S, C] and
// dgv_part [B, S, 4 heads, C] (b_out db in head 0's).
extern "C" int gtt_la_bwd1_tc(const void* x, const void* dy, const void* wq, const void* afullt,
                              const void* apre, const void* bout, void* da_part, void* dwq_part,
                              void* db_part, void* dgv_part, int B, int N, int C, int chunk,
                              int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return (int)launch_bwd1_tc<16>(x, dy, wq, afullt, apre, bout, da_part, dwq_part,
                                            db_part, dgv_part, B, N, chunk, S, st);
    case 32: return (int)launch_bwd1_tc<32>(x, dy, wq, afullt, apre, bout, da_part, dwq_part,
                                            db_part, dgv_part, B, N, chunk, S, st);
    case 64: return (int)launch_bwd1_tc<64>(x, dy, wq, afullt, apre, bout, da_part, dwq_part,
                                            db_part, dgv_part, B, N, chunk, S, st);
    case 128: return (int)launch_bwd1_tc<128>(x, dy, wq, afullt, apre, bout, da_part, dwq_part,
                                              db_part, dgv_part, B, N, chunk, S, st);
    case 256: return (int)launch_bwd1_tc<256>(x, dy, wq, afullt, apre, bout, da_part, dwq_part,
                                              db_part, dgv_part, B, N, chunk, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5 in f32. x, dy [B, N, C]; wk, wv [C, 128]; afullt [B, C, 128]; wqkv_t
// [3 * 128, C] (Wq^T, Wk^T, Wv^T stacked); dctx_t, dctx [B, 128, 128], all
// in x's dtype; m, dden [B, 128] f32. Outputs dx [B, N, C] in x's dtype and
// dwkv_part [B, S, C, 256] f32 (dWk | dWv per split).
extern "C" int gtt_la_bwd2(const void* x, const void* dy, const void* wk, const void* wv,
                           const void* afullt, const void* wqkv_t, const void* m,
                           const void* dctx_t, const void* dctx, const void* dden, void* dx,
                           void* dwkv_part, int B, int N, int C, int chunk, int S, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gtt::kFloat32) {
    GTT_DISPATCH_C(launch_bwd2, float, x, dy, wk, wv, afullt, wqkv_t, m, dctx_t, dctx, dden, dx,
                   dwkv_part, B, N, chunk, S, st)
  }
  return (int)cudaErrorInvalidValue;
}

// K5 in bf16, on the tensor cores: two kernels on one stream. x, dy [B, N,
// C]; wq, wk, wv [C, 128]; afullt [B, C, 128] and afull [B, 128, C] (its
// transpose, read at C 256); dctx [B, 128, 128] (its diagonal 32 x 32
// blocks are read), all bf16; m, dden [B, 128] f32. Outputs dx [B, N, C]
// bf16 (splits of chunk rows, S of them) and dwkv_part [B, S_w, C, 256] f32
// (dWk | dWv per split of chunk_w rows). chunk is a multiple of 64, chunk_w
// of 128. Returns the first failing launch's cudaError_t.
extern "C" int gtt_la_bwd2_tc(const void* x, const void* dy, const void* wq, const void* wk,
                              const void* wv, const void* afullt, const void* afull,
                              const void* m, const void* dctx, const void* dden, void* dx,
                              void* dwkv_part, int B, int N, int C, int chunk, int S,
                              int chunk_w, int S_w, void* stream) {
  if (chunk % TR != 0 || chunk_w % TRW != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return (int)launch_bwd2_tc<16>(x, dy, wq, wk, wv, afullt, afull, m, dctx, dden, dx,
                                            dwkv_part, B, N, chunk, S, chunk_w, S_w, st);
    case 32: return (int)launch_bwd2_tc<32>(x, dy, wq, wk, wv, afullt, afull, m, dctx, dden, dx,
                                            dwkv_part, B, N, chunk, S, chunk_w, S_w, st);
    case 64: return (int)launch_bwd2_tc<64>(x, dy, wq, wk, wv, afullt, afull, m, dctx, dden, dx,
                                            dwkv_part, B, N, chunk, S, chunk_w, S_w, st);
    case 128: return (int)launch_bwd2_tc<128>(x, dy, wq, wk, wv, afullt, afull, m, dctx, dden,
                                              dx, dwkv_part, B, N, chunk, S, chunk_w, S_w, st);
    case 256: return (int)launch_bwd2_tc<256>(x, dy, wq, wk, wv, afullt, afull, m, dctx, dden,
                                              dx, dwkv_part, B, N, chunk, S, chunk_w, S_w, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
