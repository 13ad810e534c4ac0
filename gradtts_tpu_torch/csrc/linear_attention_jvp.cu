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
// What bounds them on the H100: per row, K6 does (4 + 2 * has_dW) * C * H
// multiply-adds for the projections and 3 * DH * H for the two context
// blocks against 2 * C elements read; K7 does (2 + has_dW) * C * H + 3 * H
// * C against 2 * C read and 2 * C written. In bf16 that is 80-320 FMAs a
// byte, about the tensor cores' balance point (989 TFLOP/s over 3.35 TB/s,
// ~150 FMAs a byte): on the tensor cores K6's f32 context sums (three bf16
// products each, as split products) and K7's bytes set the pace; on the
// CUDA cores (67 TFLOP/s) every product would.
//
// Design, bf16 without weight tangents (the Hutchinson probe's variant, the
// main path's): K2 and K3 of csrc/linear_attention.cu with tangents.
// - A (S splits, B, Z) grid; each block walks its chunk of rows in 64-row
//   tiles of x AND dx kept as bf16 in shared memory, in a cp.async ring, so
//   later tiles load while tile t computes. Rows past the chunk's end are
//   zero-filled by the copy and masked.
// - K6: 2 * HB warps, warp w owning head w % HB of the block's HB and rows
//   32 * (w / HB) + [0, 32) of every tile, one m16 row block at a time. The
//   projections run on the tensor cores (mma.sync m16n8k16, f32
//   accumulators, ldmatrix from swizzled tiles), each Wk or Wv fragment
//   feeding both the x and the dx A-fragments: k and dk first (ek = exp(k -
//   m) and dek = ek * dk in f32 under the warp's running max, handed to the
//   warp's exchange buffer as bf16 hi + lo), then v and dv (the same); 64
//   projection accumulators never live at once beside the 64 of the
//   context blocks. ctx += ek^T v and dctx += dek^T v + ek^T dv are split
//   products on the tensor cores, as K2's (lo*hi + hi*lo + hi*hi, f32
//   accumulators); den and dden are f32 sums. The two warps of a head merge
//   once, at the end, rescaling the tangents by the same exp(m_w - m); the
//   wrapper merges the splits the same way.
//   Shared memory: the block's columns of Wk and Wv for the block's life,
//   a two-stage ring of (x, dx) and 8320 bytes of exchange per warp. At
//   C <= 128 a block owns all 4 heads (HB 4, Z 1; 193 KB at C 128). At
//   C 256 that would take 321 KB, so a block owns 2 heads (HB 2, Z 2):
//   64 KB of weights, 128 KB of ring, 33 KB of exchange, 225 of 227 KB.
// - K7: 4 warps, warp w owning rows 16 * w + [0, 16) of every tile. q = x
//   Wq and dq = dx Wq accumulate in f32, 64 columns at a time, each Wq
//   fragment feeding both, and are rounded to bf16 into registers as the A
//   operands of the next products (one mma's accumulator layout is the next
//   one's operand layout). y = q A and dy = q dA + dq A (one accumulator)
//   run 32 output columns at a time, each A fragment feeding q A and dq A;
//   y + bias + x and dy + dbias + dx are rounded once and written over the
//   x and dx tiles, which the warp then stores with 16-byte vectors: x and
//   dx are read once, y and dy written once. Shared memory: Wq, this batch
//   item's A and dA, and a ring of (x, dx). At C <= 128 a block writes all
//   C output columns (Z 1; a three-stage ring, 193 KB at C 128). At C 256
//   Wq, A and dA alone take 192 KB, so the output columns are split over Z
//   4 blocks, each holding Wq and its 64 columns of A and dA (96 KB) beside
//   a two-stage ring (128 KB): 225 KB. Each recomputes q and dq, which at
//   C 256 is the cheap part (the rows are few).
// The f32 route (TF32 is off, the parity route) and the bf16 variant with
// weight tangents (checked, off the path) keep the CUDA-core design: K6
// threads [0, H) own a column of (k, dk) and threads [H, 2H) a column of
// (v, dv), each thread a 4x4 tile of the head-diagonal ctx and dctx; K7
// threads own a q column, then an output column; 32-row tiles staged as
// f32; weights (and A, dA) in shared memory when they fit, else read from
// global memory (L2).

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using gtt::from_f32;
using gtt::store_split;
using gtt::to_f32;
using gtt::xch;

constexpr int H = 128;          // heads * dim_head of every U-Net attention
constexpr int DH = 32;          // dim_head
constexpr int NH = H / DH;      // heads
constexpr int THREADS = 256;    // the CUDA-core route's block
constexpr float NEG = -1e30f;   // running-max initial value (Pallas _NEG)
constexpr int SMEM_MAX = 227 * 1024;

// ---- bf16 without weight tangents: tensor cores -----------------------------

constexpr int TR = 64;          // rows per tile
constexpr int APPLY_WARPS = 4;  // K7: one m16 row block each
// K6's exchange buffer per warp: ek, dek, v and dv of one m16 row block,
// each as bf16 hi and lo parts ([16, 32] bf16 each, gtt::xch layout), and
// the rescale of the head's 32 context rows
constexpr int XCH_TILE = 16 * DH * 2;
constexpr int XCH_BYTES = 8 * XCH_TILE + DH * 4;

static_assert(TR == APPLY_WARPS * 16, "K7: one m16 row block per warp and tile");

// K6's layout at channel count C
template <int C>
struct JStats {
  static constexpr int HB = C == 256 ? 2 : NH;  // heads per block
  static constexpr int Z = NH / HB;             // blocks per split and batch item
  static constexpr int WARPS = 2 * HB;          // two per head
  static constexpr int HC = HB * DH;            // Wk, Wv columns per block
  static constexpr int STAGES = 2;
  __host__ __device__ static constexpr size_t smem() {
    return 2 * (size_t)gtt::RowTile<HC>::bytes(C) +
           STAGES * 2 * (size_t)gtt::RowTile<C>::bytes(TR) + WARPS * (size_t)XCH_BYTES;
  }
  // the end's merge buffer (in the exchange buffers): per head m, den, dden
  // and the ctx and dctx blocks of its second warp, then m of its first
  static constexpr int MERGE = 3 * DH + 2 * DH * DH;
  static_assert((HB * MERGE + HB * DH) * 4 <= WARPS * XCH_BYTES, "K6: merge buffer");
};

// K7's layout at channel count C
template <int C>
struct JApply {
  static constexpr int Z = C == 256 ? 4 : 1;   // blocks per split and batch item
  static constexpr int CB = C / Z;             // output columns per block
  static constexpr int NC = CB < 32 ? CB : 32; // output columns per pass
  static constexpr int STAGES = C == 256 ? 2 : 3;
  __host__ __device__ static constexpr size_t smem() {
    return (size_t)gtt::RowTile<H>::bytes(C) + 2 * (size_t)gtt::RowTile<CB>::bytes(H) +
           STAGES * 2 * (size_t)gtt::RowTile<C>::bytes(TR) + 2 * CB * sizeof(float);
  }
};

// K6, bf16 without weight tangents. grid (S, B, Z); block WARPS warps.
template <int C>
__device__ __forceinline__ void jstats_tc(const bf16* __restrict__ x, const bf16* __restrict__ dx,
                                          const bf16* __restrict__ wk,
                                          const bf16* __restrict__ wv, float* __restrict__ m_out,
                                          float* __restrict__ ctx_out,
                                          float* __restrict__ den_out,
                                          float* __restrict__ dctx_out,
                                          float* __restrict__ dden_out, int N, int chunk, int S) {
  using L = JStats<C>;
  constexpr int HB = L::HB;
  using XT = gtt::RowTile<C>;
  using WT = gtt::RowTile<L::HC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* wk_s = smem_raw;                    // Wk [C, HC] of the block's heads
  unsigned char* wv_s = wk_s + WT::bytes(C);         // Wv [C, HC]
  unsigned char* ring = wv_s + WT::bytes(C);         // STAGES x {x, dx} [TR, C]
  unsigned char* xch_all = ring + L::STAGES * 2 * XT::bytes(TR);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hl = warp % HB;                  // head within the block
  const int head = blockIdx.z * HB + hl;
  const int r_w = 32 * (warp / HB);          // this warp's first row in a tile
  const int g = lane / 4, q = lane % 4;
  unsigned char* ek_hi = xch_all + warp * XCH_BYTES;  // [16, 32] bf16 each
  unsigned char* ek_lo = ek_hi + XCH_TILE;
  unsigned char* dek_hi = ek_lo + XCH_TILE;
  unsigned char* dek_lo = dek_hi + XCH_TILE;
  unsigned char* v_hi = dek_lo + XCH_TILE;
  unsigned char* v_lo = v_hi + XCH_TILE;
  unsigned char* dv_hi = v_lo + XCH_TILE;
  unsigned char* dv_lo = dv_hi + XCH_TILE;
  float* alpha_s = reinterpret_cast<float*>(dv_lo + XCH_TILE);  // [32]

  const int s = blockIdx.x, b = blockIdx.y;
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  const int n_tiles = (row_end - row_begin + TR - 1) / TR;
  x += (size_t)b * N * C;
  dx += (size_t)b * N * C;

  auto load_xdx = [&](int t) {  // x and dx of tile t into its ring slot
    const int r0 = row_begin + t * TR;
    const int valid = min(TR, row_end - r0);
    unsigned char* slot = ring + (t % L::STAGES) * 2 * XT::bytes(TR);
    gtt::load_tile_async<C>(x + (size_t)r0 * C, TR, valid, slot);
    gtt::load_tile_async<C>(dx + (size_t)r0 * C, TR, valid, slot + XT::bytes(TR));
  };
  gtt::load_tile_async<L::HC>(wk + blockIdx.z * L::HC, C, C, wk_s, H);
  gtt::load_tile_async<L::HC>(wv + blockIdx.z * L::HC, C, C, wv_s, H);
  load_xdx(0);
  gtt::cp_async_commit();

  // Per lane, in the accumulator layout of the projections: the running
  // max and the den and dden partials (rows g, g + 8 of every row block)
  // of k columns 8j + 2q + c of this head; and of the ctx and dctx blocks
  // [32, 32] (rows d = k columns, columns e = v columns), rows 16 md + g
  // (+ 8), columns 8 ne + 2q (+ 1).
  float m_run[4][2], den[4][2], dden[4][2], ctx[2][4][4], dctx[2][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      m_run[j][c] = NEG;
      den[j][c] = dden[j][c] = 0.f;
    }
#pragma unroll
  for (int md = 0; md < 2; ++md)
#pragma unroll
    for (int ne = 0; ne < 4; ++ne)
#pragma unroll
      for (int e = 0; e < 4; ++e) ctx[md][ne][e] = dctx[md][ne][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int row0 = row_begin + t * TR;
    if (t + 1 < n_tiles) load_xdx(t + 1);
    gtt::cp_async_commit();
    gtt::cp_async_wait<1>();  // tile t (and the weights) landed
    __syncthreads();
    unsigned char* xt = ring + (t % L::STAGES) * 2 * XT::bytes(TR);
    unsigned char* dxt = xt + XT::bytes(TR);
    const int nvalid = min(TR, row_end - row0) - r_w;  // this warp's valid rows

#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      const int nv = nvalid - 16 * mt;  // valid rows of this row block
      if (nv <= 0) break;
      const int arow = r_w + 16 * mt + lane % 16;

      // p = [x | dx] W of the head's 32 columns of one weight: p[0][j] the
      // primal, p[1][j] the tangent, n-tile j = columns 8j.. (rows g, g + 8)
      auto project = [&](unsigned char* w_s, float (&p)[2][4][4]) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) p[u][j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < C / 16; ++ks) {
          uint32_t a[4], da[4];
          gtt::ldmatrix_x4(a, XT::at(xt, arow, 2 * ks + lane / 16));
          gtt::ldmatrix_x4(da, XT::at(dxt, arow, 2 * ks + lane / 16));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t w[4];
            gtt::ldmatrix_x4_trans(
                w, WT::at(w_s, 16 * ks + lane % 16, (hl * DH + 16 * np) / 8 + lane / 16));
            gtt::mma_bf16_16816(p[0][2 * np], a, w[0], w[1]);
            gtt::mma_bf16_16816(p[0][2 * np + 1], a, w[2], w[3]);
            gtt::mma_bf16_16816(p[1][2 * np], da, w[0], w[1]);
            gtt::mma_bf16_16816(p[1][2 * np + 1], da, w[2], w[3]);
          }
        }
      };

      float p[2][4][4];
      project(wk_s, p);  // k, dk
      // running max over the block's valid rows; a warp whose max moved in
      // no column skips the rescale (its alpha would be expf(0) = 1)
      float m_new[4][2];
      bool grew = false;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float mx = NEG;
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            if (8 * hi + g < nv) mx = fmaxf(mx, p[0][j][2 * hi + c]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          m_new[j][c] = fmaxf(m_run[j][c], mx);
          grew |= m_new[j][c] > m_run[j][c];
        }
      grew = __any_sync(0xffffffffu, grew);
      if (grew) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float a = expf(m_run[j][c] - m_new[j][c]);
            den[j][c] *= a;
            dden[j][c] *= a;
            if (g == 0) alpha_s[8 * j + 2 * q + c] = a;
          }
      }
      // ek = exp(k - m) and dek = ek * dk (m is stop-gradient), f32
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          m_run[j][c] = m_new[j][c];
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            float& e = p[0][j][2 * hi + c];
            e = 8 * hi + g < nv ? expf(e - m_new[j][c]) : 0.f;
            p[1][j][2 * hi + c] *= e;
          }
          den[j][c] += p[0][j][c] + p[0][j][2 + c];
          dden[j][c] += p[1][j][c] + p[1][j][2 + c];
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int o = xch(g + 8 * hi, 8 * j + 2 * q);
          store_split(ek_hi + o, ek_lo + o, p[0][j][2 * hi], p[0][j][2 * hi + 1]);
          store_split(dek_hi + o, dek_lo + o, p[1][j][2 * hi], p[1][j][2 * hi + 1]);
        }
      project(wv_s, p);  // v, dv: zero on the zero-filled rows past the split
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int o = xch(g + 8 * hi, 8 * j + 2 * q);
          store_split(v_hi + o, v_lo + o, p[0][j][2 * hi], p[0][j][2 * hi + 1]);
          store_split(dv_hi + o, dv_lo + o, p[1][j][2 * hi], p[1][j][2 * hi + 1]);
        }
      __syncwarp();
      if (grew) {
#pragma unroll
        for (int md = 0; md < 2; ++md)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const float a = alpha_s[16 * md + 8 * hi + g];
#pragma unroll
            for (int ne = 0; ne < 4; ++ne)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                ctx[md][ne][2 * hi + c] *= a;
                dctx[md][ne][2 * hi + c] *= a;
              }
          }
      }
      // the context blocks over the 16 rows, split products on the tensor
      // cores: ctx += ek^T v, dctx += dek^T v + ek^T dv
      gtt::split_context_mma(ctx, ek_hi, ek_lo, v_hi, v_lo, lane);
      gtt::split_context_mma(dctx, dek_hi, dek_lo, v_hi, v_lo, lane);
      gtt::split_context_mma(dctx, ek_hi, ek_lo, dv_hi, dv_lo, lane);
      __syncwarp();  // the exchange tiles and alpha_s are free for the next block
    }
    __syncthreads();  // every warp is done with ring slot t % STAGES
  }

  // den and dden over the warp's rows: the 8 lanes of one q hold the same
  // columns
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int sh = 4; sh < 32; sh *= 2) {
        den[j][c] += __shfl_xor_sync(0xffffffffu, den[j][c], sh);
        dden[j][c] += __shfl_xor_sync(0xffffffffu, dden[j][c], sh);
      }

  // merge the two warps of each head (exchange buffers are free now): the
  // second warp hands over its m, den, dden and blocks, the first rescales
  // primal and tangent alike by exp(m_w - m)
  float* merge = reinterpret_cast<float*>(xch_all);
  float* mrg = merge + hl * L::MERGE;  // m, den, dden, ctx, dctx [32, 32]
  float* m_first = merge + HB * L::MERGE + hl * DH;
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * j + 2 * q + c;
        if (warp < HB) {
          m_first[d] = m_run[j][c];
        } else {
          mrg[d] = m_run[j][c];
          mrg[DH + d] = den[j][c];
          mrg[2 * DH + d] = dden[j][c];
        }
      }
  }
  if (warp >= HB) {
#pragma unroll
    for (int md = 0; md < 2; ++md)
#pragma unroll
      for (int ne = 0; ne < 4; ++ne)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int o = 3 * DH + (16 * md + 8 * hi + g) * DH + 8 * ne + 2 * q;
          *reinterpret_cast<float2*>(mrg + o) =
              make_float2(ctx[md][ne][2 * hi], ctx[md][ne][2 * hi + 1]);
          *reinterpret_cast<float2*>(mrg + DH * DH + o) =
              make_float2(dctx[md][ne][2 * hi], dctx[md][ne][2 * hi + 1]);
        }
  }
  __syncthreads();
  if (warp < HB) {
    const size_t bs = (size_t)b * S + s;
    float* blk = ctx_out + (bs * NH + head) * DH * DH;
    float* dblk = dctx_out + (bs * NH + head) * DH * DH;
#pragma unroll
    for (int md = 0; md < 2; ++md)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int d = 16 * md + 8 * hi + g;
        const float m0 = m_first[d], m1 = mrg[d];
        const float mm = fmaxf(m0, m1);
        const float a0 = expf(m0 - mm), a1 = expf(m1 - mm);
#pragma unroll
        for (int ne = 0; ne < 4; ++ne) {
          const int e = 8 * ne + 2 * q;
          const float2 other = *reinterpret_cast<const float2*>(mrg + 3 * DH + d * DH + e);
          const float2 dother =
              *reinterpret_cast<const float2*>(mrg + 3 * DH + DH * DH + d * DH + e);
          *reinterpret_cast<float2*>(blk + d * DH + e) =
              make_float2(ctx[md][ne][2 * hi] * a0 + other.x * a1,
                          ctx[md][ne][2 * hi + 1] * a0 + other.y * a1);
          *reinterpret_cast<float2*>(dblk + d * DH + e) =
              make_float2(dctx[md][ne][2 * hi] * a0 + dother.x * a1,
                          dctx[md][ne][2 * hi + 1] * a0 + dother.y * a1);
        }
      }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = 8 * j + 2 * q + c;
          const float m0 = m_first[d], m1 = mrg[d];
          const float mm = fmaxf(m0, m1);
          const float a0 = expf(m0 - mm), a1 = expf(m1 - mm);
          const size_t o = bs * H + head * DH + d;
          m_out[o] = mm;
          den_out[o] = den[j][c] * a0 + mrg[DH + d] * a1;
          dden_out[o] = dden[j][c] * a0 + mrg[2 * DH + d] * a1;
        }
    }
  }
}

// K7, bf16 without a weight tangent. grid (S, B, Z); block APPLY_WARPS
// warps.
template <int C>
__device__ __forceinline__ void japply_tc(const bf16* __restrict__ x, const bf16* __restrict__ dx,
                                          const bf16* __restrict__ wq,
                                          const bf16* __restrict__ a_g,
                                          const bf16* __restrict__ da_g,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ dbias, bf16* __restrict__ y,
                                          bf16* __restrict__ dy, int N, int chunk) {
  using L = JApply<C>;
  constexpr int CB = L::CB, NC = L::NC, STAGES = L::STAGES;
  using XT = gtt::RowTile<C>;
  using WT = gtt::RowTile<H>;
  using AT = gtt::RowTile<CB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* wq_s = smem_raw;               // Wq [C, H]
  unsigned char* a_s = wq_s + WT::bytes(C);     // A[b] [H, CB] (the block's columns)
  unsigned char* da_s = a_s + AT::bytes(H);     // dA[b] [H, CB]
  unsigned char* ring = da_s + AT::bytes(H);    // STAGES x {x, dx} [TR, C]
  float* bias_s = reinterpret_cast<float*>(ring + STAGES * 2 * XT::bytes(TR));  // [CB]
  float* dbias_s = bias_s + CB;                                                  // [CB]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int r_w = 16 * warp;
  const int s = blockIdx.x, b = blockIdx.y;
  const int col0 = blockIdx.z * CB;  // the block's first output column
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  const int n_tiles = (row_end - row_begin + TR - 1) / TR;
  x += (size_t)b * N * C;
  dx += (size_t)b * N * C;
  y += (size_t)b * N * C;
  dy += (size_t)b * N * C;
  a_g += (size_t)b * H * C + col0;
  da_g += (size_t)b * H * C + col0;

  // one commit group per tile, the weights in the first: tiles
  // [0, STAGES - 1) ahead, then one more per tile consumed
  auto load_xdx = [&](int t) {
    if (t < n_tiles) {
      const int r0 = row_begin + t * TR;
      const int valid = min(TR, row_end - r0);
      unsigned char* slot = ring + (t % STAGES) * 2 * XT::bytes(TR);
      gtt::load_tile_async<C>(x + (size_t)r0 * C, TR, valid, slot);
      gtt::load_tile_async<C>(dx + (size_t)r0 * C, TR, valid, slot + XT::bytes(TR));
    }
    gtt::cp_async_commit();
  };
  gtt::load_tile_async<H>(wq, C, C, wq_s);
  gtt::load_tile_async<CB>(a_g, H, H, a_s, C);
  gtt::load_tile_async<CB>(da_g, H, H, da_s, C);
  for (int t = 0; t < STAGES - 1; ++t) load_xdx(t);
  for (int i = threadIdx.x; i < CB; i += blockDim.x) {
    bias_s[i] = bias[col0 + i];
    dbias_s[i] = dbias[col0 + i];
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int row0 = row_begin + t * TR;
    load_xdx(t + STAGES - 1);           // into the slot tile t - 1 left
    gtt::cp_async_wait<STAGES - 1>();   // tiles <= t (and the weights) landed
    __syncthreads();
    unsigned char* xt = ring + (t % STAGES) * 2 * XT::bytes(TR);
    unsigned char* dxt = xt + XT::bytes(TR);
    const int nvalid = min(TR, row_end - row0) - r_w;

    if (nvalid > 0) {
      // q = x Wq and dq = dx Wq for the warp's 16 rows, f32, 64 columns at
      // a time, rounded to bf16 (_jvp_apply_kernel :731-732) as the A
      // fragments of the next products: k-step kk takes columns 16 kk..
      uint32_t qf[H / 16][4], dqf[H / 16][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float qa[8][4], dqa[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[j][e] = dqa[j][e] = 0.f;
#pragma unroll 4  // fully unrolled, C 256 spills past 255 registers
        for (int ks = 0; ks < C / 16; ++ks) {
          uint32_t a[4], da[4];
          gtt::ldmatrix_x4(a, XT::at(xt, r_w + lane % 16, 2 * ks + lane / 16));
          gtt::ldmatrix_x4(da, XT::at(dxt, r_w + lane % 16, 2 * ks + lane / 16));
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t w[4];
            gtt::ldmatrix_x4_trans(
                w, WT::at(wq_s, 16 * ks + lane % 16, 8 * hh + 2 * np + lane / 16));
            gtt::mma_bf16_16816(qa[2 * np], a, w[0], w[1]);
            gtt::mma_bf16_16816(qa[2 * np + 1], a, w[2], w[3]);
            gtt::mma_bf16_16816(dqa[2 * np], da, w[0], w[1]);
            gtt::mma_bf16_16816(dqa[2 * np + 1], da, w[2], w[3]);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int kk = 4 * hh + k;
          qf[kk][0] = gtt::pack_bf16x2(qa[2 * k][0], qa[2 * k][1]);
          qf[kk][1] = gtt::pack_bf16x2(qa[2 * k][2], qa[2 * k][3]);
          qf[kk][2] = gtt::pack_bf16x2(qa[2 * k + 1][0], qa[2 * k + 1][1]);
          qf[kk][3] = gtt::pack_bf16x2(qa[2 * k + 1][2], qa[2 * k + 1][3]);
          dqf[kk][0] = gtt::pack_bf16x2(dqa[2 * k][0], dqa[2 * k][1]);
          dqf[kk][1] = gtt::pack_bf16x2(dqa[2 * k][2], dqa[2 * k][3]);
          dqf[kk][2] = gtt::pack_bf16x2(dqa[2 * k + 1][0], dqa[2 * k + 1][1]);
          dqf[kk][3] = gtt::pack_bf16x2(dqa[2 * k + 1][2], dqa[2 * k + 1][3]);
        }
      }
#pragma unroll 1
      for (int cc = 0; cc < CB / NC; ++cc) {  // one pass's 2 x NC / 2 accumulators live
        float o[NC / 8][4], od[NC / 8][4];
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] = od[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk)
#pragma unroll
          for (int np = 0; np < NC / 16; ++np) {
            uint32_t w[4], dw[4];
            const int chunk16 = (cc * NC) / 8 + 2 * np + lane / 16;
            gtt::ldmatrix_x4_trans(w, AT::at(a_s, 16 * kk + lane % 16, chunk16));
            gtt::ldmatrix_x4_trans(dw, AT::at(da_s, 16 * kk + lane % 16, chunk16));
            gtt::mma_bf16_16816(o[2 * np], qf[kk], w[0], w[1]);
            gtt::mma_bf16_16816(o[2 * np + 1], qf[kk], w[2], w[3]);
            gtt::mma_bf16_16816(od[2 * np], qf[kk], dw[0], dw[1]);
            gtt::mma_bf16_16816(od[2 * np + 1], qf[kk], dw[2], dw[3]);
            gtt::mma_bf16_16816(od[2 * np], dqf[kk], w[0], w[1]);
            gtt::mma_bf16_16816(od[2 * np + 1], dqf[kk], w[2], w[3]);
          }
        // o + bias + x and od + dbias + dx, rounded once, written over the
        // x and dx tiles
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int col = cc * NC + 8 * j + 2 * q;  // within the block's columns
          const int xc = col0 + col;                // within the row
          const float b0 = bias_s[col], b1 = bias_s[col + 1];
          const float db0 = dbias_s[col], db1 = dbias_s[col + 1];
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int r = r_w + g + 8 * hi;
            __nv_bfloat162* p =
                reinterpret_cast<__nv_bfloat162*>(XT::at(xt, r, xc / 8) + (xc % 8) * 2);
            __nv_bfloat162* dp =
                reinterpret_cast<__nv_bfloat162*>(XT::at(dxt, r, xc / 8) + (xc % 8) * 2);
            const float2 xv = __bfloat1622float2(*p);
            const float2 dxv = __bfloat1622float2(*dp);
            *p = __floats2bfloat162_rn(o[j][2 * hi] + b0 + xv.x, o[j][2 * hi + 1] + b1 + xv.y);
            *dp = __floats2bfloat162_rn(od[j][2 * hi] + db0 + dxv.x,
                                        od[j][2 * hi + 1] + db1 + dxv.y);
          }
        }
      }
      __syncwarp();
      constexpr int BCH = CB / 8;  // 16-byte chunks of the block's columns in a row
      for (int i = lane; i < 16 * BCH; i += 32) {
        const int r = i / BCH, c = col0 / 8 + i % BCH;
        if (r < nvalid) {
          const size_t o = (size_t)(row0 + r_w + r) * C + c * 8;
          *reinterpret_cast<uint4*>(y + o) =
              *reinterpret_cast<const uint4*>(XT::at(xt, r_w + r, c));
          *reinterpret_cast<uint4*>(dy + o) =
              *reinterpret_cast<const uint4*>(XT::at(dxt, r_w + r, c));
        }
      }
    }
    __syncthreads();  // every warp is done with ring slot t % STAGES
  }
}

// ---- f32, and bf16 with weight tangents: CUDA cores ------------------------

constexpr int R = 32;           // rows per tile
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

// K6 on the CUDA cores (f32; bf16 with weight tangents). grid (S, B);
// block THREADS.
template <typename T, int C, bool DW>
__device__ __forceinline__ void jstats_simple(
    const T* __restrict__ x, const T* __restrict__ dx, const T* __restrict__ wk_g,
    const T* __restrict__ wv_g, const T* __restrict__ dwk_g, const T* __restrict__ dwv_g,
    float* __restrict__ m_out, float* __restrict__ ctx_out, float* __restrict__ den_out,
    float* __restrict__ dctx_out, float* __restrict__ dden_out, int N, int chunk, int S,
    int w_in_smem) {
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

// K7 on the CUDA cores (f32; bf16 with a weight tangent). grid (S, B);
// block THREADS. For q and dq every thread owns column tid % H of R/2
// rows; for y and dy column tid % C of R*C/THREADS consecutive rows.
template <typename T, int C, bool DW>
__device__ __forceinline__ void japply_simple(
    const T* __restrict__ x, const T* __restrict__ dx, const T* __restrict__ wq_g,
    const T* __restrict__ dwq_g, const T* __restrict__ a_g, const T* __restrict__ da_g,
    const float* __restrict__ bias, const float* __restrict__ dbias, T* __restrict__ y,
    T* __restrict__ dy, int N, int chunk, int w_in_smem) {
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


// ---- the kernels -----------------------------------------------------------

template <typename T, bool DW>
constexpr bool kTensorCores = std::is_same<T, bf16>::value && !DW;

template <typename T, int C, bool DW>
__global__ void __launch_bounds__(THREADS)
la_jvp_stats_kernel(const T* __restrict__ x, const T* __restrict__ dx,
                    const T* __restrict__ wk, const T* __restrict__ wv,
                    const T* __restrict__ dwk, const T* __restrict__ dwv,
                    float* __restrict__ m_out, float* __restrict__ ctx_out,
                    float* __restrict__ den_out, float* __restrict__ dctx_out,
                    float* __restrict__ dden_out, int N, int chunk, int S, int w_in_smem) {
  if constexpr (kTensorCores<T, DW>)
    jstats_tc<C>(x, dx, wk, wv, m_out, ctx_out, den_out, dctx_out, dden_out, N, chunk, S);
  else
    jstats_simple<T, C, DW>(x, dx, wk, wv, dwk, dwv, m_out, ctx_out, den_out, dctx_out,
                            dden_out, N, chunk, S, w_in_smem);
}

template <typename T, int C, bool DW>
__global__ void __launch_bounds__(THREADS)
la_jvp_apply_kernel(const T* __restrict__ x, const T* __restrict__ dx,
                    const T* __restrict__ wq, const T* __restrict__ dwq,
                    const T* __restrict__ a, const T* __restrict__ da,
                    const float* __restrict__ bias, const float* __restrict__ dbias,
                    T* __restrict__ y, T* __restrict__ dy, int N, int chunk, int w_in_smem) {
  if constexpr (kTensorCores<T, DW>)
    japply_tc<C>(x, dx, wq, a, da, bias, dbias, y, dy, N, chunk);
  else
    japply_simple<T, C, DW>(x, dx, wq, dwq, a, da, bias, dbias, y, dy, N, chunk, w_in_smem);
}

template <typename T, int C, bool DW>
cudaError_t launch_stats_dw(const void* x, const void* dx, const void* wk, const void* wv,
                            const void* dwk, const void* dwv, void* m, void* ctx, void* den,
                            void* dctx, void* dden, int B, int N, int chunk, int S,
                            cudaStream_t stream) {
  size_t smem;
  int w_in_smem = 1;
  dim3 grid(S, B), block(THREADS);
  if constexpr (kTensorCores<T, DW>) {
    static_assert(JStats<C>::smem() <= SMEM_MAX, "K6: shared memory over budget");
    smem = JStats<C>::smem();
    grid.z = JStats<C>::Z;
    block.x = JStats<C>::WARPS * 32;
  } else {
    const size_t w_bytes = (DW ? 4 : 2) * (size_t)C * H * sizeof(T);
    w_in_smem = jstats_smem_f32(C) + w_bytes <= SMEM_LIMIT;
    smem = jstats_smem_f32(C) + (w_in_smem ? w_bytes : 0);
  }
  cudaError_t err = cudaFuncSetAttribute(la_jvp_stats_kernel<T, C, DW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  la_jvp_stats_kernel<T, C, DW><<<grid, block, smem, stream>>>(
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
  size_t smem;
  int w_in_smem = 1;
  dim3 grid(S, B), block(THREADS);
  if constexpr (kTensorCores<T, DW>) {
    static_assert(JApply<C>::smem() <= SMEM_MAX, "K7: shared memory over budget");
    smem = JApply<C>::smem();
    grid.z = JApply<C>::Z;
    block.x = APPLY_WARPS * 32;
  } else {
    const size_t w_bytes = (DW ? 4 : 3) * (size_t)C * H * sizeof(T);
    w_in_smem = japply_smem_f32(C) + w_bytes <= SMEM_LIMIT;
    smem = japply_smem_f32(C) + (w_in_smem ? w_bytes : 0);
  }
  cudaError_t err = cudaFuncSetAttribute(la_jvp_apply_kernel<T, C, DW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  la_jvp_apply_kernel<T, C, DW><<<grid, block, smem, stream>>>(
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
