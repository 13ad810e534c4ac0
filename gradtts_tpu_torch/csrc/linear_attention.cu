// Linear attention (+ ReZero residual) forward for the Grad-TTS U-Net:
// K2, the context statistics, and K3, the apply pass.
//
// Replaces the Pallas TPU kernels gradtts_tpu/ops/pallas/linear_attention.py
// _stats_kernel (:58, driven by _forward :146) and _apply_kernel (:113).
//
// Function, for x [B, N = F*T, C] and H = 128 = 4 heads of DH = 32:
//   K2: per batch item and split of the rows, k = x Wk, v = x Wv (f32
//       accumulation) and, under an online running max m over the rows,
//       the head-diagonal blocks of ctx = sum_rows exp(k - m) v^T
//       [4, 32, 32] and den = sum_rows exp(k - m) [H], all f32. The fold
//       reads no entry of ctx off those blocks.
//   K3: out = x + (x Wq rounded to x's dtype) ctx2 + bias, where ctx2
//       [B, H, C] and bias [C] are the host fold of the merged (ctx, den)
//       with Wout and the ReZero gain.
//
// What bounds them on the H100: per row, K2 does 2*C*H multiply-adds for
// the projections and DH*H = 4096 for the context blocks against C
// elements read; K3 does 2*C*H against C read and C written. In bf16 that
// is 128-256 FMAs a byte, near the tensor cores' balance point (989 TFLOP/s
// over 3.35 TB/s, ~150 FMAs a byte) for K2, below it for K3, which on the
// tensor cores is bound by its bytes. K2's context blocks are summed in
// f32 in the Pallas kernel: as f32 FMAs on the CUDA cores (67 TFLOP/s)
// they alone would take 4x the projections' time at the tensor cores'
// rate, and feeding them from shared memory took more of its bandwidth
// than the rest of the kernel together.
//
// Design, bf16 (the main path's dtype):
// - A (S splits, B) grid fills the 132 SMs; each block walks its chunk of
//   rows in 64-row tiles kept as bf16 in shared memory, in a cp.async ring
//   (two stages in K2, three in K3), so that later tiles load while tile t
//   computes. Rows past the chunk's end are zero-filled by the copy and
//   masked.
// - The projections run on the tensor cores (mma.sync m16n8k16, f32
//   accumulators, operands by ldmatrix from swizzled tiles). bf16 products
//   are exact in f32, so only the order of the f32 sums differs from the
//   Pallas kernels, whose rounding points these keep.
// - K2: 8 warps, two blocks an SM; warp w owns head w % 4 and rows
//   32 * (w / 4) + [0, 32) of every tile, one m16 row block at a time. It
//   projects its head's 32 k and 32 v columns, keeps its own running max,
//   den and 32x32 context block, and hands exp(k - m) and v to itself only
//   (a 4 KB swizzled buffer and __syncwarp): no block barrier beyond the
//   ring's two. exp(k - m), den and the rescales are f32. The context block
//   sums exp(k - m)^T v on the tensor cores as a split product: each f32
//   operand is hi + lo, two bf16 (hi + lo is the value to ~2^-17 of it),
//   and lo*hi + hi*lo + hi*hi accumulate in f32; the dropped lo*lo and the
//   split leave ~2^-16 of each product, near f32's own rounding of the sum
//   (PERF.md has the measured error). The two warps of a head merge once,
//   at the end, with the exp(m_w - m) rescale; the wrapper merges the
//   splits the same way. Wk and Wv stay in shared memory for the block's
//   life: 2 * C * 256 bytes, 128 KB at C = 256, beside the 64 KB ring and
//   the 33 KB of exchange buffers, within the 227 KB a block may use.
// - K3: 4 warps, warp w owning rows 16 * w + [0, 16) of every tile; Wq and
//   this batch item's ctx2 stay in shared memory (64 + 64 KB at C = 256,
//   beside a 96 KB ring). q = x Wq accumulates in f32, is rounded to bf16
//   and stays in registers as the A operand of o = q ctx2 (one mma's
//   accumulator layout is the next one's operand layout). o + bias + x is
//   rounded once and written over the tile's x in shared memory, which the
//   warp then stores with 16-byte vectors: x is read once, out written
//   once.
// f32 (the parity route; TF32 is off): the products stay f32 FMAs on the
// CUDA cores, one k or v column a thread over 32-row tiles staged as f32;
// K2 keeps the head-diagonal blocks as a 4x4 tile a thread, as K6 does.

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
constexpr int THREADS = 256;    // K2 (both routes), K3 f32
constexpr float NEG = -1e30f;   // running-max initial value (Pallas _NEG)

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int TR = 64;              // rows per tile
constexpr int STAGES = 2;           // depth of K2's cp.async ring
constexpr int APPLY_STAGES = 3;     // depth of K3's (it streams x: more in flight)
constexpr int APPLY_WARPS = 4;      // K3: one m16 row block each
// K2's exchange buffer per warp: exp(k - m) and v of one m16 row block,
// each as bf16 hi and lo parts ([16, 32] bf16 each), and the rescale of the
// head's 32 context rows
constexpr int XCH_TILE = 16 * DH * 2;
constexpr int XCH_BYTES = 4 * XCH_TILE + DH * 4;
constexpr int SMEM_MAX = 227 * 1024;

static_assert(THREADS == 2 * NH * 32, "K2: two warps per head");
static_assert(TR == 2 * 32 && TR == APPLY_WARPS * 16, "tile rows");

template <int C>
__host__ __device__ constexpr size_t stats_smem_tc() {
  return 2 * (size_t)gtt::RowTile<H>::bytes(C) + STAGES * (size_t)gtt::RowTile<C>::bytes(TR) +
         (THREADS / 32) * (size_t)XCH_BYTES;
}

template <int C>
__host__ __device__ constexpr size_t apply_smem_tc() {
  return (size_t)gtt::RowTile<H>::bytes(C) + (size_t)gtt::RowTile<C>::bytes(H) +
         APPLY_STAGES * (size_t)gtt::RowTile<C>::bytes(TR) + C * sizeof(float);
}

// K2, bf16. grid (S, B); block THREADS = 8 warps.
template <int C>
__device__ __forceinline__ void stats_tc(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                                         const bf16* __restrict__ wv, float* __restrict__ m_out,
                                         float* __restrict__ ctx_out, float* __restrict__ den_out,
                                         int N, int chunk, int S) {
  using XT = gtt::RowTile<C>;
  using WT = gtt::RowTile<H>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* wk_s = smem_raw;                    // Wk [C, H]
  unsigned char* wv_s = wk_s + WT::bytes(C);         // Wv [C, H]
  unsigned char* ring = wv_s + WT::bytes(C);         // STAGES x [TR, C]
  unsigned char* xch_all = ring + STAGES * XT::bytes(TR);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int head = warp % NH;
  const int r_w = 32 * (warp / NH);  // this warp's first row in a tile
  const int g = lane / 4, q = lane % 4;
  unsigned char* ek_hi = xch_all + warp * XCH_BYTES;  // [16, 32] bf16 each
  unsigned char* ek_lo = ek_hi + XCH_TILE;
  unsigned char* v_hi = ek_lo + XCH_TILE;
  unsigned char* v_lo = v_hi + XCH_TILE;
  float* alpha_s = reinterpret_cast<float*>(v_lo + XCH_TILE);  // [32]

  const int s = blockIdx.x, b = blockIdx.y;
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  const int n_tiles = (row_end - row_begin + TR - 1) / TR;
  x += (size_t)b * N * C;

  gtt::load_tile_async<H>(wk, C, C, wk_s);
  gtt::load_tile_async<H>(wv, C, C, wv_s);
  gtt::load_tile_async<C>(x + (size_t)row_begin * C, TR, min(TR, row_end - row_begin), ring);
  gtt::cp_async_commit();

  // Per lane, in the accumulator layout of the projections: the running
  // max and the den partial (rows g, g + 8 of every row block) of k
  // columns 8j + 2q + c of this head; and of the context block [32, 32]
  // (rows d = k columns, columns e = v columns), rows 16 md + g (+ 8),
  // columns 8 ne + 2q (+ 1).
  float m_run[4][2], den[4][2], ctx[2][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m_run[j][0] = m_run[j][1] = NEG;
    den[j][0] = den[j][1] = 0.f;
  }
#pragma unroll
  for (int md = 0; md < 2; ++md)
#pragma unroll
    for (int ne = 0; ne < 4; ++ne)
#pragma unroll
      for (int e = 0; e < 4; ++e) ctx[md][ne][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int row0 = row_begin + t * TR;
    if (t + 1 < n_tiles)
      gtt::load_tile_async<C>(x + (size_t)(row0 + TR) * C, TR, min(TR, row_end - row0 - TR),
                              ring + ((t + 1) % STAGES) * XT::bytes(TR));
    gtt::cp_async_commit();
    gtt::cp_async_wait<1>();  // tile t (and the weights) landed
    __syncthreads();
    unsigned char* xt = ring + (t % STAGES) * XT::bytes(TR);
    const int nvalid = min(TR, row_end - row0) - r_w;  // this warp's valid rows

    // the warp's 32 rows, one m16 row block at a time: [k | v] of the head
    // (acc[j], rows g and g + 8; n-tiles 0-3 k columns 8j.., 4-7 v
    // columns), the running max, exp(k - m), then the context
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      const int nv = nvalid - 16 * mt;  // valid rows of this row block
      if (nv <= 0) break;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks) {
        uint32_t a[4];
        gtt::ldmatrix_x4(a, XT::at(xt, r_w + 16 * mt + lane % 16, 2 * ks + lane / 16));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t w[4];
          gtt::ldmatrix_x4_trans(w, WT::at(np < 2 ? wk_s : wv_s, 16 * ks + lane % 16,
                                           (head * DH + 16 * (np % 2)) / 8 + lane / 16));
          gtt::mma_bf16_16816(acc[2 * np], a, w[0], w[1]);
          gtt::mma_bf16_16816(acc[2 * np + 1], a, w[2], w[3]);
        }
      }

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
            if (8 * hi + g < nv) mx = fmaxf(mx, acc[j][2 * hi + c]);
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
            if (g == 0) alpha_s[8 * j + 2 * q + c] = a;
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          m_run[j][c] = m_new[j][c];
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            float& e = acc[j][2 * hi + c];
            e = 8 * hi + g < nv ? expf(e - m_new[j][c]) : 0.f;
          }
          den[j][c] += acc[j][c] + acc[j][2 + c];
        }
      // exp(k - m) and v of the 16 rows as bf16 hi + lo parts
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int o = xch(g + 8 * hi, 8 * j + 2 * q);
          store_split(ek_hi + o, ek_lo + o, acc[j][2 * hi], acc[j][2 * hi + 1]);
          store_split(v_hi + o, v_lo + o, acc[4 + j][2 * hi], acc[4 + j][2 * hi + 1]);
        }
      __syncwarp();
      if (grew) {
#pragma unroll
        for (int md = 0; md < 2; ++md)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const float a = alpha_s[16 * md + 8 * hi + g];
#pragma unroll
            for (int ne = 0; ne < 4; ++ne) {
              ctx[md][ne][2 * hi] *= a;
              ctx[md][ne][2 * hi + 1] *= a;
            }
          }
      }
      // context block += exp(k - m)^T v over the 16 rows on the tensor
      // cores, as a split product
      gtt::split_context_mma(ctx, ek_hi, ek_lo, v_hi, v_lo, lane);
      __syncwarp();  // the exchange tiles and alpha_s are free for the next block
    }
    __syncthreads();  // every warp is done with ring slot t % STAGES
  }

  // den over the warp's rows: the 8 lanes of one q hold the same columns
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float d = den[j][c];
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      d += __shfl_xor_sync(0xffffffffu, d, 8);
      d += __shfl_xor_sync(0xffffffffu, d, 16);
      den[j][c] = d;
    }

  // merge the two warps of each head (exchange buffers are free now):
  // the second warp hands over its m, den and block, the first rescales
  float* merge = reinterpret_cast<float*>(xch_all);
  float* mrg = merge + head * (2 * DH + DH * DH);  // m, den, ctx [32, 32]
  float* m_first = merge + NH * (2 * DH + DH * DH) + head * DH;
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * j + 2 * q + c;
        if (warp < NH) {
          m_first[d] = m_run[j][c];
        } else {
          mrg[d] = m_run[j][c];
          mrg[DH + d] = den[j][c];
        }
      }
  }
  if (warp >= NH) {
#pragma unroll
    for (int md = 0; md < 2; ++md)
#pragma unroll
      for (int ne = 0; ne < 4; ++ne)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
          *reinterpret_cast<float2*>(mrg + 2 * DH + (16 * md + 8 * hi + g) * DH + 8 * ne + 2 * q) =
              make_float2(ctx[md][ne][2 * hi], ctx[md][ne][2 * hi + 1]);
  }
  __syncthreads();
  if (warp < NH) {
    const size_t bs = (size_t)b * S + s;
    float* blk = ctx_out + (bs * NH + head) * DH * DH;
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
          const float2 other = *reinterpret_cast<const float2*>(mrg + 2 * DH + d * DH + e);
          *reinterpret_cast<float2*>(blk + d * DH + e) =
              make_float2(ctx[md][ne][2 * hi] * a0 + other.x * a1,
                          ctx[md][ne][2 * hi + 1] * a0 + other.y * a1);
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
          m_out[bs * H + head * DH + d] = mm;
          den_out[bs * H + head * DH + d] =
              den[j][c] * expf(m0 - mm) + mrg[DH + d] * expf(m1 - mm);
        }
    }
  }
}

// K3, bf16. grid (S, B); block APPLY_WARPS warps.
template <int C>
__device__ __forceinline__ void apply_tc(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                                         const bf16* __restrict__ ctx2,
                                         const float* __restrict__ bias, bf16* __restrict__ out,
                                         int N, int chunk) {
  using XT = gtt::RowTile<C>;
  using WT = gtt::RowTile<H>;
  constexpr int NC = C < 64 ? C : 64;  // output columns per pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* wq_s = smem_raw;                 // Wq [C, H]
  unsigned char* c2_s = wq_s + WT::bytes(C);      // ctx2[b] [H, C]
  unsigned char* ring = c2_s + XT::bytes(H);      // APPLY_STAGES x [TR, C]
  float* bias_s = reinterpret_cast<float*>(ring + APPLY_STAGES * XT::bytes(TR));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int r_w = 16 * warp;
  const int s = blockIdx.x, b = blockIdx.y;
  const int row_begin = s * chunk;
  const int row_end = min(N, row_begin + chunk);
  const int n_tiles = (row_end - row_begin + TR - 1) / TR;
  x += (size_t)b * N * C;
  out += (size_t)b * N * C;
  ctx2 += (size_t)b * H * C;

  // one commit group per tile, the weights in the first: tiles
  // [0, APPLY_STAGES - 1) ahead, then one more per tile consumed
  auto load_x = [&](int t) {
    if (t < n_tiles) {
      const int r0 = row_begin + t * TR;
      gtt::load_tile_async<C>(x + (size_t)r0 * C, TR, min(TR, row_end - r0),
                              ring + (t % APPLY_STAGES) * XT::bytes(TR));
    }
    gtt::cp_async_commit();
  };
  gtt::load_tile_async<H>(wq, C, C, wq_s);
  gtt::load_tile_async<C>(ctx2, H, H, c2_s);
  for (int t = 0; t < APPLY_STAGES - 1; ++t) load_x(t);
  for (int i = threadIdx.x; i < C; i += blockDim.x) bias_s[i] = bias[i];

  for (int t = 0; t < n_tiles; ++t) {
    const int row0 = row_begin + t * TR;
    load_x(t + APPLY_STAGES - 1);        // into the slot tile t - 1 left
    gtt::cp_async_wait<APPLY_STAGES - 1>();  // tiles <= t (and the weights) landed
    __syncthreads();
    unsigned char* xt = ring + (t % APPLY_STAGES) * XT::bytes(TR);
    const int nvalid = min(TR, row_end - row0) - r_w;

    if (nvalid > 0) {
      // q = x Wq for the warp's 16 rows, f32: n-tile j is columns 8j..
      float qa[H / 8][4];
#pragma unroll
      for (int j = 0; j < H / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks) {
        uint32_t a[4];
        gtt::ldmatrix_x4(a, XT::at(xt, r_w + lane % 16, 2 * ks + lane / 16));
#pragma unroll
        for (int np = 0; np < H / 16; ++np) {
          uint32_t w[4];
          gtt::ldmatrix_x4_trans(w, WT::at(wq_s, 16 * ks + lane % 16, 2 * np + lane / 16));
          gtt::mma_bf16_16816(qa[2 * np], a, w[0], w[1]);
          gtt::mma_bf16_16816(qa[2 * np + 1], a, w[2], w[3]);
        }
      }
      // q rounded to bf16 (_apply_kernel :118), as the A fragments of
      // o = q ctx2: k-step kk takes q columns 16 kk + [0, 16)
      uint32_t qf[H / 16][4];
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        qf[kk][0] = gtt::pack_bf16x2(qa[2 * kk][0], qa[2 * kk][1]);
        qf[kk][1] = gtt::pack_bf16x2(qa[2 * kk][2], qa[2 * kk][3]);
        qf[kk][2] = gtt::pack_bf16x2(qa[2 * kk + 1][0], qa[2 * kk + 1][1]);
        qf[kk][3] = gtt::pack_bf16x2(qa[2 * kk + 1][2], qa[2 * kk + 1][3]);
      }
#pragma unroll 1
      for (int cc = 0; cc < C / NC; ++cc) {  // one pass's 32 accumulators live
        float o[NC / 8][4];
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk)
#pragma unroll
          for (int np = 0; np < NC / 16; ++np) {
            uint32_t w[4];
            gtt::ldmatrix_x4_trans(
                w, XT::at(c2_s, 16 * kk + lane % 16, (cc * NC) / 8 + 2 * np + lane / 16));
            gtt::mma_bf16_16816(o[2 * np], qf[kk], w[0], w[1]);
            gtt::mma_bf16_16816(o[2 * np + 1], qf[kk], w[2], w[3]);
          }
        // o + bias + x, rounded once, written over x in the tile
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int col = cc * NC + 8 * j + 2 * q;
          const float b0 = bias_s[col], b1 = bias_s[col + 1];
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
                XT::at(xt, r_w + g + 8 * hi, col / 8) + (col % 8) * 2);
            const float2 xv = __bfloat1622float2(*p);
            *p = __floats2bfloat162_rn(o[j][2 * hi] + b0 + xv.x, o[j][2 * hi + 1] + b1 + xv.y);
          }
        }
      }
      __syncwarp();
      for (int i = lane; i < 16 * XT::CH; i += 32) {
        const int r = i / XT::CH, c = i % XT::CH;
        if (r < nvalid)
          *reinterpret_cast<uint4*>(out + (size_t)(row0 + r_w + r) * C + c * 8) =
              *reinterpret_cast<const uint4*>(XT::at(xt, r_w + r, c));
      }
    }
    __syncthreads();  // every warp is done with ring slot t % APPLY_STAGES
  }
}

// ---- f32: CUDA cores -------------------------------------------------------

constexpr int R = 32;           // rows per tile
constexpr int SMEM_LIMIT = 200 * 1024;

__host__ __device__ constexpr size_t stats_smem_f32(int C) {
  return ((size_t)R * C + 2 * (size_t)R * H + H) * sizeof(float);
}
__host__ __device__ constexpr size_t apply_smem_f32(int C) {
  return ((size_t)R * C + (size_t)R * H) * sizeof(float);
}

static_assert(NH * (DH / 4) * (DH / 4) == THREADS,
              "K2 f32: one 4x4 tile of the head-diagonal blocks per thread");

// K2, f32. grid (S, B); block THREADS. Threads [0, H) own k column tid,
// threads [H, 2H) own v column tid - H; for the context every thread owns
// a 4x4 tile of one head's diagonal block.
template <typename T, int C>
__device__ __forceinline__ void stats_f32(const T* __restrict__ x, const T* __restrict__ wk_g,
                                          const T* __restrict__ wv_g, float* __restrict__ m_out,
                                          float* __restrict__ ctx_out, float* __restrict__ den_out,
                                          int N, int chunk, int S, int w_in_smem) {
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
  // this thread's 4x4 tile of the head-diagonal blocks: head hd, rows
  // [d0, d0 + 4) and columns [e0, e0 + 4) of the [H, H] context
  const int hd = tid / ((DH / 4) * (DH / 4));
  const int within = tid % ((DH / 4) * (DH / 4));
  const int d0 = hd * DH + 4 * (within / (DH / 4));
  const int e0 = hd * DH + 4 * (within % (DH / 4));

  float m_run = NEG, den_run = 0.f;  // used by the k threads
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

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
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[d0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= a;
    }
    for (int r = 0; r < nvalid; ++r) {
      const float4 e4 = *reinterpret_cast<const float4*>(eks + r * H + d0);
      const float4 v4 = *reinterpret_cast<const float4*>(vs + r * H + e0);
      const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ev[i], vv[j], acc[i][j]);
    }
  }

  // blocks [B, S, NH, DH, DH]: row d0 - hd*DH + i, columns e0 - hd*DH + [0, 4)
  const size_t bs = (size_t)b * S + s;
  const size_t blk = (bs * NH + hd) * DH * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(ctx_out + blk + (size_t)(d0 - hd * DH + i) * DH + (e0 - hd * DH)) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (is_k) {
    m_out[bs * H + col] = m_run;
    den_out[bs * H + col] = den_run;
  }
}

// K3, f32. grid (S, B); block THREADS. For q every thread owns column
// tid % H of R/2 rows; for the output every thread owns column tid % C of
// R*C/THREADS consecutive rows.
template <typename T, int C>
__device__ __forceinline__ void apply_f32(const T* __restrict__ x, const T* __restrict__ wq_g,
                                          const T* __restrict__ ctx2_g,
                                          const float* __restrict__ bias, T* __restrict__ out,
                                          int N, int chunk, int w_in_smem) {
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

// ---- the kernels -----------------------------------------------------------

template <typename T>
constexpr bool kTensorCores = std::is_same<T, bf16>::value;

template <typename T>
struct ApplyThreads {
  static constexpr int value = kTensorCores<T> ? APPLY_WARPS * 32 : THREADS;
};

// K2 bf16 blocks an SM can hold by shared memory (at most 2: 128
// registers a thread); the register budget follows
template <typename T, int C>
struct StatsBlocks {
  static constexpr int value = kTensorCores<T> && 2 * stats_smem_tc<C>() <= 228 * 1024 ? 2 : 1;
};

template <typename T, int C>
__global__ void __launch_bounds__(THREADS, (StatsBlocks<T, C>::value))
la_stats_kernel(const T* __restrict__ x, const T* __restrict__ wk, const T* __restrict__ wv,
                float* __restrict__ m_out, float* __restrict__ ctx_out,
                float* __restrict__ den_out, int N, int chunk, int S, int w_in_smem) {
  if constexpr (kTensorCores<T>)
    stats_tc<C>(x, wk, wv, m_out, ctx_out, den_out, N, chunk, S);
  else
    stats_f32<T, C>(x, wk, wv, m_out, ctx_out, den_out, N, chunk, S, w_in_smem);
}

template <typename T, int C>
__global__ void __launch_bounds__(ApplyThreads<T>::value)
la_apply_kernel(const T* __restrict__ x, const T* __restrict__ wq, const T* __restrict__ ctx2,
                const float* __restrict__ bias, T* __restrict__ out, int N, int chunk,
                int w_in_smem) {
  if constexpr (kTensorCores<T>)
    apply_tc<C>(x, wq, ctx2, bias, out, N, chunk);
  else
    apply_f32<T, C>(x, wq, ctx2, bias, out, N, chunk, w_in_smem);
}

template <typename T, int C>
cudaError_t launch_stats(const void* x, const void* wk, const void* wv, void* m, void* ctx,
                         void* den, int B, int N, int chunk, int S, cudaStream_t stream) {
  size_t smem;
  int w_in_smem = 1;
  if constexpr (kTensorCores<T>) {
    static_assert(stats_smem_tc<C>() <= SMEM_MAX, "K2: shared memory over budget");
    smem = stats_smem_tc<C>();
  } else {
    const size_t w_bytes = 2 * (size_t)C * H * sizeof(T);
    w_in_smem = stats_smem_f32(C) + w_bytes <= SMEM_LIMIT;
    smem = stats_smem_f32(C) + (w_in_smem ? w_bytes : 0);
  }
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
  size_t smem;
  int w_in_smem = 1;
  if constexpr (kTensorCores<T>) {
    static_assert(apply_smem_tc<C>() <= SMEM_MAX, "K3: shared memory over budget");
    smem = apply_smem_tc<C>();
  } else {
    const size_t w_bytes = 2 * (size_t)C * H * sizeof(T);
    w_in_smem = apply_smem_f32(C) + w_bytes <= SMEM_LIMIT;
    smem = apply_smem_f32(C) + (w_in_smem ? w_bytes : 0);
  }
  cudaError_t err = cudaFuncSetAttribute(la_apply_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  la_apply_kernel<T, C><<<dim3(S, B), ApplyThreads<T>::value, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wq), static_cast<const T*>(ctx2),
      static_cast<const float*>(bias), static_cast<T*>(out), N, chunk, w_in_smem);
  return cudaGetLastError();
}

}  // namespace

// x [B, N, C]; wk, wv [C, 128] in x's dtype; outputs f32 m, den [B, S, 128]
// and the head-diagonal blocks ctx [B, S, 4, 32, 32]. Split s covers rows
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
