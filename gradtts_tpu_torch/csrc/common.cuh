// Helpers shared by the port's hand-written kernels (plain C entry points,
// loaded with ctypes by gradtts_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gtt {

// dtype codes passed from Python (ops/_build.py: DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Copies n elements of T (n * sizeof(T) a multiple of 16, both pointers
// 16-byte aligned) with 16-byte vectors, all threads of the block taking part.
template <typename T>
__device__ __forceinline__ void copy_vec16(const T* __restrict__ src, T* __restrict__ dst, int n) {
  const int n_vec = n * (int)sizeof(T) / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) d[i] = s[i];
}

// Rows [row0, row0 + R) of a row-major [*, C] matrix into an f32 [R, C]
// shared tile with 16-byte loads, all THREADS threads of the block taking
// part; rows >= row_end are zero.
template <typename T, int C, int R, int THREADS>
__device__ __forceinline__ void load_rows_f32(const T* __restrict__ x, int row0, int row_end,
                                              float* __restrict__ xs) {
  constexpr int VEC = 16 / sizeof(T);
  for (int i = threadIdx.x * VEC; i < R * C; i += THREADS * VEC) {
    const int row = row0 + i / C;
    if (row < row_end) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)row0 * C + i);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) xs[i + j] = to_f32(v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) xs[i + j] = 0.f;
    }
  }
}

// ---- tensor-core building blocks (sm_80+ PTX: cp.async, ldmatrix, mma.sync)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes 0 fills the 16 bytes
// with zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8. Without .trans lane t gets (row t/4, cols 2(t%4), +1) of each
// matrix; with .trans (rows 2(t%4), +1, col t/4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b for one 16x8x16 bf16 tile, f32 accumulators. Fragments, lane t,
// g = t / 4, q = t % 4: a {(g, 2q..), (g+8, 2q..), (g, 2q+8..), (g+8,
// 2q+8..)} of A [16, 16]; b {(2q.., g), (2q+8.., g)} of B [16, 8]; d
// {(g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1)} of D [16, 8].
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to nearest even into one bf16x2 register (lo = first).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A row-major [rows, W] bf16 tile in shared memory, addressed in 16-byte
// chunks (8 values). Rows of 8 or more chunks are XOR-swizzled (chunk c of
// row r at c ^ (r % 8)), shorter rows padded by one chunk: either way the 8
// rows an ldmatrix reads at one column fall in 8 distinct bank groups.
template <int W>
struct RowTile {
  static constexpr int CH = W / 8;
  static constexpr bool SWIZZLE = CH >= 8;
  static constexpr int STRIDE = SWIZZLE ? CH : CH + 1;  // chunks per row
  __host__ __device__ static constexpr int bytes(int rows) { return rows * STRIDE * 16; }
  __device__ static __forceinline__ int chunk(int row, int c) {
    return row * STRIDE + (SWIZZLE ? (c ^ (row & 7)) : c);
  }
  __device__ static __forceinline__ unsigned char* at(unsigned char* tile, int row, int c) {
    return tile + chunk(row, c) * 16;
  }
};

// rows [0, rows) and columns [0, W) of a row-major bf16 matrix whose rows
// are ld values apart (default W) into a RowTile<W> with cp.async, all
// threads of the block taking part; rows >= valid are zeros.
template <int W>
__device__ __forceinline__ void load_tile_async(const __nv_bfloat16* __restrict__ src, int rows,
                                                int valid, unsigned char* tile, int ld = W) {
  constexpr int CH = W / 8;
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid;
    cp_async16(RowTile<W>::at(tile, r, c), src + (size_t)(ok ? r : 0) * ld + c * 8, ok ? 16 : 0);
  }
}

// Byte offset of (row, col) in a [16, 32] bf16 exchange tile: two rows to a
// 128-byte line, its 16-byte chunks XOR-swizzled by the line, so that the
// accumulators' 4-byte stores (8 rows x 4 lanes) and ldmatrix's 8 rows at
// one column each hit 32 distinct banks.
__device__ __forceinline__ int xch(int row, int col) {
  const int line = row >> 1, chunk = ((row & 1) << 2) | (col >> 3);
  return line * 128 + ((chunk ^ (line & 7)) << 4) + (col & 7) * 2;
}

// a, b (f32) as bf16 hi and lo parts, hi + lo = value to ~2^-17 of it
__device__ __forceinline__ void store_split(unsigned char* hi, unsigned char* lo, float a,
                                            float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo) = __floats2bfloat162_rn(a - hf.x, b - hf.y);
}

// The f32 context block of one head, [32, 32] (rows d: k columns, columns
// e: v columns), += a^T b over 16 rows on the tensor cores, a and b each
// held as bf16 hi and lo [16, 32] exchange tiles (xch): lo*hi + hi*lo +
// hi*hi in f32 accumulators (lo*lo, ~2^-18 of each product, is left out).
// acc[md][ne] is rows 16 md + g (+ 8), columns 8 ne + 2q (+ 1) of the
// block, in the mma accumulator layout.
__device__ __forceinline__ void split_context_mma(float (&acc)[2][4][4], const unsigned char* a_hi,
                                                  const unsigned char* a_lo,
                                                  const unsigned char* b_hi,
                                                  const unsigned char* b_lo, int lane) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int md = 0; md < 2; ++md) {
    const int o = xch((lane / 16) * 8 + lane % 8, 16 * md + (lane / 8) % 2 * 8);
    ldmatrix_x4_trans(ah[md], a_hi + o);
    ldmatrix_x4_trans(al[md], a_lo + o);
  }
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t bh[4], bl[4];
    const int o = xch(lane % 16, 16 * np + (lane / 16) * 8);
    ldmatrix_x4_trans(bh, b_hi + o);
    ldmatrix_x4_trans(bl, b_lo + o);
#pragma unroll
    for (int md = 0; md < 2; ++md)
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        float(&d)[4] = acc[md][2 * np + n2];
        mma_bf16_16816(d, al[md], bh[2 * n2], bh[2 * n2 + 1]);
        mma_bf16_16816(d, ah[md], bl[2 * n2], bl[2 * n2 + 1]);
        mma_bf16_16816(d, ah[md], bh[2 * n2], bh[2 * n2 + 1]);
      }
  }
}

}  // namespace gtt

// The channel counts of the U-Net's attentions: dispatches a launcher
// template FN<T, C> on the runtime C, returning its cudaError_t as an int.
#define GTT_DISPATCH_C(FN, T, ...)                     \
  switch (C) {                                         \
    case 16: return (int)FN<T, 16>(__VA_ARGS__);       \
    case 32: return (int)FN<T, 32>(__VA_ARGS__);       \
    case 64: return (int)FN<T, 64>(__VA_ARGS__);       \
    case 128: return (int)FN<T, 128>(__VA_ARGS__);     \
    case 256: return (int)FN<T, 256>(__VA_ARGS__);     \
    default: return (int)cudaErrorInvalidValue;        \
  }

// Every library is built from one .cu file that includes this header once,
// so each gets exactly one definition of this entry point.
extern "C" const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
