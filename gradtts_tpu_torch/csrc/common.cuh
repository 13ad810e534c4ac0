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
