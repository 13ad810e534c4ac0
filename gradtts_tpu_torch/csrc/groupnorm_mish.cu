// Masked GroupNorm + affine + Mish + time mask for the Grad-TTS U-Net
// (K1): y = mish((x - mean_g) * rstd_g * gamma + beta) * mask[t], with the
// group statistics taken over all (F, T) positions of a batch item,
// masked zeros included, as E[x^2] - E[x]^2 in f32 with var clamped at 0.
//
// Replaces the Pallas TPU kernel gradtts_tpu/ops/pallas/groupnorm_mish.py
// _gn_mish_kernel (:48, driven by _forward :103) and follows the jnp twin
// _reference (:133) that the JAX package runs by default, var clamp included.
//
// What bounds it on the H100: it does a few dozen flops per element against
// 2 bytes (bf16) or 4 bytes (f32) read twice and written once, far below the
// ~20 f32 flops per byte where the CUDA cores would take over, so it is
// bound by HBM bytes: at the top U-Net level (B 8, F 80, T 768, C 64, bf16)
// one read of x is 62.9 MB.
//
// Design: the TPU grid ran both passes in order on one core and carried the
// sums in scratch. Here the statistics need a reduction across blocks, so
// there are two launches over a grid of (tiles, B) blocks that each own a
// contiguous chunk of the N = F*T rows:
//   1. gtt_gn_stats: every thread reads 16-byte vectors of one channel slice
//      and keeps f32 sum and sum of squares; the block reduces them in
//      shared memory and writes one partial [2, C] row per (b, tile) to a
//      [B, tiles, 2, C] buffer (no atomics: the result is deterministic);
//   2. gtt_gn_apply: every block sums its batch item's partials in a fixed
//      order (so all blocks agree bit for bit), forms per-channel scale and
//      shift, and streams its rows again with 16-byte loads and stores.
// Pass 2 re-reads x; at the top level x (63 MB) exceeds the 50 MB L2, so
// the floor here is three HBM passes, not two.

#include "common.cuh"

namespace {

using gtt::from_f32;
using gtt::to_f32;

constexpr int THREADS = 256;

__device__ __forceinline__ float mish_f32(float v) {
  // stable softplus: log1p(exp(-|v|)) + max(v, 0)
  const float sp = log1pf(expf(-fabsf(v))) + fmaxf(v, 0.f);
  return v * tanhf(sp);
}

template <typename T, int C>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);    // channels per thread
  static constexpr int LANES = C / VEC;         // threads per row
  static constexpr int RPAR = THREADS / LANES;  // rows in flight per block
  static_assert(C % VEC == 0 && THREADS % LANES == 0, "unsupported C");
};

// grid (tiles, B). part[b, tile, 0, c] = sum of x[b, rows of tile, c],
// part[b, tile, 1, c] = the sum of squares.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int N, int chunk) {
  using L = Layout<T, C>;
  __shared__ float red[2][L::RPAR * C];
  const int tile = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const int lane = threadIdx.x % L::LANES, rp = threadIdx.x / L::LANES;
  const int row_end = min(N, (tile + 1) * chunk);
  x += (size_t)b * N * C + lane * L::VEC;

  float s1[L::VEC], s2[L::VEC];
#pragma unroll
  for (int j = 0; j < L::VEC; ++j) s1[j] = s2[j] = 0.f;
  for (int row = tile * chunk + rp; row < row_end; row += L::RPAR) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * C));
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) {
      const float f = to_f32(v[j]);
      s1[j] += f;
      s2[j] = fmaf(f, f, s2[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < L::VEC; ++j) {
    red[0][rp * C + lane * L::VEC + j] = s1[j];
    red[1][rp * C + lane * L::VEC + j] = s2[j];
  }
  __syncthreads();
  float* dst = part + ((size_t)b * tiles + tile) * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += THREADS) {
    const float* col = red[i / C] + i % C;
    float acc = 0.f;
    for (int r = 0; r < L::RPAR; ++r) acc += col[r * C];
    dst[i] = acc;
  }
}

// grid (tiles, B). mask is [B, T] in x's dtype; row n of a batch item is
// position (f, t) = (n / T, n % T).
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ mask,
                const float* __restrict__ part, const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ out, int N, int T_len,
                int chunk, int groups, float eps) {
  using L = Layout<T, C>;
  __shared__ float sums[2 * C];
  __shared__ float scale_s[C], shift_s[C];
  const int tile = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;

  const float* p = part + (size_t)b * tiles * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += THREADS) {
    float acc = 0.f;
    for (int s = 0; s < tiles; ++s) acc += p[(size_t)s * 2 * C + i];
    sums[i] = acc;
  }
  __syncthreads();
  const int cg = C / groups;
  const float inv_n = 1.f / ((float)N * (float)cg);
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const int g0 = (c / cg) * cg;
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < cg; ++k) {
      s1 += sums[g0 + k];
      s2 += sums[C + g0 + k];
    }
    const float mean = s1 * inv_n;
    const float var = fmaxf(s2 * inv_n - mean * mean, 0.f);
    const float sc = rsqrtf(var + eps) * gamma[c];
    scale_s[c] = sc;
    shift_s[c] = beta[c] - mean * sc;
  }
  __syncthreads();

  const int lane = threadIdx.x % L::LANES, rp = threadIdx.x / L::LANES;
  float sc[L::VEC], sh[L::VEC];
#pragma unroll
  for (int j = 0; j < L::VEC; ++j) {
    sc[j] = scale_s[lane * L::VEC + j];
    sh[j] = shift_s[lane * L::VEC + j];
  }
  const int row_end = min(N, (tile + 1) * chunk);
  const size_t base = (size_t)b * N * C + lane * L::VEC;
  mask += (size_t)b * T_len;
  for (int row = tile * chunk + rp; row < row_end; row += L::RPAR) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + base + (size_t)row * C));
    const T* v = reinterpret_cast<const T*>(&raw);
    const float m = to_f32(mask[row % T_len]);
    uint4 res;
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < L::VEC; ++j)
      o[j] = from_f32<T>(mish_f32(fmaf(to_f32(v[j]), sc[j], sh[j])) * m);
    *reinterpret_cast<uint4*>(out + base + (size_t)row * C) = res;
  }
}

template <typename T, int C>
cudaError_t launch_stats(const void* x, void* part, int B, int N, int chunk, int tiles,
                         cudaStream_t stream) {
  gn_stats_kernel<T, C><<<dim3(tiles, B), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), N, chunk);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_apply(const void* x, const void* mask, const void* part, const void* gamma,
                         const void* beta, void* out, int B, int N, int T_len, int chunk,
                         int tiles, int groups, float eps, cudaStream_t stream) {
  gn_apply_kernel<T, C><<<dim3(tiles, B), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mask), static_cast<const float*>(part),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<T*>(out),
      N, T_len, chunk, groups, eps);
  return cudaGetLastError();
}

}  // namespace

// x [B, N, C] (16-byte aligned); part [B, tiles, 2, C] f32. Tile s covers
// rows [s * chunk, min(N, (s + 1) * chunk)). Returns the launch's cudaError_t.
extern "C" int gtt_gn_stats(const void* x, void* part, int B, int N, int C, int chunk,
                            int tiles, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gtt::kBFloat16) {
    GTT_DISPATCH_C(launch_stats, __nv_bfloat16, x, part, B, N, chunk, tiles, st)
  }
  if (dtype == gtt::kFloat32) {
    GTT_DISPATCH_C(launch_stats, float, x, part, B, N, chunk, tiles, st)
  }
  return (int)cudaErrorInvalidValue;
}

// x, out [B, N = F*T, C] and mask [B, T] in x's dtype; part from
// gtt_gn_stats at the same tiling; gamma, beta [C] f32; C % groups == 0.
// Returns the launch's cudaError_t.
extern "C" int gtt_gn_apply(const void* x, const void* mask, const void* part, const void* gamma,
                            const void* beta, void* out, int B, int N, int T_len, int C,
                            int chunk, int tiles, int groups, float eps, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups <= 0 || C % groups != 0) return (int)cudaErrorInvalidValue;
  if (dtype == gtt::kBFloat16) {
    GTT_DISPATCH_C(launch_apply, __nv_bfloat16, x, mask, part, gamma, beta, out, B, N, T_len,
                   chunk, tiles, groups, eps, st)
  }
  if (dtype == gtt::kFloat32) {
    GTT_DISPATCH_C(launch_apply, float, x, mask, part, gamma, beta, out, B, N, T_len, chunk,
                   tiles, groups, eps, st)
  }
  return (int)cudaErrorInvalidValue;
}
