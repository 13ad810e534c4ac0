// Masked GroupNorm + affine + Mish + time mask for the Grad-TTS U-Net
// (K1): y = mish((x - mean_g) * rstd_g * gamma + beta) * mask[t], with the
// group statistics taken over all (F, T) positions of a batch item,
// masked zeros included, as E[x^2] - E[x]^2 in f32 with var clamped at 0.
//
// Replaces the Pallas TPU kernel gradtts_tpu/ops/pallas/groupnorm_mish.py
// _gn_mish_kernel (:48, driven by _forward :103) and follows the jnp twin
// _reference (:133) that the JAX package runs by default, var clamp included.
//
// What bounds it on the H100: HBM bytes, x read twice and y written once
// (bf16: 6 bytes an element; at the top U-Net level, B 8, F 80, T 768, C 64,
// one read of x is 62.9 MB) -- provided each element costs few enough
// instructions. Keeping pace with 3.35 TB/s in bf16 leaves ~40 FP32
// instructions an element on 132 SMs at 1.98 GHz, and Mish in accurate f32
// (expf, log1pf, tanhf) alone takes about that. So Mish is computed with
// one fast exponential: with e = exp(v) and n = e (e + 2),
//   tanh(softplus(v)) = ((1 + e)^2 - 1) / ((1 + e)^2 + 1) = n / (n + 2),
// so mish(v) = v n / (n + 2), and mish(v) = v for v > 20, where n + 2
// rounds to n in f32 (and e e would overflow further on). The plain
// version keeps the softplus form; ops/groupnorm_mish.py mish_one_exp
// mirrors this one for the CPU tests.
//
// Design: the TPU grid ran both passes in order on one core and carried the
// sums in scratch. Here the statistics need a reduction across blocks, so
// there are two launches over a grid of (tiles, B) blocks that each own a
// contiguous chunk of the N = F*T rows:
//   1. gtt_gn_stats: every thread reads 16-byte vectors of one channel slice,
//      four independent loads in flight, and keeps f32 sum and sum of
//      squares; the block reduces them in shared memory and writes one
//      partial [2, C] row per (b, tile) to a [B, tiles, 2, C] buffer (no
//      atomics: the result is deterministic);
//   2. gtt_gn_apply: every block sums its batch item's partials in a fixed
//      order (so all blocks agree bit for bit), forms per-channel scale and
//      shift, and streams its rows again with 16-byte loads and stores. It
//      walks its rows last to first: pass 1 read them first to last, so the
//      rows it read last are the ones still in L2 when pass 2 starts. y is
//      stored with the streaming hint (evict first), so that the writes do
//      not push those rows of x out of L2 before they are read.
// At the top level x (63 MB) exceeds the 50 MB L2, so part of the second
// read comes from HBM; below it the second read is served from L2.

#include "common.cuh"

namespace {

using gtt::from_f32;
using gtt::to_f32;

constexpr int THREADS = 256;

// mish(v) = v tanh(softplus(v)) with one exponential (see the head of the
// file); ops/groupnorm_mish.py mish_one_exp is its CPU mirror
__device__ __forceinline__ float mish_one_exp(float v) {
  const float e = __expf(v);
  const float n = e * (e + 2.f);
  return v > 20.f ? v : v * __fdividef(n, n + 2.f);
}

template <typename T, int C>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);    // channels per thread
  static constexpr int LANES = C / VEC;         // threads per row
  static constexpr int RPAR = THREADS / LANES;  // rows in flight per block
  static_assert(C % VEC == 0 && THREADS % LANES == 0, "unsupported C");
};

// grid (tiles, B). part[b, tile, 0, g] = sum of x[b, rows of tile,
// channels of group g], part[b, tile, 1, g] = the sum of squares.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int N, int chunk,
                int groups) {
  using L = Layout<T, C>;
  __shared__ float red[2][L::RPAR * C];
  __shared__ float ch[2 * C];
  const int tile = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const int lane = threadIdx.x % L::LANES, rp = threadIdx.x / L::LANES;
  const int row_end = min(N, (tile + 1) * chunk);
  x += (size_t)b * N * C + lane * L::VEC;

  float s1[L::VEC], s2[L::VEC];
#pragma unroll
  for (int j = 0; j < L::VEC; ++j) s1[j] = s2[j] = 0.f;
  auto add = [&](const uint4& raw) {
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) {
      const float f = to_f32(v[j]);
      s1[j] += f;
      s2[j] = fmaf(f, f, s2[j]);
    }
  };
  int row = tile * chunk + rp;
  for (; row + 3 * L::RPAR < row_end; row += 4 * L::RPAR) {  // four loads in flight
    uint4 raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      raw[u] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(row + u * L::RPAR) * C));
#pragma unroll
    for (int u = 0; u < 4; ++u) add(raw[u]);
  }
  for (; row < row_end; row += L::RPAR)
    add(__ldg(reinterpret_cast<const uint4*>(x + (size_t)row * C)));
#pragma unroll
  for (int j = 0; j < L::VEC; ++j) {
    red[0][rp * C + lane * L::VEC + j] = s1[j];
    red[1][rp * C + lane * L::VEC + j] = s2[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += THREADS) {  // over the rows
    const float* col = red[i / C] + i % C;
    float acc = 0.f;
    for (int r = 0; r < L::RPAR; ++r) acc += col[r * C];
    ch[i] = acc;
  }
  __syncthreads();
  // over each group's channels: the apply pass reads 2 * groups values a
  // tile, not 2 * C
  const int cg = C / groups;
  float* dst = part + ((size_t)b * tiles + tile) * 2 * groups;
  for (int i = threadIdx.x; i < 2 * groups; i += THREADS) {
    const float* c0 = ch + (i / groups) * C + (i % groups) * cg;
    float acc = 0.f;
    for (int k = 0; k < cg; ++k) acc += c0[k];
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
  __shared__ float tmp[THREADS];
  __shared__ float sums[2 * C];
  __shared__ float scale_s[C], shift_s[C];
  const int tile = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;

  // the batch item's 2 * groups sums over its tiles: thread t adds tiles
  // t / n2g, + par, ... of entry t % n2g, then entry i adds its par partial
  // sums in order (every block adds in the same order: the same bits)
  const int n2g = 2 * groups, par = THREADS / n2g;
  const float* p = part + (size_t)b * tiles * n2g;
  if (threadIdx.x < par * n2g) {
    float acc = 0.f;
    for (int s = threadIdx.x / n2g; s < tiles; s += par)
      acc += p[(size_t)s * n2g + threadIdx.x % n2g];
    tmp[threadIdx.x] = acc;
  }
  __syncthreads();
  if (threadIdx.x < n2g) {
    float acc = 0.f;
    for (int j = 0; j < par; ++j) acc += tmp[j * n2g + threadIdx.x];
    sums[threadIdx.x] = acc;
  }
  __syncthreads();
  const int cg = C / groups;
  const float inv_n = 1.f / ((float)N * (float)cg);
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float mean = sums[c / cg] * inv_n;
    const float var = fmaxf(sums[groups + c / cg] * inv_n - mean * mean, 0.f);
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
  const int row_begin = tile * chunk;
  const int row_end = min(N, row_begin + chunk);
  const size_t base = (size_t)b * N * C + lane * L::VEC;
  mask += (size_t)b * T_len;
  auto apply = [&](int row, const uint4& raw) {
    const T* v = reinterpret_cast<const T*>(&raw);
    const float m = to_f32(mask[row % T_len]);
    uint4 res;
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < L::VEC; ++j)
      o[j] = from_f32<T>(mish_one_exp(fmaf(to_f32(v[j]), sc[j], sh[j])) * m);
    __stcs(reinterpret_cast<uint4*>(out + base + (size_t)row * C), res);
  };
  // row groups of RPAR rows, last to first, two loads in flight
  int grp = (row_end - row_begin + L::RPAR - 1) / L::RPAR - 1;
  for (; grp >= 1; grp -= 2) {
    const int r1 = row_begin + grp * L::RPAR + rp, r0 = r1 - L::RPAR;
    uint4 raw1;
    if (r1 < row_end) raw1 = __ldg(reinterpret_cast<const uint4*>(x + base + (size_t)r1 * C));
    const uint4 raw0 = __ldg(reinterpret_cast<const uint4*>(x + base + (size_t)r0 * C));
    if (r1 < row_end) apply(r1, raw1);
    apply(r0, raw0);
  }
  if (grp == 0) {
    const int r0 = row_begin + rp;
    if (r0 < row_end) apply(r0, __ldg(reinterpret_cast<const uint4*>(x + base + (size_t)r0 * C)));
  }
}

template <typename T, int C>
cudaError_t launch_stats(const void* x, void* part, int B, int N, int chunk, int tiles,
                         int groups, cudaStream_t stream) {
  gn_stats_kernel<T, C><<<dim3(tiles, B), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), N, chunk, groups);
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

// x [B, N, C] (16-byte aligned); part [B, tiles, 2, groups] f32; C %
// groups == 0 and groups <= 128. Tile s covers rows [s * chunk, min(N,
// (s + 1) * chunk)). Returns the launch's cudaError_t.
extern "C" int gtt_gn_stats(const void* x, void* part, int B, int N, int C, int chunk,
                            int tiles, int groups, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups <= 0 || C % groups != 0 || 2 * groups > THREADS) return (int)cudaErrorInvalidValue;
  if (dtype == gtt::kBFloat16) {
    GTT_DISPATCH_C(launch_stats, __nv_bfloat16, x, part, B, N, chunk, tiles, groups, st)
  }
  if (dtype == gtt::kFloat32) {
    GTT_DISPATCH_C(launch_stats, float, x, part, B, N, chunk, tiles, groups, st)
  }
  return (int)cudaErrorInvalidValue;
}

// x, out [B, N = F*T, C] and mask [B, T] in x's dtype; part from
// gtt_gn_stats at the same tiling and groups; gamma, beta [C] f32.
// Returns the launch's cudaError_t.
extern "C" int gtt_gn_apply(const void* x, const void* mask, const void* part, const void* gamma,
                            const void* beta, void* out, int B, int N, int T_len, int C,
                            int chunk, int tiles, int groups, float eps, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups <= 0 || C % groups != 0 || 2 * groups > THREADS) return (int)cudaErrorInvalidValue;
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
