// Monotonic alignment search (MAS) for Grad-TTS training: the Viterbi DP
// over the feasible band, then the backtrace.
//
// Replaces gradtts_tpu/ops/mas.py maximum_path (:88), which the JAX package
// runs as a lax.scan over the mel frames (_forward_dp :31, _backtrace :58);
// it is not a Pallas kernel. An eager PyTorch loop over the frames would
// issue ~2 * Ty small launches per training step.
//
// Function, for value, mask [B, Tx, Ty] f32 (t_x, t_y = the mask's row and
// column counts of item b):
//   V[x, y] = max(V[x, y-1] if x != y else -1e9,
//                 V[x-1, y-1] if x > 0 else (0 if y == 0 else -1e9))
//             + value[x, y] * mask[x, y]   inside the band
//   max(0, t_x + y - t_y) <= x < min(t_x, y + 1), value * mask outside it;
//   then from (t_x - 1, t_y - 1) backwards, x moves to x - 1 after frame y
//   when x != 0 and (x == y or V[x, y-1] < V[x-1, y-1]).
// The f32 additions are the same, in the same order, as in the JAX scan and
// the plain PyTorch version, so the path is bit-exact.
//
// What bounds it on the H100: the bytes are value and mask read once and
// the path written once (12 bytes per cell, ~22 us at B 16, Tx 384,
// Ty 1024), but the DP is a chain of t_y dependent column steps. So it is
// bound by that chain (and by the instructions one warp issues for it), not
// by bytes or operations.
//
// Two routes, chosen by shape in ops/mas.py (mas_route):
//
// mas_dp_kernel<K> (Tx <= 32 K, K <= 16: every x bucket up to 512), one
// block of 8 warps per batch item. Warp 0 runs the DP with the whole text
// axis in registers: lane l holds the K cells x = l K + i of the current
// column, and a frame needs from its neighbour only V[l K - 1, y - 1], one
// __shfl_up_sync; there is no block barrier in the frame loop. It stops at
// t_y (no later frame reaches the path) and skips the band test (dp_frame
// says why the path is the same), so a frame costs a cell a compare, a
// max and an add, and a select in the first Tx frames for the diagonal.
// Six warps (none on warp 0's scheduler) stream value * mask into a ring
// of 2-4 16-frame tiles ahead of it (named barriers: full, empty), each
// thread with up to 16 16-byte loads in flight, laid out [frame][lane][i]
// so that the DP warp reads its K cells of a frame with 16-byte loads,
// without bank conflicts. Each cell's move
// decision is a bit, packed over 32 frames into a word per (lane, i), and
// the words stay in shared memory (Tx Ty / 8 bytes). The backtrace walks
// them on chip: for each 32-frame word, lane j fetches the word of cell
// index - j, 32 ballots turn those into one 32-bit mask a frame (bit j:
// cell index - j moves), and the walk over the 32 frames is then a shift,
// an and and an add a frame in registers. It writes the text index of each
// frame (index_of [B, Ty], -1 past t_y), and mas_path_kernel, a second
// launch over the whole card, writes path = (index_of[b, y] == x).
//
// mas_kernel (any Tx; the route above Tx 512 or where the ring and the
// decision words exceed shared memory), one block of 512 threads per batch
// item: threads stride over x. The block stages a tile of TY columns of
// value * mask in shared memory with coalesced row reads, then walks them
// keeping the previous column on chip (two column buffers), a block
// barrier a frame. Each cell's move decision goes to a byte tile that is
// written out coalesced; one thread then walks the decisions back from the
// last frame, and all threads write the whole path, row by row.

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int TY = 32;             // columns per staged tile
constexpr float MAX_NEG = -1e9f;   // ops/mas.py MAX_NEG

__host__ __device__ constexpr size_t mas_smem(int tx, int ty) {
  return (size_t)tx * (TY + 1) * sizeof(float)   // value * mask tile
         + 2 * (size_t)tx * sizeof(float)         // previous / current column
         + (size_t)ty * sizeof(int)               // text index of each frame
         + (size_t)tx * TY;                       // decision tile (bytes)
}

__global__ void __launch_bounds__(THREADS)
mas_kernel(const float* __restrict__ value, const float* __restrict__ mask,
           unsigned char* __restrict__ decision, float* __restrict__ path, int tx_max,
           int ty_max) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* raw = reinterpret_cast<float*>(smem_raw);      // [Tx, TY + 1]
  float* col0 = raw + (size_t)tx_max * (TY + 1);       // [Tx]
  float* col1 = col0 + tx_max;                          // [Tx]
  int* index_of = reinterpret_cast<int*>(col1 + tx_max);  // [Ty]
  unsigned char* dec_tile = reinterpret_cast<unsigned char*>(index_of + ty_max);  // [Tx, TY]
  __shared__ int counts[2];

  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * tx_max * ty_max;
  value += base;
  mask += base;
  decision += base;
  path += base;

  // t_x = #{x : mask[x, 0] != 0}, t_y = #{y : mask[0, y] != 0} (integer
  // counts, so the order of the shared atomics does not matter)
  if (tid < 2) counts[tid] = 0;
  __syncthreads();
  int cx = 0, cy = 0;
  for (int x = tid; x < tx_max; x += THREADS) cx += mask[(size_t)x * ty_max] != 0.f;
  for (int y = tid; y < ty_max; y += THREADS) cy += mask[y] != 0.f;
  if (cx) atomicAdd(&counts[0], cx);
  if (cy) atomicAdd(&counts[1], cy);
  for (int x = tid; x < tx_max; x += THREADS) col0[x] = MAX_NEG;
  __syncthreads();
  const int t_x = counts[0], t_y = counts[1];

  float* prev = col0;
  float* cur = col1;
  for (int y0 = 0; y0 < ty_max; y0 += TY) {
    const int ny = min(TY, ty_max - y0);
    for (int i = tid; i < tx_max * TY; i += THREADS) {
      const int x = i / TY, j = i % TY;
      if (j < ny) {
        const size_t at = (size_t)x * ty_max + y0 + j;
        raw[x * (TY + 1) + j] = value[at] * mask[at];
      }
    }
    __syncthreads();
    for (int j = 0; j < ny; ++j) {
      const int y = y0 + j;
      const int lo = max(0, t_x + y - t_y), hi = min(t_x, y + 1);
      for (int x = tid; x < tx_max; x += THREADS) {
        const float here = prev[x];
        const float diag = x > 0 ? prev[x - 1] : (y == 0 ? 0.f : MAX_NEG);
        // the backtrace's move test reads column y - 1 as it stands
        dec_tile[x * TY + j] = x != 0 && y != 0 && (x == y || here < diag);
        const float r = raw[x * (TY + 1) + j];
        const float v_cur = x == y ? MAX_NEG : here;
        cur[x] = (x >= lo && x < hi) ? fmaxf(v_cur, diag) + r : r;
      }
      __syncthreads();
      float* t = prev;
      prev = cur;
      cur = t;
    }
    for (int i = tid; i < tx_max * TY; i += THREADS) {
      const int x = i / TY, j = i % TY;
      if (j < ny) decision[(size_t)x * ty_max + y0 + j] = dec_tile[i];
    }
    __syncthreads();
  }

  // Backtrace: the frames' text indices, -1 past t_y. The decisions were
  // written by this block, and __syncthreads made them visible to it.
  if (tid == 0) {
    int index = t_x - 1;
    for (int y = ty_max - 1; y >= 0; --y) {
      if (y < t_y) {
        index_of[y] = index;
        if (index > 0 && decision[(size_t)index * ty_max + y]) --index;
      } else {
        index_of[y] = -1;
      }
    }
  }
  __syncthreads();
  for (size_t i = tid; i < (size_t)tx_max * ty_max; i += THREADS) {
    const int x = (int)(i / ty_max), y = (int)(i % ty_max);
    path[i] = index_of[y] == x ? 1.f : 0.f;
  }
}

// ---- the register-resident DP --------------------------------------------

constexpr int DP_FRAMES = 16;                 // frames per ring tile
constexpr int DP_MAX_STAGES = 4;
// 8 warps: warp 0 runs the DP, warps 1-3 and 5-7 produce; warp 4, which
// would share warp 0's scheduler (warp % 4), only counts the lengths
constexpr int DP_THREADS = 256;
constexpr int DP_PRODUCERS = 6;
constexpr int DP_BAR = 32 * (1 + DP_PRODUCERS);   // threads at the named barriers
constexpr int DP_BATCH = 8;                   // 16-byte loads a producer keeps in flight, per input
constexpr int BAR_FULL = 1, BAR_EMPTY = BAR_FULL + DP_MAX_STAGES;  // named barriers
constexpr size_t DP_SMEM_MAX = 226 * 1024;   // dynamic, beside the static counts

// The ring's layout at K cells a lane: frame j, lane l, cell i at float
// j FS + l LS + i. LS pads K to 4 mod 8 floats (K 8 and 16 would put two
// of the 8 lanes of a 16-byte load phase on one bank), FS keeps the 16
// frames of a producer warp's stores apart by 4 banks.
template <int K>
struct DpLayout {
  static constexpr int LS = K % 8 == 0 ? K + 4 : K;
  static constexpr int FS = 32 * LS + 4;
  static constexpr size_t tile_bytes = (size_t)DP_FRAMES * FS * sizeof(float);
  // the decision words: 32 frames x (32 lanes x K cells) bits
  __host__ __device__ static constexpr size_t dec_bytes(int ty) {
    return (size_t)((ty + 31) / 32) * K * 32 * sizeof(uint32_t);
  }
  // ring stages: as many as fit beside the decision words, 2 to 4
  __host__ __device__ static constexpr int stages(int ty) {
    return dec_bytes(ty) + 2 * tile_bytes > DP_SMEM_MAX ? 0
           : (int)((DP_SMEM_MAX - dec_bytes(ty)) / tile_bytes < DP_MAX_STAGES
                       ? (DP_SMEM_MAX - dec_bytes(ty)) / tile_bytes
                       : DP_MAX_STAGES);
  }
  __host__ __device__ static constexpr size_t smem(int ty) {
    return stages(ty) * tile_bytes + dec_bytes(ty);
  }
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Frames y0 + [j0, j1) of the DP for a lane's K cells x0 + i (v: column
// y - 1 in, column y out; tile: value * mask of frame y0 + j at j FS,
// 16-byte aligned). The band test is left out: a cell inside the band
// reads only cells inside the band at y - 1 (V[x, y-1] for x < y,
// V[x-1, y-1]: lo(y) - 1 <= lo(y - 1) and hi(y - 1) = min(t_x, y)), and the
// backtrace visits only cells inside the band, whose move tests read only
// cells inside it at y - 1. So every value the path depends on is the
// function's, added in the same order; cells outside the band hold values
// nothing reads. DIAG: frames with a cell on the diagonal x == y (y < Tx),
// which takes -1e9 for V[x, y-1] and always moves.
//
// The move test V[x, y-1] < V[x-1, y-1] is the sign of their difference
// (two distinct finite floats never subtract to zero; equal ones give +0),
// funnel-shifted into bits[i] a frame, newest in bit 0; every 32 frames
// (or at t_y - 1) the word is stored with frame y & 31 at bit y & 31.
template <int K, bool DIAG>
__device__ __forceinline__ void dp_frames(float (&v)[K], uint32_t (&bits)[K],
                                          const float* __restrict__ tile, int fs, int y0, int j0,
                                          int j1, int x0, int lane, int t_y,
                                          uint32_t* __restrict__ dec) {
#pragma unroll 1
  for (int j = j0; j < j1; ++j) {
    const int y = y0 + j;
    const float up = __shfl_up_sync(0xffffffffu, v[K - 1], 1);
    const float head = lane == 0 ? (y == 0 ? 0.f : MAX_NEG) : up;
    float r[K];
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(tile + j * fs + i);
      r[i] = q4.x;
      r[i + 1] = q4.y;
      r[i + 2] = q4.z;
      r[i + 3] = q4.w;
    }
    const int eq = y - x0;
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      const float here = v[i];
      const float diag = i > 0 ? v[i > 0 ? i - 1 : 0] : head;
      const bool on_diag = DIAG && i == eq;
      const float d = on_diag ? -1.f : here - diag;
      bits[i] = __funnelshift_l(__float_as_uint(d), bits[i], 1);
      v[i] = fmaxf(on_diag ? MAX_NEG : here, diag) + r[i];
    }
    if ((y & 31) == 31 || y == t_y - 1) {
      uint32_t* word = dec + (size_t)(y >> 5) * K * 32 + lane;
      const int pad = 31 - (y & 31);
#pragma unroll
      for (int i = 0; i < K; ++i)   // x == 0 never moves
        word[i * 32] = (lane == 0 && i == 0) ? 0u : __brev(bits[i] << pad);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(DP_THREADS, 1)
mas_dp_kernel(const float* __restrict__ value, const float* __restrict__ mask,
              int* __restrict__ index_of, int tx_max, int ty_max) {
  using L = DpLayout<K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int n_stages = L::stages(ty_max);
  // the move bits, [Ty / 32][K][32] words
  uint32_t* dec = reinterpret_cast<uint32_t*>(smem_raw + n_stages * L::tile_bytes);
  __shared__ int counts[2];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t base = (size_t)blockIdx.x * tx_max * ty_max;
  value += base;
  mask += base;
  index_of += (size_t)blockIdx.x * ty_max;

  // t_x = #{x : mask[x, 0] != 0}, t_y = #{y : mask[0, y] != 0}
  if (tid < 2) counts[tid] = 0;
  __syncthreads();
  int cx = 0, cy = 0;
  for (int x = tid; x < tx_max; x += DP_THREADS) cx += mask[(size_t)x * ty_max] != 0.f;
  for (int y = tid; y < ty_max; y += DP_THREADS) cy += mask[y] != 0.f;
  if (cx) atomicAdd(&counts[0], cx);
  if (cy) atomicAdd(&counts[1], cy);
  __syncthreads();
  const int t_x = counts[0], t_y = counts[1];
  const int n_tiles = (t_y + DP_FRAMES - 1) / DP_FRAMES;

  if (warp == 4) return;
  if (warp > 0) {
    // producers: tile t holds frames 16 t.. of value * mask. Where rows are
    // 16-byte aligned (Ty % 4 == 0), unit u is 4 frames (q4 = u % 4) of
    // cell x = u / 4: a warp reads 8 rows' 64 contiguous bytes, and each
    // thread first issues up to DP_BATCH loads of each input, then
    // multiplies and stores them (latency, not bandwidth, bounds 16 SMs)
    const int p0 = 32 * (warp - 1 - (warp > 4)) + lane;
    constexpr int NP = 32 * DP_PRODUCERS;
    const bool vec = ty_max % 4 == 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % n_stages;
      if (t >= n_stages) bar_sync(BAR_EMPTY + st, DP_BAR);
      float* tile = ring + (size_t)st * DP_FRAMES * L::FS;
      const int y0 = t * DP_FRAMES;
      if (vec) {
        const int units = tx_max * (DP_FRAMES / 4);
        for (int u0 = p0; u0 < units; u0 += NP * DP_BATCH) {
          float4 va[DP_BATCH], ma[DP_BATCH];
#pragma unroll
          for (int k = 0; k < DP_BATCH; ++k) {
            const int u = u0 + k * NP, y = y0 + 4 * (u % 4);
            va[k] = ma[k] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (u < units && y < ty_max) {
              const size_t at = (size_t)(u / 4) * ty_max + y;
              va[k] = __ldg(reinterpret_cast<const float4*>(value + at));
              ma[k] = __ldg(reinterpret_cast<const float4*>(mask + at));
            }
          }
#pragma unroll
          for (int k = 0; k < DP_BATCH; ++k) {
            const int u = u0 + k * NP;
            if (u < units) {
              const int x = u / 4;
              float* dst = tile + 4 * (u % 4) * L::FS + (x / K) * L::LS + x % K;
              dst[0] = va[k].x * ma[k].x;
              dst[L::FS] = va[k].y * ma[k].y;
              dst[2 * L::FS] = va[k].z * ma[k].z;
              dst[3 * L::FS] = va[k].w * ma[k].w;
            }
          }
        }
      } else {
        for (int p = p0; p < tx_max * DP_FRAMES; p += NP) {
          const int x = p / DP_FRAMES, j = p % DP_FRAMES, y = y0 + j;
          float r = 0.f;
          if (y < ty_max) {
            const size_t at = (size_t)x * ty_max + y;
            r = value[at] * mask[at];
          }
          tile[j * L::FS + (x / K) * L::LS + x % K] = r;
        }
      }
      bar_arrive(BAR_FULL + st, DP_BAR);
    }
    return;
  }

  // the DP warp: v[i] = V[lane K + i, y - 1]
  float v[K];
  uint32_t bits[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[i] = MAX_NEG;
    bits[i] = 0u;
  }
  const int x0 = lane * K;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % n_stages;
    bar_sync(BAR_FULL + st, DP_BAR);
    const float* tile = ring + (size_t)st * DP_FRAMES * L::FS + lane * L::LS;
    const int y0 = t * DP_FRAMES;
    const int nf = min(DP_FRAMES, t_y - y0);
    // frames with a diagonal cell first (y < Tx), then the rest
    const int jd = min(nf, max(0, tx_max - y0));
    dp_frames<K, true>(v, bits, tile, L::FS, y0, 0, jd, x0, lane, t_y, dec);
    dp_frames<K, false>(v, bits, tile, L::FS, y0, jd, nf, x0, lane, t_y, dec);
    if (t + n_stages < n_tiles) bar_arrive(BAR_EMPTY + st, DP_BAR);
  }
  __syncwarp();

  // backtrace from (t_x - 1, t_y - 1); frames past t_y get -1
  for (int w = (ty_max - 1) >> 5; w > (t_y - 1) >> 5; --w)
    if (32 * w + lane < ty_max) index_of[32 * w + lane] = -1;
  int index = t_x - 1;
  for (int w = (t_y - 1) >> 5; w >= 0; --w) {
    const int cell = index - lane;
    const uint32_t word =
        cell >= 0 ? dec[(size_t)w * K * 32 + (cell % K) * 32 + cell / K] : 0u;
    uint32_t moves[32];
#pragma unroll
    for (int yb = 0; yb < 32; ++yb) moves[yb] = __ballot_sync(0xffffffffu, (word >> yb) & 1u);
    int m = 0, mine = -1;
#pragma unroll
    for (int yb = 31; yb >= 0; --yb) {
      if (32 * w + yb < t_y) {
        if (lane == yb) mine = index - m;
        m += (int)((moves[yb] >> m) & 1u);   // m <= 31 here: one move a frame at most
      }
    }
    if (32 * w + lane < ty_max) index_of[32 * w + lane] = mine;
    index -= m;
  }
}

// path [B, Tx, Ty] = (index_of[b, y] == x), over the whole card; four
// cells a thread (16-byte stores) where Ty allows.
__global__ void mas_path_kernel(const int* __restrict__ index_of, float* __restrict__ path,
                                int B, int tx_max, int ty_max) {
  const size_t cells = (size_t)B * tx_max * ty_max;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  if (ty_max % 4 == 0) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < cells / 4; i += stride) {
      const size_t c = 4 * i;
      const size_t row = c / ty_max;   // b * tx_max + x
      const int y = (int)(c - row * ty_max), x = (int)(row % tx_max);
      const int4 idx = *reinterpret_cast<const int4*>(index_of + (row / tx_max) * ty_max + y);
      reinterpret_cast<float4*>(path)[i] =
          make_float4(idx.x == x, idx.y == x, idx.z == x, idx.w == x);
    }
  } else {
    for (size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x; c < cells; c += stride) {
      const size_t row = c / ty_max;
      const int y = (int)(c - row * ty_max), x = (int)(row % tx_max);
      path[c] = index_of[(row / tx_max) * ty_max + y] == x ? 1.f : 0.f;
    }
  }
}

template <int K>
cudaError_t launch_mas_dp(const float* value, const float* mask, int* index_of, float* path,
                          int B, int tx_max, int ty_max, cudaStream_t stream) {
  const size_t smem = DpLayout<K>::smem(ty_max);
  if (tx_max > 32 * K || DpLayout<K>::stages(ty_max) < 2) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mas_dp_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mas_dp_kernel<K><<<B, DP_THREADS, smem, stream>>>(value, mask, index_of, tx_max, ty_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mas_path_kernel<<<4 * 132, 256, 0, stream>>>(index_of, path, B, tx_max, ty_max);
  return cudaGetLastError();
}

}  // namespace

// The register-resident route. value, mask [B, Tx, Ty] f32, Tx <= 32 K;
// index_of [B, Ty] int32 scratch; path [B, Tx, Ty] f32 out. K is one of 4,
// 8, 12, 16 (ops/mas.py mas_route). Returns the first failing launch's
// cudaError_t (an invalid value for a K, Tx or Ty the route does not take).
extern "C" int gtt_mas_dp(const void* value, const void* mask, void* index_of, void* path,
                          int B, int tx_max, int ty_max, int K, void* stream) {
  const float* v = static_cast<const float*>(value);
  const float* m = static_cast<const float*>(mask);
  int* idx = static_cast<int*>(index_of);
  float* p = static_cast<float*>(path);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 4: return (int)launch_mas_dp<4>(v, m, idx, p, B, tx_max, ty_max, st);
    case 8: return (int)launch_mas_dp<8>(v, m, idx, p, B, tx_max, ty_max, st);
    case 12: return (int)launch_mas_dp<12>(v, m, idx, p, B, tx_max, ty_max, st);
    case 16: return (int)launch_mas_dp<16>(v, m, idx, p, B, tx_max, ty_max, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The block route. value, mask [B, Tx, Ty] f32; decision [B, Tx, Ty] uint8 scratch; path
// [B, Tx, Ty] f32 out. Returns the launch's cudaError_t (an invalid value
// when the tiles of a Tx this large exceed the 227 KB of shared memory).
extern "C" int gtt_mas(const void* value, const void* mask, void* decision, void* path, int B,
                       int tx_max, int ty_max, void* stream) {
  const size_t smem = mas_smem(tx_max, ty_max);
  cudaError_t err = cudaFuncSetAttribute(mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  mas_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(mask),
      static_cast<unsigned char*>(decision), static_cast<float*>(path), tx_max, ty_max);
  return cudaGetLastError();
}
