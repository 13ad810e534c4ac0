// Monotonic alignment search (MAS) for Grad-TTS training: the Viterbi DP
// over the feasible band, then the backtrace, one block per batch item.
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
// Ty 1024), but the DP is a chain of Ty dependent column steps, each a
// handful of operations per text position followed by a block barrier. So
// it is bound by the latency of that chain, not by bytes or operations.
//
// Design: threads stride over x (so any Tx works, above blockDim too). The
// block stages a tile of TY columns of value * mask in shared memory with
// coalesced row reads, then walks them keeping the previous column on chip
// (two column buffers). Each cell's move decision, all that the backtrace
// reads, goes to a byte tile that is written out coalesced. One thread then
// walks the decisions back from the last frame and records the text index
// of every frame; last, all threads write the whole path, row by row.

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

}  // namespace

// value, mask [B, Tx, Ty] f32; decision [B, Tx, Ty] uint8 scratch; path
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
