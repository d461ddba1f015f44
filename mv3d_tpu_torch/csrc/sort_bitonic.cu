// Stable bitonic sort of an int32 key carrying two f32 payloads, batched
// over rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel body `_sort_kernel` of mv3d_tpu/ops/sort_pallas.py
// (reached through `bitonic_sort_pallas`): a stable ascending sort of one
// frame's (flat, hval, refl), equal to lax.sort((key, iota, p1, p2),
// num_keys=2) with the iota dropped. The TPU kernel keeps the whole row in
// VMEM and switches between a row-major and a transposed layout so that
// every exchange distance lands on its sublane axis; that is a matter of
// the TPU's (8, 128) tiling and is not carried over. Here:
//
//   composite key  ((uint32)key ^ 0x80000000) << 32 | index, one 64-bit
//                  word that orders signed keys and breaks ties by the
//                  original index: every word is unique, so the network's
//                  output is exactly the stable order, whatever the order
//                  in which its compare-exchanges run.
//   local kernel   one block per (row, chunk of C = min(n, 4096)
//                  elements): the chunk (64 KB: 8-byte word + two f32) is
//                  loaded into shared memory, every stage whose pair
//                  distance j < C runs there, and the chunk is written
//                  back. The first launch runs all stages with k <= C.
//   global step    for k > C, each stage with j >= C is one launch of one
//                  thread per pair, in global memory; then the local
//                  kernel runs that k's j < C tail.
//
// Launches per call: 1 + sum over k = 2C .. n of (log2(k / C) + 1); for
// n = 65,536 that is 15. Rows go on blockIdx.y, so a batch of frames is
// one call. The payloads are sorted in place in the output buffers; the
// composite keys live in a (B, n) 64-bit scratch the caller allocates.
//
// What bounds it: a sorting network makes log2(n) (log2(n) + 1) / 2
// passes (136 for n = 65,536) over its data, against the one read and one
// write of a byte bound; the passes with j < C stay in shared memory, the
// 14 with j >= C go through L2 (a 65,536-row frame is 1 MB). The sort's
// wrapper (ops/sort_bitonic.py) sends it only rows longer than the cluster
// radix sort holds (sort_radix.cu, 65,536 elements), such as uncropped
// sweeps of 131,072 points.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC. Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 4096;
constexpr int kLocalThreads = 1024;
constexpr int kStepThreads = 256;

__device__ __forceinline__ unsigned long long compose(int32_t key,
                                                      int64_t index) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(key) ^
                                          0x80000000u) << 32) |
         static_cast<unsigned long long>(static_cast<uint32_t>(index));
}

__device__ __forceinline__ int32_t key_of(unsigned long long word) {
  return static_cast<int32_t>(static_cast<uint32_t>(word >> 32) ^
                              0x80000000u);
}

// Position of the lower element of pair p at distance j (a power of two).
__device__ __forceinline__ int64_t pair_low(int64_t p, int64_t j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// Stages k = k_first .. k_last (doubling), each with j = min(k, chunk)/2
// down to 1, on one chunk in shared memory. Reads the keys from `in_key`
// (composing them) when it is not null, else from `in_word`; writes the
// int32 keys to `out_key` when it is not null, else the words to
// `out_word`. Payloads may be sorted in place (in_p* == out_p*): each
// block reads and writes only its own chunk.
__global__ void sort_local(const int32_t* __restrict__ in_key,
                           const unsigned long long* in_word,
                           const float* in_p1, const float* in_p2,
                           unsigned long long* out_word, int32_t* out_key,
                           float* out_p1, float* out_p2, int64_t n,
                           int32_t chunk, int64_t k_first, int64_t k_last) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_word = smem;
  float* s_p1 = reinterpret_cast<float*>(s_word + chunk);
  float* s_p2 = s_p1 + chunk;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n + first;

  for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
    s_word[t] = in_key != nullptr ? compose(in_key[base + t], first + t)
                                  : in_word[base + t];
    s_p1[t] = in_p1[base + t];
    s_p2[t] = in_p2[base + t];
  }
  __syncthreads();

  const int half = chunk >> 1;
  for (int64_t k = k_first; k <= k_last; k <<= 1) {
    for (int j = static_cast<int>((k < chunk ? k : chunk) >> 1); j > 0;
         j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int lo = static_cast<int>(pair_low(p, j));
        const int hi = lo + j;
        const bool desc = ((first + lo) & k) != 0;
        const unsigned long long a = s_word[lo];
        const unsigned long long b = s_word[hi];
        if ((a > b) != desc) {
          s_word[lo] = b;
          s_word[hi] = a;
          const float x1 = s_p1[lo];
          s_p1[lo] = s_p1[hi];
          s_p1[hi] = x1;
          const float x2 = s_p2[lo];
          s_p2[lo] = s_p2[hi];
          s_p2[hi] = x2;
        }
      }
      __syncthreads();
    }
  }

  for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
    if (out_key != nullptr) {
      out_key[base + t] = key_of(s_word[t]);
    } else {
      out_word[base + t] = s_word[t];
    }
    out_p1[base + t] = s_p1[t];
    out_p2[base + t] = s_p2[t];
  }
}

// One stage (k, j) with j >= chunk, one thread per pair, in place.
__global__ void sort_global_step(unsigned long long* __restrict__ word,
                                 float* __restrict__ p1,
                                 float* __restrict__ p2, int64_t n,
                                 int64_t k, int64_t j) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= (n >> 1)) return;
  const int64_t lo = pair_low(p, j);
  const int64_t row = static_cast<int64_t>(blockIdx.y) * n;
  const int64_t a_at = row + lo;
  const int64_t b_at = a_at + j;
  const bool desc = (lo & k) != 0;
  const unsigned long long a = word[a_at];
  const unsigned long long b = word[b_at];
  if ((a > b) != desc) {
    word[a_at] = b;
    word[b_at] = a;
    const float x1 = p1[a_at];
    p1[a_at] = p1[b_at];
    p1[b_at] = x1;
    const float x2 = p2[a_at];
    p2[a_at] = p2[b_at];
    p2[b_at] = x2;
  }
}

}  // namespace

// Sorts `batch` rows of `n` (a power of two, >= 2) (key, p1, p2) triples
// by key, stably, into (out_key, out_p1, out_p2). `word` is a (batch, n)
// 64-bit scratch, unused when n <= 4096. Returns 0 on success, else the
// cudaError_t of the failed call.
extern "C" int mv3d_sort_bitonic(const int32_t* key, const float* p1,
                                 const float* p2, int64_t batch, int64_t n,
                                 int32_t* out_key, float* out_p1,
                                 float* out_p2, unsigned long long* word,
                                 void* stream) {
  if (batch <= 0 || n <= 1) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t chunk = static_cast<int32_t>(n < kChunk ? n : kChunk);
  const size_t smem = static_cast<size_t>(chunk) *
                      (sizeof(unsigned long long) + 2 * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      sort_local, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int local_threads = chunk / 2 < kLocalThreads ? chunk / 2
                                                      : kLocalThreads;
  const dim3 local_grid(static_cast<unsigned>(n / chunk),
                        static_cast<unsigned>(batch));
  const bool single = n <= chunk;

  sort_local<<<local_grid, local_threads, smem, st>>>(
      key, nullptr, p1, p2, single ? nullptr : word,
      single ? out_key : nullptr, out_p1, out_p2, n, chunk, 2, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 step_grid(
      static_cast<unsigned>((n / 2 + kStepThreads - 1) / kStepThreads),
      static_cast<unsigned>(batch));
  for (int64_t k = 2 * static_cast<int64_t>(chunk); k <= n; k <<= 1) {
    for (int64_t j = k >> 1; j >= chunk; j >>= 1) {
      sort_global_step<<<step_grid, kStepThreads, 0, st>>>(
          word, out_p1, out_p2, n, k, j);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const bool last = k == n;
    sort_local<<<local_grid, local_threads, smem, st>>>(
        nullptr, word, out_p1, out_p2, last ? nullptr : word,
        last ? out_key : nullptr, out_p1, out_p2, n, chunk, k, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
