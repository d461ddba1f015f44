// Stable merge of sorted runs of an int32 key carrying two f32 payloads,
// one merge-path pass per launch, for Hopper (sm_90a).
//
// Together with the cluster radix sort (sort_radix.cu) it replaces the TPU
// kernel body `_sort_kernel` of mv3d_tpu/ops/sort_pallas.py (reached
// through `bitonic_sort_pallas`) on rows longer than one cluster holds
// (65,536 elements): the wrapper (ops/sort_bitonic.py) sorts a row of
// n = 65,536 * 2^k as 2^k independent blocks in one radix launch, then runs
// k passes of this kernel, each merging pairs of sorted runs of length
// `run` into runs of 2*run, ping-ponging between two buffers of the row's
// size.
//
//   tiles       the output of every pair is cut into tiles of kTile = 2,048
//               positions (a run is at least 65,536 long, so a tile never
//               crosses a pair); one block of kThreads = 256 threads per
//               tile, all rows and pairs on one grid.
//   split       thread 0 finds where the tile's first and last output
//               position cut the two runs (a binary search on the
//               merge-path diagonal); the block loads those ranges of both
//               runs (at most kTile keys in all) into shared memory.
//   merge       each thread searches its own diagonal (every kItems = 8
//               outputs) in shared memory and merges its 8 outputs
//               sequentially into registers; the block then puts them
//               back into the shared tile and stores it in row order
//               (coalesced): key, p1 and p2 move together; 24 KB of
//               static shared memory per block.
//   stability   the left run holds the lower original indices, so on equal
//               keys the left run goes first: the diagonal search takes
//               A[i] before B[j] when A[i] <= B[j], as the sequential merge
//               does. With stable blocks below, the result is the stable
//               sort of the whole row, bit for bit.
//
// What bounds it: one pass reads and writes the row once (12 B an element:
// 3.1 MB for a 131,072 row and its two payloads, ~1 us at 3.35 TB/s per
// row); the binary searches are log2(run) dependent reads from L2 per
// block and per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC. Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

// The number of elements of `a` (length na) among the first `diag` outputs
// of the stable merge of a then b: the first i with a[i] > b[diag-1-i].
__device__ __forceinline__ int merge_split(const int32_t* a, int na,
                                           const int32_t* b, int nb,
                                           int diag) {
  int lo = max(0, diag - nb);
  int hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[diag - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
merge_pass(const int32_t* __restrict__ key, const float* __restrict__ p1,
           const float* __restrict__ p2, int64_t run,
           int32_t* __restrict__ out_key, float* __restrict__ out_p1,
           float* __restrict__ out_p2) {
  __shared__ int32_t s_key[kTile];
  __shared__ float s_p1[kTile];
  __shared__ float s_p2[kTile];
  __shared__ int split[2];

  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t pair = first / (2 * run);     // rows are whole pairs
  const int64_t a0 = pair * 2 * run;          // the left run's first index
  const int64_t b0 = a0 + run;
  const int d0 = static_cast<int>(first - a0);
  const int na = static_cast<int>(run);

  if (tid < 2) {
    split[tid] = merge_split(key + a0, na, key + b0, na, d0 + tid * kTile);
  }
  __syncthreads();
  const int ia = split[0];
  const int la = split[1] - ia;               // left keys in this tile
  const int ib = d0 - ia;
  const int lb = kTile - la;                  // right keys in this tile
  for (int t = tid; t < kTile; t += kThreads) {
    const int64_t src = t < la ? a0 + ia + t : b0 + ib + (t - la);
    s_key[t] = key[src];
    s_p1[t] = p1[src];
    s_p2[t] = p2[src];
  }
  __syncthreads();

  const int diag = tid * kItems;
  int i = merge_split(s_key, la, s_key + la, lb, diag);
  int j = la + diag - i;
  int32_t k_out[kItems];
  float p1_out[kItems], p2_out[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool take_a =
        i < la && (j >= kTile || s_key[i] <= s_key[j]);
    const int src = take_a ? i : j;
    k_out[k] = s_key[src];
    p1_out[k] = s_p1[src];
    p2_out[k] = s_p2[src];
    i += take_a;
    j += !take_a;
  }
  __syncthreads();   // every thread has read its inputs: reuse the tile
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    s_key[diag + k] = k_out[k];
    s_p1[diag + k] = p1_out[k];
    s_p2[diag + k] = p2_out[k];
  }
  __syncthreads();
  for (int t = tid; t < kTile; t += kThreads) {
    out_key[first + t] = s_key[t];
    out_p1[first + t] = s_p1[t];
    out_p2[first + t] = s_p2[t];
  }
}

}  // namespace

// Positions of output each block merges; runs must be multiples of it.
extern "C" int mv3d_sort_merge_tile() { return kTile; }

// One merge pass over `batch` rows of `n` elements, each made of sorted
// runs of `run` elements (run a multiple of kTile, n a multiple of
// 2 * run): pairs of runs merged stably, the left run first on equal keys,
// into (out_key, out_p1, out_p2). Returns 0 on success, else the
// cudaError_t of the failed launch.
extern "C" int mv3d_sort_merge(const int32_t* key, const float* p1,
                               const float* p2, int64_t batch, int64_t n,
                               int64_t run, int32_t* out_key, float* out_p1,
                               float* out_p2, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (run <= 0 || run % kTile != 0 || n % (2 * run) != 0 ||
      run > (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = batch * n / kTile;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  merge_pass<<<static_cast<unsigned>(blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      key, p1, p2, run, out_key, out_p1, out_p2);
  return static_cast<int>(cudaGetLastError());
}
