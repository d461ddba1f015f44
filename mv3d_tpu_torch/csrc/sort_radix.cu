// Stable LSD radix sort of an int32 key carrying two f32 payloads, one
// thread-block cluster per row, in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel body `_sort_kernel` of mv3d_tpu/ops/sort_pallas.py
// (reached through `bitonic_sort_pallas`): a stable ascending sort of one
// frame's (flat, hval, refl), equal to lax.sort((key, iota, p1, p2),
// num_keys=2) with the iota dropped. The TPU runs a bitonic network over a
// row held in VMEM; on this card a network of 136 stages at n = 65,536 is
// bound by its stage count, so this kernel sorts by digits instead:
//
//   cluster      one cluster of kCluster = 8 CTAs (the portable size) per
//                row, rows on gridDim.y, one launch per call. CTA r owns
//                the row's slice [r*m, (r+1)*m), m = n / 8: 1024 threads x
//                8 elements, so a cluster holds at most 65,536 elements
//                (kCapacity). The wrapper sorts longer rows as blocks of
//                kCapacity here, then merges them (sort_merge.cu).
//   buffers      each CTA keeps its slice of (key, p1, p2) in shared
//                memory, 12 B an element, twice: the row buffer, in row
//                order, and a stage, grouped by the pass's digit; 192 KiB
//                of the 211 KiB per CTA at m = 8,192. The payloads ride
//                along, so nothing is gathered at the end.
//   plan         keys are flipped (key ^ 0x80000000) so signed order is
//                unsigned order. A cluster-wide min/max of the row gives
//                the bits that vary: all keys share the bits above the
//                highest bit of (min ^ max). Only the 8-bit digits at or
//                below that bit are sorted: 0 passes when all keys are
//                equal, 3 for voxel ids below 2^24, 4 for the full range.
//   one pass     (1) each warp ranks its 256 keys (held in registers, in
//                slice order) among equal digits with one warp ballot per
//                digit bit and a per-warp counter row; (2) per digit, the
//                warps' counts become an exclusive prefix, the CTA's total and
//                the digit's first stage slot; (3) the CTA copies its
//                slice into the stage, grouped by digit (shared memory
//                only); cluster barrier; (4) each CTA reads the 8 CTAs'
//                totals through distributed shared memory (DSMEM) and
//                scans them into each digit's first row position; (5)
//                the stage goes to the row buffers through DSMEM, each
//                digit's run contiguous at both ends, so a warp's remote
//                stores go out in runs, and each CTA starts at another
//                destination CTA; cluster barrier, reload the keys.
//   stability    an element's position is (elements of smaller digit in
//                the row) + (its digit in lower CTAs) + (in lower warps) +
//                (earlier in its warp): equal digits keep their order, so
//                every pass is stable and the LSD sort is too. No index
//                breaks ties.
//
// What bounds it: the byte bound (read and write 12 B an element: 0.47 us
// for one 65,536 row) is far below the latency of the work: the launch,
// the global load and store of the row, and per pass two cluster barriers
// and a DSMEM copy of the row. The design keeps the row on chip for all
// passes and pays one launch per call (a bitonic network pays 15), with
// 8 SMs per row, so a batch of B rows runs on 8*B SMs side by side.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC. Plain C interface for ctypes.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kWarpSpan = 32 * kItems;           // elements per warp
constexpr int kSlice = kThreads * kItems;        // elements per CTA
constexpr int kCapacity = kCluster * kSlice;     // elements per row
constexpr int kDigits = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Shared {
  uint32_t key[kSlice];          // the row's slice, in row order
  float p1[kSlice];
  float p2[kSlice];
  uint32_t stage_key[kSlice];    // the slice grouped by this pass's digit
  float stage_p1[kSlice];
  float stage_p2[kSlice];
  uint16_t warp_count[kWarps][kDigits];
  uint32_t cta_count[kDigits];
  uint32_t cta_first[kDigits];   // first stage slot of each digit
  uint32_t digit_base[kDigits];  // first row position of each digit's run
  uint32_t warp_sum[kWarps];
  uint32_t warp_lo[kWarps];
  uint32_t warp_hi[kWarps];
  uint32_t cta_lo;
  uint32_t cta_hi;
  uint32_t row_lo;
  uint32_t row_hi;
};

// The lanes of the warp whose `digit` (8 bits, plus bit 8 for an empty
// slot) equals this lane's: one ballot per bit, as CUB does;
// __match_any_sync costs more the more distinct values a warp holds.
__device__ __forceinline__ unsigned same_digit(uint32_t digit) {
  unsigned peers = kFull;
#pragma unroll
  for (int bit = 0; bit <= 8; ++bit) {
    const bool set = (digit >> bit) & 1u;
    const unsigned ballot = __ballot_sync(kFull, set);
    peers &= set ? ballot : ~ballot;
  }
  return peers;
}

__device__ __forceinline__ int slot(int warp, int item, int lane) {
  return warp * kWarpSpan + item * 32 + lane;
}

// Exclusive scan of `v` over the first kDigits threads (whole warps); the
// other threads pass through. Block-wide: every thread must call it.
__device__ __forceinline__ uint32_t digit_scan(uint32_t v, Shared& s,
                                               int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t incl = v;
  if (tid < kDigits) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t x = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) s.warp_sum[warp] = incl;
  }
  __syncthreads();
  uint32_t base = 0;
  if (tid < kDigits) {
    for (int w = 0; w < warp; ++w) base += s.warp_sum[w];
  }
  __syncthreads();
  return base + incl - v;
}

__global__ void __launch_bounds__(kThreads, 1)
sort_radix(const int32_t* __restrict__ key, const float* __restrict__ p1,
           const float* __restrict__ p2, int32_t n, int32_t m,
           int32_t* __restrict__ out_key, float* __restrict__ out_p1,
           float* __restrict__ out_p2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& s = *reinterpret_cast<Shared*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int first = static_cast<int>(rank) * m;
  const int count = max(0, min(m, n - first));
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n + first;

  uint32_t k[kItems];
  uint32_t lo = kFull, hi = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = slot(warp, i, lane);
    k[i] = 0;
    if (j < count) {
      k[i] = static_cast<uint32_t>(key[base + j]) ^ 0x80000000u;
      s.key[j] = k[i];
      s.p1[j] = p1[base + j];
      s.p2[j] = p2[base + j];
      lo = min(lo, k[i]);
      hi = max(hi, k[i]);
    }
  }

  // -- the row's min and max, hence the digit passes ------------------------
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    s.warp_lo[warp] = lo;
    s.warp_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = __reduce_min_sync(kFull, s.warp_lo[lane]);
    hi = __reduce_max_sync(kFull, s.warp_hi[lane]);
    if (lane == 0) {
      s.cta_lo = lo;
      s.cta_hi = hi;
    }
  }
  cluster.sync();
  if (warp == 0) {
    lo = kFull;
    hi = 0;
    if (lane < kCluster) {
      lo = *cluster.map_shared_rank(&s.cta_lo, lane);
      hi = *cluster.map_shared_rank(&s.cta_hi, lane);
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0) {
      s.row_lo = lo;
      s.row_hi = hi;
    }
  }
  __syncthreads();
  const uint32_t vary = s.row_lo ^ s.row_hi;
  const int passes = vary == 0 ? 0 : (31 - __clz(vary)) / 8 + 1;
  if (passes == 0) cluster.sync();   // others may still read cta_lo/hi

  for (int pass = 0; pass < passes; ++pass) {
    const int shift = 8 * pass;
    // (1) rank within the warp among equal digits, in slice order
    for (int d = lane; d < kDigits; d += 32) s.warp_count[warp][d] = 0;
    __syncwarp();
    uint32_t r[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool valid = slot(warp, i, lane) < count;
      const uint32_t d = valid ? (k[i] >> shift) & 0xFFu : kDigits;
      const unsigned peers = same_digit(d);
      const unsigned below = peers & ((1u << lane) - 1u);
      const uint32_t prev = valid ? s.warp_count[warp][d] : 0u;
      __syncwarp();
      if (valid && below == 0) {
        s.warp_count[warp][d] = static_cast<uint16_t>(prev + __popc(peers));
      }
      __syncwarp();
      r[i] = prev + __popc(below);
    }
    __syncthreads();

    // (2) per digit: the warps' exclusive prefix, the CTA's total and the
    //     digit's first slot in the stage
    uint32_t total = 0;
    if (tid < kDigits) {
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t c = s.warp_count[w][tid];
        s.warp_count[w][tid] = static_cast<uint16_t>(total);
        total += c;
      }
      s.cta_count[tid] = total;
    }
    const uint32_t cta_first = digit_scan(total, s, tid);
    if (tid < kDigits) s.cta_first[tid] = cta_first;
    __syncthreads();

    // (3) group the slice by digit in the stage, on this CTA alone
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = slot(warp, i, lane);
      if (j < count) {
        const uint32_t d = (k[i] >> shift) & 0xFFu;
        const uint32_t at = s.cta_first[d] + s.warp_count[warp][d] + r[i];
        s.stage_key[at] = k[i];
        s.stage_p1[at] = s.p1[j];
        s.stage_p2[at] = s.p2[j];
      }
    }
    cluster.sync();   // stages complete, every CTA's counts visible

    // (4) each digit's first row position: smaller digits in the row,
    //     then this digit in lower CTAs
    uint32_t all = 0, before = 0;
    if (tid < kDigits) {
      for (int q = 0; q < kCluster; ++q) {
        const uint32_t c = *cluster.map_shared_rank(&s.cta_count[tid], q);
        all += c;
        if (q < static_cast<int>(rank)) before += c;
      }
    }
    const uint32_t row_first = digit_scan(all, s, tid);
    if (tid < kDigits) s.digit_base[tid] = row_first + before;
    __syncthreads();

    // (5) send the stage to the row positions: a digit's run is contiguous
    //     in the stage and at its destination, so a warp's stores to a
    //     remote CTA go out in runs. Stage position j goes to about CTA
    //     j*8/m, so CTA r starts at r*m/8: the eight CTAs send to eight
    //     different CTAs at a time instead of all to the same one.
    const int rot = (static_cast<int>(rank) * (count / kCluster)) & ~31;
    for (int t = tid; t < count; t += kThreads) {
      const int j = t + rot < count ? t + rot : t + rot - count;
      const uint32_t kk = s.stage_key[j];
      const uint32_t d = (kk >> shift) & 0xFFu;
      const uint32_t dest = s.digit_base[d] + (j - s.cta_first[d]);
      const unsigned q = dest / static_cast<uint32_t>(m);
      const uint32_t pos = dest - q * static_cast<uint32_t>(m);
      cluster.map_shared_rank(s.key, q)[pos] = kk;
      cluster.map_shared_rank(s.p1, q)[pos] = s.stage_p1[j];
      cluster.map_shared_rank(s.p2, q)[pos] = s.stage_p2[j];
    }
    cluster.sync();

    // (6) reload the keys, now ordered by the digits so far
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = slot(warp, i, lane);
      if (j < count) k[i] = s.key[j];
    }
  }

  for (int j = tid; j < count; j += kThreads) {
    out_key[base + j] = static_cast<int32_t>(s.key[j] ^ 0x80000000u);
    out_p1[base + j] = s.p1[j];
    out_p2[base + j] = s.p2[j];
  }
}

}  // namespace

// Rows of at most this many elements take the cluster radix sort.
extern "C" int mv3d_sort_radix_capacity() { return kCapacity; }

// Dynamic shared memory of each CTA, in bytes.
extern "C" int mv3d_sort_radix_smem() {
  return static_cast<int>(sizeof(Shared));
}

// How many 8-CTA clusters of the sort can be resident on the current
// device at once (cudaOccupancyMaxActiveClusters), or -1 on error: rows
// beyond it run in a later wave.
extern "C" int mv3d_sort_radix_max_clusters() {
  const size_t smem = sizeof(Shared);
  if (cudaFuncSetAttribute(sort_radix,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    return -1;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, sort_radix, &config) !=
      cudaSuccess) {
    return -1;
  }
  return clusters;
}

// Sorts `batch` rows of `n` (1 <= n <= kCapacity) (key, p1, p2) triples by
// key, stably, into (out_key, out_p1, out_p2), one cluster per row, in one
// launch. Returns 0 on success, else the cudaError_t of the failed call
// (a refused cluster launch included).
extern "C" int mv3d_sort_radix(const int32_t* key, const float* p1,
                               const float* p2, int64_t batch, int64_t n,
                               int32_t* out_key, float* out_p1,
                               float* out_p2, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > kCapacity || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t m = static_cast<int32_t>((n + kCluster - 1) / kCluster);
  const size_t smem = sizeof(Shared);
  cudaError_t err = cudaFuncSetAttribute(
      sort_radix, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster, static_cast<unsigned>(batch), 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, sort_radix, key, p1, p2,
                           static_cast<int32_t>(n), m, out_key, out_p1,
                           out_p2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
