// Fused BEV voxelizer sweep for Hopper (sm_90a): heights, count and
// intensity of the top view, by binning the points by output tile and
// sweeping the tiles in shared memory with persistent blocks whose
// finished tiles go out as asynchronous bulk copies.
//
// Replaces the TPU kernel body `_fused_kernel_grouped` of
// mv3d_tpu/ops/voxelize_pallas.py (reached through
// `scatter_top_fused_batched`). Like the TPU kernel it groups the points
// by destination tile and writes every output tile once; where the TPU
// sorts, this card bins with a counting sort. Points come as
// flat = cell*zn + s_eff (row-major cells: the hwc numbering and the
// folded s2d2 numbering alike); flat outside [0, n_cells*zn) is padding
// and is never binned.
//
//   tiles       the batch's cells are one array of batch*n_cells global
//               cells g = frame*n_cells + cell, cut into tiles of `tile`
//               consecutive cells (a power of two of at least 8; the
//               wrapper's tile_plan, ops/voxelize_sweep.py). A tile may
//               hold the end of one frame and the start of the next: a
//               KITTI frame has 481,401 cells, so tiles per frame would
//               start off the 16-byte grid that bulk copies need, where
//               global tiles start at t*tile*zn heights and t*tile cells,
//               always on it. Only the very last tile may be partial.
//   bin_count   one thread per (frame, point): atomicAdd on its tile in an
//               int32 histogram (zeroed here with cudaMemsetAsync); the
//               value it returns is the point's rank in its bin;
//   bin_scan    one block: exclusive scan of the histogram into starts,
//               in chunks of 8,192 tiles loaded and stored in coalesced
//               rows through shared memory;
//   bin_fill    one thread per (frame, point): its 16-byte record (slot in
//               the tile, value, reflectance, global index) at its tile's
//               start + its rank, one store, so the sweep reads its points
//               in coalesced 16-byte loads with no dependent gather;
//   tile_sweep  persistent blocks (as many per SM as shared memory allows,
//               at most four) walk the tiles with a stride of the grid. An
//               empty tile stores zeros and never touches shared memory.
//               While a block works on a tile it loads the bin bounds of
//               the tile after next and each thread its first record of
//               the next tile. For a tile with points the block
//               takes the next of its two shared buffers (waiting until
//               the bulk copy that last read it has read it), zeroes it
//               and applies its bin with shared-memory atomics:
//                 heights  atomicMax on the bits of the f32 value (values
//                          > 0, so uint order is float order);
//                 count    atomicAdd on an int32;
//                 winner   64-bit atomicMax on
//                          (float_as_uint(qz) << 32) | (0xFFFFFFFF - idx),
//                          the largest qz = s_eff + v, lowest index on
//                          ties (idx is the point's global index: the
//                          points of one cell share a frame, so its order
//                          is the frame's);
//               then the point whose key won its cell writes its
//               reflectance (keys are unique), the counts turn into f32 in
//               place, heights are rounded to bf16 once in place (nearest
//               even, which commutes with max) when the output is bf16,
//               the shared writes are fenced for the async proxy and one
//               thread issues three bulk copies
//               (cp.async.bulk.global.shared::cta) of the tile's heights,
//               count and intensity. The block goes on to the next tile
//               while they drain: the store of tile i overlaps the work on
//               tile i+1. The partial last tile is stored with plain
//               stores.
//
// Max and integer add do not depend on the order in which the atomics land
// or the order of a bin, so the result is bit-exact and deterministic.
// There is no zero fill of the planes, no global scratch per cell and no
// global atomic into an output. What bounds it on this card is writing the
// outputs once: per KITTI frame (481,401 cells, zn = 25) 48.1 MB of f32
// heights (24.1 MB in bf16) and 3.9 MB of count and intensity, beside a
// few reads and writes of the 0.79 MB of points, their ranks and their
// 1 MB of records. All offsets into the planes are 64-bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math). Plain C interface for ctypes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;
constexpr int kScanChunk = kScanThreads * kScanItems;
constexpr int kMaxBlocksPerSm = 4;
constexpr int kMaxDevices = 64;

// Two f32 bit patterns rounded to bf16 (nearest even) and packed, the
// first in the low half (little-endian: the lower address).
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi) {
  return static_cast<uint32_t>(
             __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(lo)))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(
              __float2bfloat16_rn(__uint_as_float(hi)))) << 16);
}

// The winner key of a point: the largest qz = s_eff + v (exact in f32),
// then the lowest index.
__device__ __forceinline__ unsigned long long winner_key(int32_t s_eff,
                                                         float v,
                                                         int32_t idx) {
  const float qz = static_cast<float>(s_eff) + v;
  return (static_cast<unsigned long long>(__float_as_uint(qz)) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu -
                                         static_cast<uint32_t>(idx));
}

// -- the bulk copies of the async proxy (sm_90) ------------------------------
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(src))), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group still reads its source.
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// Wait until every committed group has completed its writes.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Make this thread's generic-proxy shared writes visible to bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- binning: frames on blockIdx.y, points on x -------------------------------
__global__ void bin_count(const int32_t* __restrict__ flat, int64_t n_points,
                          int64_t n_cells, int32_t zn, int32_t tile_shift,
                          int32_t* __restrict__ counts,
                          int32_t* __restrict__ rank) {
  const int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (j >= n_points) return;
  const int64_t i = blockIdx.y * n_points + j;
  const int32_t f = flat[i];
  if (f < 0 || static_cast<int64_t>(f) >= n_cells * zn) return;   // padding
  const int64_t g = blockIdx.y * n_cells + f / zn;
  rank[i] = atomicAdd(&counts[g >> tile_shift], 1);
}

// One block: the histogram in chunks of kScanChunk tiles, each loaded and
// stored in coalesced rows through shared memory and scanned as
// kScanItems consecutive tiles per thread, the chunks' totals carried.
__global__ void bin_scan(const int32_t* __restrict__ counts, int32_t n_tiles,
                         int32_t* __restrict__ starts) {
  __shared__ int32_t buf[kScanChunk];
  __shared__ int32_t warp_sum[kScanThreads / 32];
  __shared__ int32_t carry;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) carry = 0;
  for (int32_t first = 0; first < n_tiles; first += kScanChunk) {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int32_t t = first + k * kScanThreads + tid;
      buf[k * kScanThreads + tid] = t < n_tiles ? counts[t] : 0;
    }
    __syncthreads();
    int32_t v[kScanItems];
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      v[k] = buf[tid * kScanItems + k];
      sum += v[k];
    }
    int32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t x = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int32_t w = warp_sum[lane];
      int32_t w_incl = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t x = __shfl_up_sync(0xFFFFFFFFu, w_incl, o);
        if (lane >= o) w_incl += x;
      }
      warp_sum[lane] = w_incl - w;
    }
    __syncthreads();
    int32_t run = carry + warp_sum[warp] + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      buf[tid * kScanItems + k] = run;
      run += v[k];
    }
    __syncthreads();   // every thread has read carry and written its run
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int32_t t = first + k * kScanThreads + tid;
      if (t < n_tiles) starts[t] = buf[k * kScanThreads + tid];
    }
    if (tid == kScanThreads - 1) carry = run;
    __syncthreads();
  }
  if (tid == 0) starts[n_tiles] = carry;
}

// Each point's 16-byte record at its tile's start + its rank: its slot in
// the tile (local cell * zn + s_eff), the bits of its value and
// reflectance, and its global index; one store per point.
__global__ void bin_fill(const int32_t* __restrict__ flat,
                         const float* __restrict__ hval,
                         const float* __restrict__ refl, int64_t n_points,
                         int64_t n_cells, int32_t zn, int32_t tile_shift,
                         const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ rank,
                         int4* __restrict__ recs) {
  const int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (j >= n_points) return;
  const int64_t i = blockIdx.y * n_points + j;
  const int32_t f = flat[i];
  if (f < 0 || static_cast<int64_t>(f) >= n_cells * zn) return;
  const int32_t cell = f / zn;
  const int64_t g = blockIdx.y * n_cells + cell;
  const int64_t t = g >> tile_shift;
  recs[starts[t] + rank[i]] = make_int4(
      static_cast<int32_t>(g - (t << tile_shift)) * zn + (f - cell * zn),
      __float_as_int(hval[i]), __float_as_int(refl[i]),
      static_cast<int32_t>(i));
}

// Bytes of one of a block's two tile buffers: f32 heights bits (rounded
// to bf16 in place for bf16 output), the 64-bit winners, the int32 counts
// (f32 once final) and the f32 intensity.
__host__ __device__ __forceinline__ int64_t buffer_bytes(int32_t tile,
                                                         int32_t zn) {
  return static_cast<int64_t>(tile) * (zn * 4 + 8 + 4 + 4);
}

__global__ void __launch_bounds__(kThreads)
tile_sweep(const int4* __restrict__ recs, int32_t zn, int64_t total_cells,
           int32_t tile, int32_t n_tiles, int32_t bf16,
           const int32_t* __restrict__ starts, void* __restrict__ heights,
           float* __restrict__ count, float* __restrict__ intensity) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int slots = tile * zn;                 // heights of a full tile
  const int64_t buf_bytes = buffer_bytes(tile, zn);
  const int esize = bf16 ? 2 : 4;
  int buf = 0;

  // the bin bounds of a tile are loaded two tiles ahead and this thread's
  // first record of it one tile ahead, so neither load waits in the chain
  // of a tile's work
  const int32_t stride = gridDim.x;
  int32_t t = blockIdx.x;
  int32_t start = 0, end = 0, start_next = 0, end_next = 0;
  if (t < n_tiles) {
    start = starts[t];
    end = starts[t + 1];
  }
  if (t + stride < n_tiles) {
    start_next = starts[t + stride];
    end_next = starts[t + stride + 1];
  }
  int4 rec0 = make_int4(0, 0, 0, 0);
  if (start + tid < end) rec0 = recs[start + tid];

  for (; t < n_tiles; t += stride) {
    int4 rec_next = make_int4(0, 0, 0, 0);
    if (start_next + tid < end_next) rec_next = recs[start_next + tid];
    int32_t start_after = 0, end_after = 0;
    if (t + 2 * stride < n_tiles) {
      start_after = starts[t + 2 * stride];
      end_after = starts[t + 2 * stride + 1];
    }
    const int64_t g0 = static_cast<int64_t>(t) * tile;
    const int cells = static_cast<int>(
        total_cells - g0 < tile ? total_cells - g0 : tile);
    const bool full = cells == tile;
    unsigned char* h_out =
        static_cast<unsigned char*>(heights) + g0 * zn * esize;

    if (start == end) {                        // zeros, shared memory idle
      if (full) {
        const uint4 z4 = make_uint4(0u, 0u, 0u, 0u);
        uint4* h4 = reinterpret_cast<uint4*>(h_out);
        for (int i = tid; i < slots * esize / 16; i += kThreads) h4[i] = z4;
        for (int i = tid; i < tile / 4; i += kThreads) {
          reinterpret_cast<uint4*>(count + g0)[i] = z4;
          reinterpret_cast<uint4*>(intensity + g0)[i] = z4;
        }
      } else {
        for (int i = tid; i < cells * zn * esize / 2; i += kThreads) {
          reinterpret_cast<uint16_t*>(h_out)[i] = 0;
        }
        for (int i = tid; i < cells; i += kThreads) {
          count[g0 + i] = 0.0f;
          intensity[g0 + i] = 0.0f;
        }
      }
    } else {
      unsigned char* base = smem + buf * buf_bytes;
      uint32_t* s_h = reinterpret_cast<uint32_t*>(base);
      unsigned long long* s_best =
          reinterpret_cast<unsigned long long*>(s_h + slots);
      int32_t* s_cnt = reinterpret_cast<int32_t*>(s_best + tile);
      float* s_inten = reinterpret_cast<float*>(s_cnt + tile);
      const int32_t first = start + tid;

      // the bulk copy that last read this buffer (two tiles ago) is done
      if (tid == 0) bulk_wait_read_all_but_one();
      __syncthreads();
      for (int i = tid; i < slots / 4; i += kThreads) {
        reinterpret_cast<uint4*>(s_h)[i] = make_uint4(0u, 0u, 0u, 0u);
      }
      for (int i = tid; i < tile; i += kThreads) {
        s_best[i] = 0ull;
        s_cnt[i] = 0;
        s_inten[i] = 0.0f;
      }
      __syncthreads();

      for (int32_t i = first; i < end; i += kThreads) {
        const int4 q = i == first ? rec0 : recs[i];
        const int32_t c = q.x / zn;
        const float v = __int_as_float(q.y);
        if (v > 0.0f) atomicMax(&s_h[q.x], static_cast<uint32_t>(q.y));
        atomicAdd(&s_cnt[c], 1);
        atomicMax(&s_best[c], winner_key(q.x - c * zn, v, q.w));
      }
      __syncthreads();

      // each cell's winner writes its reflectance (keys are unique); the
      // counts become f32
      for (int32_t i = first; i < end; i += kThreads) {
        const int4 q = i == first ? rec0 : recs[i];
        const int32_t c = q.x / zn;
        if (s_best[c] == winner_key(q.x - c * zn, __int_as_float(q.y), q.w)) {
          s_inten[c] = __int_as_float(q.z);
        }
      }
      for (int i = tid; i < cells; i += kThreads) {
        reinterpret_cast<float*>(s_cnt)[i] = static_cast<float>(s_cnt[i]);
      }
      if (bf16) {
        // round in place: group k's 8 values (32 B at 32k) go to 16 B at
        // 16k, below every group of a later chunk, so one barrier between
        // a chunk's reads and writes suffices
        uint4* s_h4 = reinterpret_cast<uint4*>(s_h);
        const int groups = slots / 8;
        for (int chunk = 0; chunk < groups; chunk += 4 * kThreads) {
          uint4 lo[4], hi[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int g = chunk + k * kThreads + tid;
            if (g < groups) {
              lo[k] = s_h4[2 * g];
              hi[k] = s_h4[2 * g + 1];
            }
          }
          __syncthreads();
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int g = chunk + k * kThreads + tid;
            if (g < groups) {
              s_h4[g] = make_uint4(bf16_pair(lo[k].x, lo[k].y),
                                   bf16_pair(lo[k].z, lo[k].w),
                                   bf16_pair(hi[k].x, hi[k].y),
                                   bf16_pair(hi[k].z, hi[k].w));
            }
          }
        }
      }
      if (full) {
        fence_async_shared();
        __syncthreads();
        if (tid == 0) {
          bulk_store(h_out, s_h, static_cast<uint32_t>(slots * esize));
          bulk_store(count + g0, s_cnt, static_cast<uint32_t>(tile * 4));
          bulk_store(intensity + g0, s_inten,
                     static_cast<uint32_t>(tile * 4));
          bulk_commit();
        }
      } else {                                 // the partial last tile
        __syncthreads();
        for (int i = tid; i < cells * zn * esize / 2; i += kThreads) {
          reinterpret_cast<uint16_t*>(h_out)[i] =
              reinterpret_cast<const uint16_t*>(s_h)[i];
        }
        for (int i = tid; i < cells; i += kThreads) {
          count[g0 + i] = reinterpret_cast<const float*>(s_cnt)[i];
          intensity[g0 + i] = s_inten[i];
        }
      }
      buf ^= 1;
    }
    start = start_next;
    end = end_next;
    rec0 = rec_next;
    start_next = start_after;
    end_next = end_after;
  }
  // the copies read shared memory and must land before the block ends
  if (tid == 0) bulk_wait_all();
}

// The sweep's grid on the current device for `smem` bytes a block (the
// occupancy it allows, at most kMaxBlocksPerSm per SM), set up once per
// device and size: the host's share of a call stays a few launches.
cudaError_t sweep_grid(int64_t smem, int* blocks) {
  static int64_t cached_smem[kMaxDevices] = {};
  static int cached_blocks[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && cached_smem[device] == smem) {
    *blocks = cached_blocks[device];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(tile_sweep,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tile_sweep, kThreads, static_cast<size_t>(smem));
  }
  if (err != cudaSuccess) return err;
  per_sm = per_sm < 1 ? 1 : (per_sm > kMaxBlocksPerSm ? kMaxBlocksPerSm
                                                      : per_sm);
  *blocks = sms * per_sm;
  if (device < kMaxDevices) {
    cached_blocks[device] = *blocks;
    cached_smem[device] = smem;
  }
  return cudaSuccess;
}

}  // namespace

// Dynamic shared memory of one sweep block (two tile buffers), in bytes,
// for heights in f32 or bf16 alike (mirrored by the wrapper's tile_plan).
extern "C" int64_t mv3d_voxelize_sweep_smem(int32_t tile, int32_t zn) {
  return 2 * buffer_bytes(tile, zn);
}

// Returns 0 on success, else the cudaError_t of the failed call. Writes
// heights ((batch, n_cells*zn) f32, or bf16 when `bf16` is nonzero), count
// and intensity ((batch, n_cells) f32) in full; none needs a fill. The
// three outputs and `work` must be 16-byte aligned and `tile` a power of
// two of at least 8. `work` is an int32 scratch of 5 * batch * n_points +
// 2 * n_tiles + 1 elements, n_tiles = ceil(batch * n_cells / tile).
extern "C" int mv3d_voxelize_sweep(const int32_t* flat, const float* hval,
                                   const float* refl, int64_t batch,
                                   int64_t n_points, int64_t n_cells,
                                   int32_t zn, int32_t bf16, int32_t tile,
                                   void* heights, float* count,
                                   float* intensity, int32_t* work,
                                   void* stream) {
  const int64_t total_cells = batch * n_cells;
  if (total_cells <= 0) return 0;
  if (tile < 8 || (tile & (tile - 1)) != 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t tile_shift = __builtin_ctz(static_cast<unsigned>(tile));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t n_tiles =
      static_cast<int32_t>((total_cells + tile - 1) / tile);
  const int64_t total = batch * n_points;
  int4* recs = reinterpret_cast<int4*>(work);  // 16-byte aligned first
  int32_t* rank = work + 4 * total;
  int32_t* counts = rank + total;
  int32_t* starts = counts + n_tiles;
  cudaError_t err = cudaMemsetAsync(
      counts, 0, static_cast<size_t>(n_tiles) * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 point_grid(
      static_cast<unsigned>((n_points + kThreads - 1) / kThreads),
      static_cast<unsigned>(batch));
  if (total > 0) {
    bin_count<<<point_grid, kThreads, 0, st>>>(flat, n_points, n_cells, zn,
                                               tile_shift, counts, rank);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bin_scan<<<1, kScanThreads, 0, st>>>(counts, n_tiles, starts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total > 0) {
    bin_fill<<<point_grid, kThreads, 0, st>>>(
        flat, hval, refl, n_points, n_cells, zn, tile_shift, starts, rank,
        recs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const int64_t smem = mv3d_voxelize_sweep_smem(tile, zn);
  int blocks = 0;
  err = sweep_grid(smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n_tiles < blocks ? n_tiles : blocks;
  tile_sweep<<<static_cast<unsigned>(grid), kThreads,
               static_cast<size_t>(smem), st>>>(
      recs, zn, total_cells, tile, n_tiles, bf16, starts, heights, count,
      intensity);
  return static_cast<int>(cudaGetLastError());
}
