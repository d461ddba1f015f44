// Lane-padded BEV voxelizer sweep for Hopper (sm_90a): the heights plane
// (B, h2, w2p, 128), the count and the intensity of the folded top view
// ("s2d2p"), by binning the points by output tile and sweeping each tile
// in shared memory.
//
// Replaces the TPU kernel body `_fused_kernel_grouped` with lane_pad=True
// of mv3d_tpu/ops/voxelize_pallas.py (reached through
// `scatter_top_padded_batched`). Like the TPU kernel, it groups the points
// by destination tile and writes every output tile once; where the TPU
// sorts, this card bins with a counting sort. Points come as
// flat = sc*128 + sub*zn + s_eff over n_sc supercells (folded cell
// = sc*4 + sub); padding (flat out of range, or a lane >= 4*zn) is never
// binned. A tile is tile_sc consecutive supercells: tile_sc*128 heights
// slots and 4*tile_sc cells (the wrapper's tile plan, ops/voxelize_padded.py).
//
//   bin_count   one thread per (frame, point): atomicAdd on the point's
//               tile in a (B, n_tiles) int32 histogram, zeroed here with
//               cudaMemsetAsync; the value it returns is the point's rank
//               in its bin (in whatever order the atomics land);
//   bin_scan    one block per frame: exclusive scan of the histogram into
//               starts (B, n_tiles + 1);
//   bin_fill    one thread per (frame, point): the point's index at
//               start of its tile + its rank, a plain store;
//   tile_sweep  one block per (frame, tile). An empty tile stores zeros
//               and returns. Otherwise the block zeroes the tile in shared
//               memory and applies its bin with shared-memory atomics:
//                 heights  atomicMax on the bits of the f32 value (values
//                          > 0, so uint order is float order), for both
//                          output types;
//                 count    atomicAdd on an int32;
//                 winner   64-bit atomicMax on
//                          (float_as_uint(qz) << 32) | (0xFFFFFFFF - idx),
//                          the largest qz = s_eff + v, lowest index on ties;
//               then writes the heights tile once in 16-byte stores (bf16:
//               the f32 max rounded once to nearest even, which commutes
//               with max, as the TPU kernel's f32 accumulator does), the
//               count as f32 and the winner's reflectance.
//
// Max and integer add do not depend on the order in which the atomics land
// or the order of a bin, so the result is bit-exact and deterministic.
// There is no zero fill of the planes, no global scratch per cell and no
// global atomic into an output. What bounds it on this card is writing the
// outputs once: per KITTI frame (n_sc = 121,600) 31.1 MB of bf16 heights
// (62.3 MB in f32) and 3.9 MB of count and intensity, beside ~2-3 reads of
// the 0.79 MB of points and 0.5 MB of ranks and bins. All offsets into
// the planes are 64-bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math). Plain C interface for ctypes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kLanes = 128;

// The tile of a live point, or -1 for padding.
__device__ __forceinline__ int32_t tile_of(int32_t f, int64_t n_flat,
                                           int32_t zn, int32_t tile_sc) {
  if (f < 0 || static_cast<int64_t>(f) >= n_flat) return -1;
  if ((f & (kLanes - 1)) / zn >= 4) return -1;
  return (f >> 7) / tile_sc;
}

// Two f32 bit patterns rounded to bf16 (nearest even) and packed, the
// first in the low half (little-endian: the lower address).
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi) {
  return static_cast<uint32_t>(
             __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(lo)))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(
              __float2bfloat16_rn(__uint_as_float(hi)))) << 16);
}

__global__ void bin_count(const int32_t* __restrict__ flat, int64_t total,
                          int64_t n_points, int64_t n_sc, int32_t zn,
                          int32_t tile_sc, int32_t n_tiles,
                          int32_t* __restrict__ counts,
                          int32_t* __restrict__ rank) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int32_t t = tile_of(flat[i], n_sc * kLanes, zn, tile_sc);
  if (t < 0) return;
  rank[i] = atomicAdd(&counts[(i / n_points) * n_tiles + t], 1);
}

__global__ void bin_scan(const int32_t* __restrict__ counts, int32_t n_tiles,
                         int32_t* __restrict__ starts) {
  __shared__ int32_t warp_sum[kScanThreads / 32];
  __shared__ int32_t carry;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int32_t first = 0; first < n_tiles; first += kScanThreads) {
    const int32_t t = first + tid;
    const int32_t c = t < n_tiles ? counts[b * n_tiles + t] : 0;
    int32_t incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t x = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int32_t wbase = 0, chunk = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) {
      if (w < warp) wbase += warp_sum[w];
      chunk += warp_sum[w];
    }
    const int32_t excl = carry + wbase + incl - c;
    if (t < n_tiles) starts[b * (n_tiles + 1) + t] = excl;
    __syncthreads();
    if (tid == 0) carry += chunk;
    __syncthreads();
  }
  if (tid == 0) starts[b * (n_tiles + 1) + n_tiles] = carry;
}

__global__ void bin_fill(const int32_t* __restrict__ flat, int64_t total,
                         int64_t n_points, int64_t n_sc, int32_t zn,
                         int32_t tile_sc, int32_t n_tiles,
                         const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ rank,
                         int32_t* __restrict__ bins) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int32_t t = tile_of(flat[i], n_sc * kLanes, zn, tile_sc);
  if (t < 0) return;
  const int64_t b = i / n_points;
  const int32_t pos = starts[b * (n_tiles + 1) + t] + rank[i];
  bins[b * n_points + pos] = static_cast<int32_t>(i - b * n_points);
}

__global__ void __launch_bounds__(kThreads)
tile_sweep(const int32_t* __restrict__ flat, const float* __restrict__ hval,
           const float* __restrict__ refl, int64_t n_points, int64_t n_sc,
           int32_t zn, int32_t tile_sc, int32_t n_tiles, int32_t bf16,
           const int32_t* __restrict__ starts,
           const int32_t* __restrict__ bins, void* __restrict__ heights,
           float* __restrict__ count, float* __restrict__ intensity) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t sc0 = static_cast<int64_t>(blockIdx.x) * tile_sc;
  const int n_sct = static_cast<int>(n_sc - sc0 < tile_sc ? n_sc - sc0
                                                          : tile_sc);
  const int n_slots = n_sct * kLanes;
  const int n_cells = n_sct * 4;
  const int64_t slot0 = (b * n_sc + sc0) * kLanes;
  const int64_t cell0 = (b * n_sc + sc0) * 4;
  const int32_t* st = starts + b * (n_tiles + 1) + blockIdx.x;
  const int32_t start = st[0];
  const int32_t end = st[1];
  // 16-byte views of the tile's outputs: slot0 and cell0 are multiples
  // of 128 and 4 elements, so every store is aligned
  uint4* h_out = bf16 ? reinterpret_cast<uint4*>(
                            static_cast<__nv_bfloat16*>(heights) + slot0)
                      : reinterpret_cast<uint4*>(
                            static_cast<float*>(heights) + slot0);
  const int h_vecs = bf16 ? n_slots / 8 : n_slots / 4;
  float4* c_out = reinterpret_cast<float4*>(count + cell0);
  float4* r_out = reinterpret_cast<float4*>(intensity + cell0);

  if (start == end) {
    const uint4 z4 = make_uint4(0u, 0u, 0u, 0u);
    const float4 zf = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = tid; i < h_vecs; i += kThreads) h_out[i] = z4;
    for (int i = tid; i < n_sct; i += kThreads) {
      c_out[i] = zf;
      r_out[i] = zf;
    }
    return;
  }

  // the first point of this thread, loaded while the tile is zeroed
  const int64_t frame = b * n_points;
  int32_t idx = 0, f = 0;
  float v = 0.0f;
  if (start + tid < end) {
    idx = bins[frame + start + tid];
    f = flat[frame + idx];
    v = hval[frame + idx];
  }

  uint32_t* s_h = reinterpret_cast<uint32_t*>(smem);
  unsigned long long* s_best =
      reinterpret_cast<unsigned long long*>(s_h + tile_sc * kLanes);
  int32_t* s_cnt = reinterpret_cast<int32_t*>(s_best + tile_sc * 4);
  uint4* s_h4 = reinterpret_cast<uint4*>(s_h);
  for (int i = tid; i < n_slots / 4; i += kThreads) {
    s_h4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = tid; i < n_cells; i += kThreads) {
    s_best[i] = 0ull;
    s_cnt[i] = 0;
  }
  __syncthreads();

  for (int32_t i = start + tid; i < end; i += kThreads) {
    if (i != start + tid) {
      idx = bins[frame + i];
      f = flat[frame + idx];
      v = hval[frame + idx];
    }
    const int32_t lane = f & (kLanes - 1);
    const int32_t sub = lane / zn;
    const int32_t s_eff = lane - sub * zn;
    const int32_t sc = static_cast<int32_t>((f >> 7) - sc0);
    if (v > 0.0f) atomicMax(&s_h[sc * kLanes + lane], __float_as_uint(v));
    const int32_t c = sc * 4 + sub;
    atomicAdd(&s_cnt[c], 1);
    const float qz = static_cast<float>(s_eff) + v;   // exact in f32
    atomicMax(&s_best[c],
              (static_cast<unsigned long long>(__float_as_uint(qz)) << 32) |
                  static_cast<unsigned long long>(
                      0xFFFFFFFFu - static_cast<uint32_t>(idx)));
  }
  __syncthreads();

  if (bf16) {
    for (int i = tid; i < h_vecs; i += kThreads) {
      const uint4 lo = s_h4[2 * i];
      const uint4 hi = s_h4[2 * i + 1];
      h_out[i] = make_uint4(bf16_pair(lo.x, lo.y), bf16_pair(lo.z, lo.w),
                            bf16_pair(hi.x, hi.y), bf16_pair(hi.z, hi.w));
    }
  } else {
    for (int i = tid; i < h_vecs; i += kThreads) h_out[i] = s_h4[i];
  }
  for (int i = tid; i < n_cells; i += kThreads) {
    count[cell0 + i] = static_cast<float>(s_cnt[i]);
    const unsigned long long key = s_best[i];
    float r = 0.0f;
    if (key != 0ull) {
      const uint32_t idx =
          0xFFFFFFFFu - static_cast<uint32_t>(key & 0xFFFFFFFFull);
      r = refl[frame + idx];
    }
    intensity[cell0 + i] = r;
  }
}

int64_t blocks_for(int64_t n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Shared memory of one tile of `tile_sc` supercells, in bytes: f32 heights,
// the 64-bit winners and the int32 counts (mirrored by the wrapper's plan).
extern "C" int64_t mv3d_voxelize_padded_smem(int32_t tile_sc) {
  return static_cast<int64_t>(tile_sc) * (kLanes * 4 + 4 * 8 + 4 * 4);
}

// Returns 0 on success, else the cudaError_t of the failed call. Writes
// heights ((batch, n_sc*128) f32, or bf16 when `bf16` is nonzero), count
// and intensity ((batch, n_sc*4) f32) in full; none needs a fill. `work`
// is an int32 scratch of batch * (2 * n_tiles + 1 + 2 * n_points)
// elements, n_tiles = ceil(n_sc / tile_sc).
extern "C" int mv3d_voxelize_padded(const int32_t* flat, const float* hval,
                                    const float* refl, int64_t batch,
                                    int64_t n_points, int64_t n_sc,
                                    int32_t zn, int32_t bf16, int32_t tile_sc,
                                    void* heights, float* count,
                                    float* intensity, int32_t* work,
                                    void* stream) {
  if (batch <= 0 || n_sc <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t n_tiles = static_cast<int32_t>((n_sc + tile_sc - 1) / tile_sc);
  int32_t* counts = work;
  int32_t* starts = counts + batch * n_tiles;
  int32_t* rank = starts + batch * (n_tiles + 1);
  int32_t* bins = rank + batch * n_points;
  cudaError_t err = cudaMemsetAsync(
      counts, 0, static_cast<size_t>(batch * n_tiles) * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t total = batch * n_points;
  if (total > 0) {
    bin_count<<<blocks_for(total), kThreads, 0, st>>>(
        flat, total, n_points, n_sc, zn, tile_sc, n_tiles, counts, rank);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bin_scan<<<static_cast<unsigned>(batch), kScanThreads, 0, st>>>(
      counts, n_tiles, starts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total > 0) {
    bin_fill<<<blocks_for(total), kThreads, 0, st>>>(
        flat, total, n_points, n_sc, zn, tile_sc, n_tiles, starts, rank,
        bins);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const int64_t smem = mv3d_voxelize_padded_smem(tile_sc);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(tile_sweep,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tile_sweep<<<dim3(static_cast<unsigned>(n_tiles),
                    static_cast<unsigned>(batch)),
               kThreads, static_cast<size_t>(smem), st>>>(
      flat, hval, refl, n_points, n_sc, zn, tile_sc, n_tiles, bf16, starts,
      bins, heights, count, intensity);
  return static_cast<int>(cudaGetLastError());
}
