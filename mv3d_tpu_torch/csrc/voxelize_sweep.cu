// Fused BEV voxelizer sweep for Hopper (sm_90a): heights, count and
// intensity of the top view in two passes of global atomics.
//
// Replaces the TPU kernel body `_fused_kernel_grouped` of
// mv3d_tpu/ops/voxelize_pallas.py (reached through
// `scatter_top_fused_batched`). The TPU needs a sort of the points by
// destination and a sweep over VMEM-sized output tiles because it has no
// scattered read-modify-write into HBM; Hopper has global atomics, so the
// sort and the tile grid are gone:
//
//   point pass  one thread per (frame, point); padding is skipped.
//               heights: atomicMax on the int bits of the zero-filled f32
//               (values are >= 0, so int order is float order);
//               count:   atomicAdd on an int32;
//               winner:  64-bit atomicMax on
//                        (float_as_uint(qz) << 32) | (0xFFFFFFFF - idx),
//                        the largest qz = s_eff + v, lowest index on ties.
//   cell pass   one thread per (frame, cell): count as f32 and the
//               winner's reflectance (0 for an empty cell).
//
// Max and integer add do not depend on the order in which the atomics
// land, so the result is bit-exact and deterministic. What bounds the
// kernel on this card is the zero fill and write of the 48 MB heights
// volume per frame (done by the caller's torch.zeros) against ~65k
// scattered atomics; fusing the view assembly into the cell pass is later
// work. All offsets are 64-bit: B * 12,000,000 passes 2^31 at B >= 179.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math). Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void point_pass(const int32_t* __restrict__ flat,
                           const float* __restrict__ hval,
                           int64_t total, int64_t n_points,
                           int64_t n_cells, int32_t zn,
                           int32_t* __restrict__ heights_bits,
                           int32_t* __restrict__ cnt,
                           unsigned long long* __restrict__ best) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int64_t n_flat = n_cells * zn;
  const int32_t f = flat[i];
  if (f < 0 || static_cast<int64_t>(f) >= n_flat) return;   // padding
  const int64_t b = i / n_points;
  const uint32_t idx = static_cast<uint32_t>(i - b * n_points);
  const float v = hval[i];
  const int32_t cell = f / zn;
  const int32_t s_eff = f - cell * zn;

  if (v > 0.0f) {   // max with the zero fill is the identity otherwise
    atomicMax(&heights_bits[b * n_flat + f], __float_as_int(v));
  }
  const int64_t c = b * n_cells + cell;
  atomicAdd(&cnt[c], 1);
  const float qz = static_cast<float>(s_eff) + v;   // exact in f32
  const unsigned long long key =
      (static_cast<unsigned long long>(__float_as_uint(qz)) << 32) |
      static_cast<unsigned long long>(0xFFFFFFFFu - idx);
  atomicMax(&best[c], key);
}

__global__ void cell_pass(const int32_t* __restrict__ cnt,
                          const unsigned long long* __restrict__ best,
                          const float* __restrict__ refl,
                          int64_t total, int64_t n_cells, int64_t n_points,
                          float* __restrict__ count,
                          float* __restrict__ intensity) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / n_cells;
  count[i] = static_cast<float>(cnt[i]);
  const unsigned long long key = best[i];
  float r = 0.0f;
  if (key != 0ull) {
    const uint32_t idx = 0xFFFFFFFFu - static_cast<uint32_t>(key & 0xFFFFFFFFull);
    r = refl[b * n_points + idx];
  }
  intensity[i] = r;
}

int64_t blocks_for(int64_t n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Returns 0 on success, else the cudaError_t of the failed launch.
// heights, cnt and best must be zero-filled by the caller; count and
// intensity are written in full.
extern "C" int mv3d_voxelize_sweep(const int32_t* flat, const float* hval,
                                   const float* refl, int64_t batch,
                                   int64_t n_points, int64_t n_cells,
                                   int32_t zn, float* heights, float* count,
                                   float* intensity, int32_t* cnt,
                                   unsigned long long* best, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_total = batch * n_points;
  if (n_total > 0) {
    point_pass<<<blocks_for(n_total), kThreads, 0, st>>>(
        flat, hval, n_total, n_points, n_cells, zn,
        reinterpret_cast<int32_t*>(heights), cnt, best);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t c_total = batch * n_cells;
  if (c_total > 0) {
    cell_pass<<<blocks_for(c_total), kThreads, 0, st>>>(
        cnt, best, refl, c_total, n_cells, n_points, count, intensity);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
