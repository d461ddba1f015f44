// Heights-only BEV scatter-max for Hopper (sm_90a): the 25 height channels
// of the top view when the host supplies the intensity/density plane.
//
// Replaces the TPU kernel `_kernel` of mv3d_tpu/ops/voxelize_pallas.py,
// reached through `scatter_max_sorted` (and `heights_pallas`). The TPU has
// no scattered read-modify-write into HBM, so that kernel sorts the points
// by destination, finds each output tile's point window with searchsorted
// and applies the window in VMEM, writing each 512 KB tile back once.
// Hopper has global atomics, so the sort, the windows and the tile grid
// are gone:
//
//   fill pass   grid-stride zero fill of the (B, n_flat) f32 output with
//               16-byte stores;
//   point pass  one thread per (frame, point): padding (flat < 0 or
//               flat >= n_flat) and values that are not > 0 are skipped
//               (max with the zero fill is the identity for them); the
//               rest take an atomicMax on the int bits of the f32 value.
//               Non-negative f32 values order like their int bits, so the
//               result is the f32 max, bit-exact whatever order the
//               atomics land in.
//
// What bounds it on this card is the fill pass: at KITTI width n_flat =
// 800*600*25 = 12,000,000, a 48 MB write per frame (about 14 us at the
// H100's 3.35 TB/s), against 65,536 point reads (0.5 MB) and as many
// scattered atomics. All offsets are 64-bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC. Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxFillBlocks = 132 * 16;

__global__ void fill_pass(float* __restrict__ out, int64_t n) {
  const int64_t n4 = n / 4;
  float4* __restrict__ out4 = reinterpret_cast<float4*>(out);
  const int64_t first = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                        threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = first; i < n4; i += stride) {
    out4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const int64_t tail = n4 * 4 + first;   // at most 3 trailing floats
  if (tail < n) out[tail] = 0.0f;
}

__global__ void point_pass(const int32_t* __restrict__ flat,
                           const float* __restrict__ val, int64_t total,
                           int64_t n_points, int64_t n_flat,
                           int32_t* __restrict__ out_bits) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= total) return;
  const int32_t f = flat[i];
  if (f < 0 || static_cast<int64_t>(f) >= n_flat) return;   // padding
  const float v = val[i];
  if (!(v > 0.0f)) return;
  const int64_t b = i / n_points;
  atomicMax(&out_bits[b * n_flat + f], __float_as_int(v));
}

}  // namespace

// out: (batch, n_flat) f32, written in full (zero fill, then the maxima).
// The pointer must be 16-byte aligned (torch allocations are).
// Returns 0 on success, else the cudaError_t of the failed launch.
extern "C" int mv3d_voxelize_heights(const int32_t* flat, const float* val,
                                     int64_t batch, int64_t n_points,
                                     int64_t n_flat, float* out,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_out = batch * n_flat;
  if (n_out > 0) {
    int64_t blocks = (n_out / 4 + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > kMaxFillBlocks) blocks = kMaxFillBlocks;
    fill_pass<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(out,
                                                                   n_out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t total = batch * n_points;
  if (total > 0 && n_out > 0) {
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    point_pass<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        flat, val, total, n_points, n_flat, reinterpret_cast<int32_t*>(out));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
