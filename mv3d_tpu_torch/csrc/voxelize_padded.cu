// Lane-padded BEV voxelizer sweep for Hopper (sm_90a): the heights plane
// (B, h2, w2p, 128), the count and the intensity of the folded top view
// ("s2d2p") in two passes of global atomics.
//
// Replaces the TPU kernel body `_fused_kernel_grouped` with lane_pad=True
// of mv3d_tpu/ops/voxelize_pallas.py (reached through
// `scatter_top_padded_batched`). The TPU sorts the points by destination
// and sweeps VMEM tiles of supercells because it has no scattered
// read-modify-write into HBM; Hopper has global atomics, so this is the
// fused sweep's design (voxelize_sweep.cu) with the lane-padded decode
// flat = sc*128 + sub*zn + s_eff, folded cell = sc*4 + sub:
//
//   point pass  one thread per (frame, point); padding (flat out of range,
//               or a lane >= 4*zn) is skipped.
//               heights f32:  atomicMax on the int bits of the zero-filled
//                             f32 (values are >= 0: int order is float
//                             order);
//               heights bf16: the value rounded once to bf16 (round to
//                             nearest even, monotone, so it commutes with
//                             max), then a 32-bit atomicCAS loop on the
//                             word holding the bf16 pair, which stores
//                             the max of the two 16-bit halves (bf16 bits
//                             of values >= 0 order like the values);
//               count:        atomicAdd on an int32;
//               winner:       64-bit atomicMax on
//                             (float_as_uint(qz) << 32) | (0xFFFFFFFF - idx),
//                             the largest qz = s_eff + v, lowest index on
//                             ties.
//   cell pass   one thread per (frame, folded cell): count as f32 and the
//               winner's reflectance (0 for an empty cell).
//
// Max and integer add do not depend on the order in which the atomics
// land, so the result is bit-exact and deterministic. The bf16 CAS loop
// writes the final plane directly: no f32 scratch and no conversion pass,
// so the caller's zero fill is 31.1 MB per frame instead of 62.3 MB, and
// a CAS retries only when two points of one frame hit one 32-bit word at
// once (65,536 points over 7.8M words). What bounds the kernel on this
// card is that zero fill and the write of the plane against ~65k
// scattered atomics. All offsets are 64-bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math). Plain C interface for ctypes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;

// max of the bf16 at heights[pos] and `h` (both >= 0), through a CAS on
// the aligned 32-bit word that holds it (little-endian: even pos is the
// low half). The row offsets are even, so the word never spans frames.
__device__ void atomic_max_bf16(uint16_t* heights, int64_t pos, uint16_t h) {
  unsigned int* word = reinterpret_cast<unsigned int*>(heights + (pos & ~1ll));
  const int shift = (pos & 1) ? 16 : 0;
  unsigned int old = *word;
  while (((old >> shift) & 0xFFFFu) < h) {
    const unsigned int want = (old & ~(0xFFFFu << shift)) |
                              (static_cast<unsigned int>(h) << shift);
    const unsigned int seen = atomicCAS(word, old, want);
    if (seen == old) break;
    old = seen;
  }
}

__global__ void point_pass(const int32_t* __restrict__ flat,
                           const float* __restrict__ hval,
                           int64_t total, int64_t n_points, int64_t n_sc,
                           int32_t zn, int32_t bf16, void* __restrict__ heights,
                           int32_t* __restrict__ cnt,
                           unsigned long long* __restrict__ best) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int64_t n_flat = n_sc * kLanes;
  const int32_t f = flat[i];
  if (f < 0 || static_cast<int64_t>(f) >= n_flat) return;   // padding
  const int32_t lane = f & (kLanes - 1);
  const int32_t sub = lane / zn;
  if (sub >= 4) return;                                      // pad lane
  const int32_t s_eff = lane - sub * zn;
  const int64_t b = i / n_points;
  const uint32_t idx = static_cast<uint32_t>(i - b * n_points);
  const float v = hval[i];

  if (v > 0.0f) {   // max with the zero fill is the identity otherwise
    const int64_t pos = b * n_flat + f;
    if (bf16) {
      const uint16_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      if (h != 0) atomic_max_bf16(static_cast<uint16_t*>(heights), pos, h);
    } else {
      atomicMax(static_cast<int32_t*>(heights) + pos, __float_as_int(v));
    }
  }
  const int64_t c = b * n_sc * 4 + (f >> 7) * 4 + sub;
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
// heights ((batch, n_sc*128) f32, or bf16 when `bf16` is nonzero), cnt and
// best must be zero-filled by the caller; count and intensity
// ((batch, n_sc*4) f32) are written in full.
extern "C" int mv3d_voxelize_padded(const int32_t* flat, const float* hval,
                                    const float* refl, int64_t batch,
                                    int64_t n_points, int64_t n_sc,
                                    int32_t zn, int32_t bf16, void* heights,
                                    float* count, float* intensity,
                                    int32_t* cnt, unsigned long long* best,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_total = batch * n_points;
  if (n_total > 0) {
    point_pass<<<blocks_for(n_total), kThreads, 0, st>>>(
        flat, hval, n_total, n_points, n_sc, zn, bf16, heights, cnt, best);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t c_total = batch * n_sc * 4;
  if (c_total > 0) {
    cell_pass<<<blocks_for(c_total), kThreads, 0, st>>>(
        cnt, best, refl, c_total, n_sc * 4, n_points, count, intensity);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
