// Exact greedy NMS of axis-aligned boxes, stopping at max_out kept, for
// Hopper (sm_90a): AVOD's proposal NMS (up to 89,600 BEV boxes a frame at
// IoU 0.8, down to 300) and its final NMS (300 at 0.01, down to 100).
//
// Replaces no TPU kernel. The port's batched greedy_nms (ops/nms.py) takes
// max_out sequential (B, K) pick-and-suppress steps of a few launches
// each: ~1,200 launches a request at the proposal layer's sizes. This
// kernel makes one launch for the batch, one block a frame, whatever
// max_out is.
//
// Input: each frame's boxes (x1, y1, x2, y2) and scores, already sorted by
// descending score (stably, so equal scores keep their index order: the
// plain loop's first maximum). A score that is not > -inf ends the frame's
// valid boxes (the caller scores invalid boxes -inf before the sort). Box
// j is suppressed by a kept box i where
//     inter * (1 + t) > t * (area_i + area_j),
//     iw = min(x2) - max(x1) + off, ih likewise, inter = max(iw, 0) *
//     max(ih, 0), area = (x2 - x1 + off) * (y2 - y1 + off),
// each operation rounded as PyTorch rounds the plain loop's (no FMA
// contraction), with off 1 for the "+1" pixel convention and 0 for
// metric boxes. So the kept set is the plain loop's, to the index.
//
// The block sweeps the sorted list in tiles of kTile boxes:
//   1. each box of the tile is tested against every box kept so far
//      (held in shared memory), kParts threads a box;
//   2. the tile's own upper-triangular suppression bitmask is built, one
//      32-bit word a thread;
//   3. one warp walks the tile in order: a box not yet removed is kept,
//      and its row of the mask is OR-ed into the removed bits (each lane
//      holds one word of them); the walk stops at the max_out-th keep.
// The sweep ends at the max_out-th keep or at the first invalid box, so
// the work follows the boxes it visits (about max_out at IoU 0.8 over
// anchors), not K.
//
// Output per frame: keep[max_out] sorted positions of the kept boxes in
// order (0 past count), count, and visited: the sorted position of the
// max_out-th keep plus one, or the number of valid boxes where fewer were
// kept.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC. Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 256;
constexpr int kWords = kTile / 32;
constexpr int kParts = kThreads / kTile;

struct Shared {
  int kept;
  int end;      // the first invalid sorted position seen, else k
  int stop;
  int visited;
};

__device__ __forceinline__ float box_area(float4 b, float off) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), off),
                   __fadd_rn(__fsub_rn(b.w, b.y), off));
}

// whether a and b suppress each other (the test is symmetric)
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float t,
                                           float one_t, float off) {
  const float iw = __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)),
                             off);
  const float ih = __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)),
                             off);
  const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  return __fmul_rn(inter, one_t) > __fmul_rn(t, __fadd_rn(area_a, area_b));
}

__global__ void __launch_bounds__(kThreads)
nms_topk_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores, int64_t k, int max_out,
                float t, float off, int32_t* __restrict__ keep,
                int32_t* __restrict__ count, int32_t* __restrict__ visited) {
  extern __shared__ float4 smem[];
  float4* kbox = smem;                              // [max_out]
  float4* tbox = kbox + max_out;                    // [kTile]
  float* karea = reinterpret_cast<float*>(tbox + kTile);   // [max_out]
  float* tarea = karea + max_out;                   // [kTile]
  uint32_t* tmask = reinterpret_cast<uint32_t*>(tarea + kTile);
  uint32_t* removed = tmask + kTile * kWords;       // [kWords]
  __shared__ Shared sh;

  const int64_t frame = blockIdx.x;
  const float4* bx = boxes + frame * k;
  const float* sc = scores + frame * k;
  int32_t* out = keep + frame * max_out;
  const int tid = threadIdx.x;
  const float one_t = __fadd_rn(1.0f, t);

  if (tid == 0) {
    sh.kept = 0;
    sh.end = static_cast<int>(k);
    sh.stop = 0;
    sh.visited = 0;
  }
  for (int i = tid; i < max_out; i += kThreads) out[i] = 0;
  __syncthreads();

  for (int64_t pos = 0; pos < k; pos += kTile) {
    const int n = static_cast<int>(k - pos < kTile ? k - pos : kTile);
    if (tid < kWords) removed[tid] = 0u;
    for (int i = tid; i < kTile; i += kThreads) {
      if (i < n) {
        const float4 b = bx[pos + i];
        tbox[i] = b;
        tarea[i] = box_area(b, off);
        if (!(sc[pos + i] > -INFINITY)) {
          atomicMin(&sh.end, static_cast<int>(pos + i));
        }
      }
    }
    __syncthreads();
    const int valid = sh.end - static_cast<int>(pos) < n
                          ? sh.end - static_cast<int>(pos) : n;
    const int kept = sh.kept;

    // 1. against the boxes kept so far
    {
      const int i = tid / kParts;
      const int part = tid % kParts;
      if (i < kTile) {
        bool hit = i >= valid;
        if (!hit) {
          const float4 b = tbox[i];
          const float a = tarea[i];
          for (int j = part; j < kept; j += kParts) {
            if (suppresses(kbox[j], karea[j], b, a, t, one_t, off)) {
              hit = true;
              break;
            }
          }
        }
        if (hit) atomicOr(&removed[i >> 5], 1u << (i & 31));
      }
    }
    // 2. the tile's own mask: bit j of row i where i < j suppresses j
    for (int idx = tid; idx < kTile * kWords; idx += kThreads) {
      const int i = idx / kWords;
      const int w = idx % kWords;
      uint32_t bits = 0u;
      if (i < valid) {
        const float4 a = tbox[i];
        const float aa = tarea[i];
        const int lo = w * 32;
        for (int jj = 0; jj < 32; ++jj) {
          const int j = lo + jj;
          if (j > i && j < valid &&
              suppresses(a, aa, tbox[j], tarea[j], t, one_t, off)) {
            bits |= 1u << jj;
          }
        }
      }
      tmask[idx] = bits;
    }
    __syncthreads();

    // 3. one warp walks the tile in order
    if (tid < 32) {
      const int lane = tid;
      uint32_t word = lane < kWords ? removed[lane] : 0xffffffffu;
      int kc = kept;
      int stop = 0;
      int seen = 0;
      for (int i = 0; i < valid; ++i) {
        const uint32_t w = __shfl_sync(0xffffffffu, word, i >> 5);
        if ((w >> (i & 31)) & 1u) continue;
        if (lane == 0) {
          out[kc] = static_cast<int32_t>(pos + i);
          kbox[kc] = tbox[i];
          karea[kc] = tarea[i];
        }
        if (lane < kWords) word |= tmask[i * kWords + lane];
        ++kc;
        if (kc == max_out) {
          stop = 1;
          seen = static_cast<int>(pos) + i + 1;
          break;
        }
      }
      if (lane == 0) {
        sh.kept = kc;
        if (stop) {
          sh.stop = 1;
          sh.visited = seen;
        } else if (valid < n || pos + n >= k) {
          sh.stop = 1;
          sh.visited = static_cast<int>(pos) + valid;
        }
      }
    }
    __syncthreads();
    if (sh.stop) break;
  }
  if (tid == 0) {
    count[frame] = sh.kept;
    visited[frame] = sh.kept == 0 && !sh.stop ? 0 : sh.visited;
  }
}

}  // namespace

// Dynamic shared memory of one block at max_out.
extern "C" int64_t mv3d_nms_topk_smem(int32_t max_out) {
  return static_cast<int64_t>(max_out + kTile) * (sizeof(float4) + 4) +
         static_cast<int64_t>(kTile) * kWords * 4 + kWords * 4;
}

// Returns 0 on success, else the cudaError_t of the failed call. boxes
// (batch, k, 4) and scores (batch, k) f32, sorted as the header says;
// keep (batch, max_out), count and visited (batch,) int32, written in
// full.
extern "C" int mv3d_nms_topk(const float* boxes, const float* scores,
                             int64_t batch, int64_t k, int32_t max_out,
                             float threshold, float offset, int32_t* keep,
                             int32_t* count, int32_t* visited,
                             void* stream) {
  if (batch <= 0) return 0;
  if (max_out < 1 || batch > 2147483647LL || k > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t smem = mv3d_nms_topk_smem(max_out);
  cudaError_t err = cudaFuncSetAttribute(
      nms_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_topk_kernel<<<static_cast<unsigned>(batch), kThreads,
                    static_cast<size_t>(smem), st>>>(
      reinterpret_cast<const float4*>(boxes), scores, k, max_out, threshold,
      offset, keep, count, visited);
  return static_cast<int>(cudaGetLastError());
}
