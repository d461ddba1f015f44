// Eval-mode BatchNorm + ReLU in one pass for Hopper (sm_90a): the epilogue
// of every conv and dense layer of the served trunks, ROI towers and fusion
// head (models/backbone.py::bn_relu).
//
// Replaces no TPU kernel: on the TPU, XLA fused the JAX package's
// cast -> BatchNorm -> ReLU -> cast chain into the producer's epilogue. In
// PyTorch the chain is four device passes with f32 intermediates (read 2 B
// and write 4, read 4 and write 4 twice, read 4 and write 2: 28 bytes an
// element in bf16). This pass reads the layer's output once in its compute
// dtype and writes the result once: 4 bytes an element in bf16, 8 in f32.
//
// What bounds it on this card is HBM bytes: the arithmetic is one FMA and
// a compare an element. The design serves that:
//
//   * each block first turns the four per-channel vectors into a table of
//     (scale, shift) in shared memory, scale = weight / sqrt(var + eps)
//     and shift = bias - mean * scale rounded as PyTorch's CPU BatchNorm
//     rounds them; the element pass then reads nothing but the input;
//   * 16-byte loads and stores of 8 elements, two vectors a thread in
//     flight, in a grid-stride loop over one wave of 256-thread blocks
//     (as many as each SM holds), which keeps enough bytes in flight to
//     cover HBM's latency and leaves no second wave's tail;
//   * the vector's channels follow from the output's layout, which the
//     wrapper reads from the strides: channels-last (the trunks, the ROI
//     towers and the dense layers, C a multiple of 8) gives 8 consecutive
//     channels a vector, and where the grid's stride is whole pixels (C
//     divides 2,048 x blocks) a thread keeps its 8 channels' terms in
//     registers; anything else (NCHW, which no served path hands it, or
//     channels not a multiple of 8) one element at a time;
//   * the input may be rows with a stride between them (the split stem's
//     cropped view): row r of `row_len` elements starts at x + r * ld, so
//     no copy makes it contiguous. The output is dense.
//
// Per element: y = fmaf(x, scale, shift) in f32, ReLU (NaN passes, as
// PyTorch's ReLU lets it), rounded once to the input's dtype.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC. Plain C interface for ctypes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;

enum Mode : int {
  kEightChannels = 0, // a vector holds channels c..c+7 (inner == 1)
  kScalar = 1,        // one element at a time
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float affine_relu(float x, float2 p) {
  const float y = fmaf(x, p.x, p.y);
  return y < 0.0f ? 0.0f : y;
}

// x: rows of row_len elements, row r at x + r * ld; y: dense, element
// o = r * row_len + col; channel of o = (o / inner) % channels. All counts
// fit 32 bits (the wrapper checks), offsets are taken in 64.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
mv3d_bn_relu_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias,
                    const float* __restrict__ mean,
                    const float* __restrict__ var, float eps,
                    uint32_t channels, uint32_t inner, uint32_t total,
                    uint32_t row_len, int64_t ld) {
  extern __shared__ float2 table[];
  for (uint32_t c = threadIdx.x; c < channels; c += blockDim.x) {
    // as PyTorch's CPU BatchNorm: invstd, then alpha = invstd * weight,
    // beta = bias - mean * alpha, each rounded (no contraction)
    const float invstd = 1.0f / sqrtf(__fadd_rn(var[c], eps));
    const float scale = __fmul_rn(invstd, weight[c]);
    table[c] = make_float2(scale, __fsub_rn(bias[c],
                                            __fmul_rn(mean[c], scale)));
  }
  __syncthreads();
  const uint32_t stride = gridDim.x * blockDim.x;
  const uint32_t first = blockIdx.x * blockDim.x + threadIdx.x;
  if (kMode == kScalar) {
    for (uint32_t o = first; o < total; o += stride) {
      const uint32_t r = o / row_len;
      const int64_t src = r * ld + (o - r * row_len);
      const float2 p = table[(o / inner) % channels];
      from_float(affine_relu(to_float(x[src]), p), &y[o]);
    }
    return;
  }
  const uint32_t n_vec = total / kVec;
  const uint32_t vec_per_row = row_len / kVec;
  // channels-last: where the grid's stride is a whole number of pixels, a
  // thread's vectors all hold the same 8 channels, so their (scale,
  // shift) come from shared memory once, into registers (read per vector,
  // neighbouring threads' 64-byte strides would meet in the same banks)
  const bool fixed = kMode == kEightChannels &&
                     (stride * kVec) % channels == 0;
  float2 held[kVec];
  if (fixed) {
    const uint32_t c = (first * kVec) % channels;
#pragma unroll
    for (int k = 0; k < kVec; ++k) held[k] = table[c + k];
  }
  auto source = [&](uint32_t v) -> int64_t {
    const uint32_t r = v / vec_per_row;
    return r * ld + (v * kVec - r * row_len);
  };
  auto apply = [&](float (&e)[kVec], uint32_t o) {
    if (fixed) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) e[k] = affine_relu(e[k], held[k]);
    } else {
      const uint32_t c = o % channels;
#pragma unroll
      for (int k = 0; k < kVec; ++k) e[k] = affine_relu(e[k], table[c + k]);
    }
  };
  // two vectors a thread in flight per step
  uint32_t v = first;
  for (; v + stride < n_vec; v += 2 * stride) {
    float e0[kVec], e1[kVec];
    load8(x + source(v), e0);
    load8(x + source(v + stride), e1);
    apply(e0, v * kVec);
    apply(e1, (v + stride) * kVec);
    store8(y + v * kVec, e0);
    store8(y + (v + stride) * kVec, e1);
  }
  if (v < n_vec) {
    float e[kVec];
    load8(x + source(v), e);
    apply(e, v * kVec);
    store8(y + v * kVec, e);
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, void* y, const float* weight,
                         const float* bias, const float* mean,
                         const float* var, float eps, uint32_t channels,
                         uint32_t inner, uint32_t total, uint32_t row_len,
                         int64_t ld, int mode, uint32_t sms,
                         cudaStream_t st) {
  void (*kernel)(const T*, T*, const float*, const float*, const float*,
                 const float*, float, uint32_t, uint32_t, uint32_t,
                 uint32_t, int64_t) =
      mode == kEightChannels ? mv3d_bn_relu_kernel<T, kEightChannels>
                             : mv3d_bn_relu_kernel<T, kScalar>;
  const size_t smem = channels * sizeof(float2);
  // one wave: as many blocks as the SMs hold at once, each looping
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const uint32_t items = mode == kScalar ? total : total / kVec;
  uint32_t blocks = (items + kThreads - 1) / kThreads;
  const uint32_t wave = static_cast<uint32_t>(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  kernel<<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<T*>(y), weight, bias, mean, var,
      eps, channels, inner, total, row_len, ld);
  return cudaGetLastError();
}

}  // namespace

// x: the input, rows of row_len elements with a stride of ld elements
// between row starts; y: the dense output of total elements, both bf16
// if bf16 else f32; weight, bias, mean, var: f32 vectors of `channels`.
// mode: 0 eight channels a vector (inner 1, channels, row_len and ld
// multiples of 8; x and y 16-byte aligned), 1 scalar.
// channels * 8 bytes of shared memory, at most 48 KB. sms: the card's SM
// count (the grid is one wave of them).
// Returns 0 on success, else the cudaError_t of the failed launch.
extern "C" int mv3d_bn_relu(const void* x, void* y, int bf16,
                            const float* weight, const float* bias,
                            const float* mean, const float* var, float eps,
                            int64_t channels, int64_t inner, int64_t total,
                            int64_t row_len, int64_t ld, int mode,
                            int64_t sms, void* stream) {
  if (total == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t c = static_cast<uint32_t>(channels);
  const uint32_t in = static_cast<uint32_t>(inner);
  const uint32_t n = static_cast<uint32_t>(total);
  const uint32_t len = static_cast<uint32_t>(row_len);
  const uint32_t s = static_cast<uint32_t>(sms);
  const cudaError_t err =
      bf16 ? launch_typed<__nv_bfloat16>(x, y, weight, bias, mean, var, eps,
                                         c, in, n, len, ld, mode, s, st)
           : launch_typed<float>(x, y, weight, bias, mean, var, eps, c, in,
                                 n, len, ld, mode, s, st);
  return static_cast<int>(err);
}
