// Depthwise k x k convolution on NHWC tensors: one CUDA kernel for Hopper
// (sm_90a), with a plain C interface loaded by ctypes
// (deadtrees_tpu_torch/ops/_build.py, wrapper in ops/depthwise.py).
//
// Replaces the TPU kernel deadtrees_tpu/ops/depthwise.py
// `depthwise_conv2d(force="pallas")` (Pallas `_dw_kernel` via `_dw_pallas`):
//
//   out[b, oy, ox, c] = sum_{dy, dx} x[b, s*oy - p + dy, s*ox - p + dx, c]
//                                    * w[dy, dx, c]
//
// with p = k // 2 zero padding on each side, stride s = 1 or 2, any odd k,
// any H and W; float32 accumulation, output in x's type (float32 or
// bfloat16). The TPU function falls back to XLA for stride 2 or H % 8 != 0;
// this kernel takes every such shape itself.
//
// What bounds it on this card: bytes. A k = 3 output costs 18 FLOPs for
// one element read and one written (2 + 2 bytes in bf16), far below the
// card's 20 FLOPs a byte in float32, so the least time is the tensor read
// once and the output written once at 3.35 TB/s.
//
// What this simple design does: a block per (output row, image, run of
// 256 thread positions along the row); each thread computes V neighbouring
// channels (V = 8 for bfloat16, 4 for float32: 16-byte loads of x and of
// the weights) of P = 4 neighbouring output pixels, so a warp reads and
// writes whole runs of channels (coalesced in NHWC), the weights of a row
// stay in registers for the 4 pixels and each input column is loaded once
// for all the outputs it feeds. Index math stays in 32 bits except the
// final offsets; the rows the 4 pixels share come from the caches. A
// kernel side other than 3 or 5, or C and pointers that do not allow V > 1,
// take a plain one-pixel, one-channel-a-thread kernel.
//
// What it leaves for later work: rows staged in shared memory so that
// each input element is read from memory once, and fusion with the
// adjacent pointwise convolutions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int V>
struct Vec;  // V values of T in one load
template <>
struct Vec<float, 4> {
  typedef float4 type;
};
template <>
struct Vec<__nv_bfloat16, 8> {
  typedef uint4 type;
};

template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  if constexpr (V == 1) {
    out[0] = to_f32(*p);
  } else {
    const typename Vec<T, V>::type v = *reinterpret_cast<const typename Vec<T, V>::type*>(p);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f32(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_from_f32(T* p, const float* in) {
  if constexpr (V == 1) {
    *p = from_f32<T>(in[0]);
  } else {
    typename Vec<T, V>::type v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<T>(in[i]);
    *reinterpret_cast<typename Vec<T, V>::type*>(p) = v;
  }
}

// V float32 weights of one tap through the read-only cache, 16 bytes a
// load when V allows
template <int V>
__device__ __forceinline__ void load_w(const float* p, float* out) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      out[i] = v.x;
      out[i + 1] = v.y;
      out[i + 2] = v.z;
      out[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = __ldg(p + i);
  }
}

// One output pixel and V channels a thread. KS > 0: the kernel side fixed
// at compile time (3, 5: the taps unroll); KS == 0: any odd side k at run
// time. Grid (ceil(out_w * C / V / 256), out_h, batch).
template <typename T, int KS, int V>
__global__ void __launch_bounds__(kThreads)
    dw_nhwc_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, int height, int width, int c,
                   int out_h, int out_w, int stride, int k_runtime) {
  const int k = KS > 0 ? KS : k_runtime;
  const int pad = k / 2;
  const int cv = c / V;  // channel groups a pixel
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= out_w * cv) return;
  const int ox = i / cv;
  const int ch = (i - ox * cv) * V;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;
  const int iy0 = oy * stride - pad;
  const int ix0 = ox * stride - pad;
  const T* xb = x + (size_t)b * height * width * c + ch;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  // taps in row-major order, as the plain version sums them
#pragma unroll
  for (int dy = 0; dy < k; ++dy) {
    const int iy = iy0 + dy;
    if (iy < 0 || iy >= height) continue;
    const T* xr = xb + (size_t)iy * width * c;
#pragma unroll
    for (int dx = 0; dx < k; ++dx) {
      const int ix = ix0 + dx;
      if (ix < 0 || ix >= width) continue;
      float xv[V];
      float wv[V];
      load_f32<T, V>(xr + (size_t)ix * c, xv);
      load_w<V>(w + (dy * k + dx) * c + ch, wv);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(xv[j], wv[j], acc[j]);
    }
  }
  store_from_f32<T, V>(out + (((size_t)b * out_h + oy) * out_w + ox) * c + ch, acc);
}

// The same function with P neighbouring output pixels a thread (k and
// the stride fixed at compile time): the k weight vectors of a row stay in
// registers for the P pixels, and each input column of the row is loaded
// once for all the outputs it feeds. Taps still sum in row-major order.
// Grid (ceil(ceil(out_w / P) * C / V / 256), out_h, batch).
template <typename T, int K, int S, int V, int P>
__global__ void __launch_bounds__(kThreads)
    dw_nhwc_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        T* __restrict__ out, int height, int width, int c,
                        int out_h, int out_w) {
  constexpr int pad = K / 2;
  constexpr int NC = (P - 1) * S + K;  // input columns a row of P outputs reads
  const int cv = c / V;
  const int groups = (out_w + P - 1) / P;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= groups * cv) return;
  const int g = i / cv;
  const int ch = (i - g * cv) * V;
  const int ox0 = g * P;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;
  const int iy0 = oy * S - pad;
  const int ix0 = ox0 * S - pad;
  const T* xb = x + (size_t)b * height * width * c + ch;
  float acc[P][V];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[p][j] = 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const int iy = iy0 + dy;
    if (iy < 0 || iy >= height) continue;
    const T* xr = xb + (size_t)iy * width * c;
    float wr[K][V];
#pragma unroll
    for (int dx = 0; dx < K; ++dx) load_w<V>(w + (dy * K + dx) * c + ch, wr[dx]);
#pragma unroll
    for (int col = 0; col < NC; ++col) {
      const int ix = ix0 + col;
      if (ix < 0 || ix >= width) continue;
      float xv[V];
      load_f32<T, V>(xr + (size_t)ix * c, xv);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int dx = col - p * S;  // known at compile time once unrolled
        if (dx < 0 || dx >= K) continue;
#pragma unroll
        for (int j = 0; j < V; ++j) acc[p][j] = fmaf(xv[j], wr[dx][j], acc[p][j]);
      }
    }
  }
  T* ob = out + (((size_t)b * out_h + oy) * out_w + ox0) * c + ch;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (ox0 + p < out_w) store_from_f32<T, V>(ob + (size_t)p * c, acc[p]);
}

constexpr int kPixels = 4;  // output pixels a thread in the row kernel

template <typename T, int K, int S, int V>
int launch_rows(const void* x, const void* w, void* out, int batch, int height,
                int width, int c, int out_h, int out_w, cudaStream_t s) {
  const int groups = (out_w + kPixels - 1) / kPixels;
  const dim3 grid((unsigned)((groups * (c / V) + kThreads - 1) / kThreads), out_h, batch);
  dw_nhwc_rows_kernel<T, K, S, V, kPixels><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(out),
      height, width, c, out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KS, int V>
int launch(const void* x, const void* w, void* out, int batch, int height,
           int width, int c, int k, int stride, cudaStream_t s) {
  const int out_h = (height + 2 * (k / 2) - k) / stride + 1;
  const int out_w = (width + 2 * (k / 2) - k) / stride + 1;
  if (batch == 0 || c == 0) return static_cast<int>(cudaSuccess);
  if (out_h > 65535 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (KS > 0 && V > 1) {
    if (stride == 1)
      return launch_rows<T, KS, 1, V>(x, w, out, batch, height, width, c, out_h, out_w, s);
    return launch_rows<T, KS, 2, V>(x, w, out, batch, height, width, c, out_h, out_w, s);
  } else {
    const dim3 grid((unsigned)((out_w * (c / V) + kThreads - 1) / kThreads), out_h, batch);
    dw_nhwc_kernel<T, KS, V><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<T*>(out), height, width, c, out_h, out_w, stride, k);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int V>
int dispatch_k(const void* x, const void* w, void* out, int batch, int height,
               int width, int c, int k, int stride, cudaStream_t s) {
  if (k == 3) return launch<T, 3, V>(x, w, out, batch, height, width, c, k, stride, s);
  if (k == 5) return launch<T, 5, V>(x, w, out, batch, height, width, c, k, stride, s);
  return launch<T, 0, V>(x, w, out, batch, height, width, c, k, stride, s);
}

// the vector path needs C a multiple of V and 16-byte aligned x, w, out
template <typename T, int V>
int dispatch(const void* x, const void* w, void* out, int batch, int height,
             int width, int c, int k, int stride, cudaStream_t s) {
  const bool aligned = ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w) |
                         reinterpret_cast<size_t>(out)) % 16) == 0;
  if (c % V == 0 && aligned)
    return dispatch_k<T, V>(x, w, out, batch, height, width, c, k, stride, s);
  return dispatch_k<T, 1>(x, w, out, batch, height, width, c, k, stride, s);
}

}  // namespace

extern "C" {

// x (B, H, W, C) and out (B, Ho, Wo, C) in float32 (bf16 == 0) or
// bfloat16, Ho = (H - 1) / stride + 1 (likewise Wo); w (k, k, C) float32.
// k odd, stride 1 or 2, B and Ho at most 65535. Returns cudaGetLastError()
// after the launch.
int depthwise_nhwc(const void* x, const void* w, void* out, int batch,
                   int height, int width, int c, int k, int stride, int bf16,
                   void* stream) {
  if (k < 1 || k % 2 == 0 || stride < 1 || stride > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16, 8>(x, w, out, batch, height, width, c, k, stride, s);
  return dispatch<float, 4>(x, w, out, batch, height, width, c, k, stride, s);
}

}  // extern "C"
