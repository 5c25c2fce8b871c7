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
// once and the output written once at 3.35 TB/s. bf16 arithmetic would buy
// nothing here, so the sums stay in float32.
//
// What the design does about it: the output is cut into tiles of th x tw
// pixels and a chunk of channels. A tile's haloed input ((th-1)*s + k
// rows, (tw-1)*s + k columns, the chunk's channels) and its weights are
// staged in shared memory with 16-byte cp.async copies; pixels outside the
// image are zero-filled by the copy itself (source size 0), so the
// arithmetic needs no masks and each input element is read from device
// memory about once (the halo rows and columns again, mostly from L2).
// Persistent blocks walk over the tiles with two stages of shared memory,
// so the copies of a block's next tile are in flight while it computes the
// current one. A thread takes a 16-byte run of channels (8 bf16 or 4
// float32) of kP = 4 neighbouring output columns and streams down its
// output rows: for each row, the taps of input row dy are summed for dy
// ascending, dx ascending within, as the plain version sums them, with the
// k weight vectors of the row in registers and each staged input column
// loaded once for the kP outputs it feeds. The tiling (tile sides, channel
// chunk, rows a thread, threads, shared memory) is planned in Python
// (`depthwise_tile_plan`) and passed in with the number of persistent
// blocks (as many as fit on the card at once, from
// `depthwise_blocks_per_sm`, up to the number of tiles); this file
// recomputes none of it.
//
// Shapes the 16-byte copies cannot take (C not a multiple of the vector,
// x or w not 16-byte aligned) stage through plain element loads into the
// same layout and compute one channel a thread: the same kernel, chosen by
// template, launched and counted the same way. A kernel side other than 3
// or 5 runs the same kernel with k read at run time.
//
// What it leaves for later work: fusion with the adjacent pointwise
// convolutions, and tiles shaped for the narrow-spatial, wide-channel
// stages (16 x 16 and 32 x 32 pixels) where the kernel is furthest from
// its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kP = 4;  // output columns a thread

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

// V float32 weights from shared memory, 16 bytes a load when V allows
template <int V>
__device__ __forceinline__ void load_w(const float* p, float* out) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x;
      out[i + 1] = v.y;
      out[i + 2] = v.z;
      out[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = p[i];
  }
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ int staged_bytes(int ih, int iw, int cb, int itemsize) {
  return (ih * iw * cb * itemsize + 15) / 16 * 16;
}

// One stage of shared memory: the haloed input tile, then the chunk's
// k * k weight vectors (float32). The kernel keeps two.
__device__ __forceinline__ int stage_bytes(int ih, int iw, int cb, int k, int itemsize) {
  return staged_bytes(ih, iw, cb, itemsize) + k * k * cb * 4;
}

// Persistent blocks over the tiles (column tile, channel chunk, row tile,
// image), neighbouring tiles first, each block taking every gridDim.x-th.
// Two stages of shared memory: while a block computes one tile, the
// copies of its next tile are in flight. Thread t takes channel vector
// t % cbv, column group (t / cbv) % (tw / kP) and output rows
// (t / (cbv * tw / kP)) * rows .. + rows - 1 of each tile. K > 0: the
// kernel side fixed at compile time (3, 5: the taps unroll); K == 0: any
// odd k at run time. ASYNC: 16-byte cp.async staging, V the channels of 16
// bytes; else plain element loads and V == 1.
template <typename T, int K, int S, int V, bool ASYNC>
__global__ void __launch_bounds__(kMaxThreads)
    dw_tile_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, int batch, int height, int width, int c,
                   int k_runtime, int cbv, int th, int tw, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = K > 0 ? K : k_runtime;
  const int pad = k / 2;
  const int cb = cbv * V;  // channels a chunk
  const int out_h = (height - 1) / S + 1;
  const int out_w = (width - 1) / S + 1;
  const int col_tiles = (out_w + tw - 1) / tw;
  const int chunks = (c / V + cbv - 1) / cbv;
  const int row_tiles = (out_h + th - 1) / th;
  const int ih = (th - 1) * S + k;
  const int iw = (tw - 1) * S + k;
  const int xbytes = staged_bytes(ih, iw, cb, (int)sizeof(T));
  const int sbytes = stage_bytes(ih, iw, cb, k, (int)sizeof(T));
  const int tiles = col_tiles * chunks * row_tiles * batch;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int groups = tw / kP;
  const int cvi = tid % cbv;
  const int gi = (tid / cbv) % groups;
  const int ri = tid / (cbv * groups);
  const int oxl = gi * kP;  // first local output column

  // tile t -> (column tile, first channel, first output row, image)
  auto tile_of = [&](int t, int& ox0, int& c0, int& oy0, int& b) {
    ox0 = (t % col_tiles) * tw;
    t /= col_tiles;
    c0 = (t % chunks) * cb;
    t /= chunks;
    oy0 = (t % row_tiles) * th;
    b = t / row_tiles;
  };

  // copies of tile t into stage buf: asynchronous (ASYNC) or plain loads
  auto stage = [&](int t, int buf) {
    int ox0, c0, oy0, b;
    tile_of(t, ox0, c0, oy0, b);
    T* xs = reinterpret_cast<T*>(smem_raw + buf * sbytes);  // [ih][iw][cb]
    float* ws = reinterpret_cast<float*>(smem_raw + buf * sbytes + xbytes);  // [k*k][cb]
    const int iy0 = oy0 * S - pad;
    const int ix0 = ox0 * S - pad;
    const T* xb = x + (size_t)b * height * width * c;
    if constexpr (ASYNC) {
      // the thread's channel vector is fixed (nthreads is a multiple of cbv)
      const int ch = c0 + cvi * V;
      const int n = ih * iw;
      for (int pix = tid / cbv; pix < n; pix += nthreads / cbv) {
        const int py = pix / iw;
        const int gy = iy0 + py;
        const int gx = ix0 + pix - py * iw;
        const bool in = gy >= 0 && gy < height && gx >= 0 && gx < width && ch < c;
        const T* src = in ? xb + ((size_t)gy * width + gx) * c + ch : x;
        cp_async16(xs + (size_t)pix * cb + cvi * V, src, in);
      }
      const int pieces = cb / 4;  // 16-byte runs of float32 weights a tap
      for (int i = tid; i < k * k * pieces; i += nthreads) {
        const int tap = i / pieces;
        const int ch = c0 + (i - tap * pieces) * 4;
        const bool in = ch < c;
        cp_async16(ws + tap * cb + (i - tap * pieces) * 4, in ? w + (size_t)tap * c + ch : w,
                   in);
      }
    } else {
      const int n = ih * iw * cb;
      for (int i = tid; i < n; i += nthreads) {
        const int ci = i % cb;
        const int pix = i / cb;
        const int py = pix / iw;
        const int gy = iy0 + py;
        const int gx = ix0 + pix - py * iw;
        const int ch = c0 + ci;
        const bool in = gy >= 0 && gy < height && gx >= 0 && gx < width && ch < c;
        xs[i] = in ? xb[((size_t)gy * width + gx) * c + ch] : from_f32<T>(0.f);
      }
      for (int i = tid; i < k * k * cb; i += nthreads) {
        const int tap = i / cb;
        const int ch = c0 + i - tap * cb;
        ws[i] = ch < c ? w[(size_t)tap * c + ch] : 0.f;
      }
    }
  };

  int t = blockIdx.x;
  if (t < tiles) stage(t, 0);
  if constexpr (ASYNC) asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int it = 0; t < tiles; t += gridDim.x, ++it) {
    if (t + gridDim.x < tiles) stage(t + gridDim.x, (it + 1) & 1);
    if constexpr (ASYNC) {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's copies
    }
    __syncthreads();

    int ox0, c0, oy0, b;
    tile_of(t, ox0, c0, oy0, b);
    const T* xs = reinterpret_cast<const T*>(smem_raw + (it & 1) * sbytes);
    const float* ws = reinterpret_cast<const float*>(smem_raw + (it & 1) * sbytes + xbytes);
    const int ch = c0 + cvi * V;
    for (int rr = 0; rr < rows && ch < c; ++rr) {
      const int ly = ri * rows + rr;  // local output row
      const int oy = oy0 + ly;
      if (oy >= out_h) break;
      float acc[kP][V];
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[p][j] = 0.f;
      if constexpr (K > 0) {
        constexpr int NC = (kP - 1) * S + K;  // input columns of kP outputs
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
          const T* xr = xs + ((size_t)(ly * S + dy) * iw + oxl * S) * cb + cvi * V;
          float wr[K][V];
#pragma unroll
          for (int dx = 0; dx < K; ++dx) load_w<V>(ws + (dy * K + dx) * cb + cvi * V, wr[dx]);
#pragma unroll
          for (int col = 0; col < NC; ++col) {
            float xv[V];
            load_f32<T, V>(xr + (size_t)col * cb, xv);
#pragma unroll
            for (int p = 0; p < kP; ++p) {
              const int dx = col - p * S;  // known at compile time once unrolled
              if (dx < 0 || dx >= K) continue;
#pragma unroll
              for (int j = 0; j < V; ++j) acc[p][j] = fmaf(xv[j], wr[dx][j], acc[p][j]);
            }
          }
        }
      } else {
        for (int dy = 0; dy < k; ++dy) {
          const T* xr = xs + ((size_t)(ly * S + dy) * iw + oxl * S) * cb + cvi * V;
          for (int dx = 0; dx < k; ++dx) {
            float wv[V];
            load_w<V>(ws + (dy * k + dx) * cb + cvi * V, wv);
#pragma unroll
            for (int p = 0; p < kP; ++p) {
              float xv[V];
              load_f32<T, V>(xr + (size_t)(p * S + dx) * cb, xv);
#pragma unroll
              for (int j = 0; j < V; ++j) acc[p][j] = fmaf(xv[j], wv[j], acc[p][j]);
            }
          }
        }
      }
      T* ob = out + (((size_t)b * out_h + oy) * out_w + ox0 + oxl) * c + ch;
#pragma unroll
      for (int p = 0; p < kP; ++p)
        if (ox0 + oxl + p < out_w) store_from_f32<T, V>(ob + (size_t)p * c, acc[p]);
    }
    __syncthreads();  // the stage is read: the copies two tiles on may refill it
  }
  if constexpr (ASYNC) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Dynamic shared memory up to the card's opt-in limit, allowed once per
// instantiation
template <typename T, int K, int S, int V, bool ASYNC>
cudaError_t allow_smem() {
  static const cudaError_t e = [] {
    int dev = 0, optin = 0;
    cudaError_t r = cudaGetDevice(&dev);
    if (r == cudaSuccess)
      r = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (r == cudaSuccess)
      r = cudaFuncSetAttribute(dw_tile_kernel<T, K, S, V, ASYNC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    return r;
  }();
  return e;
}

struct DwCall {  // one call: the tensors, the shape and the plan
  const void* x;
  const void* w;
  void* out;
  int batch, height, width, c, k, cbv, th, tw, rows, threads, smem, blocks;
  cudaStream_t stream;
};

// With per_sm: the blocks of this plan that fit on one SM, no launch.
// Else the launch of a.blocks persistent blocks.
template <typename T, int K, int S, int V, bool ASYNC>
int run(const DwCall& a, int* per_sm) {
  const cudaError_t e = allow_smem<T, K, S, V, ASYNC>();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, dw_tile_kernel<T, K, S, V, ASYNC>, a.threads, a.smem));
  dw_tile_kernel<T, K, S, V, ASYNC><<<a.blocks, a.threads, a.smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.w), static_cast<T*>(a.out),
      a.batch, a.height, a.width, a.c, a.k, a.cbv, a.th, a.tw, a.rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool ASYNC>
int dispatch(const DwCall& a, int stride, int* per_sm) {
  if (a.k == 3)
    return stride == 1 ? run<T, 3, 1, V, ASYNC>(a, per_sm) : run<T, 3, 2, V, ASYNC>(a, per_sm);
  if (a.k == 5)
    return stride == 1 ? run<T, 5, 1, V, ASYNC>(a, per_sm) : run<T, 5, 2, V, ASYNC>(a, per_sm);
  return stride == 1 ? run<T, 0, 1, V, ASYNC>(a, per_sm) : run<T, 0, 2, V, ASYNC>(a, per_sm);
}

int dispatch_type(const DwCall& a, int stride, int bf16, int vector, int* per_sm) {
  if (a.k < 1 || a.k % 2 == 0 || stride < 1 || stride > 2 || a.threads < 1 ||
      a.threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return vector ? dispatch<__nv_bfloat16, 8, true>(a, stride, per_sm)
                  : dispatch<__nv_bfloat16, 1, false>(a, stride, per_sm);
  return vector ? dispatch<float, 4, true>(a, stride, per_sm)
                : dispatch<float, 1, false>(a, stride, per_sm);
}

}  // namespace

extern "C" {

// The blocks of a plan (threads, smem bytes) that fit on one SM at once,
// into *per_sm, for the instantiation (bf16, vector, k, stride). Returns a
// cudaError_t.
int depthwise_blocks_per_sm(int bf16, int vector, int k, int stride, int threads, int smem,
                            int* per_sm) {
  DwCall a = {};
  a.k = k;
  a.threads = threads;
  a.smem = smem;
  return dispatch_type(a, stride, bf16, vector, per_sm);
}

// x (B, H, W, C) and out (B, Ho, Wo, C) in float32 (bf16 == 0) or
// bfloat16, Ho = (H - 1) / stride + 1 (likewise Wo); w (k, k, C) float32.
// k odd, stride 1 or 2. The plan comes from ops/depthwise.py
// `depthwise_tile_plan`: vector (16-byte staging; needs C a multiple of 16
// bytes' worth of channels and x, w, out 16-byte aligned), cbv channel
// vectors a chunk, th x tw output pixels a tile (tw a multiple of 4), rows
// output rows a thread, threads, smem bytes of dynamic shared memory (two
// stages); blocks persistent blocks walk over the tiles. Returns
// cudaErrorInvalidValue for arguments it cannot take, else
// cudaGetLastError() after the launch.
int depthwise_nhwc(const void* x, const void* w, void* out, int batch, int height,
                   int width, int c, int k, int stride, int bf16, int vector, int cbv,
                   int th, int tw, int rows, int threads, int smem, int blocks,
                   void* stream) {
  const int v = vector ? (bf16 ? 8 : 4) : 1;
  const bool aligned = ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w) |
                        reinterpret_cast<size_t>(out)) % 16) == 0;
  if (blocks < 1 || (vector && (c % v != 0 || !aligned)))
    return static_cast<int>(cudaErrorInvalidValue);
  const DwCall a = {x,   w,  out, batch, height,  width, c,      k,
                    cbv, th, tw,  rows,  threads, smem,  blocks, static_cast<cudaStream_t>(stream)};
  return dispatch_type(a, stride, bf16, vector, nullptr);
}

}  // extern "C"
