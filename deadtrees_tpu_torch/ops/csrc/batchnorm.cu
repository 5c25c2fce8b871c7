// Train-mode BatchNorm, forward and backward: four CUDA kernels for Hopper
// (sm_90a), with a plain C interface loaded by ctypes
// (deadtrees_tpu_torch/ops/_build.py); the ops that launch them are C++,
// in batchnorm_op.cpp, which gets these entry points at load.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA (flax's
// nn.BatchNorm). It was added because PyTorch's own train-mode BatchNorm
// (a float32 copy of x for var_mean, then native kernels that take the
// statistics a second time) took about half of the busy device time of
// both 512^2 training cells, and ~11 launches a layer. What the kernels
// compute, for x (N, C, H, W), M = N * H * W values a channel:
//
//   mean_c, var_c = the biased statistics of channel c, in float32
//   invstd_c      = 1 / sqrt(var_c + eps)
//   y             = x * scale_c + shift_c, scale_c = w_c * invstd_c,
//                   shift_c = b_c - mean_c * scale_c, in x's type
//   running_mean  = running_mean * (1 - momentum) + mean * momentum
//   running_var   = running_var * (1 - momentum) + var * momentum (flax's
//                   biased variance), num_batches_tracked += 1
//   backward: dbias_c = sum dy, dweight_c = sum dy * xhat, xhat = (x - mean_c)
//             * invstd_c, dx = scale_c * (dy - dbias_c / M - xhat * dweight_c / M)
//
// What bounds them on this card: bytes. Forward, x is read twice (the
// statistics, then the normalisation) and y written once: 6 B a bf16
// element; backward, x and dy twice and dx once: 10 B. A step of the b5
// model of record at bs 16 normalises 5.5 G elements: 88 GB, 26 ms at
// 3.35 TB/s. The arithmetic is a few float32 operations an element.
//
// The design: every kernel runs on a grid of (chunk, channel group)
// blocks. A channel's M values are cut into chunks, so that the layers
// with few channels at high resolution (24 channels of 1 M values at
// 256^2, bs 16) still give every one of the 132 SMs blocks to run; the
// ops pick the number of chunks from (N, C, H * W) and the card's SM
// count (batchnorm_op.cpp plan). Two layouts:
//   NCHW: a block takes one channel; its chunk is a run of that channel's
//     N * H * W values, read as 16-byte vectors where H * W allows (a
//     vector never crosses from one image to the next).
//   NHWC (channels-last): a block takes one channel vector (16 bytes of
//     each pixel: 8 bf16 or 4 float32 channels) and a run of pixels; the
//     grid runs the vectors of one pixel run side by side, so that blocks
//     that share a 32-byte sector of memory run together.
// Tensors whose layout or alignment does not allow 16-byte vectors take
// single-element loads (v = 1) through the same kernels.
//
// bn_forward launches the first two, bn_backward the last two:
//
//   bn_stats:       each thread keeps a float32 Welford (count, mean, M2)
//                   triple, merged (Chan et al.) warp by warp and then
//                   across warps; one triple a (channel, chunk) is written
//                   to scratch.
//   bn_apply:       each block merges its channels' chunk triples in chunk
//                   order (every block of a channel computes the same
//                   numbers), forms scale and shift and writes y; the
//                   chunk-0 blocks write mean and invstd and move the
//                   running buffers; block (0, 0) ticks the counter.
//   bn_grad_reduce: per (channel, chunk) float32 sums of dy and of
//                   dy * (x - mean).
//   bn_grad_apply:  merges them in chunk order and writes dx; the chunk-0
//                   blocks write dweight and dbias in float32.
//
// No atomics: every sum is taken in a fixed order, so the results are
// bit-identical from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // vectors a thread keeps in flight
constexpr int kMaxV = 8;    // elements a 16-byte vector (bf16)
constexpr unsigned kFull = 0xffffffffu;

template <bool kBf16>
struct Elem;
template <>
struct Elem<false> {
  using T = float;
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float put(float v) { return v; }
};
template <>
struct Elem<true> {
  using T = unsigned short;
  static __device__ __forceinline__ float get(unsigned short v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  static __device__ __forceinline__ unsigned short put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T e[V];
};

struct Welford {
  float n, mean, m2;
};

// Chan's merge; an empty side (n = 0, mean = 0, m2 = 0) leaves the other
// as it is.
__device__ __forceinline__ Welford merge(Welford a, Welford b) {
  const float n = a.n + b.n;
  if (n == 0.0f) return a;
  const float f = b.n / n;
  const float d = b.mean - a.mean;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

__device__ __forceinline__ Welford shfl_down(Welford w, int o) {
  return {__shfl_down_sync(kFull, w.n, o), __shfl_down_sync(kFull, w.mean, o),
          __shfl_down_sync(kFull, w.m2, o)};
}

// The geometry of one call, the same for all four kernels of a plan. The
// grid is (chunks, C) on NCHW and (C / v, chunks) on NHWC.
struct Geometry {
  int c;             // channels
  int chunks;        // chunks a channel
  long long stride;  // NCHW: vectors of one (n, c) plane; NHWC: vectors of one pixel
  long long units;   // NCHW: vectors of one channel; NHWC: pixels
  long long chunk;   // units a block
};

// NCHW: the vector offset of unit u of channel c (u < 2^31, checked by
// the op).
__device__ __forceinline__ long long nchw_at(const Geometry& g, int c, long long u) {
  const unsigned plane = static_cast<unsigned>(u) / static_cast<unsigned>(g.stride);
  const long long r = u - static_cast<long long>(plane) * g.stride;
  return (static_cast<long long>(plane) * g.c + c) * g.stride + r;
}

// A block's (chunk, first channel, channels): one channel on NCHW, the
// v channels of one pixel vector on NHWC.
template <bool kNhwc, int V>
struct Tile {
  int chunk;
  long long cvec;  // NCHW: the channel; NHWC: the channel vector
  long long start, end;
  __device__ __forceinline__ explicit Tile(const Geometry& g) {
    chunk = kNhwc ? blockIdx.y : blockIdx.x;
    cvec = kNhwc ? blockIdx.x : blockIdx.y;
    start = static_cast<long long>(chunk) * g.chunk;
    end = min(g.units, start + g.chunk);
  }
  __device__ __forceinline__ long long first_channel() const { return kNhwc ? cvec * V : cvec; }
};

// ---------------------------------------------------------------------------
// statistics
// ---------------------------------------------------------------------------

template <bool kBf16, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_nchw_kernel(const typename Elem<kBf16>::T* __restrict__ x, float* __restrict__ part,
                     Geometry g) {
  using E = Elem<kBf16>;
  using VT = Vec<typename E::T, V>;
  const VT* xv = reinterpret_cast<const VT*>(x);
  const Tile<false, V> t(g);
  const int c = static_cast<int>(t.cvec);
  Welford w{0.0f, 0.0f, 0.0f};
  for (long long u0 = t.start + threadIdx.x; u0 < t.end; u0 += kThreads * kUnroll) {
    VT v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long u = u0 + j * kThreads;
      if (u < t.end) v[j] = xv[nchw_at(g, c, u)];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (u0 + j * kThreads < t.end) {
        float f[V];
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          f[i] = E::get(v[j].e[i]);
          s += f[i];
        }
        const float mean = s * (1.0f / V);
        float m2 = 0.0f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = f[i] - mean;
          m2 += d * d;
        }
        w = merge(w, {static_cast<float>(V), mean, m2});
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) w = merge(w, shfl_down(w, o));
  __shared__ Welford warp_w[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_w[warp] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    Welford r = warp_w[0];
    for (int i = 1; i < kWarps; ++i) r = merge(r, warp_w[i]);
    float* p = part + (static_cast<long long>(c) * g.chunks + t.chunk) * 3;
    p[0] = r.n;
    p[1] = r.mean;
    p[2] = r.m2;
  }
}

template <bool kBf16, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_nhwc_kernel(const typename Elem<kBf16>::T* __restrict__ x, float* __restrict__ part,
                     Geometry g) {
  using E = Elem<kBf16>;
  using VT = Vec<typename E::T, V>;
  const VT* xv = reinterpret_cast<const VT*>(x);
  const Tile<true, V> t(g);
  float n = 0.0f, mean[V], m2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) mean[i] = m2[i] = 0.0f;
  for (long long p0 = t.start + threadIdx.x; p0 < t.end; p0 += kThreads * kUnroll) {
    VT v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long p = p0 + j * kThreads;
      if (p < t.end) v[j] = xv[p * g.stride + t.cvec];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (p0 + j * kThreads < t.end) {
        n += 1.0f;
        const float f = 1.0f / n;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xi = E::get(v[j].e[i]);
          const float d = xi - mean[i];
          mean[i] += d * f;
          m2[i] += d * (xi - mean[i]);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_down_sync(kFull, n, o);
    const float nn = n + nb;
    const float f = nn == 0.0f ? 0.0f : nb / nn;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float mb = __shfl_down_sync(kFull, mean[i], o);
      const float qb = __shfl_down_sync(kFull, m2[i], o);
      const float d = mb - mean[i];
      mean[i] += d * f;
      m2[i] += qb + d * d * n * f;
    }
    n = nn;
  }
  __shared__ float sn[kWarps], smean[kWarps][kMaxV], sm2[kWarps][kMaxV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sn[warp] = n;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      smean[warp][i] = mean[i];
      sm2[warp][i] = m2[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < V) {
    const int i = threadIdx.x;
    Welford r{sn[0], smean[0][i], sm2[0][i]};
    for (int k = 1; k < kWarps; ++k) r = merge(r, {sn[k], smean[k][i], sm2[k][i]});
    float* p = part + ((t.first_channel() + i) * g.chunks + t.chunk) * 3;
    p[0] = r.n;
    p[1] = r.mean;
    p[2] = r.m2;
  }
}

// ---------------------------------------------------------------------------
// normalisation
// ---------------------------------------------------------------------------

struct ApplyArgs {
  const float* weight;
  const float* bias;
  float* running_mean;
  float* running_var;
  long long* num_batches_tracked;
  float* mean;
  float* invstd;
  float momentum;  // float32(momentum)
  float keep;      // float32(1 - momentum)
  float eps;
  float count;     // M
};

// Warp i of the block merges the chunk triples of the block's channel
// first + i in chunk order (lanes take every 32nd chunk, then a fixed
// shuffle tree) and leaves scale and shift in shared memory; the chunk-0
// blocks write the statistics and the running buffers.
__device__ void channel_affine(const float* __restrict__ part, const ApplyArgs& a,
                               const Geometry& g, long long first, int nch, int chunk,
                               float* scale, float* shift) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < nch) {
    const long long ch = first + warp;
    Welford w{0.0f, 0.0f, 0.0f};
    for (int k = lane; k < g.chunks; k += 32) {
      const float* p = part + (ch * g.chunks + k) * 3;
      w = merge(w, {p[0], p[1], p[2]});
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w = merge(w, shfl_down(w, o));
    if (lane == 0) {
      const float var = w.m2 / a.count;
      const float invstd = 1.0f / sqrtf(var + a.eps);
      const float s = a.weight[ch] * invstd;
      scale[warp] = s;
      shift[warp] = a.bias[ch] - w.mean * s;
      if (chunk == 0) {
        a.mean[ch] = w.mean;
        a.invstd[ch] = invstd;
        a.running_mean[ch] =
            __fadd_rn(__fmul_rn(a.running_mean[ch], a.keep), __fmul_rn(w.mean, a.momentum));
        a.running_var[ch] =
            __fadd_rn(__fmul_rn(a.running_var[ch], a.keep), __fmul_rn(var, a.momentum));
      }
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *a.num_batches_tracked += 1;
  __syncthreads();
}

template <bool kBf16, int V>
__global__ void __launch_bounds__(kThreads)
bn_apply_nchw_kernel(const typename Elem<kBf16>::T* __restrict__ x, const float* __restrict__ part,
                     typename Elem<kBf16>::T* __restrict__ y, ApplyArgs a, Geometry g) {
  using E = Elem<kBf16>;
  using VT = Vec<typename E::T, V>;
  __shared__ float scale[1], shift[1];
  const Tile<false, V> t(g);
  const int c = static_cast<int>(t.cvec);
  channel_affine(part, a, g, c, 1, t.chunk, scale, shift);
  const float s = scale[0], sh = shift[0];
  const VT* xv = reinterpret_cast<const VT*>(x);
  VT* yv = reinterpret_cast<VT*>(y);
  for (long long u0 = t.start + threadIdx.x; u0 < t.end; u0 += kThreads * kUnroll) {
    VT v[kUnroll];
    long long at[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long u = u0 + j * kThreads;
      if (u < t.end) {
        at[j] = nchw_at(g, c, u);
        v[j] = xv[at[j]];
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (u0 + j * kThreads < t.end) {
        VT o;
#pragma unroll
        for (int i = 0; i < V; ++i) o.e[i] = E::put(fmaf(E::get(v[j].e[i]), s, sh));
        yv[at[j]] = o;
      }
    }
  }
}

template <bool kBf16, int V>
__global__ void __launch_bounds__(kThreads)
bn_apply_nhwc_kernel(const typename Elem<kBf16>::T* __restrict__ x, const float* __restrict__ part,
                     typename Elem<kBf16>::T* __restrict__ y, ApplyArgs a, Geometry g) {
  using E = Elem<kBf16>;
  using VT = Vec<typename E::T, V>;
  __shared__ float scale[kMaxV], shift[kMaxV];
  const Tile<true, V> t(g);
  channel_affine(part, a, g, t.first_channel(), V, t.chunk, scale, shift);
  float s[V], sh[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s[i] = scale[i];
    sh[i] = shift[i];
  }
  const VT* xv = reinterpret_cast<const VT*>(x);
  VT* yv = reinterpret_cast<VT*>(y);
  for (long long p0 = t.start + threadIdx.x; p0 < t.end; p0 += kThreads * kUnroll) {
    VT v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long p = p0 + j * kThreads;
      if (p < t.end) v[j] = xv[p * g.stride + t.cvec];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long p = p0 + j * kThreads;
      if (p < t.end) {
        VT o;
#pragma unroll
        for (int i = 0; i < V; ++i) o.e[i] = E::put(fmaf(E::get(v[j].e[i]), s[i], sh[i]));
        yv[p * g.stride + t.cvec] = o;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <bool kBf16, int V>
__global__ void __launch_bounds__(kThreads)
bn_grad_reduce_nchw_kernel(const typename Elem<kBf16>::T* __restrict__ dy,
                           const typename Elem<kBf16>::T* __restrict__ x,
                           const float* __restrict__ mean, float* __restrict__ part, Geometry g) {
  using E = Elem<kBf16>;
  using VT = Vec<typename E::T, V>;
  const VT* dv = reinterpret_cast<const VT*>(dy);
  const VT* xv = reinterpret_cast<const VT*>(x);
  const Tile<false, V> t(g);
  const int c = static_cast<int>(t.cvec);
  const float m = mean[c];
  float s1 = 0.0f, s2 = 0.0f;
  for (long long u0 = t.start + threadIdx.x; u0 < t.end; u0 += kThreads * kUnroll) {
    VT a[kUnroll], b[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long u = u0 + j * kThreads;
      if (u < t.end) {
        const long long at = nchw_at(g, c, u);
        a[j] = dv[at];
        b[j] = xv[at];
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (u0 + j * kThreads < t.end) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = E::get(a[j].e[i]);
          s1 += d;
          s2 += d * (E::get(b[j].e[i]) - m);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_down_sync(kFull, s1, o);
    s2 += __shfl_down_sync(kFull, s2, o);
  }
  __shared__ float w1[kWarps], w2[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    w1[warp] = s1;
    w2[warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = w1[0], t2 = w2[0];
    for (int i = 1; i < kWarps; ++i) {
      t1 += w1[i];
      t2 += w2[i];
    }
    float* p = part + (static_cast<long long>(c) * g.chunks + t.chunk) * 2;
    p[0] = t1;
    p[1] = t2;
  }
}

template <bool kBf16, int V>
__global__ void __launch_bounds__(kThreads)
bn_grad_reduce_nhwc_kernel(const typename Elem<kBf16>::T* __restrict__ dy,
                           const typename Elem<kBf16>::T* __restrict__ x,
                           const float* __restrict__ mean, float* __restrict__ part, Geometry g) {
  using E = Elem<kBf16>;
  using VT = Vec<typename E::T, V>;
  const VT* dv = reinterpret_cast<const VT*>(dy);
  const VT* xv = reinterpret_cast<const VT*>(x);
  const Tile<true, V> t(g);
  float s1[V], s2[V], m[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s1[i] = s2[i] = 0.0f;
    m[i] = mean[t.first_channel() + i];
  }
  for (long long p0 = t.start + threadIdx.x; p0 < t.end; p0 += kThreads * kUnroll) {
    VT a[kUnroll], b[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long p = p0 + j * kThreads;
      if (p < t.end) {
        a[j] = dv[p * g.stride + t.cvec];
        b[j] = xv[p * g.stride + t.cvec];
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (p0 + j * kThreads < t.end) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = E::get(a[j].e[i]);
          s1[i] += d;
          s2[i] += d * (E::get(b[j].e[i]) - m[i]);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s1[i] += __shfl_down_sync(kFull, s1[i], o);
      s2[i] += __shfl_down_sync(kFull, s2[i], o);
    }
  }
  __shared__ float w1[kWarps][kMaxV], w2[kWarps][kMaxV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      w1[warp][i] = s1[i];
      w2[warp][i] = s2[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < V) {
    const int i = threadIdx.x;
    float t1 = w1[0][i], t2 = w2[0][i];
    for (int k = 1; k < kWarps; ++k) {
      t1 += w1[k][i];
      t2 += w2[k][i];
    }
    float* p = part + ((t.first_channel() + i) * g.chunks + t.chunk) * 2;
    p[0] = t1;
    p[1] = t2;
  }
}

struct GradArgs {
  const float* weight;
  const float* mean;
  const float* invstd;
  float* dweight;
  float* dbias;
  float count;  // M
};

// As channel_affine: per channel of the block, dx = a * (dy - k1 - (x - mean) * k2)
// with a = w * invstd, k1 = sum dy / M, k2 = invstd^2 * sum dy (x - mean) / M.
__device__ void channel_grad(const float* __restrict__ part, const GradArgs& a,
                             const Geometry& g, long long first, int nch, int chunk,
                             float* coef) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < nch) {
    const long long ch = first + warp;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = lane; k < g.chunks; k += 32) {
      const float* p = part + (ch * g.chunks + k) * 2;
      s1 += p[0];
      s2 += p[1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_down_sync(kFull, s1, o);
      s2 += __shfl_down_sync(kFull, s2, o);
    }
    if (lane == 0) {
      const float is = a.invstd[ch];
      const float dw = s2 * is;  // sum dy * xhat
      coef[4 * warp + 0] = a.weight[ch] * is;
      coef[4 * warp + 1] = s1 / a.count;
      coef[4 * warp + 2] = is * dw / a.count;
      coef[4 * warp + 3] = a.mean[ch];
      if (chunk == 0) {
        a.dweight[ch] = dw;
        a.dbias[ch] = s1;
      }
    }
  }
  __syncthreads();
}

template <bool kBf16, int V>
__global__ void __launch_bounds__(kThreads)
bn_grad_apply_nchw_kernel(const typename Elem<kBf16>::T* __restrict__ dy,
                          const typename Elem<kBf16>::T* __restrict__ x,
                          const float* __restrict__ part, typename Elem<kBf16>::T* __restrict__ dx,
                          GradArgs a, Geometry g) {
  using E = Elem<kBf16>;
  using VT = Vec<typename E::T, V>;
  __shared__ float coef[4];
  const Tile<false, V> t(g);
  const int c = static_cast<int>(t.cvec);
  channel_grad(part, a, g, c, 1, t.chunk, coef);
  const float sc = coef[0], k1 = coef[1], k2 = coef[2], m = coef[3];
  const VT* dv = reinterpret_cast<const VT*>(dy);
  const VT* xv = reinterpret_cast<const VT*>(x);
  VT* ov = reinterpret_cast<VT*>(dx);
  for (long long u0 = t.start + threadIdx.x; u0 < t.end; u0 += kThreads * kUnroll) {
    VT da[kUnroll], xb[kUnroll];
    long long at[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long u = u0 + j * kThreads;
      if (u < t.end) {
        at[j] = nchw_at(g, c, u);
        da[j] = dv[at[j]];
        xb[j] = xv[at[j]];
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (u0 + j * kThreads < t.end) {
        VT o;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = E::get(da[j].e[i]) - k1 - (E::get(xb[j].e[i]) - m) * k2;
          o.e[i] = E::put(sc * d);
        }
        ov[at[j]] = o;
      }
    }
  }
}

template <bool kBf16, int V>
__global__ void __launch_bounds__(kThreads)
bn_grad_apply_nhwc_kernel(const typename Elem<kBf16>::T* __restrict__ dy,
                          const typename Elem<kBf16>::T* __restrict__ x,
                          const float* __restrict__ part, typename Elem<kBf16>::T* __restrict__ dx,
                          GradArgs a, Geometry g) {
  using E = Elem<kBf16>;
  using VT = Vec<typename E::T, V>;
  __shared__ float coef[4 * kMaxV];
  const Tile<true, V> t(g);
  channel_grad(part, a, g, t.first_channel(), V, t.chunk, coef);
  float sc[V], k1[V], k2[V], m[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sc[i] = coef[4 * i + 0];
    k1[i] = coef[4 * i + 1];
    k2[i] = coef[4 * i + 2];
    m[i] = coef[4 * i + 3];
  }
  const VT* dv = reinterpret_cast<const VT*>(dy);
  const VT* xv = reinterpret_cast<const VT*>(x);
  VT* ov = reinterpret_cast<VT*>(dx);
  for (long long p0 = t.start + threadIdx.x; p0 < t.end; p0 += kThreads * kUnroll) {
    VT da[kUnroll], xb[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long p = p0 + j * kThreads;
      if (p < t.end) {
        da[j] = dv[p * g.stride + t.cvec];
        xb[j] = xv[p * g.stride + t.cvec];
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long p = p0 + j * kThreads;
      if (p < t.end) {
        VT o;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = E::get(da[j].e[i]) - k1[i] - (E::get(xb[j].e[i]) - m[i]) * k2[i];
          o.e[i] = E::put(sc[i] * d);
        }
        ov[p * g.stride + t.cvec] = o;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Launch {
  Geometry g;
  dim3 grid;
  cudaStream_t stream;
};

Launch plan(int nhwc, int v, int c, long long hw, long long units, long long chunk, int chunks,
            void* stream) {
  Launch l;
  l.g.c = c;
  l.g.chunks = chunks;
  l.g.stride = nhwc ? c / v : hw / v;
  l.g.units = units;
  l.g.chunk = chunk;
  l.grid = nhwc ? dim3(c / v, chunks) : dim3(chunks, c);
  l.stream = static_cast<cudaStream_t>(stream);
  return l;
}

// Calls f(bf16 tag, vector width tag) for the instantiation of (bf16, v).
template <typename F>
int dispatch(int bf16, int v, F f) {
  if (bf16) {
    if (v == 8) return f(std::true_type{}, std::integral_constant<int, 8>{});
    if (v == 1) return f(std::true_type{}, std::integral_constant<int, 1>{});
  } else {
    if (v == 4) return f(std::false_type{}, std::integral_constant<int, 4>{});
    if (v == 1) return f(std::false_type{}, std::integral_constant<int, 1>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The SM count of CUDA device `device` (the plan spreads a call over it),
// or 0 where the runtime cannot tell.
int bn_sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  return sms;
}

// Forward: bn_stats_*, then bn_apply_* on the same stream.
// x: (N, C, H, W) in bf16 (bf16 = 1) or float32, NCHW- (nhwc = 0) or
// channels-last-contiguous (nhwc = 1); y: x's shape, type and layout;
// weight, bias, running_mean, running_var, mean, invstd: (C,) float32;
// num_batches_tracked: one int64; part: (C, chunks, 3) float32 scratch.
// v: elements a vector (16 bytes, or 1); units: NCHW vectors of a channel
// (N * H * W / v) or NHWC pixels (N * H * W); chunk: units a block;
// chunks: blocks a channel (at most 65,535); count: N * H * W. All on the
// device; returns the first cudaGetLastError() that is not 0 after a
// launch, else 0.
int bn_forward(const void* x, void* part, const void* weight, const void* bias,
               void* running_mean, void* running_var, void* num_batches_tracked, void* mean,
               void* invstd, void* y, float momentum, float keep, float eps, float count,
               int bf16, int nhwc, int v, int c, long long hw, long long units, long long chunk,
               int chunks, void* stream) {
  const Launch l = plan(nhwc, v, c, hw, units, chunk, chunks, stream);
  ApplyArgs a;
  a.weight = static_cast<const float*>(weight);
  a.bias = static_cast<const float*>(bias);
  a.running_mean = static_cast<float*>(running_mean);
  a.running_var = static_cast<float*>(running_var);
  a.num_batches_tracked = static_cast<long long*>(num_batches_tracked);
  a.mean = static_cast<float*>(mean);
  a.invstd = static_cast<float*>(invstd);
  a.momentum = momentum;
  a.keep = keep;
  a.eps = eps;
  a.count = count;
  return dispatch(bf16, v, [&](auto b, auto vw) {
    constexpr bool kB = decltype(b)::value;
    constexpr int kV = decltype(vw)::value;
    using T = typename Elem<kB>::T;
    const T* xt = static_cast<const T*>(x);
    float* p = static_cast<float*>(part);
    T* yt = static_cast<T*>(y);
    if (nhwc) {
      bn_stats_nhwc_kernel<kB, kV><<<l.grid, kThreads, 0, l.stream>>>(xt, p, l.g);
    } else {
      bn_stats_nchw_kernel<kB, kV><<<l.grid, kThreads, 0, l.stream>>>(xt, p, l.g);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (nhwc) {
      bn_apply_nhwc_kernel<kB, kV><<<l.grid, kThreads, 0, l.stream>>>(xt, p, yt, a, l.g);
    } else {
      bn_apply_nchw_kernel<kB, kV><<<l.grid, kThreads, 0, l.stream>>>(xt, p, yt, a, l.g);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// Backward: bn_grad_reduce_*, then bn_grad_apply_*. dy, dx: x's shape,
// type and layout; weight, mean, invstd (bn_forward's), dweight, dbias:
// (C,) float32; part: (C, chunks, 2) float32 scratch. The rest as
// bn_forward's.
int bn_backward(const void* dy, const void* x, const void* weight, const void* mean,
                const void* invstd, void* part, void* dx, void* dweight, void* dbias,
                float count, int bf16, int nhwc, int v, int c, long long hw, long long units,
                long long chunk, int chunks, void* stream) {
  const Launch l = plan(nhwc, v, c, hw, units, chunk, chunks, stream);
  GradArgs a;
  a.weight = static_cast<const float*>(weight);
  a.mean = static_cast<const float*>(mean);
  a.invstd = static_cast<const float*>(invstd);
  a.dweight = static_cast<float*>(dweight);
  a.dbias = static_cast<float*>(dbias);
  a.count = count;
  return dispatch(bf16, v, [&](auto b, auto vw) {
    constexpr bool kB = decltype(b)::value;
    constexpr int kV = decltype(vw)::value;
    using T = typename Elem<kB>::T;
    const T* dt = static_cast<const T*>(dy);
    const T* xt = static_cast<const T*>(x);
    const float* m = static_cast<const float*>(mean);
    float* p = static_cast<float*>(part);
    T* ot = static_cast<T*>(dx);
    if (nhwc) {
      bn_grad_reduce_nhwc_kernel<kB, kV><<<l.grid, kThreads, 0, l.stream>>>(dt, xt, m, p, l.g);
    } else {
      bn_grad_reduce_nchw_kernel<kB, kV><<<l.grid, kThreads, 0, l.stream>>>(dt, xt, m, p, l.g);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (nhwc) {
      bn_grad_apply_nhwc_kernel<kB, kV><<<l.grid, kThreads, 0, l.stream>>>(dt, xt, p, ot, a, l.g);
    } else {
      bn_grad_apply_nchw_kernel<kB, kV><<<l.grid, kThreads, 0, l.stream>>>(dt, xt, p, ot, a, l.g);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
