// Signed distance maps of the boundary loss: two CUDA kernels for Hopper
// (sm_90a), with a plain C interface loaded by ctypes
// (deadtrees_tpu_torch/ops/_build.py, wrapper in ops/edt.py).
//
// Replaces no TPU kernel: the JAX package computes these maps in XLA
// (deadtrees_tpu/losses/functional.py `batch_one_hot2dist`), and the
// port's plain version (deadtrees_tpu_torch/losses/functional.py
// `batch_one_hot2dist_reference`) is eager PyTorch: ~2,300 launches a
// training batch and 64 MiB row blocks of (x - x')^2 + g^2 written out
// and reduced. What the kernels compute, for each plane (one class of one
// image, H x W, `pos` = seg > 0.5, `neg` its complement):
//
//   g2_c[y, x] = (column distance from (y, x) to the nearest pixel of
//                 class c)^2, or 1e12f where the column has none
//   d_c[y, x]  = sqrt(min_x' fl(fl((x - x')^2) + g2_c[y, x']))
//   out        = d_pos * neg - (d_neg - 1) * pos, or 0 for a plane with
//                no pos pixel
//
// every step in the plain version's float32 operations (each product and
// sum rounded on its own, IEEE sqrt), so the two agree bit for bit on the
// card. A min is exact in any order; a sum fl(d*d) + g may be fused into
// one FMA only where d*d is exact, |d| <= 4096 (W <= 4097).
//
// Two kernels:
//   edt_columns_kernel: one thread a column of a plane; neighbouring
//     threads take neighbouring columns, so each row step is one coalesced
//     access. A scan down stores, for each pixel, its class and the
//     distance up to the nearest pixel of the other class (in the g2_neg
//     buffer); a scan up reads it back, completes the distance with the
//     nearest one below and writes g2_pos and g2_neg (one of the two is 0:
//     the pixel's own class).
//   edt_rows_kernel: one block a row of a plane. It stages the row's two
//     g2 rows in shared memory as (g2_pos, g2_neg) pairs and each thread
//     takes kR output columns: for every x' one broadcast load and, for
//     each of its columns, the two sums and mins. The epilogue takes the
//     square roots, the signed combine and the zero map of an absent class:
//     a class is present in the plane iff any g2_pos of the row is below
//     1e12f (a present class gives every row a finite column distance), so
//     no reduction across blocks is needed. The pixel's own class is
//     g2_pos == 0.
//
// What bounds them on this card. The columns are bytes: 20 bytes a pixel
// (seg read, the scan's word written and read back, two g2 written), 252
// MB at 16 x 3 x 512^2, 0.075 ms at 3.35 TB/s; with only P * W threads
// (24,576 there) the scan is latency-bound, so each thread keeps
// kColumnBatch loads in flight. The rows are bound by instruction
// dispatch: W^2 (sum, min) pairs a row and class half, 12.9 G pairs at
// 16 x 3 x 512^2. For each x' a thread runs one shared load and, for its
// kR columns, a sub (shared by the halves) and, for each half, an FMA and
// a min: 2.6 instructions a pair, about 1.0 ms at one warp instruction
// per scheduler a clock (1.98 GHz); the mins alone on the half-rate ALU
// pipe would take 0.77 ms. So the FMA matters: mul-then-add takes 3.1 a pair, and its
// row kernel measured 1.13 x the FMA one's time on an H100 at that shape
// (1.490 against 1.315 ms), 1.12 x at 1024^2 and 4096^2 rows; it is kept
// only for rows wider than 4,097, where d * d is not exact.
// The shared row is 8 bytes a column: 64 KB at the widest row (W = 8,192,
// the range 1e12f covers: (2 * 8192)^2 < 1e12), above the 48 KB default,
// so launch_rows opts in to the dynamic size there.
//
// What it leaves for later work: a linear-time lower envelope
// (Felzenszwalb-Huttenlocher), which has to stay bit-equal on rows of
// 1e12f; pruning x' beyond the row's largest distance.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float kBig = 1e12f;    // the plain version's _BIG, rounded to float32
constexpr int kNone = 1 << 20;   // "no pixel of that class in the column"
constexpr int kColumnThreads = 256;
constexpr int kColumnBatch = 16;  // loads a column thread keeps in flight
constexpr int kR = 4;            // output columns a thread in the row kernel
constexpr int kRowThreads = 256;
constexpr int kFmaExactMaxW = 4097;  // |x - x'| <= 4096: (x - x')^2 <= 2^24, exact

__device__ __forceinline__ float square_or_big(int d) {
  const float f = static_cast<float>(d);
  return d >= kNone ? kBig : __fmul_rn(f, f);
}

__global__ void __launch_bounds__(kColumnThreads)
edt_columns_kernel(const float* __restrict__ seg, float* __restrict__ g2,
                   long long columns, int h, int w) {
  const long long c = static_cast<long long>(blockIdx.x) * kColumnThreads + threadIdx.x;
  if (c >= columns) return;
  const size_t plane = static_cast<size_t>(c / w);
  const size_t at = plane * h * w + static_cast<size_t>(c % w);
  const size_t half = static_cast<size_t>(columns) * h;  // P * H * W
  const float* src = seg + at;
  float* gp = g2 + at;
  float* gn = gp + half;  // holds the scan down's words (as float bits) until the scan up

  // down: class bit and distance up to the nearest pixel of the other class
  int last_pos = -kNone, last_neg = -kNone;
  for (int y0 = 0; y0 < h; y0 += kColumnBatch) {
    float v[kColumnBatch];
#pragma unroll
    for (int i = 0; i < kColumnBatch; ++i) {
      if (y0 + i < h) v[i] = src[static_cast<size_t>(y0 + i) * w];
    }
#pragma unroll
    for (int i = 0; i < kColumnBatch; ++i) {
      const int y = y0 + i;
      if (y < h) {
        const bool pos = v[i] > 0.5f;
        int d;
        if (pos) {
          last_pos = y;
          d = y - last_neg;
        } else {
          last_neg = y;
          d = y - last_pos;
        }
        gn[static_cast<size_t>(y) * w] =
            __int_as_float((min(d, kNone) << 1) | static_cast<int>(pos));
      }
    }
  }
  // up: the nearest below completes the distance; one of the two is 0
  int next_pos = h - 1 + kNone, next_neg = h - 1 + kNone;
  for (int y1 = h - 1; y1 >= 0; y1 -= kColumnBatch) {
    int word[kColumnBatch];
#pragma unroll
    for (int i = 0; i < kColumnBatch; ++i) {
      if (y1 - i >= 0) word[i] = __float_as_int(gn[static_cast<size_t>(y1 - i) * w]);
    }
#pragma unroll
    for (int i = 0; i < kColumnBatch; ++i) {
      const int y = y1 - i;
      if (y >= 0) {
        const bool pos = word[i] & 1;
        int d = word[i] >> 1;
        if (pos) {
          next_pos = y;
          d = min(d, next_neg - y);
        } else {
          next_neg = y;
          d = min(d, next_pos - y);
        }
        const float far = square_or_big(d);
        const size_t o = static_cast<size_t>(y) * w;
        gp[o] = pos ? 0.0f : far;
        gn[o] = pos ? far : 0.0f;
      }
    }
  }
}

template <bool kFma>
__device__ __forceinline__ float sum_sq(float d, float g) {
  if constexpr (kFma) {
    return __fmaf_rn(d, d, g);  // d * d is exact: the same as its rounding, then the add
  } else {
    return __fadd_rn(__fmul_rn(d, d), g);
  }
}

template <bool kFma>
__global__ void __launch_bounds__(kRowThreads)
edt_rows_kernel(const float* __restrict__ g2, float* __restrict__ out, long long rows,
                int w) {
  extern __shared__ float2 row_g2[];  // (g2_pos, g2_neg) of each column
  const size_t at = static_cast<size_t>(blockIdx.x) * w;
  const float* gp = g2 + at;
  const float* gn = g2 + static_cast<size_t>(rows) * w + at;
  int present = 0;
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    const float p = gp[x];
    row_g2[x] = make_float2(p, gn[x]);
    present |= p < kBig;
  }
  present = __syncthreads_or(present);
  float* o = out + at;
  for (int x0 = 0; x0 < w; x0 += blockDim.x * kR) {
    float xf[kR], m_pos[kR], m_neg[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      xf[k] = static_cast<float>(x0 + threadIdx.x + k * blockDim.x);
      m_pos[k] = INFINITY;
      m_neg[k] = INFINITY;
    }
    float xp = 0.0f;
#pragma unroll 4
    for (int j = 0; j < w; ++j) {
      const float2 g = row_g2[j];
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const float d = __fsub_rn(xf[k], xp);
        m_pos[k] = fminf(m_pos[k], sum_sq<kFma>(d, g.x));
        m_neg[k] = fminf(m_neg[k], sum_sq<kFma>(d, g.y));
      }
      xp = __fadd_rn(xp, 1.0f);
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int x = x0 + threadIdx.x + k * blockDim.x;
      if (x < w) {
        const float posf = row_g2[x].x == 0.0f ? 1.0f : 0.0f;
        const float negf = 1.0f - posf;
        const float d_out = __fmul_rn(__fsqrt_rn(m_pos[k]), negf);
        const float d_in = __fmul_rn(__fsub_rn(__fsqrt_rn(m_neg[k]), 1.0f), posf);
        o[x] = present ? __fsub_rn(d_out, d_in) : 0.0f;
      }
    }
  }
}

template <bool kFma>
int launch_rows(const float* g2, float* out, long long rows, int w, cudaStream_t s) {
  const int per_thread = (w + kR - 1) / kR;
  const int threads = min(kRowThreads, max(32, (per_thread + 31) / 32 * 32));
  const size_t smem = static_cast<size_t>(w) * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        edt_rows_kernel<kFma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  edt_rows_kernel<kFma><<<static_cast<unsigned>(rows), threads, smem, s>>>(g2, out, rows, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// seg: (planes, h, w) float32; g2: (2, planes, h, w) float32 scratch,
// written: [0] the squared column distances to class pixels, [1] to the
// others. All on the device, contiguous. Returns cudaGetLastError() after
// the launch.
int edt_columns(const void* seg, void* g2, long long planes, int h, int w, void* stream) {
  const long long columns = planes * w;
  const long long blocks = (columns + kColumnThreads - 1) / kColumnThreads;
  edt_columns_kernel<<<static_cast<unsigned>(blocks), kColumnThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seg), static_cast<float*>(g2), columns, h, w);
  return static_cast<int>(cudaGetLastError());
}

// g2: edt_columns' output; out: (planes, h, w) float32, the signed maps.
int edt_rows(const void* g2, void* out, long long planes, int h, int w, void* stream) {
  const long long rows = planes * h;
  const float* in = static_cast<const float*>(g2);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w <= kFmaExactMaxW ? launch_rows<true>(in, o, rows, w, s)
                            : launch_rows<false>(in, o, rows, w, s);
}

}  // extern "C"
