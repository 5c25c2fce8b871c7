// Fused, BN-folded inverted-residual block on NHWC tensors: two CUDA
// kernels for Hopper (sm_90a), with a plain C interface loaded by ctypes
// (deadtrees_tpu_torch/ops/_build.py, wrappers in ops/fused_cell.py).
//
// Replaces two TPU kernels that compute the same block in this layout:
//   deadtrees_tpu/ops/fused_cell.py `fused_ir_fat` (Pallas `_p1_kernel`,
//     `_p2_kernel`): hswish or silu, k = 3 or 5, h stored in x's dtype;
//   deadtrees_tpu/ops/fused_mbconv.py `fused_inverted_residual` (Pallas
//     `_pass1_kernel`, `_pass2_kernel`): hswish, k = 3, h stored in float32.
// The caller picks h's type; the sums are float32 throughout.
//
//   pass 1:  y = act(x W1 + b1), zero at every pixel outside the image
//            h = act(dw_kxk(y) + b_dw)            stored as float32 or bf16
//            psum[b, tile, c] = sum of the float32 h over the tile's pixels
//   (torch, between the passes: gate = sigmoid(relu(mean h Wc1 + bc1) Wc2 + bc2))
//   pass 2:  s = sigmoid(h . w_sse + b_sse)       per pixel, h as stored
//            out = (h*gate + h*s) W2 + b2 + skip  skip: x Wsk + bsk, x, or 0
//
// What bounds it on this card: the 1x1 convolutions. At the flagship's fat
// decoder cells (C_in 64 to 688) a pixel costs 2*C_in*C_mid + 2*C_mid*C_out
// FLOPs for a few bytes per channel, so on the CUDA cores (67 TFLOP/s
// float32) both passes are bound by operations, not by the 3.35 TB/s of
// memory; with the products on the tensor cores (989 TFLOP/s bf16) the
// bf16 pass 1 is bound by its bytes.
//
// bf16 pass 1 (`nhwc_p1_bf16_kernel`, the served route, h in bf16 for
// kernel 2 or float32 for kernel 3): the 1x1 expand runs on the tensor
// cores (tc_expand.cuh `expand_chunk_kmajor`: mma.sync bf16 with float32
// accumulation on W1 split into bf16 hi + lo at fold time, as kernel 1's
// pass 1; x is K-major here, so its B fragments come from ldmatrix without
// .trans). One block of 16 warps per (8 x 32 output tile, 64 mid channels,
// image). x comes 32 channels at a time through a 3-stage ring: a 4-D TMA
// box (C_in, W, H, B) of the exact halo, (8 + 2P) x (32 + 2P) pixels (the
// box's inner extent is 32 channels, so its origin is always 16-byte
// aligned), in the 64-byte swizzle (conflict-free ldmatrix), and a bulk
// copy of the chunk's packed W1; C_in % 8 != 0 or a misaligned x takes the
// same kernel with a plain-load staging variant. Then y = act(acc + b1),
// zero at every pixel outside the image (TMA's zero fill zeroes x, and
// act(b1) is not zero), goes to shared memory as float32 over the emptied
// ring, the depthwise conv runs one output pixel and 8 channels at a time
// a thread, h is staged [pixel][channel] (16-byte pieces swizzled by pixel)
// and written 16 bytes a store, the block's channels of a pixel in a row,
// and the per-tile cSE sums keep a fixed order (no atomics).
//
// The float32 path (`nhwc_p1_kernel`, float32 x) and pass 2 (`nhwc_p2_kernel`):
// every multiply-add is float32 on the CUDA cores, from shared-memory
// tiles, with register-tiled products. Pass 1 takes one block per (2-D
// output tile, 32 or 64 mid channels, image): the output tile is 14x14
// (k=3) or 12x12 (k=5), its haloed tile 16x16 pixels. x's haloed tile
// streams through shared memory 16 channels a step, each half-warp reading
// 16 neighbouring channels of one pixel (C_in reaches 688), the next step
// fetched into registers while the current one is summed. y of the haloed
// tile goes to shared memory, zeroed outside the image (the depthwise
// conv's zero padding applies to y, not x: a halo pixel must not carry
// act(b1)); the depthwise conv runs from there, and h is staged once more
// in shared memory so that each warp writes 32 neighbouring channels of a
// pixel. Per-tile channel sums of the float32 h go to psum with no
// atomics, so runs repeat exactly. Pass 2 takes one block per (64 pixels,
// 64 output channels, image): each warp reduces the sSE logit of 8 pixels
// over C_mid with a fixed shuffle tree, then the projection runs as a
// 64x64 register-tiled product (4x4 outputs a thread) over C_mid in steps
// of 32, and the conv skip as a second one over C_in.
//
// What it leaves for later work: the tensor cores in pass 2 (the
// projection, the sSE logit and the conv skip, as kernel 1's bf16 pass 2
// does them), wgmma in place of mma.sync in pass 1, TMA loads in pass 2,
// x read once per 64 mid channels in pass 1, h read once per 64 output
// channels in pass 2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

#include "tc_expand.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;               // pass-1 haloed tile side
constexpr int kSide2 = kSide * kSide;   // haloed pixels
constexpr int kRound = 32;              // pass-1 channels per y/depthwise round
constexpr int kKc = 16;                 // input channels staged per step
constexpr int kXs = kSide2 + 4;         // padded row of the staged x (banks)
constexpr int kPix2 = 64;               // pass-2 pixels per block
constexpr int kCo2 = 64;                // pass-2 output channels per block
constexpr int kCc2 = 32;                // pass-2 reduction step
static_assert(kKc * kSide == kThreads, "a thread stages one channel of a column");
static_assert(kKc * kXs <= kRound * kSide2, "x steps fit the y buffer");

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
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// 0: hard swish x * relu6(x + 3) / 6; 1: silu x * sigmoid(x)
template <int ACT>
__device__ __forceinline__ float act(float v) {
  if (ACT == 0) return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) / 6.f;
  return v / (1.f + expf(-v));
}

template <int K, int CMB>
constexpr size_t pass1_smem_floats() {
  return (size_t)kRound * kSide2            // buf: staged x, then y
         + (size_t)kKc * CMB                // ws: expand weights of a step
         + (size_t)CMB * K * K              // dws
         + (size_t)(kSide - 2 * (K / 2)) * (kSide - 2 * (K / 2)) * (kRound + 1)  // hs
         + (size_t)(kThreads / 32) * kRound;  // red
}

// The float32 pass 1. One block per (output tile, CMB mid channels, image), CMB 32 or
// 64; 256 threads. Staging: thread t fetches channel c0 + t % 16 of haloed
// column t / 16, all 16 rows, for each step of 16 input channels. The
// expand is kernel 1's register-tiled product: warp w owns mid channels
// w*CPT..w*CPT+CPT-1 (CPT = CMB / 8), lane l the haloed pixels 4l..4l+3
// and 128+4l..128+4l+3.
template <int K, int ACT, int CMB>
__global__ void __launch_bounds__(kThreads, 2)
    nhwc_p1_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ dw,
                   const float* __restrict__ bdw, float* __restrict__ h,
                   float* __restrict__ psum, int cin, int cm, int height,
                   int width, int tiles_w) {
  constexpr int P = K / 2;
  constexpr int OT = kSide - 2 * P;      // output tile side: 14 (k=3), 12 (k=5)
  constexpr int CPT = CMB / 8;           // mid channels a thread (and a warp)
  constexpr int WPT = kKc * CMB / kThreads;  // expand weights staged a thread
  constexpr int HS = kRound + 1;         // padded pixel row of hs
  static_assert(CMB == 32 || CMB == 64, "32 or 64 mid channels a block");

  extern __shared__ __align__(16) float smem[];
  float* buf = smem;                            // [kKc][kXs] x, then [kRound][kSide2] y
  float* ws = buf + kRound * kSide2;            // [kKc][CMB]
  float* dws = ws + kKc * CMB;                  // [CMB][K*K]
  float* hs = dws + CMB * K * K;                // [OT*OT][HS]
  float* red = hs + OT * OT * HS;               // [8][kRound]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_w) * OT - P;  // haloed tile origin
  const int x0 = (tile % tiles_w) * OT - P;
  const int m0 = blockIdx.y * CMB;
  const int b = blockIdx.z;
  const size_t row = (size_t)width * cin;    // x elements per image row

  // staging: channel kc of haloed column col, rows 0..15
  const int col = tid / kKc;
  const int kc = tid % kKc;
  const int sx = x0 + col;
  const bool col_in = sx >= 0 && sx < width;
  const float* xp = x + (size_t)b * height * row + (size_t)(col_in ? sx : 0) * cin + kc;
  const int wm = tid % CMB;
  const bool wm_ok = m0 + wm < cm;

  float pre[kSide];
  float wpre[WPT];
#pragma unroll
  for (int r = 0; r < kSide; ++r) {
    const int sy = y0 + r;
    pre[r] = (col_in && sy >= 0 && sy < height && kc < cin)
                 ? to_f32(xp[(size_t)sy * row])
                 : 0.f;
  }
#pragma unroll
  for (int r = 0; r < WPT; ++r) {
    const int wk = (tid + r * kThreads) / CMB;
    wpre[r] = (wm_ok && wk < cin) ? w1[(size_t)wk * cm + m0 + wm] : 0.f;
  }

  float acc[2][4][CPT];  // [pixel run][pixel][channel]
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[r][i][j] = 0.f;

  // expand: acc = sum_c x[pixel, c] W1[c, m0 + channel]
  for (int c0 = 0; c0 < cin; c0 += kKc) {
    __syncthreads();  // the previous step is done reading buf and ws
#pragma unroll
    for (int r = 0; r < kSide; ++r) buf[kc * kXs + r * kSide + col] = pre[r];
#pragma unroll
    for (int r = 0; r < WPT; ++r) ws[((tid + r * kThreads) / CMB) * CMB + wm] = wpre[r];
    __syncthreads();
    const int c1 = c0 + kKc;
    if (c1 < cin) {  // fetch the next step while this one is summed
#pragma unroll
      for (int r = 0; r < kSide; ++r) {
        const int sy = y0 + r;
        pre[r] = (col_in && sy >= 0 && sy < height && c1 + kc < cin)
                     ? to_f32(xp[(size_t)sy * row + c1])
                     : 0.f;
      }
#pragma unroll
      for (int r = 0; r < WPT; ++r) {
        const int wk = c1 + (tid + r * kThreads) / CMB;
        wpre[r] = (wm_ok && wk < cin) ? w1[(size_t)wk * cm + m0 + wm] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kKc; ++k) {
      float wv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; j += 4) {
        const float4 w = *reinterpret_cast<const float4*>(&ws[k * CMB + warp * CPT + j]);
        wv[j] = w.x;
        wv[j + 1] = w.y;
        wv[j + 2] = w.z;
        wv[j + 3] = w.w;
      }
      const float4 v0 = *reinterpret_cast<const float4*>(&buf[k * kXs + lane * 4]);
      const float4 v1 = *reinterpret_cast<const float4*>(&buf[k * kXs + 128 + lane * 4]);
      const float xv[2][4] = {{v0.x, v0.y, v0.z, v0.w},
                              {v1.x, v1.y, v1.z, v1.w}};
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[r][i][j] = fmaf(xv[r][i], wv[j], acc[r][i][j]);
    }
  }
  for (int i = tid; i < CMB * K * K; i += kThreads) {
    const int m = i / (K * K);
    const int j = i - m * (K * K);
    dws[m * K * K + j] = (m0 + m < cm) ? dw[(size_t)j * cm + m0 + m] : 0.f;
  }

  const bool active = tid < OT * OT;  // this thread's output pixel
  const int oy = tid / OT;
  const int ox = tid % OT;
  const bool inside = active && y0 + P + oy < height && x0 + P + ox < width;

  for (int r0 = 0; r0 < CMB; r0 += kRound) {
    __syncthreads();  // x, or the previous round's y and h, is no longer read
    // y = act(expand + b1), zero outside the image (rows AND columns)
    if (warp * CPT >= r0 && warp * CPT < r0 + kRound) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = r * 128 + lane * 4;  // four pixels of one tile row
        const int qy = y0 + q / kSide;
        const bool row_in = qy >= 0 && qy < height;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int m = warp * CPT + j;
          const bool m_ok = m0 + m < cm;
          const float bias = m_ok ? b1[m0 + m] : 0.f;
          float yv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qx = x0 + q % kSide + i;
            const bool in = row_in && m_ok && qx >= 0 && qx < width;
            yv[i] = in ? act<ACT>(acc[r][i][j] + bias) : 0.f;
          }
          *reinterpret_cast<float4*>(&buf[(m - r0) * kSide2 + q]) =
              make_float4(yv[0], yv[1], yv[2], yv[3]);
        }
      }
    }
    __syncthreads();

    // depthwise k x k for this thread's output pixel, then the partial sums
    for (int ml = 0; ml < kRound; ++ml) {
      const int m = r0 + ml;
      float a = 0.f;
      if (active) {
        const float* yq = &buf[ml * kSide2 + oy * kSide + ox];
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
            a = fmaf(yq[dy * kSide + dx], dws[m * K * K + dy * K + dx], a);
      }
      const bool live = inside && m0 + m < cm;
      const float hv = live ? act<ACT>(a + bdw[m0 + m]) : 0.f;
      if (active) hs[tid * HS + ml] = hv;
      float s = hv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp * kRound + ml] = s;
    }
    __syncthreads();
    // h: each warp writes 32 neighbouring channels of one pixel
    const int nc = min(kRound, cm - (m0 + r0));
    for (int i = tid; i < OT * OT * kRound; i += kThreads) {
      const int p = i / kRound;
      const int c = i - p * kRound;
      const int gy = y0 + P + p / OT;
      const int gx = x0 + P + p % OT;
      if (c < nc && gy < height && gx < width)
        h[((size_t)b * height + gy) * ((size_t)width * cm) + (size_t)gx * cm + m0 + r0 + c] =
            hs[p * HS + c];
    }
    if (tid < nc) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += red[w * kRound + tid];  // fixed order
      psum[((size_t)b * gridDim.x + tile) * cm + m0 + r0 + tid] = s;
    }
  }
}

// Pass 2. One block per (64 pixels, 64 output channels, image); 256
// threads. skip: 0 none, 1 identity (cin == cout), 2 conv.
template <typename TX, typename TH>
__global__ void __launch_bounds__(kThreads)
    nhwc_p2_kernel(const TH* __restrict__ h, const TX* __restrict__ x,
                   const float* __restrict__ gate,
                   const float* __restrict__ sse_w,
                   const float* __restrict__ sse_b,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ wsk,
                   const float* __restrict__ bsk, TX* __restrict__ out,
                   int cin, int cm, int cout, int hw, int skip) {
  __shared__ float vs[kPix2][kCc2 + 1];                // [pixel][channel]
  __shared__ __align__(16) float ws[kCc2][kCo2];       // [channel][output]
  __shared__ float sv[kPix2];                          // sSE gate per pixel

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * kPix2;
  const int co0 = blockIdx.y * kCo2;
  const int b = blockIdx.z;
  const int np = min(kPix2, hw - p0);  // live pixels of this block
  const TH* hb = h + ((size_t)b * hw + p0) * cm;
  const TX* xb = x + ((size_t)b * hw + p0) * cin;
  const float* gb = gate + (size_t)b * cm;

  // sSE: warp w takes pixels 8w..8w+7, its lanes stride over C_mid
  constexpr int kPerWarp = kPix2 / (kThreads / 32);
  for (int i = 0; i < kPerWarp; ++i) {
    const int p = warp * kPerWarp + i;
    float z = 0.f;
    if (p < np)
      for (int c = lane; c < cm; c += 32)
        z = fmaf(sse_w[c], to_f32(hb[(size_t)p * cm + c]), z);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      z += __shfl_xor_sync(0xffffffffu, z, off);
    if (lane == 0) sv[p] = 1.f / (1.f + expf(-(z + sse_b[0])));
  }
  __syncthreads();

  const int tx = tid % 16;  // output channels co0 + 4tx .. +3
  const int ty = tid / 16;  // pixels 4ty .. 4ty+3
  float acc[4][4];
  float accs[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = accs[i][j] = 0.f;

  // project: acc = sum_c (h gate + h s)[pixel, c] W2[c, co]; then the conv
  // skip: accs = sum_c x[pixel, c] Wsk[c, co]
  for (int part = 0; part < (skip == 2 ? 2 : 1); ++part) {
    const int kdim = part == 0 ? cm : cin;
    const float* wmat = part == 0 ? w2 : wsk;
    for (int c0 = 0; c0 < kdim; c0 += kCc2) {
      for (int e = tid; e < kPix2 * kCc2; e += kThreads) {
        const int p = e / kCc2;
        const int j = e - p * kCc2;
        const int c = c0 + j;
        float v = 0.f;
        if (p < np && c < kdim) {
          if (part == 0) {
            const float hv = to_f32(hb[(size_t)p * cm + c]);
            v = hv * gb[c] + hv * sv[p];
          } else {
            v = to_f32(xb[(size_t)p * cin + c]);
          }
        }
        vs[p][j] = v;
      }
      for (int e = tid; e < kCc2 * kCo2; e += kThreads) {
        const int j = e / kCo2;
        const int o = e - j * kCo2;
        ws[j][o] = (c0 + j < kdim && co0 + o < cout)
                       ? wmat[(size_t)(c0 + j) * cout + co0 + o]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < kCc2; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(&ws[j][tx * 4]);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = vs[ty * 4 + i][j];
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            if (part == 0)
              acc[i][o] = fmaf(v, wv[o], acc[i][o]);
            else
              accs[i][o] = fmaf(v, wv[o], accs[i][o]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty * 4 + i;
    if (p >= np) break;
    TX* op = out + ((size_t)b * hw + p0 + p) * cout;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int co = co0 + tx * 4 + o;
      if (co >= cout) break;
      float v = acc[i][o] + b2[co];
      if (skip == 2) {
        v += accs[i][o] + bsk[co];
      } else if (skip == 1) {
        v += to_f32(xb[(size_t)p * cin + co]);
      }
      op[co] = from_f32<TX>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 pass 1: the expand on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kThreadsNB = 512;  // 16 warps: 2 along the mid channels x 8 along the pixels
constexpr int kOtHN = 8;         // output tile rows
constexpr int kOtWN = 32;        // and columns
constexpr int kPixN = kOtHN * kOtWN;
constexpr int kStagesN = 3;      // chunks in flight (TMA variant)
constexpr int kHalvesN = kThreadsNB / kPixN;  // the depthwise conv splits the channels
static_assert(tc::kCmb % (kHalvesN * 8) == 0, "whole groups of 8 channels a half");

// The hard swish and silu with a multiply by 1/6 and the fast exponential
// and divide, a few ulp from act() (as kernel 1's bf16 pass 1).
template <int ACT>
__device__ __forceinline__ float act_fast(float v) {
  if (ACT == 0) return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) * (1.f / 6.f);
  return __fdividef(v, 1.f + __expf(-v));
}

// Shared-memory plan of the bf16 pass 1 for a k x k depthwise conv and h
// of type TH. The staged tile is the exact halo, (8 + 2P) x (32 + 2P)
// pixels of 32 channels (64 bytes a pixel, 64-byte swizzle); the ring of x
// and W chunks is overlaid, once the product is done, by y.
template <int K, typename TH>
struct NhwcTile {
  static constexpr int P = K / 2;
  static constexpr int BH = kOtHN + 2 * P;      // staged rows
  static constexpr int BW = kOtWN + 2 * P;      // and columns
  static constexpr int NPIX = BH * BW;          // staged pixels
  static constexpr int NT = (NPIX + 7) / 8;     // n8 tiles
  static constexpr int NTW = (NT + 7) / 8;      // n8 tiles a warp (8 warps along N)
  static constexpr int NPAD = NTW * 8 * 8;      // pixels the product covers
  static constexpr int XBYTES = NPIX * tc::kKc * 2;       // one chunk of x (a TMA box)
  static constexpr int XSLOT = (XBYTES + 1023) / 1024 * 1024;
  static constexpr int STAGE = XSLOT + tc::kWChunkBytes;  // x box, then its W chunk
  static constexpr int RING = kStagesN * STAGE;
  static constexpr int YS = NPAD + 8;           // y row stride in floats (bank spread)
  static constexpr int YBYTES = tc::kCmb * YS * 4;
  static constexpr int U = RING > YBYTES ? RING : YBYTES;
  static constexpr int HROW = tc::kCmb * (int)sizeof(TH);  // bytes a pixel of the h tile
  static constexpr int OFF_HS = (U + 1023) / 1024 * 1024;  // h tile [256 px][64 ch]
  static constexpr int OFF_DWS = OFF_HS + kPixN * HROW;
  static constexpr int OFF_B1 = OFF_DWS + tc::kCmb * K * K * 4;
  static constexpr int OFF_BDW = OFF_B1 + tc::kCmb * 4;
  static constexpr int OFF_RED = OFF_BDW + tc::kCmb * 4;
  static constexpr int OFF_BAR = OFF_RED + (kThreadsNB / 32) * tc::kCmb * 4;
  static constexpr int SMEM = OFF_BAR + kStagesN * 8 + 1024;  // + the 1024-byte alignment
  static_assert(BW % 2 == 0, "a C fragment's two pixels share a staged row");
  // the product reads NPAD pixels of a stage: past its box it reads into
  // the stage's own W chunk, never past the ring
  static_assert((NPAD - NPIX) * 64 <= STAGE - XBYTES, "padding stays in the stage");
};

// One thread: chunk c's x box (TMA: channels c*32.., the haloed tile, with
// the out-of-image part zero-filled) and packed W chunk (bulk copy) into
// stage c % kStagesN, completing on that stage's mbarrier.
template <typename L>
__device__ __forceinline__ void issue_nhwc(const CUtensorMap* tmap, unsigned char* ring,
                                           const __nv_bfloat16* wblk, uint64_t* bars, int c,
                                           int x0, int y0, int b) {
  const int s = c % kStagesN;
  unsigned char* st = ring + s * L::STAGE;
  tc::mbar_expect_tx(&bars[s], L::XBYTES + tc::kWChunkBytes);
  tc::tma_load_4d(st, tmap, c * tc::kKc, x0, y0, b, &bars[s]);
  tc::bulk_load(st + L::XSLOT, wblk + (size_t)c * tc::kWChunkElems, tc::kWChunkBytes,
                &bars[s]);
}

// One block of 16 warps per (8 x 32 output tile, 64 mid channels, image).
// Warp w owns m16 tiles (w / 8) * 2 + {0, 1} and n8 tiles (w % 8) * NTW + j
// of the product (tc::expand_chunk_kmajor: x is K-major in NHWC); a warp
// whose m16 tiles lie past C_mid skips it. TMA: the ring of chunks fed by a
// 4-D TMA box of x (C_in % 8 == 0, x 16-byte aligned) and bulk copies of W;
// else one stage filled by plain loads in the same swizzled layout. Then y
// = act(acc + b1), zero outside the image, goes to shared memory as float32
// (over the emptied ring), the depthwise conv runs one output pixel and
// half of the channels a thread, 8 channels at once, and h is staged
// [pixel][channel] (16-byte pieces swizzled by pixel) and written 16 bytes
// a store, 64 channels of a pixel in a row; the cSE partial sums keep the
// float32 path's fixed order.
template <typename TH, int K, int ACT, bool TMA>
__global__ void __launch_bounds__(kThreadsNB, 1)
    nhwc_p1_bf16_kernel(const __grid_constant__ CUtensorMap tmap,
                        const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wpk, const float* __restrict__ b1,
                        const float* __restrict__ dw, const float* __restrict__ bdw,
                        TH* __restrict__ h, float* __restrict__ psum, int cin, int cm,
                        int height, int width, int tiles_w) {
  using L = NhwcTile<K, TH>;
  constexpr int P = L::P;
  constexpr int NTW = L::NTW;
  constexpr int CMB = tc::kCmb;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = tc::align1024(smem_raw);
  float* ys = reinterpret_cast<float*>(smem);  // [CMB][YS], after the product
  unsigned char* hs = smem + L::OFF_HS;
  float* dws = reinterpret_cast<float*>(smem + L::OFF_DWS);
  float* b1s = reinterpret_cast<float*>(smem + L::OFF_B1);
  float* bdws = reinterpret_cast<float*>(smem + L::OFF_BDW);
  float* red = reinterpret_cast<float*>(smem + L::OFF_RED);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 3;
  const int wn = warp & 7;
  const int tile = blockIdx.x;
  const int oy0 = (tile / tiles_w) * kOtHN;
  const int ox0 = (tile % tiles_w) * kOtWN;
  const int y0 = oy0 - P;  // staged tile origin: the exact halo
  const int x0 = ox0 - P;
  const int mblk = blockIdx.y;
  const int m0 = mblk * CMB;
  const int b = blockIdx.z;
  const int nchunks = (cin + tc::kKc - 1) / tc::kKc;
  const __nv_bfloat16* wblk = wpk + (size_t)mblk * nchunks * tc::kWChunkElems;
  const bool warp_live = m0 + wm * 32 < cm;  // warp-uniform: its m16 tiles hold a channel

  for (int i = tid; i < CMB * K * K; i += kThreadsNB) {
    const int m = i / (K * K);
    const int j = i - m * (K * K);
    dws[i] = (m0 + m < cm) ? dw[(size_t)j * cm + m0 + m] : 0.f;
  }
  if (tid < CMB) {
    b1s[tid] = (m0 + tid < cm) ? b1[m0 + tid] : 0.f;
    bdws[tid] = (m0 + tid < cm) ? bdw[m0 + tid] : 0.f;
  }

  float acc[2][NTW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s < kStagesN; ++s) tc::mbar_init(&bars[s], 1);
      tc::mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0)
      for (int c = 0; c < kStagesN && c < nchunks; ++c)
        issue_nhwc<L>(&tmap, smem, wblk, bars, c, x0, y0, b);
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % kStagesN;
      tc::mbar_wait(&bars[s], (c / kStagesN) & 1);
      const unsigned char* st = smem + s * L::STAGE;
      if (warp_live)
        tc::expand_chunk_kmajor<NTW>(reinterpret_cast<const __nv_bfloat16*>(st),
                                     reinterpret_cast<const __nv_bfloat16*>(st + L::XSLOT),
                                     acc, wm, wn, lane);
      __syncthreads();  // every warp is done with stage s
      if (tid == 0 && c + kStagesN < nchunks)
        issue_nhwc<L>(&tmap, smem, wblk, bars, c + kStagesN, x0, y0, b);
    }
  } else {
    for (int c = 0; c < nchunks; ++c) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < L::NPIX * tc::kKc; i += kThreadsNB) {
        const int p = i / tc::kKc;
        const int ch = i - p * tc::kKc;
        const int py = p / L::BW;
        const int gy = y0 + py;
        const int gx = x0 + p - py * L::BW;
        const int gc = c * tc::kKc + ch;
        const bool in = gc < cin && gy >= 0 && gy < height && gx >= 0 && gx < width;
        *reinterpret_cast<__nv_bfloat16*>(smem + p * 64 + (((ch >> 3) ^ ((p >> 1) & 3)) << 4) +
                                          (ch & 7) * 2) =
            in ? x[(((size_t)b * height + gy) * width + gx) * cin + gc] : __float2bfloat16(0.f);
      }
      const uint4* wsrc = reinterpret_cast<const uint4*>(wblk + (size_t)c * tc::kWChunkElems);
      uint4* wdst = reinterpret_cast<uint4*>(smem + L::XSLOT);
      for (int i = tid; i < tc::kWChunkBytes / 16; i += kThreadsNB) wdst[i] = wsrc[i];
      __syncthreads();
      if (warp_live)
        tc::expand_chunk_kmajor<NTW>(reinterpret_cast<const __nv_bfloat16*>(smem),
                                     reinterpret_cast<const __nv_bfloat16*>(wdst), acc, wm, wn,
                                     lane);
    }
  }
  __syncthreads();  // the ring is no longer read: y overlays it

  // y = act(expand + b1), zero outside the image (rows AND columns): the
  // depthwise conv's zero padding applies to y, not to x, so a halo pixel
  // must not carry act(b1). A warp past C_mid writes nothing: the
  // depthwise conv reads no channel of it.
  if (warp_live) {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = (wm * 2 + i) * 16 + hr * 8 + g;
        const bool m_ok = m0 + m < cm;
        const float bias = b1s[m];
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int n = (wn * NTW + j) * 8 + 2 * t;  // even: n and n + 1 share a row
          if (n >= L::NPIX) continue;
          const int py = n / L::BW;
          const int gy = y0 + py;
          const int gx = x0 + n - py * L::BW;
          const bool row_in = m_ok && gy >= 0 && gy < height;
          float2 v;
          v.x = (row_in && gx >= 0 && gx < width) ? act_fast<ACT>(acc[i][j][hr * 2] + bias)
                                                  : 0.f;
          v.y = (row_in && gx + 1 >= 0 && gx + 1 < width)
                    ? act_fast<ACT>(acc[i][j][hr * 2 + 1] + bias)
                    : 0.f;
          *reinterpret_cast<float2*>(&ys[m * L::YS + n]) = v;
        }
      }
    }
  }
  __syncthreads();

  // depthwise k x k: thread tid takes output pixel tid % 256 and the
  // channels of half tid / 256, kGroup at once; each channel's sums keep
  // their order (taps row-major, then the warp's shuffle tree). Channels
  // past mcount (y and weights zero) are computed and never read.
  const int pix = tid % kPixN;
  const int half = tid / kPixN;
  const int oy = pix / kOtWN;
  const int ox = pix % kOtWN;
  const bool inside = oy0 + oy < height && ox0 + ox < width;
  const int mcount = min(CMB, cm - m0);
  constexpr int kGroup = 8;
  constexpr int kPerHalf = CMB / kHalvesN;
  unsigned char* hrow = hs + pix * L::HROW;
  for (int mg = half * kPerHalf; mg < min(mcount, (half + 1) * kPerHalf); mg += kGroup) {
    float s[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int m = mg + j;
      const float* yq = ys + m * L::YS + oy * L::BW + ox;
      float a = 0.f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          a = fmaf(yq[dy * L::BW + dx], dws[m * K * K + dy * K + dx], a);
      s[j] = inside ? act_fast<ACT>(a + bdws[m]) : 0.f;
    }
    // h staged [pixel][channel]: 16-byte piece q of a pixel at q ^ (pixel % 8)
    if constexpr (sizeof(TH) == 2) {
      uint4 pk;
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
      for (int k = 0; k < 4; ++k) p2[k] = __floats2bfloat162_rn(s[2 * k], s[2 * k + 1]);
      *reinterpret_cast<uint4*>(hrow + (((mg >> 3) ^ (pix & 7)) << 4)) = pk;
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k)
        *reinterpret_cast<float4*>(hrow + ((((mg >> 2) + k) ^ (pix & 7)) << 4)) =
            make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
    }
    // the float32 h, before rounding to h's type
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < kGroup; ++j) s[j] += __shfl_down_sync(0xffffffffu, s[j], off);
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < kGroup; ++j) red[warp * CMB + mg + j] = s[j];
  }
  __syncthreads();
  if (tid < mcount) {
    // the 8 warps of the channel's half, in order
    const int w0 = (tid / kPerHalf) * (kPixN / 32);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kPixN / 32; ++w) s += red[(w0 + w) * CMB + tid];
    psum[((size_t)b * gridDim.x + tile) * cm + m0 + tid] = s;
  }

  // h: the block's channels of each pixel in a row
  constexpr int kVec = 16 / (int)sizeof(TH);  // channels a 16-byte store
  constexpr int kPieces = CMB / kVec;         // 16-byte pieces a pixel
  if (cm % kVec == 0) {
    const int npieces = mcount / kVec;
    for (int i = tid; i < kPixN * kPieces; i += kThreadsNB) {
      const int p = i / kPieces;
      const int q = i - p * kPieces;
      const int gy = oy0 + p / kOtWN;
      const int gx = ox0 + p % kOtWN;
      if (q < npieces && gy < height && gx < width)
        *reinterpret_cast<uint4*>(h + (((size_t)b * height + gy) * width + gx) * cm + m0 +
                                  q * kVec) =
            *reinterpret_cast<const uint4*>(hs + p * L::HROW + ((q ^ (p & 7)) << 4));
    }
  } else {
    for (int i = tid; i < kPixN * CMB; i += kThreadsNB) {
      const int p = i / CMB;
      const int m = i - p * CMB;
      const int gy = oy0 + p / kOtWN;
      const int gx = ox0 + p % kOtWN;
      if (m < mcount && gy < height && gx < width)
        h[(((size_t)b * height + gy) * width + gx) * cm + m0 + m] = *reinterpret_cast<const TH*>(
            hs + p * L::HROW + (((m / kVec) ^ (p & 7)) << 4) + (m % kVec) * (int)sizeof(TH));
    }
  }
}

template <int K, int ACT, int CMB>
int launch_pass1_cmb(const void* x, const void* w1, const void* b1,
                     const void* dw, const void* bdw, void* h, void* psum,
                     int batch, int cin, int cm, int height, int width,
                     cudaStream_t stream) {
  constexpr int OT = kSide - 2 * (K / 2);
  constexpr size_t smem = pass1_smem_floats<K, CMB>() * sizeof(float);
  auto kernel = nhwc_p1_kernel<K, ACT, CMB>;
  // above 48 KB a block's dynamic shared memory must be allowed first
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (height + OT - 1) / OT;
  const int tiles_w = (width + OT - 1) / OT;
  const dim3 grid(tiles_h * tiles_w, (cm + CMB - 1) / CMB, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(dw),
      static_cast<const float*>(bdw), static_cast<float*>(h),
      static_cast<float*>(psum), cin, cm, height, width, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

// 64 mid channels a block (x read half as often) for C_mid above 64, unless
// that pads C_mid further than 32 a block would (kernel 1's rule)
template <int K, int ACT>
int launch_pass1(const void* x, const void* w1, const void* b1,
                 const void* dw, const void* bdw, void* h, void* psum,
                 int batch, int cin, int cm, int height, int width,
                 cudaStream_t stream) {
  if (cm > 64 && (cm + 63) / 64 * 64 == (cm + 31) / 32 * 32)
    return launch_pass1_cmb<K, ACT, 64>(x, w1, b1, dw, bdw, h, psum, batch, cin, cm,
                                        height, width, stream);
  return launch_pass1_cmb<K, ACT, 32>(x, w1, b1, dw, bdw, h, psum, batch, cin, cm, height,
                                      width, stream);
}

template <typename TX, typename TH>
int launch_pass2(const void* h, const void* x, const void* gate,
                 const void* sse_w, const void* sse_b, const void* w2,
                 const void* b2, const void* wsk, const void* bsk, void* out,
                 int batch, int cin, int cm, int cout, int hw, int skip,
                 cudaStream_t stream) {
  const dim3 grid((hw + kPix2 - 1) / kPix2, (cout + kCo2 - 1) / kCo2, batch);
  nhwc_p2_kernel<TX, TH><<<grid, kThreads, 0, stream>>>(
      static_cast<const TH*>(h), static_cast<const TX*>(x),
      static_cast<const float*>(gate), static_cast<const float*>(sse_w),
      static_cast<const float*>(sse_b), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wsk),
      static_cast<const float*>(bsk), static_cast<TX*>(out), cin, cm, cout, hw,
      skip);
  return static_cast<int>(cudaGetLastError());
}

template <typename TH, int K, int ACT, bool TMA>
int launch_pass1_bf16(const void* x, const void* wpk, const void* b1, const void* dw,
                      const void* bdw, void* h, void* psum, int batch, int cin, int cm,
                      int height, int width, cudaStream_t stream) {
  using L = NhwcTile<K, TH>;
  static bool smem_allowed = false;  // once per instantiation
  if (!smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(nhwc_p1_bf16_kernel<TH, K, ACT, TMA>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = true;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if constexpr (TMA) {
    // x as a 4-D tensor (C_in, W, H, B), innermost first; one box is a
    // chunk's haloed tile: 32 channels x (32 + 2P) columns x (8 + 2P) rows
    const tc::EncodeTiledFn encode = tc::encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)width, (cuuint64_t)height,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)width * cin * 2,
                                   (cuuint64_t)height * width * cin * 2};
    const cuuint32_t box[4] = {tc::kKc, L::BW, L::BH, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                              dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_w = (width + kOtWN - 1) / kOtWN;
  const int tiles_h = (height + kOtHN - 1) / kOtHN;
  const dim3 grid(tiles_h * tiles_w, (cm + tc::kCmb - 1) / tc::kCmb, batch);
  nhwc_p1_bf16_kernel<TH, K, ACT, TMA><<<grid, kThreadsNB, L::SMEM, stream>>>(
      map, static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wpk),
      static_cast<const float*>(b1), static_cast<const float*>(dw),
      static_cast<const float*>(bdw), static_cast<TH*>(h), static_cast<float*>(psum), cin, cm,
      height, width, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows (axis 0) or columns (axis 1) of the pass-1 output tile for a k x k
// depthwise conv: 8 x 32 for bfloat16 x (the tensor-core kernel), 14 x 14
// (k = 3) or 12 x 12 (k = 5) for float32 x. psum has one row per tile.
int fused_ir_nhwc_tile_size(int ksize, int x_bf16, int axis) {
  if (x_bf16) return axis == 0 ? kOtHN : kOtWN;
  return kSide - 2 * (ksize / 2);
}

// x (B, H, W, Cin) in float32 (x_bf16 == 0) or bfloat16; h (B, H, W, Cm)
// in float32 (h_bf16 == 0) or bfloat16; w1 (Cin, Cm), b1 (Cm),
// dw (k, k, Cm), bdw (Cm) float32; psum (B, ceil(H/t0) * ceil(W/t1), Cm)
// float32, t = fused_ir_nhwc_tile_size(k, x_bf16, axis). act: 0 hard
// swish, 1 silu. Types: (x, h) = (f32, f32) or (bf16, bf16) with any k and
// act, or (bf16, f32) with k = 3 and hard swish. float32 x reads w1;
// bfloat16 x reads w1_packed (ops/fused_mbconv.py `pack_w1`, 16-byte
// aligned) and with tma != 0 stages x by TMA (needs C_in % 8 == 0 and x
// 16-byte aligned), else by plain loads. Returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments it cannot take).
int fused_ir_nhwc_pass1(const void* x, const void* w1, const void* w1_packed,
                        const void* b1, const void* dw, const void* bdw, void* h, void* psum,
                        int batch, int cin, int cm, int height, int width,
                        int ksize, int act, int x_bf16, int h_bf16, int tma,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16) {
    const bool aligned = reinterpret_cast<size_t>(x) % 16 == 0;
    if (w1_packed == nullptr || reinterpret_cast<size_t>(w1_packed) % 16 != 0 ||
        (tma && (cin % 8 != 0 || !aligned)))
      return static_cast<int>(cudaErrorInvalidValue);
#define DT_BF16(TH, K, A)                                                                   \
  return tma ? launch_pass1_bf16<TH, K, A, true>(x, w1_packed, b1, dw, bdw, h, psum, batch, \
                                                 cin, cm, height, width, s)                 \
             : launch_pass1_bf16<TH, K, A, false>(x, w1_packed, b1, dw, bdw, h, psum, batch, \
                                                  cin, cm, height, width, s)
    switch (h_bf16 * 100 + ksize * 10 + act) {
      case 130: DT_BF16(bf, 3, 0);
      case 131: DT_BF16(bf, 3, 1);
      case 150: DT_BF16(bf, 5, 0);
      case 151: DT_BF16(bf, 5, 1);
      case 30: DT_BF16(float, 3, 0);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DT_BF16
  }
#define DT_PASS1(K, A)                                                                    \
  return launch_pass1<K, A>(x, w1, b1, dw, bdw, h, psum, batch, cin, cm, height, width, s)
  if (h_bf16) return static_cast<int>(cudaErrorInvalidValue);
  switch (ksize * 10 + act) {
    case 30: DT_PASS1(3, 0);
    case 31: DT_PASS1(3, 1);
    case 50: DT_PASS1(5, 0);
    case 51: DT_PASS1(5, 1);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DT_PASS1
}

// h (B, H*W, Cm) as pass 1 stored it, x (B, H*W, Cin) and out
// (B, H*W, Cout) in x's type; gate (B, Cm), sse_w (Cm), sse_b (1),
// w2 (Cm, Cout), b2 (Cout) float32; wsk (Cin, Cout) and bsk (Cout)
// float32, read only when skip == 2. skip: 0 none, 1 identity, 2 conv.
// Returns cudaGetLastError().
int fused_ir_nhwc_pass2(const void* h, const void* x, const void* gate,
                        const void* sse_w, const void* sse_b, const void* w2,
                        const void* b2, const void* wsk, const void* bsk,
                        void* out, int batch, int cin, int cm, int cout, int hw,
                        int skip, int x_bf16, int h_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  if (skip < 0 || skip > 2) return static_cast<int>(cudaErrorInvalidValue);
#define DT_PASS2(TX, TH)                                                        \
  return launch_pass2<TX, TH>(h, x, gate, sse_w, sse_b, w2, b2, wsk, bsk, out, \
                              batch, cin, cm, cout, hw, skip, s)
  if (!x_bf16 && !h_bf16) DT_PASS2(float, float);
  if (x_bf16 && h_bf16) DT_PASS2(bf, bf);
  if (x_bf16 && !h_bf16) DT_PASS2(bf, float);
#undef DT_PASS2
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
