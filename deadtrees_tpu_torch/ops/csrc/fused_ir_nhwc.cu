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
// memory; with the products on the tensor cores (989 TFLOP/s bf16) both
// bf16 passes are bound by their bytes.
//
// bf16 pass 1 (`nhwc_p1_bf16_kernel`, the served route, h in bf16 for
// kernel 2 or float32 for kernel 3): the 1x1 expand runs on the tensor
// cores (tc_expand.cuh `expand_chunk_kmajor`: mma.sync bf16 with float32
// accumulation on W1 split into bf16 hi + lo at fold time, as kernel 1's
// pass 1; x is K-major here, so its B fragments come from ldmatrix without
// .trans). For float32 h W1 is split into three terms and each chunk's
// products are summed in a temporary before the float32 total
// (`expand_chunk`), so that h stays at float32 level. One block of 16
// warps per (8 x 32 output tile, 64 mid channels, image). x comes 32
// channels at a time through a 3-stage ring: a 4-D TMA box (C_in, W, H, B)
// of the exact halo, (8 + 2P) x (32 + 2P) pixels (the box's inner extent
// is 32 channels, so its origin is always 16-byte aligned), in the 64-byte
// swizzle (conflict-free ldmatrix), and a bulk copy of the chunk's packed
// W1; C_in % 8 != 0 or a misaligned x takes the same kernel with a
// plain-load staging variant. Then y = act(acc + b1), zero at every pixel
// outside the image (TMA's zero fill zeroes x, and act(b1) is not zero),
// goes to shared memory as float32 over the emptied ring, the depthwise
// conv runs one output pixel and 8 channels at a time a thread, h is
// staged [pixel][channel] (16-byte pieces swizzled by pixel) and written
// 16 bytes a store, the block's channels of a pixel in a row, and the
// per-tile cSE sums keep a fixed order (no atomics).
//
// bf16 pass 2 (`nhwc_p2_bf16_kernel`, the served route, h in bf16 or
// float32): kernel 1's bf16 pass 2 on K-major tiles. (W2 * gate)^T h +
// s * W2^T h, the sSE logit and Wsk^T x run as mma.sync products on h and x
// as stored (float32 h split in registers into bf16 hi + lo), with the
// packed, fold-time A operands. One block of 8 warps per (64 outputs, 128
// pixels, image), the output blocks of a pixel tile next to each other in
// the grid so that h comes from HBM once and from L2 for the others; h and
// x arrive 32 channels at a time through a 3-stage ring of 3-D TMA boxes
// ([128 pixels][32 channels], 64- or 128-byte swizzle), or by a plain-load
// variant that writes the same layout; the epilogue stages the float32
// tile in shared memory and writes each pixel's outputs as bf16, 16 bytes
// a store.
//
// The float32 path (`nhwc_p1_kernel`, `nhwc_p2_kernel`, float32 x):
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
// What it leaves for later work: wgmma in place of mma.sync in both bf16
// passes, x read once per 64 mid channels in pass 1, a block shape for
// C_out <= 32 (half of pass 2's warps then hold no output), and the
// overlap of one tile's epilogue with the next tile's copies.

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
                 ? xp[(size_t)sy * row]
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
                     ? xp[(size_t)sy * row + c1]
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

// The float32 pass 2. One block per (64 pixels, 64 output channels,
// image); 256 threads. skip: 0 none, 1 identity (cin == cout), 2 conv.
__global__ void __launch_bounds__(kThreads)
    nhwc_p2_kernel(const float* __restrict__ h, const float* __restrict__ x,
                   const float* __restrict__ gate,
                   const float* __restrict__ sse_w,
                   const float* __restrict__ sse_b,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ wsk,
                   const float* __restrict__ bsk, float* __restrict__ out,
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
  const float* hb = h + ((size_t)b * hw + p0) * cm;
  const float* xb = x + ((size_t)b * hw + p0) * cin;
  const float* gb = gate + (size_t)b * cm;

  // sSE: warp w takes pixels 8w..8w+7, its lanes stride over C_mid
  constexpr int kPerWarp = kPix2 / (kThreads / 32);
  for (int i = 0; i < kPerWarp; ++i) {
    const int p = warp * kPerWarp + i;
    float z = 0.f;
    if (p < np)
      for (int c = lane; c < cm; c += 32)
        z = fmaf(sse_w[c], hb[(size_t)p * cm + c], z);
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
            const float hv = hb[(size_t)p * cm + c];
            v = hv * gb[c] + hv * sv[p];
          } else {
            v = xb[(size_t)p * cin + c];
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
    float* op = out + ((size_t)b * hw + p0 + p) * cout;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int co = co0 + tx * 4 + o;
      if (co >= cout) break;
      float v = acc[i][o] + b2[co];
      if (skip == 2) {
        v += accs[i][o] + bsk[co];
      } else if (skip == 1) {
        v += xb[(size_t)p * cin + co];
      }
      op[co] = v;
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

// The activations of the bf16 pass 1 for h of type TH: the fast ones.
// -DDT_NHWC_F32H_ACT_PRECISE builds the precise act() for float32 h
// (kernel 3), a variant for tools/time_passes.py --k3-act-precise: 15-17 %
// slower at the same error, which is the tensor-core expand's (PERF.md).
template <typename TH, int ACT>
__device__ __forceinline__ float act_p1(float v) {
#ifdef DT_NHWC_F32H_ACT_PRECISE
  if constexpr (sizeof(TH) == 4) return act<ACT>(v);
#endif
  return act_fast<ACT>(v);
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
  static constexpr int TERMS = sizeof(TH) == 4 ? 3 : 2;   // W1's bf16 terms (pack_w1)
  static constexpr int WELEMS = tc::kWChunkElems / 2 * TERMS;  // packed W1 a chunk
  static constexpr int WBYTES = WELEMS * 2;
  static constexpr int STAGE = XSLOT + WBYTES;            // x box, then its W chunk
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

// The chunk's expand for h of type TH. bf16 h (kernel 2):
// tc::expand_chunk_kmajor, W1 in two bf16 terms, into acc. Float32 h
// (kernel 3): W1 in three terms (pack_w1(w1, terms=3): hi, lo, lo2, within
// about 2^-24 of W1), and each tile's six products of the chunk (two k16
// steps x three terms) summed in a zeroed temporary that is then added to
// acc in float32: the tensor cores do not round each sum to nearest, so a
// running sum over C_in drifts by ulps of its own size (2.0e-5 in h at the
// flagship shapes, PERF.md), a temporary by ulps of its part. What is left
// (1.0e-5) arises inside one mma. The loops run over pairs of n8 tiles,
// then m16 tiles, then the two k16 steps and the three terms.
template <typename TH, int NTW>
__device__ __forceinline__ void expand_chunk(const __nv_bfloat16* xs, const __nv_bfloat16* ws,
                                             float (*acc)[NTW][4], int wm, int wn, int lane) {
  if constexpr (sizeof(TH) == 2) {
    tc::expand_chunk_kmajor<NTW>(xs, ws, acc, wm, wn, lane);
  } else {
    constexpr int kTerms = 3;
    const uint4* wv = reinterpret_cast<const uint4*>(ws);
    const uint32_t base = tc::smem_u32(xs);
#pragma unroll
    for (int j = 0; j < NTW; j += 2) {
      uint32_t b[2][4];  // [k16 step]: tile j (0, 1), tile j + 1 (2, 3)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        tc::ldsm_kmajor(base, wn * NTW + j, ks, lane, j + 1 < NTW, b[ks]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 2 * kTerms; ++q) {  // k16 step q / kTerms, term q % kTerms
          const uint4 a = wv[(q * 4 + wm * 2 + i) * 32 + lane];
          tc::mma_bf16(t0, a, b[q / kTerms][0], b[q / kTerms][1]);
          if (j + 1 < NTW) tc::mma_bf16(t1, a, b[q / kTerms][2], b[q / kTerms][3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] += t0[e];
          if (j + 1 < NTW) acc[i][j + 1][e] += t1[e];
        }
      }
    }
  }
}

// One thread: chunk c's x box (TMA: channels c*32.., the haloed tile, with
// the out-of-image part zero-filled) and packed W chunk (bulk copy) into
// stage c % kStagesN, completing on that stage's mbarrier.
template <typename L>
__device__ __forceinline__ void issue_nhwc(const CUtensorMap* tmap, unsigned char* ring,
                                           const __nv_bfloat16* wblk, uint64_t* bars, int c,
                                           int x0, int y0, int b) {
  const int s = c % kStagesN;
  unsigned char* st = ring + s * L::STAGE;
  tc::mbar_expect_tx(&bars[s], L::XBYTES + L::WBYTES);
  tc::tma_load_4d(st, tmap, c * tc::kKc, x0, y0, b, &bars[s]);
  tc::bulk_load(st + L::XSLOT, wblk + (size_t)c * L::WELEMS, L::WBYTES, &bars[s]);
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
  const __nv_bfloat16* wblk = wpk + (size_t)mblk * nchunks * L::WELEMS;
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
        expand_chunk<TH, NTW>(reinterpret_cast<const __nv_bfloat16*>(st),
                              reinterpret_cast<const __nv_bfloat16*>(st + L::XSLOT), acc, wm,
                              wn, lane);
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
      const uint4* wsrc = reinterpret_cast<const uint4*>(wblk + (size_t)c * L::WELEMS);
      uint4* wdst = reinterpret_cast<uint4*>(smem + L::XSLOT);
      for (int i = tid; i < L::WBYTES / 16; i += kThreadsNB) wdst[i] = wsrc[i];
      __syncthreads();
      if (warp_live)
        expand_chunk<TH, NTW>(reinterpret_cast<const __nv_bfloat16*>(smem),
                              reinterpret_cast<const __nv_bfloat16*>(wdst), acc, wm, wn, lane);
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
          v.x = (row_in && gx >= 0 && gx < width) ? act_p1<TH, ACT>(acc[i][j][hr * 2] + bias)
                                                  : 0.f;
          v.y = (row_in && gx + 1 >= 0 && gx + 1 < width)
                    ? act_p1<TH, ACT>(acc[i][j][hr * 2 + 1] + bias)
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
      s[j] = inside ? act_p1<TH, ACT>(a + bdws[m]) : 0.f;
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

// ---------------------------------------------------------------------------
// bf16 pass 2: the projection, the sSE logit and the conv skip on the tensor
// cores
// ---------------------------------------------------------------------------
//
// The arithmetic of kernel 1's bf16 pass 2 (fused_ir_chw.cu
// `pass2_bf16_kernel`) on NHWC tensors. With gate g (per image and mid
// channel) and s[p] = sigmoid(z[p] + b_sse), z[p] = sum_c w_sse[c] h[p, c],
// the projection of h*g + h*s is
//   sum_c (W2[c, o] g[c]) h[p, c] + s[p] sum_c W2[c, o] h[p, c],
// so every product takes h as stored for its B operand. The A operands:
// W2^T (`w2_packed`, bf16 hi + lo), (W2 * g)^T, formed by the block per
// chunk from the packed W2 and g and split again into hi + lo, and the sSE
// tile (`sse_packed`: rows 0 and 1 hi and lo of w_sse, so that one product
// gives both halves of z). The conv skip is one more product, Wsk^T
// (`wsk_packed`) against x, summed with the gated one. h and x are K-major
// here: a chunk is [128 pixels][32 channels], a 3-D TMA box of the
// (C, HW, B) tensor, in the 64-byte swizzle for bf16 (the layout
// tc::expand_chunk_kmajor reads: B fragments from ldmatrix without .trans)
// and in the 128-byte swizzle for float32 h (kernel 3). Float32 h is split
// in registers into bf16 hi = bf16(h) and lo = bf16(h - hi), as the weights
// are, and each product sums Whi hhi + Wlo hhi + Whi hlo (the sSE logit
// also the lo rows against hlo): the dropped Wlo hlo and the splits'
// remainders are below 2^-16 of each term, so the sums stay at float32
// level and out is rounded to bf16 once, at the end.

constexpr int kThreadsQ = 256;          // 8 warps: 2 along the outputs x 4 along the pixels
constexpr int kPixQ = 128;              // pixels a block
constexpr int kStagesQ = 3;             // chunks in flight (TMA variant)
constexpr int kSseElemsQ = 2 * 32 * 8;  // a chunk's sSE tiles: [k16 step][lane][8]
constexpr int kSseBytesQ = kSseElemsQ * 2;
constexpr int kOutStrideQ = tc::kCmb + 4;  // floats a pixel of the staged output tile

// Shared-memory plan of the bf16 pass 2 for h of type TH: a ring of stages,
// each the chunk's h or x box, its packed W2 or Wsk chunk and (h steps) its
// sSE tiles; two gated W2 chunks; z of the block's pixels; the barriers.
// The output tile, [128 pixels][64 outputs] float32, overlays the ring.
template <typename TH>
struct P2Tile {
  static constexpr int BOX = kPixQ * tc::kKc * (int)sizeof(TH);  // an h chunk: 8 or 16 KB
  static constexpr int XBOX = kPixQ * tc::kKc * 2;                 // an x chunk: 8 KB
  static constexpr int OFF_W = BOX;
  static constexpr int OFF_S = OFF_W + tc::kWChunkBytes;
  static constexpr int STAGE = OFF_S + kSseBytesQ;  // 17 or 25 KB
  static constexpr int OFF_GATED = kStagesQ * STAGE;
  static constexpr int OFF_Z = OFF_GATED + 2 * tc::kWChunkBytes;
  static constexpr int OFF_BAR = OFF_Z + kPixQ * 4;
  static constexpr int SMEM = OFF_BAR + kStagesQ * 8 + 1024;  // + the ring's 1024-byte alignment
  static_assert(STAGE % 1024 == 0, "stages stay 1024-byte aligned (the swizzles)");
  static_assert(kPixQ * kOutStrideQ * 4 <= kStagesQ * STAGE, "the output tile fits the ring");
};

// One thread: step c's h (c < nh) or x chunk (the box of 32 channels x 128
// pixels from channel cc * 32, pixel p0; pixels past HW and channels past C
// are zero-filled), its packed W2 or Wsk chunk and, for h, its sSE tiles,
// into stage c % kStagesQ, completing on that stage's mbarrier.
template <typename TH>
__device__ __forceinline__ void issue_p2n(const CUtensorMap* hmap, const CUtensorMap* xmap,
                                          unsigned char* ring, uint64_t* bars, int c, int nh,
                                          int p0, int b, const __nv_bfloat16* w2blk,
                                          const __nv_bfloat16* ssep,
                                          const __nv_bfloat16* wskblk) {
  using L = P2Tile<TH>;
  const int s = c % kStagesQ;
  unsigned char* st = ring + s * L::STAGE;
  const bool hstep = c < nh;
  const int cc = hstep ? c : c - nh;
  tc::mbar_expect_tx(&bars[s], (hstep ? L::BOX + kSseBytesQ : L::XBOX) + tc::kWChunkBytes);
  tc::tma_load_3d(st, hstep ? hmap : xmap, cc * tc::kKc, p0, b, &bars[s]);
  tc::bulk_load(st + L::OFF_W, (hstep ? w2blk : wskblk) + (size_t)cc * tc::kWChunkElems,
                tc::kWChunkBytes, &bars[s]);
  if (hstep)
    tc::bulk_load(st + L::OFF_S, ssep + (size_t)c * kSseElemsQ, kSseBytesQ, &bars[s]);
}

// The plain-load staging: channels c0 .. c0 + 31 of pixels p0 .. p0 + 127
// of image b of a (B, HW, nc) tensor, zero past nc and HW, in the layout of
// the TMA box (bf16: 64 bytes a pixel, 64-byte swizzle; float32: 128 bytes
// a pixel, 128-byte swizzle).
__device__ __forceinline__ void stage_bf16(unsigned char* dst, const __nv_bfloat16* src, int c0,
                                           int nc, int p0, int hw, int b, int tid) {
  for (int i = tid; i < kPixQ * tc::kKc; i += kThreadsQ) {
    const int p = i / tc::kKc;
    const int ch = i - p * tc::kKc;
    const bool in = c0 + ch < nc && p0 + p < hw;
    *reinterpret_cast<__nv_bfloat16*>(dst + p * 64 + (((ch >> 3) ^ ((p >> 1) & 3)) << 4) +
                                      (ch & 7) * 2) =
        in ? src[((size_t)b * hw + p0 + p) * nc + c0 + ch] : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void stage_f32(unsigned char* dst, const float* src, int c0, int nc,
                                          int p0, int hw, int b, int tid) {
  for (int i = tid; i < kPixQ * tc::kKc; i += kThreadsQ) {
    const int p = i / tc::kKc;
    const int ch = i - p * tc::kKc;
    const bool in = c0 + ch < nc && p0 + p < hw;
    *reinterpret_cast<float*>(dst + p * 128 + (((ch >> 2) ^ (p & 7)) << 4) + (ch & 3) * 4) =
        in ? src[((size_t)b * hw + p0 + p) * nc + c0 + ch] : 0.f;
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// B fragments of the warp's four n8 tiles (pixels wn * 32 ..) at k16 step
// ks from a K-major bf16 chunk ([128 pixels][32 channels], 64-byte swizzle).
__device__ __forceinline__ void frags_bf16(uint32_t base, int wn, int ks, int lane,
                                           uint32_t (*bf)[2]) {
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    uint32_t r[4];
    tc::ldsm_kmajor(base, wn * 4 + jp * 2, ks, lane, true, r);
    bf[2 * jp][0] = r[0];
    bf[2 * jp][1] = r[1];
    bf[2 * jp + 1][0] = r[2];
    bf[2 * jp + 1][1] = r[3];
  }
}

// The same fragments from a K-major float32 chunk ([128 pixels][32
// channels], 128-byte swizzle: the 16-byte chunk q of pixel p's 128 bytes at
// q ^ (p % 8)), split into bf16 hi (bh) and lo (bl). Lane (g, t) reads
// channels 2t, 2t + 1 and 2t + 8, 2t + 9 of pixel g of each tile, 8 bytes a
// load: the warp's 32 loads fill every bank twice, the least for 256 bytes.
__device__ __forceinline__ void frags_f32(const unsigned char* chunk, int wn, int ks, int lane,
                                          uint32_t (*bh)[2], uint32_t (*bl)[2]) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = wn * 32 + j * 8 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // channels ks * 16 + r * 8 + 2t, + 1
      const int q = ks * 4 + r * 2 + (t >> 1);
      const float2 v = *reinterpret_cast<const float2*>(chunk + p * 128 + ((q ^ (p & 7)) << 4) +
                                                        (t & 1) * 8);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.x, v.y);
      const float2 f = __bfloat1622float2(hi);
      bh[j][r] = bf16x2_bits(hi);
      bl[j][r] = bf16x2_bits(__floats2bfloat162_rn(v.x - f.x, v.y - f.y));
    }
  }
}

// One chunk's products of a warp (tc::pass2_products): m16 tiles wm * 2 + i
// (those holding an output), n8 tiles wn * 4 + j; float32 h (kernel 3) as
// bf16 hi and lo fragments.
template <typename TH>
__device__ __forceinline__ void p2n_chunk(const unsigned char* st, bool hstep, const uint4* gv,
                                          float (*accp)[4][4], float (*accg)[4][4],
                                          float (*accz)[4], int wm, int wn, int lane,
                                          bool live0, bool live1) {
  using L = P2Tile<TH>;
  constexpr bool SPLIT = sizeof(TH) == 4;
  const uint4* wv = reinterpret_cast<const uint4*>(st + L::OFF_W);
  const uint4* sv = reinterpret_cast<const uint4*>(st + L::OFF_S);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t bh[4][2], bl[4][2];
    if (SPLIT && hstep)
      frags_f32(st, wn, ks, lane, bh, bl);
    else
      frags_bf16(tc::smem_u32(st), wn, ks, lane, bh);
    tc::pass2_products<SPLIT>(bh, bl, hstep, ks, wv, gv, sv, accp, accg, accz, wm, lane, live0,
                              live1);
  }
}

// One block of 8 warps per (64 output channels, 128 pixels, image), the
// output block fastest in the grid (blockIdx.x = (b * n_pt + pixel tile) *
// n_ob + output block), so that the blocks that read the same h run side
// by side and all but the first find it in L2. skip: 0 none, 1 identity
// (cin == cout), 2 conv. TMA: h and x by 3-D TMA boxes through a ring of
// kStagesQ stages (C % 8 == 0 and 16-byte aligned tensors, pass2_staging in
// ops/fused_cell.py); else one stage filled by plain loads in the same
// swizzled layout. The epilogue stages the float32 tile [pixel][output] in
// shared memory and writes out = acc_g + s acc_p + b2 (+ bsk) (+ x) as bf16,
// each pixel's outputs in a row, 16 bytes a store where C_out % 8 == 0.
template <typename TH, bool TMA>
__global__ void __launch_bounds__(kThreadsQ, 2)
    nhwc_p2_bf16_kernel(const __grid_constant__ CUtensorMap hmap,
                        const __grid_constant__ CUtensorMap xmap, const TH* __restrict__ h,
                        const __nv_bfloat16* __restrict__ x, const float* __restrict__ gate,
                        const __nv_bfloat16* __restrict__ w2p,
                        const __nv_bfloat16* __restrict__ ssep, const float* __restrict__ sse_b,
                        const float* __restrict__ b2, const __nv_bfloat16* __restrict__ wskp,
                        const float* __restrict__ bsk, __nv_bfloat16* __restrict__ out, int cin,
                        int cm, int cout, int hw, int skip, int n_ob, int n_pt) {
  using L = P2Tile<TH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = tc::align1024(smem_raw);
  uint4* gated = reinterpret_cast<uint4*>(ring + L::OFF_GATED);
  float* zs = reinterpret_cast<float*>(ring + L::OFF_Z);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + L::OFF_BAR);
  float* ot = reinterpret_cast<float*>(ring);  // [kPixQ][kOutStrideQ], after the products

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int ob = blockIdx.x % n_ob;
  const int pt = (blockIdx.x / n_ob) % n_pt;
  const int b = blockIdx.x / n_ob / n_pt;
  const int o0 = ob * tc::kCmb;
  const int p0 = pt * kPixQ;
  const int nh = (cm + tc::kKc - 1) / tc::kKc;
  const int nxc = (cin + tc::kKc - 1) / tc::kKc;
  const int nsteps = nh + (skip == 2 ? nxc : 0);
  const __nv_bfloat16* w2blk = w2p + (size_t)ob * nh * tc::kWChunkElems;
  const __nv_bfloat16* wskblk =
      skip == 2 ? wskp + (size_t)ob * nxc * tc::kWChunkElems : nullptr;
  const float* gb = gate + (size_t)b * cm;
  const bool live0 = o0 + wm * 32 < cout;  // warp-uniform: the m16 tile holds an output
  const bool live1 = o0 + wm * 32 + 16 < cout;
  constexpr int kGatedChunk = tc::kWChunkBytes / 16;  // uint4 a gated chunk

  float accp[2][4][4], accg[2][4][4], accz[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accp[i][j][e] = accg[i][j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) accz[j][e] = 0.f;

  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s < kStagesQ; ++s) tc::mbar_init(&bars[s], 1);
      tc::mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0)
      for (int c = 0; c < kStagesQ && c < nsteps; ++c)
        issue_p2n<TH>(&hmap, &xmap, ring, bars, c, nh, p0, b, w2blk, ssep, wskblk);
    tc::mbar_wait(&bars[0], 0);
    tc::gate_chunk(reinterpret_cast<const uint4*>(ring + L::OFF_W), gated, gb, 0, cm, tid);
    __syncthreads();
    for (int c = 0; c < nsteps; ++c) {
      const unsigned char* st = ring + (c % kStagesQ) * L::STAGE;
      p2n_chunk<TH>(st, c < nh, gated + (c & 1) * kGatedChunk, accp, accg, accz, wm, wn, lane,
                    live0, live1);
      if (c + 1 < nsteps) {  // the next chunk: wait for it, form its gated operand
        const int s1 = (c + 1) % kStagesQ;
        tc::mbar_wait(&bars[s1], ((c + 1) / kStagesQ) & 1);
        if (c + 1 < nh)
          tc::gate_chunk(reinterpret_cast<const uint4*>(ring + s1 * L::STAGE + L::OFF_W),
                         gated + ((c + 1) & 1) * kGatedChunk, gb, c + 1, cm, tid);
      }
      __syncthreads();  // stage c % kStagesQ is consumed; the next gated operand is ready
      if (tid == 0 && c + kStagesQ < nsteps)
        issue_p2n<TH>(&hmap, &xmap, ring, bars, c + kStagesQ, nh, p0, b, w2blk, ssep, wskblk);
    }
  } else {
    for (int c = 0; c < nsteps; ++c) {
      __syncthreads();  // the previous chunk is consumed
      const bool hstep = c < nh;
      const int cc = hstep ? c : c - nh;
      if constexpr (sizeof(TH) == 4) {
        if (hstep)
          stage_f32(ring, h, cc * tc::kKc, cm, p0, hw, b, tid);
        else
          stage_bf16(ring, x, cc * tc::kKc, cin, p0, hw, b, tid);
      } else {
        stage_bf16(ring, hstep ? h : x, cc * tc::kKc, hstep ? cm : cin, p0, hw, b, tid);
      }
      const uint4* wsrc = reinterpret_cast<const uint4*>((hstep ? w2blk : wskblk) +
                                                         (size_t)cc * tc::kWChunkElems);
      uint4* wdst = reinterpret_cast<uint4*>(ring + L::OFF_W);
      for (int i = tid; i < tc::kWChunkBytes / 16; i += kThreadsQ) wdst[i] = wsrc[i];
      if (hstep) {
        const uint4* ssrc = reinterpret_cast<const uint4*>(ssep + (size_t)c * kSseElemsQ);
        uint4* sdst = reinterpret_cast<uint4*>(ring + L::OFF_S);
        for (int i = tid; i < kSseBytesQ / 16; i += kThreadsQ) sdst[i] = ssrc[i];
      }
      __syncthreads();
      if (hstep) {
        tc::gate_chunk(wdst, gated, gb, c, cm, tid);
        __syncthreads();
      }
      p2n_chunk<TH>(ring, hstep, gated, accp, accg, accz, wm, wn, lane, live0, live1);
    }
  }

  // z of the warp's n8 tiles 2 wm, 2 wm + 1: row 0 (hi) + row 1 (lo) of the
  // sSE product, in lanes 0-3 and 4-7
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const float v0 = accz[jj][0] + __shfl_down_sync(0xffffffffu, accz[jj][0], 4);
    const float v1 = accz[jj][1] + __shfl_down_sync(0xffffffffu, accz[jj][1], 4);
    if (lane < 4) {
      const int n = wn * 32 + (wm * 2 + jj) * 8 + 2 * lane;
      zs[n] = v0;
      zs[n + 1] = v1;
    }
  }
  __syncthreads();  // z is complete; the ring is no longer read: the output tile overlays it

  // the C fragments into the tile [pixel][output]: with 68 floats a pixel
  // the warp's 32 stores of one register hit 32 banks
  const int g = lane >> 2;
  const int t = lane & 3;
  const float sb = sse_b[0];
  float sv[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      sv[j][e] = 1.f / (1.f + expf(-(zs[wn * 32 + j * 8 + 2 * t + e] + sb)));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!(i ? live1 : live0)) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int o = (wm * 2 + i) * 16 + hr * 8 + g;
      if (o0 + o >= cout) continue;
      const float bias = b2[o0 + o] + (skip == 2 ? bsk[o0 + o] : 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ot[(n + e) * kOutStrideQ + o] =
              accg[i][j][hr * 2 + e] + sv[j][e] * accp[i][j][hr * 2 + e] + bias;
      }
    }
  }
  __syncthreads();

  // each pixel's outputs in a row, with the identity skip added in float32
  const int rows = min(tc::kCmb, cout - o0);
  const int np = min(kPixQ, hw - p0);
  __nv_bfloat16* ob_ = out + ((size_t)b * hw + p0) * cout + o0;
  const __nv_bfloat16* xb = x + ((size_t)b * hw + p0) * cin + o0;  // identity: cin == cout
  if (cout % 8 == 0 && (skip != 1 || TMA)) {
    // 8 outputs (16 bytes) a store; lanes 8k .. 8k + 7 take 8 pixels of one
    // group of 8 outputs, so their 16-byte reads of the tile hit 32 banks
    for (int i = tid; i < kPixQ * (tc::kCmb / 8); i += kThreadsQ) {
      const int q = (i >> 3) & 7;
      const int p = (i & 7) + ((i >> 6) << 3);
      if (q * 8 >= rows || p >= np) continue;
      const float4 u0 = *reinterpret_cast<const float4*>(&ot[p * kOutStrideQ + q * 8]);
      const float4 u1 = *reinterpret_cast<const float4*>(&ot[p * kOutStrideQ + q * 8 + 4]);
      float v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      if (skip == 1) {  // TMA: C_in % 8 == 0 and x 16-byte aligned
        const uint4 xv = *reinterpret_cast<const uint4*>(xb + (size_t)p * cin + q * 8);
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(x2[k]);
          v[2 * k] += f.x;
          v[2 * k + 1] += f.y;
        }
      }
      uint4 pk;
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
      for (int k = 0; k < 4; ++k) p2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      *reinterpret_cast<uint4*>(ob_ + (size_t)p * cout + q * 8) = pk;
    }
  } else {
    for (int i = tid; i < kPixQ * tc::kCmb; i += kThreadsQ) {
      const int p = i / tc::kCmb;
      const int o = i - p * tc::kCmb;
      if (o >= rows || p >= np) continue;
      float v = ot[p * kOutStrideQ + o];
      if (skip == 1) v += __bfloat162float(xb[(size_t)p * cin + o]);
      ob_[(size_t)p * cout + o] = __float2bfloat16(v);
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

int launch_pass2(const void* h, const void* x, const void* gate,
                 const void* sse_w, const void* sse_b, const void* w2,
                 const void* b2, const void* wsk, const void* bsk, void* out,
                 int batch, int cin, int cm, int cout, int hw, int skip,
                 cudaStream_t stream) {
  const dim3 grid((hw + kPix2 - 1) / kPix2, (cout + kCo2 - 1) / kCo2, batch);
  nhwc_p2_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(x),
      static_cast<const float*>(gate), static_cast<const float*>(sse_w),
      static_cast<const float*>(sse_b), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wsk),
      static_cast<const float*>(bsk), static_cast<float*>(out), cin, cm, cout, hw,
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


// a 3-D tensor map of a (B, HW, C) tensor of bf16 or float32, innermost
// first: boxes of 32 channels x 128 pixels, in the 64-byte (bf16) or
// 128-byte (float32) swizzle, so that a box's pixel row is one swizzle span
template <typename T>
int encode_nhwc_boxes(CUtensorMap* map, const void* base, int hw, int c, int batch) {
  const tc::EncodeTiledFn encode = tc::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  constexpr bool f32 = sizeof(T) == 4;
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)hw, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)c * sizeof(T), (cuuint64_t)hw * c * sizeof(T)};
  const cuuint32_t box[3] = {tc::kKc, kPixQ, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
      const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      f32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename TH, bool TMA>
int launch_pass2_bf16(const void* h, const void* x, const void* gate, const void* ssep,
                      const void* sse_b, const void* w2p, const void* b2, const void* wskp,
                      const void* bsk, void* out, int batch, int cin, int cm, int cout, int hw,
                      int skip, cudaStream_t stream) {
  using L = P2Tile<TH>;
  static bool smem_allowed = false;  // once per instantiation
  if (!smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        nhwc_p2_bf16_kernel<TH, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = true;
  }
  CUtensorMap hmap, xmap;
  memset(&hmap, 0, sizeof(hmap));
  memset(&xmap, 0, sizeof(xmap));
  if constexpr (TMA) {
    int r = encode_nhwc_boxes<TH>(&hmap, h, hw, cm, batch);
    if (r == 0 && skip == 2) r = encode_nhwc_boxes<__nv_bfloat16>(&xmap, x, hw, cin, batch);
    if (r != 0) return r;
  }
  const int n_ob = (cout + tc::kCmb - 1) / tc::kCmb;
  const int n_pt = (hw + kPixQ - 1) / kPixQ;
  const long long blocks = (long long)n_ob * n_pt * batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  nhwc_p2_bf16_kernel<TH, TMA><<<(unsigned)blocks, kThreadsQ, L::SMEM, stream>>>(
      hmap, xmap, static_cast<const TH*>(h), static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(gate), static_cast<const __nv_bfloat16*>(w2p),
      static_cast<const __nv_bfloat16*>(ssep), static_cast<const float*>(sse_b),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(wskp),
      static_cast<const float*>(bsk), static_cast<__nv_bfloat16*>(out), cin, cm, cout, hw, skip,
      n_ob, n_pt);
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
// bfloat16 x reads w1_packed (ops/fused_mbconv.py `pack_w1`: two bf16
// terms for bf16 h, three (terms=3) for float32 h; 16-byte aligned) and
// with tma != 0 stages x by TMA (needs C_in % 8 == 0 and x 16-byte
// aligned), else by plain loads. Returns cudaGetLastError()
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
// float32 x (with float32 h) reads w2, sse_w and wsk; bfloat16 x (h bf16,
// kernel 2, or float32, kernel 3) reads their bf16 hi + lo splits in the
// product's order (ops/fused_mbconv.py `pack_w1` of w2 and wsk, `pack_sse`;
// 16-byte aligned) and with tma != 0 stages h and x by TMA (needs C_mid %
// 8 == 0 and h 16-byte aligned, and unless skip == 0 C_in % 8 == 0 and x
// 16-byte aligned), else by plain loads. Returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments it cannot take).
int fused_ir_nhwc_pass2(const void* h, const void* x, const void* gate,
                        const void* sse_w, const void* sse_b, const void* w2,
                        const void* b2, const void* wsk, const void* bsk,
                        const void* w2_packed, const void* sse_packed,
                        const void* wsk_packed, void* out, int batch, int cin, int cm,
                        int cout, int hw, int skip, int x_bf16, int h_bf16, int tma,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  if (skip < 0 || skip > 2 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (!x_bf16) {
    if (h_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return launch_pass2(h, x, gate, sse_w, sse_b, w2, b2, wsk, bsk, out, batch, cin, cm, cout,
                        hw, skip, s);
  }
  auto misaligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 != 0; };
  if (w2_packed == nullptr || sse_packed == nullptr || misaligned(w2_packed) ||
      misaligned(sse_packed) || (skip == 2 && (wsk_packed == nullptr || misaligned(wsk_packed))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tma && (cm % 8 != 0 || misaligned(h) || (skip != 0 && (cin % 8 != 0 || misaligned(x)))))
    return static_cast<int>(cudaErrorInvalidValue);
#define DT_PASS2(TH, TMA)                                                                   \
  return launch_pass2_bf16<TH, TMA>(h, x, gate, sse_packed, sse_b, w2_packed, b2, wsk_packed, \
                                    bsk, out, batch, cin, cm, cout, hw, skip, s)
  if (h_bf16) {
    if (tma) DT_PASS2(bf, true);
    DT_PASS2(bf, false);
  }
  if (tma) DT_PASS2(float, true);
  DT_PASS2(float, false);
#undef DT_PASS2
}

}  // extern "C"
