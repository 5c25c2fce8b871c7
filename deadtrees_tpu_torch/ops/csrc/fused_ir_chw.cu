// Fused, BN-folded inverted-residual block on NCHW tensors: two CUDA
// kernels for Hopper (sm_90a), with a plain C interface loaded by ctypes
// (deadtrees_tpu_torch/ops/_build.py, wrapper in ops/fused_mbconv.py).
//
// Replaces the TPU kernel deadtrees_tpu/ops/fused_mbconv.py
// `fused_inverted_residual_chw` (Pallas `_chw_pass1_kernel` and
// `_chw_pass2_kernel`). What the block computes, per image:
//
//   pass 1:  y = act(W1 x + b1), zero at every pixel outside the image
//            h = act(dw_kxk(y) + b_dw)            stored in x's dtype
//            psum[tile, c] = sum of the float32 h over the tile's pixels
//   (torch, between the passes: gate = sigmoid(Wc2 relu(Wc1 mean h + bc1) + bc2))
//   pass 2:  s = sigmoid(w_sse . h + b_sse)        h as stored
//            out = W2 (h*gate + h*s) + b2 + skip   skip: Wsk x + bsk, x, or 0
//
// What bounds it on this card: the 1x1 convolutions. At the flagship's
// decoder shapes the block does 2*C^2 to 4*C^2 FLOPs per pixel for about
// 4*C*2 bytes of traffic per pixel (bf16), so with C from 16 to 688 it is
// bound by operations whenever it runs on the CUDA cores (67 TFLOP/s f32),
// and by bytes only for the thin 512^2 cells; with the products on the
// tensor cores (989 TFLOP/s bf16) both bf16 passes are bound by bytes.
//
// bf16 pass 1 (`pass1_bf16_kernel`, the served route): the 1x1 expand runs
// on the tensor cores (tc_expand.cuh: mma.sync bf16 with float32
// accumulation, W1 split into bf16 hi + lo at fold time, so the product
// keeps float32 accuracy). One block of 16 warps per (8 x 32 output tile, 64
// mid channels, image). The haloed x tile (8 + 2P rows x 48 columns: a TMA
// box must start at a multiple of 16 bytes in its inner dimension, so it
// starts 8 columns left of the tile and covers the P + 32 + P columns the
// conv reads) comes in chunks of 32 channels through a 3-stage ring: one
// thread issues a 4-D TMA load of the CHW tensor (signed origin; the out-of-
// image part is zero-filled) and a bulk copy of the chunk's packed weights,
// completing on the stage's mbarrier, while the warps run the product on the
// chunks that have arrived. TMA needs W % 8 == 0 (16-byte row strides) and a
// 16-byte aligned x; other shapes take the same kernel with a plain-load
// staging variant (one stage, loads by all threads), chosen by template.
// Then y = act(acc + b1), zero at every row and column outside the image,
// goes to shared memory as float32 (over the emptied ring), the depthwise
// conv runs one output pixel and half of the channels a thread (activations
// with the fast multiply, exponential and divide), h is rounded to bf16 into
// a shared tile and written in whole 32-pixel rows with 16-byte stores, and
// the cSE partial sums keep the float32 path's fixed order.
//
// bf16 pass 2 (`pass2_bf16_kernel`, the served route): every product runs
// on the tensor cores with h, as stored, for the B operand. The mix
// W2^T (h*gate + h*s) becomes (W2*gate)^T h + s * W2^T h, so the A operands
// are W2^T (split into bf16 hi + lo at fold time), (W2*gate)^T (formed by
// the block per chunk from the packed W2 and the image's gate, split again
// into hi + lo) and the sSE tile (hi and lo of w_sse as rows 0 and 1 of one
// m16 tile, so one product gives the logit); the conv skip Wsk^T x adds
// into the gated sums. One block of 8 warps per (128 pixels, 64 output
// channels, image): h, then x for the conv skip, arrive 32 channels at a
// time through a 3-stage ring, each chunk two 3-D TMA boxes of 64 pixels in
// the 128-byte swizzle (conflict-free ldmatrix.trans) plus bulk copies of
// the chunk's packed weights; HW % 8 != 0 or a misaligned h or x takes the
// same kernel with a plain-load staging variant. The epilogue computes
// out = acc_g + sigmoid(z + b_sse) acc_p + b2 + skip in float32 and writes
// rows of the tile with 16-byte stores.
//
// The float32 path (`pass1_kernel`, `pass2_kernel`, float32 x): every
// multiply-add runs in float32 on the CUDA cores, from shared-memory
// tiles. Pass 1 takes one block per (output tile, 64 or 32 mid channels,
// image); the output tile is 14x14 (k=3) or 12x12 (k=5), so that its
// haloed tile is 16x16 pixels, one a thread.
// It runs the expand as a register-tiled GEMM over the haloed pixels
// (Cin in steps of 16, the next step fetched into registers while the
// current one is summed: Cin reaches 688), writes y for the haloed tile
// to shared memory and runs the depthwise conv from there. The partial
// sums are written per tile and channel to a buffer (no atomics, so runs
// repeat exactly). Pass 2 takes one block per (128 pixels, 32 output
// channels, image).
//
// What it leaves for later work: wgmma in place of mma.sync in both bf16
// passes (a warpgroup product from shared memory, the card's full tensor
// rate), the halo recompute of pass 1 (the bf16 expand covers 512 (k = 3)
// or 576 (k = 5) pixels a channel for an 8 x 32 output tile, of which the
// conv reads 340 or 432: the 16-byte box origin stages 16 columns where 2P
// would do, and the pixels are padded to whole n8 tiles of the 8 warps),
// x read once per 64 mid channels in pass 1, pass 2's latency at the thin
// 256^2 and 512^2 cells (one or two chunks a block, no overlap of one
// tile's epilogue with the next tile's copies), and the launch count per
// block (two kernels plus the small gate ops, 22 times per forward).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

#include "tc_expand.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;               // pass 1 haloed tile side
constexpr int kSide2 = kSide * kSide;   // haloed pixels: one per thread
constexpr int kRound = 32;              // pass-1 channels per y/depthwise round
constexpr int kKc = 16;                 // input channels staged per step
constexpr int kPix2 = 128;     // pass-2 pixels per block
constexpr int kCoTile = 32;    // pass-2 output channels per block
constexpr int kCChunk2 = 32;   // pass-2 reduction chunk
constexpr int kPer = kCoTile / (kThreads / kPix2);  // outputs per thread
static_assert(kSide2 == kThreads, "pass 1 stages one haloed pixel a thread");

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// 0: hard swish x * relu6(x + 3) / 6; 1: silu x * sigmoid(x)
template <int ACT>
__device__ __forceinline__ float act(float v) {
  if (ACT == 0) return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) / 6.f;
  return v / (1.f + expf(-v));
}

// Pass 1. One block per (output tile, CMB mid channels, image), CMB 32 or
// 64. The output tile is (16 - 2P)^2 pixels, so its haloed tile is 16 x 16:
// one pixel a thread while staging x. The expand is a small GEMM over the
// 256 haloed pixels: warp w owns mid channels w*CPT..w*CPT+CPT-1 (CPT =
// CMB / 8), lane l the pixels 4l..4l+3 and 128+4l..128+4l+3, so each step
// of the reduction is 2 + CPT/4 16-byte shared loads for 8*CPT FMAs. The
// next 16 input channels are fetched into registers while the current ones
// are summed. y and the depthwise conv then go 32 channels at a time
// through the same shared buffer.
template <typename T, int K, int ACT, int CMB>
__global__ void __launch_bounds__(kThreads, 2)
    pass1_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ dw,
                 const float* __restrict__ bdw, T* __restrict__ h,
                 float* __restrict__ psum, int cin, int cm, int height,
                 int width, int tiles_w) {
  constexpr int P = K / 2;
  constexpr int OT = kSide - 2 * P;      // output tile side: 14 (k=3), 12 (k=5)
  constexpr int CPT = CMB / 8;           // mid channels a thread (and a warp)
  constexpr int WPT = kKc * CMB / kThreads;  // expand weights staged a thread
  static_assert(CMB == 32 || CMB == 64, "32 or 64 mid channels a block");

  // xs [kKc][256] during the expand, then ys [32][256] per round
  __shared__ __align__(16) float buf[kRound * kSide2];
  __shared__ __align__(16) float ws[kKc][CMB];
  __shared__ float dws[CMB][K * K];
  __shared__ float red[kThreads / 32][kRound];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_w) * OT - P;  // haloed tile origin
  const int x0 = (tile % tiles_w) * OT - P;
  const int m0 = blockIdx.y * CMB;
  const int b = blockIdx.z;
  const size_t plane = (size_t)height * width;

  // staging: thread tid fetches haloed pixel tid of 16 channels a step,
  // and WPT of the 16 x CMB expand weights
  const int sy = y0 + tid / kSide;
  const int sx = x0 + tid % kSide;
  const bool s_in = sy >= 0 && sy < height && sx >= 0 && sx < width;
  const T* xp = x + (size_t)b * cin * plane +
                (s_in ? (size_t)sy * width + sx : 0);
  const int wm = tid % CMB;
  const bool wm_ok = m0 + wm < cm;

  float pre[kKc];
  float wpre[WPT];
#pragma unroll
  for (int k = 0; k < kKc; ++k)
    pre[k] = (s_in && k < cin) ? to_f32(xp[(size_t)k * plane]) : 0.f;
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

  // expand: acc = sum_c x[c, pixel] W1[c, m0 + channel]
  for (int c0 = 0; c0 < cin; c0 += kKc) {
    __syncthreads();  // the previous step is done reading xs and ws
#pragma unroll
    for (int k = 0; k < kKc; ++k) buf[k * kSide2 + tid] = pre[k];
#pragma unroll
    for (int r = 0; r < WPT; ++r) ws[(tid + r * kThreads) / CMB][wm] = wpre[r];
    __syncthreads();
    const int c1 = c0 + kKc;
    if (c1 < cin) {  // fetch the next step while this one is summed
#pragma unroll
      for (int k = 0; k < kKc; ++k)
        pre[k] = (s_in && c1 + k < cin) ? to_f32(xp[(size_t)(c1 + k) * plane])
                                        : 0.f;
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
        const float4 w = *reinterpret_cast<const float4*>(&ws[k][warp * CPT + j]);
        wv[j] = w.x;
        wv[j + 1] = w.y;
        wv[j + 2] = w.z;
        wv[j + 3] = w.w;
      }
      const float4 v0 =
          *reinterpret_cast<const float4*>(&buf[k * kSide2 + lane * 4]);
      const float4 v1 =
          *reinterpret_cast<const float4*>(&buf[k * kSide2 + 128 + lane * 4]);
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
    dws[m][j] = (m0 + m < cm) ? dw[(size_t)j * cm + m0 + m] : 0.f;
  }

  const bool active = tid < OT * OT;  // this thread's output pixel
  const int oy = tid / OT;
  const int ox = tid % OT;
  const int gy = y0 + P + oy;
  const int gx = x0 + P + ox;
  const bool inside = active && gy < height && gx < width;
  T* hb = h + (size_t)b * cm * plane + (inside ? (size_t)gy * width + gx : 0);

  for (int r0 = 0; r0 < CMB; r0 += kRound) {
    __syncthreads();  // xs, or the previous round's ys, is no longer read
    // y = act(expand + b1), zero outside the image (rows AND columns): the
    // depthwise conv's zero padding applies to y, not to x, so a halo
    // pixel must not carry act(b1)
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
            a = fmaf(yq[dy * kSide + dx], dws[m][dy * K + dx], a);
      }
      const bool live = inside && m0 + m < cm;
      const float hv = live ? act<ACT>(a + bdw[m0 + m]) : 0.f;
      if (live) hb[(size_t)(m0 + m) * plane] = from_f32<T>(hv);
      float s = hv;  // the float32 h, before rounding to x's dtype
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp][ml] = s;
    }
    __syncthreads();
    if (tid < kRound && m0 + r0 + tid < cm) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += red[w][tid];  // fixed order
      psum[((size_t)b * gridDim.x + tile) * cm + m0 + r0 + tid] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 pass 1: the expand on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kThreadsB = 512;  // bf16 pass-1 threads a block: 16 warps
constexpr int kOtH = 8;         // bf16 pass-1 output tile rows
constexpr int kOtW = 32;        // and columns
constexpr int kPixB = kOtH * kOtW;  // output pixels a tile
constexpr int kXOff = 8;    // columns staged left of the tile: a TMA box starts
                            // at a multiple of 16 bytes in its inner dimension
constexpr int kBoxW = 48;   // staged columns: kXOff + kOtW + kXOff >= P + 32 + P
constexpr int kStages = 3;  // chunks in flight (TMA variant)
constexpr int kHalves = kThreadsB / kPixB;  // the depthwise conv splits the channels
static_assert(tc::kCmb % (kHalves * 8) == 0, "whole groups of 8 channels a half");

// The hard swish and silu of the bf16 pass 1: the same functions with a
// multiply by 1/6 and the fast exponential and divide, a few ulp from
// act() (h is rounded to bf16 after them).
template <int ACT>
__device__ __forceinline__ float act_fast(float v) {
  if (ACT == 0) return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) * (1.f / 6.f);
  return __fdividef(v, 1.f + __expf(-v));
}

// Shared-memory plan of the bf16 pass 1 for a k x k depthwise conv. The
// ring of x and W chunks is overlaid, once the product is done, by y.
template <int K>
struct Bf16Tile {
  static constexpr int P = K / 2;
  static constexpr int HH = kOtH + 2 * P;         // staged rows
  static constexpr int NPIX = HH * kBoxW;         // staged pixels a channel
  static constexpr int NT = (NPIX + 7) / 8;       // n8 tiles
  static constexpr int NTW = (NT + 7) / 8;        // n8 tiles a warp (8 warps along N)
  static constexpr int NPAD = NTW * 8 * 8;        // pixels the product covers
  static constexpr int XBYTES = tc::kKc * NPIX * 2;  // one chunk of x (a TMA box)
  static constexpr int YS = NPAD + 8;             // y row stride in floats (bank spread)
  static constexpr int RING = kStages * (XBYTES + tc::kWChunkBytes);
  static constexpr int YBYTES = tc::kCmb * YS * 4;
  static constexpr int U = RING > YBYTES ? RING : YBYTES;
  static constexpr int OFF_HS = (U + 127) / 128 * 128;  // h tile, bf16 [64][8 x 32]
  static constexpr int OFF_DWS = OFF_HS + tc::kCmb * kPixB * 2;
  static constexpr int OFF_B1 = OFF_DWS + tc::kCmb * K * K * 4;
  static constexpr int OFF_BDW = OFF_B1 + tc::kCmb * 4;
  static constexpr int OFF_RED = OFF_BDW + tc::kCmb * 4;
  static constexpr int OFF_BAR = OFF_RED + (kThreadsB / 32) * tc::kCmb * 4;
  static constexpr int SMEM = OFF_BAR + kStages * 8;
  static_assert(XBYTES % 128 == 0, "TMA destinations are 128-byte aligned");
  static_assert(NPIX * 2 % 16 == 0, "ldmatrix rows are 16-byte aligned");
  // the product reads NPAD pixels of a channel: past the last channel of
  // the last stage it reads into the W ring, never past the allocation
  static_assert((NPAD - NPIX) * 2 <= kStages * tc::kWChunkBytes, "padding stays in smem");
};

// The phase clock of the bf16 pass 1, compiled in only with
// -DDT_PASS1_PROBE (tools/probe_pass1.py): thread 0 of each block reads
// clock64() at the start and after each phase, and adds the cycles it
// waited on the chunks' mbarriers; the block writes kProbeSlots numbers to
// g_pass1_probe[block]. Without the macro nothing of it is compiled.
#ifdef DT_PASS1_PROBE
constexpr int kProbeSlots = 5;  // stage + expand, y write, depthwise + psum, h store, x waits
__device__ long long* g_pass1_probe = nullptr;
#endif

// One thread: chunk c's x box (TMA) and packed W chunk (bulk copy) into
// stage c % kStages, completing on that stage's mbarrier.
template <typename L>
__device__ __forceinline__ void issue_chunk(const CUtensorMap* tmap, __nv_bfloat16* xring,
                                            __nv_bfloat16* wring,
                                            const __nv_bfloat16* wblk, uint64_t* bars,
                                            int c, int x0, int y0, int b) {
  const int s = c % kStages;
  tc::mbar_expect_tx(&bars[s], L::XBYTES + tc::kWChunkBytes);
  tc::tma_load_4d(xring + s * (L::XBYTES / 2), tmap, x0, y0, c * tc::kKc, b, &bars[s]);
  tc::bulk_load(wring + s * tc::kWChunkElems, wblk + (size_t)c * tc::kWChunkElems,
                tc::kWChunkBytes, &bars[s]);
}

// One block of 16 warps per (8 x 32 output tile, 64 mid channels, image).
// Warp w owns m16 tiles (w / 8) * 2 + {0, 1} and n8 tiles (w % 8) * NTW + j
// of the product; a warp whose m16 tiles all lie past C_mid skips it. The
// depthwise conv takes one output pixel and half of the channels a thread.
// TMA: the ring of chunks fed by TMA and bulk copies (W % 8 == 0, x
// 16-byte aligned); else one stage filled by plain loads.
template <int K, int ACT, bool TMA>
__global__ void __launch_bounds__(kThreadsB, 1)
    pass1_bf16_kernel(const __grid_constant__ CUtensorMap tmap,
                      const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wpk,
                      const float* __restrict__ b1, const float* __restrict__ dw,
                      const float* __restrict__ bdw, __nv_bfloat16* __restrict__ h,
                      float* __restrict__ psum, int cin, int cm, int height,
                      int width, int tiles_w) {
  using L = Bf16Tile<K>;
  constexpr int P = L::P;
  constexpr int NTW = L::NTW;
  constexpr int CMB = tc::kCmb;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wring = reinterpret_cast<__nv_bfloat16*>(smem + kStages * L::XBYTES);
  float* ys = reinterpret_cast<float*>(smem);  // [CMB][YS], after the product
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_HS);
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
  const int oy0 = (tile / tiles_w) * kOtH;
  const int ox0 = (tile % tiles_w) * kOtW;
  const int y0 = oy0 - P;  // staged tile origin
  const int x0 = ox0 - kXOff;
  const int mblk = blockIdx.y;
  const int m0 = mblk * CMB;
  const int b = blockIdx.z;
  const int nchunks = (cin + tc::kKc - 1) / tc::kKc;
  const __nv_bfloat16* wblk = wpk + (size_t)mblk * nchunks * tc::kWChunkElems;
  const size_t plane = (size_t)height * width;
  const bool warp_live = m0 + wm * 32 < cm;  // warp-uniform: its m16 tiles hold a channel
#ifdef DT_PASS1_PROBE
  long long stamp[kProbeSlots] = {};
  long long waited = 0;
  if (tid == 0) stamp[0] = clock64();
#endif

  for (int i = tid; i < CMB * K * K; i += kThreadsB) {
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
      for (int s = 0; s < kStages; ++s) tc::mbar_init(&bars[s], 1);
      tc::mbar_fence_init();
    }
    __syncthreads();
    // thread 0 issues chunk c's x box and W chunk into stage c % kStages
    if (tid == 0)
      for (int c = 0; c < kStages && c < nchunks; ++c)
        issue_chunk<L>(&tmap, xring, wring, wblk, bars, c, x0, y0, b);
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % kStages;
#ifdef DT_PASS1_PROBE
      const long long w0 = clock64();
#endif
      tc::mbar_wait(&bars[s], (c / kStages) & 1);
#ifdef DT_PASS1_PROBE
      if (tid == 0) waited += clock64() - w0;
#endif
      if (warp_live)
        tc::expand_chunk<NTW>(xring + s * (L::XBYTES / 2), L::NPIX,
                              wring + s * tc::kWChunkElems, acc, wm, wn, lane);
      __syncthreads();  // every warp is done with stage s
      if (tid == 0 && c + kStages < nchunks)
        issue_chunk<L>(&tmap, xring, wring, wblk, bars, c + kStages, x0, y0, b);
    }
  } else {
    for (int c = 0; c < nchunks; ++c) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < tc::kKc * L::NPIX; i += kThreadsB) {
        const int ch = i / L::NPIX;
        const int p = i - ch * L::NPIX;
        const int py = p / kBoxW;
        const int gy = y0 + py;
        const int gx = x0 + p - py * kBoxW;
        const int gc = c * tc::kKc + ch;
        const bool in = gc < cin && gy >= 0 && gy < height && gx >= 0 && gx < width;
        xring[i] = in ? x[((size_t)b * cin + gc) * plane + (size_t)gy * width + gx]
                      : __float2bfloat16(0.f);
      }
      const uint4* wsrc = reinterpret_cast<const uint4*>(wblk + (size_t)c * tc::kWChunkElems);
      uint4* wdst = reinterpret_cast<uint4*>(wring);
      for (int i = tid; i < tc::kWChunkBytes / 16; i += kThreadsB) wdst[i] = wsrc[i];
      __syncthreads();
      if (warp_live) tc::expand_chunk<NTW>(xring, L::NPIX, wring, acc, wm, wn, lane);
    }
  }
  __syncthreads();  // the ring is no longer read: y overlays it
#ifdef DT_PASS1_PROBE
  if (tid == 0) stamp[1] = clock64();
#endif

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
          const int py = n / kBoxW;
          const int gy = y0 + py;
          const int gx = x0 + n - py * kBoxW;
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
#ifdef DT_PASS1_PROBE
  if (tid == 0) stamp[2] = clock64();
#endif

  // depthwise k x k: thread tid takes output pixel tid % 256 and the
  // channels of half tid / 256, kGroup at once, so that their tap chains
  // and shuffle trees interleave; each channel's sums keep their order
  // (taps row-major, then the warp's shuffle tree). Channels past mcount
  // (y and weights zero) are computed and never read.
  const int pix = tid % kPixB;
  const int half = tid / kPixB;
  const int oy = pix / kOtW;
  const int ox = pix % kOtW;
  const bool inside = oy0 + oy < height && ox0 + ox < width;
  const int mcount = min(CMB, cm - m0);
  constexpr int kGroup = 8;
  constexpr int kPerHalf = CMB / kHalves;
  for (int mg = half * kPerHalf; mg < min(mcount, (half + 1) * kPerHalf); mg += kGroup) {
    float s[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int m = mg + j;
      const float* yq = ys + m * L::YS + oy * kBoxW + ox + kXOff - P;
      float a = 0.f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          a = fmaf(yq[dy * kBoxW + dx], dws[m * K * K + dy * K + dx], a);
      const float hv = inside ? act_fast<ACT>(a + bdws[m]) : 0.f;
      hs[m * kPixB + pix] = __float2bfloat16(hv);
      s[j] = hv;  // the float32 h, before rounding to bf16
    }
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
    const int w0 = (tid / kPerHalf) * (kPixB / 32);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kPixB / 32; ++w) s += red[(w0 + w) * CMB + tid];
    psum[((size_t)b * gridDim.x + tile) * cm + m0 + tid] = s;
  }
#ifdef DT_PASS1_PROBE
  if (tid == 0) stamp[3] = clock64();
#endif

  // h in whole tile rows
  __nv_bfloat16* hb = h + ((size_t)b * cm + m0) * plane;
  if constexpr (TMA) {
    // W % 8 == 0: a run of 8 pixels (16 bytes) is all inside or all outside
    constexpr int kRuns = kOtW / 8;  // 16-byte runs a tile row
    for (int i = tid; i < mcount * kOtH * kRuns; i += kThreadsB) {
      const int m = i / (kOtH * kRuns);
      const int r = (i / kRuns) % kOtH;
      const int q = i % kRuns;
      const int ry = oy0 + r;
      const int rx = ox0 + q * 8;
      if (ry < height && rx < width)
        *reinterpret_cast<uint4*>(hb + (size_t)m * plane + (size_t)ry * width + rx) =
            *reinterpret_cast<const uint4*>(hs + m * kPixB + r * kOtW + q * 8);
    }
  } else {
    for (int i = tid; i < mcount * kPixB; i += kThreadsB) {
      const int m = i / kPixB;
      const int p = i - m * kPixB;
      const int ry = oy0 + p / kOtW;
      const int rx = ox0 + p % kOtW;
      if (ry < height && rx < width) hb[(size_t)m * plane + (size_t)ry * width + rx] = hs[i];
    }
  }
#ifdef DT_PASS1_PROBE
  __syncthreads();  // every thread's h stores are issued
  if (tid == 0 && g_pass1_probe != nullptr) {
    stamp[4] = clock64();
    long long* out =
        g_pass1_probe + (((size_t)b * gridDim.y + mblk) * gridDim.x + tile) * kProbeSlots;
    for (int i = 0; i < 4; ++i) out[i] = stamp[i + 1] - stamp[i];
    out[4] = waited;
  }
#endif
}

// The float32 pass 2. skip: 0 none, 1 identity (cin == cout), 2 conv
__global__ void __launch_bounds__(kThreads)
    pass2_kernel(const float* __restrict__ h, const float* __restrict__ x,
                 const float* __restrict__ gate,
                 const float* __restrict__ sse_w,
                 const float* __restrict__ sse_b,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ wsk,
                 const float* __restrict__ bsk, float* __restrict__ out, int cin,
                 int cm, int cout, int hw, int skip) {
  __shared__ float vs[kCChunk2][kPix2];
  __shared__ float ws[kCoTile][kCChunk2 + 1];
  __shared__ float part[kThreads / kPix2][kPix2];

  const int tid = threadIdx.x;
  const int pix = tid % kPix2;
  const int grp = tid / kPix2;  // which half of the output channels
  constexpr int kGroups = kThreads / kPix2;
  const int p = blockIdx.x * kPix2 + pix;
  const bool valid = p < hw;
  const int co0 = blockIdx.y * kCoTile;
  const int b = blockIdx.z;
  const float* hb = h + (size_t)b * cm * hw + p;
  const float* xb = x + (size_t)b * cin * hw + p;
  const float* gb = gate + (size_t)b * cm;

  // sSE logit: the thread groups split the channels, summed in fixed order
  float z = 0.f;
  if (valid)
    for (int c = grp; c < cm; c += kGroups)
      z = fmaf(sse_w[c], hb[(size_t)c * hw], z);
  part[grp][pix] = z;
  __syncthreads();
  z = sse_b[0];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) z += part[g][pix];
  const float s = 1.f / (1.f + expf(-z));

  float acc[kPer];
  float accs[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = accs[k] = 0.f;

  // project: acc[k] = sum_c W2[c, co] (h gate + h s)[c]
  for (int c0 = 0; c0 < cm; c0 += kCChunk2) {
    for (int j = grp; j < kCChunk2; j += kGroups) {
      const int c = c0 + j;
      float v = 0.f;
      if (valid && c < cm) {
        const float hv = hb[(size_t)c * hw];
        v = hv * gb[c] + hv * s;
      }
      vs[j][pix] = v;
    }
    for (int i = tid; i < kCoTile * kCChunk2; i += kThreads) {
      const int j = i / kCoTile;
      const int o = i - j * kCoTile;
      ws[o][j] = (c0 + j < cm && co0 + o < cout)
                     ? w2[(size_t)(c0 + j) * cout + co0 + o]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kCChunk2; ++j) {
      const float v = vs[j][pix];
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        acc[k] = fmaf(ws[grp * kPer + k][j], v, acc[k]);
    }
    __syncthreads();
  }

  // projected skip: accs[k] = sum_c Wsk[c, co] x[c]
  if (skip == 2) {
    for (int c0 = 0; c0 < cin; c0 += kCChunk2) {
      for (int j = grp; j < kCChunk2; j += kGroups) {
        const int c = c0 + j;
        vs[j][pix] = (valid && c < cin) ? xb[(size_t)c * hw] : 0.f;
      }
      for (int i = tid; i < kCoTile * kCChunk2; i += kThreads) {
        const int j = i / kCoTile;
        const int o = i - j * kCoTile;
        ws[o][j] = (c0 + j < cin && co0 + o < cout)
                       ? wsk[(size_t)(c0 + j) * cout + co0 + o]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < kCChunk2; ++j) {
        const float v = vs[j][pix];
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          accs[k] = fmaf(ws[grp * kPer + k][j], v, accs[k]);
      }
      __syncthreads();
    }
  }

  if (!valid) return;
  float* ob = out + (size_t)b * cout * hw + p;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int co = co0 + grp * kPer + k;
    if (co >= cout) break;
    float v = acc[k] + b2[co];
    if (skip == 2) {
      v += accs[k] + bsk[co];
    } else if (skip == 1) {
      v += xb[(size_t)co * hw];
    }
    ob[(size_t)co * hw] = v;
  }
}

// ---------------------------------------------------------------------------
// bf16 pass 2: the projection, the sSE logit and the conv skip on the tensor
// cores
// ---------------------------------------------------------------------------
//
// With gate g (per image and mid channel) and s[p] = sigmoid(z[p] + b_sse),
// z[p] = sum_c w_sse[c] h[c, p], the projection of h*g + h*s is
//   sum_c (W2[c, o] g[c]) h[c, p] + s[p] sum_c W2[c, o] h[c, p],
// so every product takes h as stored (bf16, exact) for its B operand. The
// A operands: W2^T (`w2_packed`, W2 split into bf16 hi + lo in the order
// of pack_w1), (W2 * g)^T, which the block forms per chunk from the packed
// W2 and g and splits again into hi + lo, and the sSE tile (`sse_packed`:
// row 0 hi(w_sse), row 1 lo(w_sse), so that one product gives both halves
// of z). The conv skip is one more product, Wsk^T (`wsk_packed`) against x,
// summed with the gated one. h and x arrive in chunks of 32 channels x 128
// pixels: two TMA boxes of 64 pixels (128 bytes a channel, the 128-byte
// swizzle keeps the ldmatrix.trans reads free of bank conflicts).

constexpr int kThreadsP2 = 256;  // 8 warps: 2 along the outputs x 4 along the pixels
constexpr int kPixP2 = 128;      // pixels a block
constexpr int kBoxPix = 64;      // pixels a box: one 128-byte swizzled row a channel
constexpr int kBoxBytes = tc::kKc * kBoxPix * 2;  // 4 KB
constexpr int kStagesP2 = 3;                      // chunks in flight (TMA variant)
constexpr int kSseElems = 2 * 32 * 8;             // a chunk's sSE tiles: [k16 step][lane][8]
constexpr int kSseBytes = kSseElems * 2;
constexpr int kStageP2 = 2 * kBoxBytes + tc::kWChunkBytes + kSseBytes;  // 17 KB
constexpr int kGatedOff = kStagesP2 * kStageP2;   // two gated W2 chunks
constexpr int kZOff = kGatedOff + 2 * tc::kWChunkBytes;  // z of the block's pixels
constexpr int kBarOff = kZOff + kPixP2 * 4;
constexpr int kSmemP2 = kBarOff + kStagesP2 * 8 + 1024;  // + the ring's 1024-byte alignment
constexpr int kOutStride = kPixP2 + 8;  // floats a row of the staged output tile
static_assert(kStageP2 % 1024 == 0, "stages stay 1024-byte aligned (128-byte swizzle)");
static_assert(tc::kCmb * kOutStride * 4 <= kStagesP2 * kStageP2, "the output tile fits the ring");

// One thread: step c's h (c < nh) or x chunk (two boxes; the second only if
// it holds a pixel of the image), its packed W2 or Wsk chunk and, for h,
// its sSE tiles, into stage c % kStagesP2, completing on that stage's
// mbarrier. A box's pixels past the image (or its channels past C) are
// zero-filled; a second box left out leaves stale pixels whose products
// are never stored.
__device__ __forceinline__ void issue_p2(const CUtensorMap* hmap, const CUtensorMap* xmap,
                                         unsigned char* ring, uint64_t* bars, int c, int nh,
                                         int p0, int hw, int b,
                                         const __nv_bfloat16* w2blk,
                                         const __nv_bfloat16* ssep,
                                         const __nv_bfloat16* wskblk) {
  const int s = c % kStagesP2;
  unsigned char* st = ring + s * kStageP2;
  const bool hstep = c < nh;
  const bool two = p0 + kBoxPix < hw;
  tc::mbar_expect_tx(&bars[s], (two ? 2 : 1) * kBoxBytes + tc::kWChunkBytes +
                                   (hstep ? kSseBytes : 0));
  const CUtensorMap* map = hstep ? hmap : xmap;
  const int cc = hstep ? c : c - nh;
  tc::tma_load_3d(st, map, p0, cc * tc::kKc, b, &bars[s]);
  if (two) tc::tma_load_3d(st + kBoxBytes, map, p0 + kBoxPix, cc * tc::kKc, b, &bars[s]);
  const __nv_bfloat16* wsrc = (hstep ? w2blk : wskblk) + (size_t)cc * tc::kWChunkElems;
  tc::bulk_load(st + 2 * kBoxBytes, wsrc, tc::kWChunkBytes, &bars[s]);
  if (hstep)
    tc::bulk_load(st + 2 * kBoxBytes + tc::kWChunkBytes, ssep + (size_t)c * kSseElems,
                  kSseBytes, &bars[s]);
}

// One chunk's products of a warp (tc::pass2_products): m16 tiles wm * 2 + i
// (those holding an output), n8 tiles wn * 4 + j. An h step (HSTEP) adds
// W2^T h to accp, (W2 g)^T h to accg and, for n8 tiles 2 wm and 2 wm + 1,
// the sSE tile's product to accz; a skip step adds Wsk^T x to accg.
template <bool HSTEP>
__device__ __forceinline__ void p2_products(uint32_t bbase, const uint4* wv, const uint4* gv,
                                            const uint4* sv, float (*accp)[4][4],
                                            float (*accg)[4][4], float (*accz)[4], int wm,
                                            int wn, int lane, bool live0, bool live1) {
  // ldmatrix.trans rows: lanes 0-15 channels 0-15 of the first n8 tile of a
  // pair, lanes 16-31 the same of the second; 16-byte column q of a box's
  // 128-byte row sits at q ^ (row % 8)
  const int r = lane & 15;
  const uint32_t box = bbase + (uint32_t)((wn >> 1) * kBoxBytes);
  const int q0 = (wn & 1) * 4 + (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int row = ks * 16 + r;
    uint32_t bf[4][2];  // [n8 tile]
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {  // n8 tiles 2 jp and 2 jp + 1
      uint32_t t[4];
      tc::ldsm_x4_trans(box + (uint32_t)(row * 128 + (((q0 + jp * 2) ^ (row & 7)) << 4)), t);
      bf[2 * jp][0] = t[0];
      bf[2 * jp][1] = t[1];
      bf[2 * jp + 1][0] = t[2];
      bf[2 * jp + 1][1] = t[3];
    }
    tc::pass2_products<false>(bf, nullptr, HSTEP, ks, wv, gv, sv, accp, accg, accz, wm, lane,
                              live0, live1);
  }
}

// One block of 8 warps per (128 pixels, 64 output channels, image). skip: 0
// none, 1 identity (cin == cout), 2 conv. TMA: h and x by 3-D TMA boxes
// through a ring of kStagesP2 stages (HW % 8 == 0, h and a read x 16-byte
// aligned); else one stage filled by plain loads in the same swizzled
// layout. The epilogue stages the float32 tile in shared memory and writes
// out = acc_g + s acc_p + b2 (+ bsk) (+ x) as bf16 rows, 16 bytes a store in
// the TMA variant.
template <bool TMA>
__global__ void __launch_bounds__(kThreadsP2, 2)
    pass2_bf16_kernel(const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap xmap,
                      const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ gate, const __nv_bfloat16* __restrict__ w2p,
                      const __nv_bfloat16* __restrict__ ssep, const float* __restrict__ sse_b,
                      const float* __restrict__ b2, const __nv_bfloat16* __restrict__ wskp,
                      const float* __restrict__ bsk, __nv_bfloat16* __restrict__ out, int cin,
                      int cm, int cout, int hw, int skip) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = tc::align1024(smem_raw);
  uint4* gated = reinterpret_cast<uint4*>(ring + kGatedOff);
  float* zs = reinterpret_cast<float*>(ring + kZOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kBarOff);
  float* ot = reinterpret_cast<float*>(ring);  // [64][kOutStride], after the products

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int p0 = blockIdx.x * kPixP2;
  const int o0 = blockIdx.y * tc::kCmb;
  const int b = blockIdx.z;
  const int nh = (cm + tc::kKc - 1) / tc::kKc;
  const int nxc = (cin + tc::kKc - 1) / tc::kKc;
  const int nsteps = nh + (skip == 2 ? nxc : 0);
  const __nv_bfloat16* w2blk = w2p + (size_t)blockIdx.y * nh * tc::kWChunkElems;
  const __nv_bfloat16* wskblk =
      skip == 2 ? wskp + (size_t)blockIdx.y * nxc * tc::kWChunkElems : nullptr;
  const float* gb = gate + (size_t)b * cm;
  const bool live0 = o0 + wm * 32 < cout;  // warp-uniform: the m16 tile holds an output
  const bool live1 = o0 + wm * 32 + 16 < cout;
  constexpr int kW = 2 * kBoxBytes;      // a stage's packed W chunk
  constexpr int kS = kW + tc::kWChunkBytes;  // and its sSE tiles

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
      for (int s = 0; s < kStagesP2; ++s) tc::mbar_init(&bars[s], 1);
      tc::mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0)
      for (int c = 0; c < kStagesP2 && c < nsteps; ++c)
        issue_p2(&hmap, &xmap, ring, bars, c, nh, p0, hw, b, w2blk, ssep, wskblk);
    tc::mbar_wait(&bars[0], 0);
    tc::gate_chunk(reinterpret_cast<const uint4*>(ring + kW), gated, gb, 0, cm, tid);
    __syncthreads();
    for (int c = 0; c < nsteps; ++c) {
      unsigned char* st = ring + (c % kStagesP2) * kStageP2;
      const uint4* wv = reinterpret_cast<const uint4*>(st + kW);
      if (c < nh)
        p2_products<true>(tc::smem_u32(st), wv, gated + (c & 1) * (tc::kWChunkBytes / 16),
                          reinterpret_cast<const uint4*>(st + kS), accp, accg, accz, wm, wn,
                          lane, live0, live1);
      else
        p2_products<false>(tc::smem_u32(st), wv, nullptr, nullptr, accp, accg, accz, wm, wn,
                           lane, live0, live1);
      if (c + 1 < nsteps) {  // the next chunk: wait for it, form its gated operand
        const int s1 = (c + 1) % kStagesP2;
        tc::mbar_wait(&bars[s1], ((c + 1) / kStagesP2) & 1);
        if (c + 1 < nh)
          tc::gate_chunk(reinterpret_cast<const uint4*>(ring + s1 * kStageP2 + kW),
                         gated + ((c + 1) & 1) * (tc::kWChunkBytes / 16), gb, c + 1, cm, tid);
      }
      __syncthreads();  // stage c % kStagesP2 is consumed; the next gated operand is ready
      if (tid == 0 && c + kStagesP2 < nsteps)
        issue_p2(&hmap, &xmap, ring, bars, c + kStagesP2, nh, p0, hw, b, w2blk, ssep, wskblk);
    }
  } else {
    for (int c = 0; c < nsteps; ++c) {
      __syncthreads();  // the previous chunk is consumed
      const bool hstep = c < nh;
      const __nv_bfloat16* src = hstep ? h : x;
      const int nc = hstep ? cm : cin;
      const int cc = hstep ? c : c - nh;
      for (int i = tid; i < tc::kKc * kPixP2; i += kThreadsP2) {
        const int r = i / kPixP2;
        const int q = i - r * kPixP2;
        const int gc = cc * tc::kKc + r;
        const int p = p0 + q;
        const int qq = q & (kBoxPix - 1);
        *reinterpret_cast<__nv_bfloat16*>(ring + (q / kBoxPix) * kBoxBytes + r * 128 +
                                          (((qq >> 3) ^ (r & 7)) << 4) + (qq & 7) * 2) =
            (gc < nc && p < hw) ? src[((size_t)b * nc + gc) * hw + p] : __float2bfloat16(0.f);
      }
      const uint4* wsrc = reinterpret_cast<const uint4*>((hstep ? w2blk : wskblk) +
                                                         (size_t)cc * tc::kWChunkElems);
      uint4* wdst = reinterpret_cast<uint4*>(ring + kW);
      for (int i = tid; i < tc::kWChunkBytes / 16; i += kThreadsP2) wdst[i] = wsrc[i];
      if (hstep) {
        const uint4* ssrc = reinterpret_cast<const uint4*>(ssep + (size_t)c * kSseElems);
        uint4* sdst = reinterpret_cast<uint4*>(ring + kS);
        for (int i = tid; i < kSseBytes / 16; i += kThreadsP2) sdst[i] = ssrc[i];
      }
      __syncthreads();
      if (hstep) {
        tc::gate_chunk(wdst, gated, gb, c, cm, tid);
        __syncthreads();
        p2_products<true>(tc::smem_u32(ring), wdst, gated,
                          reinterpret_cast<const uint4*>(ring + kS), accp, accg, accz, wm, wn,
                          lane, live0, live1);
      } else {
        p2_products<false>(tc::smem_u32(ring), wdst, nullptr, nullptr, accp, accg, accz, wm,
                           wn, lane, live0, live1);
      }
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
        float2 v;
        v.x = accg[i][j][hr * 2] + sv[j][0] * accp[i][j][hr * 2] + bias;
        v.y = accg[i][j][hr * 2 + 1] + sv[j][1] * accp[i][j][hr * 2 + 1] + bias;
        *reinterpret_cast<float2*>(&ot[o * kOutStride + wn * 32 + j * 8 + 2 * t]) = v;
      }
    }
  }
  __syncthreads();

  // the tile's rows, with the identity skip added in float32
  const int rows = min(tc::kCmb, cout - o0);
  __nv_bfloat16* ob = out + ((size_t)b * cout + o0) * hw;
  const __nv_bfloat16* xb = x + ((size_t)b * cin + o0) * hw;  // identity: cin == cout
  if constexpr (TMA) {
    // HW % 8 == 0: a run of 8 pixels (16 bytes) is all inside or all outside
    constexpr int kRuns = kPixP2 / 8;
    for (int i = tid; i < rows * kRuns; i += kThreadsP2) {
      const int o = i / kRuns;
      const int q = i - o * kRuns;
      const int p = p0 + q * 8;
      if (p >= hw) continue;
      const float4 u0 = *reinterpret_cast<const float4*>(&ot[o * kOutStride + q * 8]);
      const float4 u1 = *reinterpret_cast<const float4*>(&ot[o * kOutStride + q * 8 + 4]);
      float v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      if (skip == 1) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xb + (size_t)o * hw + p);
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
      *reinterpret_cast<uint4*>(ob + (size_t)o * hw + p) = pk;
    }
  } else {
    for (int i = tid; i < rows * kPixP2; i += kThreadsP2) {
      const int o = i / kPixP2;
      const int q = i - o * kPixP2;
      const int p = p0 + q;
      if (p >= hw) continue;
      float v = ot[o * kOutStride + q];
      if (skip == 1) v += __bfloat162float(xb[(size_t)o * hw + p]);
      ob[(size_t)o * hw + p] = __float2bfloat16(v);
    }
  }
}

template <typename T, int K, int ACT, int CMB>
void launch_pass1_cmb(const void* x, const void* w1, const void* b1,
                      const void* dw, const void* bdw, void* h, void* psum,
                      int batch, int cin, int cm, int height, int width,
                      cudaStream_t stream) {
  constexpr int OT = kSide - 2 * (K / 2);
  const int tiles_h = (height + OT - 1) / OT;
  const int tiles_w = (width + OT - 1) / OT;
  const dim3 grid(tiles_h * tiles_w, (cm + CMB - 1) / CMB, batch);
  pass1_kernel<T, K, ACT, CMB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(dw),
      static_cast<const float*>(bdw), static_cast<T*>(h),
      static_cast<float*>(psum), cin, cm, height, width, tiles_w);
}

// 64 mid channels a block (x read half as often) for C_mid above 64, unless
// that pads C_mid further than 32 a block would; 32 for the thin cells,
// where the 64-wide block (128 registers, a few spilled) measured slower
template <typename T, int K, int ACT>
void launch_pass1(const void* x, const void* w1, const void* b1,
                  const void* dw, const void* bdw, void* h, void* psum,
                  int batch, int cin, int cm, int height, int width,
                  cudaStream_t stream) {
  if (cm > 64 && (cm + 63) / 64 * 64 == (cm + 31) / 32 * 32)
    launch_pass1_cmb<T, K, ACT, 64>(x, w1, b1, dw, bdw, h, psum, batch, cin,
                                    cm, height, width, stream);
  else
    launch_pass1_cmb<T, K, ACT, 32>(x, w1, b1, dw, bdw, h, psum, batch, cin,
                                    cm, height, width, stream);
}

template <int K, int ACT, bool TMA>
int launch_pass1_bf16(const void* x, const void* wpk, const void* b1, const void* dw,
                      const void* bdw, void* h, void* psum, int batch, int cin, int cm,
                      int height, int width, cudaStream_t stream) {
  using L = Bf16Tile<K>;
  static bool smem_allowed = false;  // once per instantiation
  if (!smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(pass1_bf16_kernel<K, ACT, TMA>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = true;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if constexpr (TMA) {
    // x as a 4-D tensor (W, H, C_in, B), innermost first; one box is a
    // chunk's haloed tile: 48 columns x HH rows x 32 channels
    const tc::EncodeTiledFn encode = tc::encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)height, (cuuint64_t)cin,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)width * 2, (cuuint64_t)height * width * 2,
                                   (cuuint64_t)cin * height * width * 2};
    const cuuint32_t box[4] = {kBoxW, L::HH, tc::kKc, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                              dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_w = (width + kOtW - 1) / kOtW;
  const int tiles_h = (height + kOtH - 1) / kOtH;
  const dim3 grid(tiles_h * tiles_w, (cm + tc::kCmb - 1) / tc::kCmb, batch);
  pass1_bf16_kernel<K, ACT, TMA><<<grid, kThreadsB, L::SMEM, stream>>>(
      map, static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wpk),
      static_cast<const float*>(b1), static_cast<const float*>(dw),
      static_cast<const float*>(bdw), static_cast<__nv_bfloat16*>(h),
      static_cast<float*>(psum), cin, cm, height, width, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

void launch_pass2(const void* h, const void* x, const void* gate,
                  const void* sse_w, const void* sse_b, const void* w2,
                  const void* b2, const void* wsk, const void* bsk, void* out,
                  int batch, int cin, int cm, int cout, int hw, int skip,
                  cudaStream_t stream) {
  const dim3 grid((hw + kPix2 - 1) / kPix2, (cout + kCoTile - 1) / kCoTile,
                  batch);
  pass2_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(x),
      static_cast<const float*>(gate), static_cast<const float*>(sse_w),
      static_cast<const float*>(sse_b), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wsk),
      static_cast<const float*>(bsk), static_cast<float*>(out), cin, cm, cout, hw,
      skip);
}

// a 3-D tensor map of a (B, C, HW) bf16 tensor, innermost first: boxes of
// 64 pixels x 32 channels in the 128-byte swizzle
int encode_chw_boxes(CUtensorMap* map, const void* base, int hw, int c, int batch) {
  const tc::EncodeTiledFn encode = tc::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {(cuuint64_t)hw, (cuuint64_t)c, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)hw * 2, (cuuint64_t)c * hw * 2};
  const cuuint32_t box[3] = {kBoxPix, tc::kKc, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <bool TMA>
int launch_pass2_bf16(const void* h, const void* x, const void* gate, const void* ssep,
                      const void* sse_b, const void* w2p, const void* b2, const void* wskp,
                      const void* bsk, void* out, int batch, int cin, int cm, int cout, int hw,
                      int skip, cudaStream_t stream) {
  static bool smem_allowed = false;  // once per instantiation
  if (!smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        pass2_bf16_kernel<TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemP2);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = true;
  }
  CUtensorMap hmap, xmap;
  memset(&hmap, 0, sizeof(hmap));
  memset(&xmap, 0, sizeof(xmap));
  if constexpr (TMA) {
    int r = encode_chw_boxes(&hmap, h, hw, cm, batch);
    if (r == 0 && skip == 2) r = encode_chw_boxes(&xmap, x, hw, cin, batch);
    if (r != 0) return r;
  }
  const dim3 grid((hw + kPixP2 - 1) / kPixP2, (cout + tc::kCmb - 1) / tc::kCmb, batch);
  pass2_bf16_kernel<TMA><<<grid, kThreadsP2, kSmemP2, stream>>>(
      hmap, xmap, static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(gate), static_cast<const __nv_bfloat16*>(w2p),
      static_cast<const __nv_bfloat16*>(ssep), static_cast<const float*>(sse_b),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(wskp),
      static_cast<const float*>(bsk), static_cast<__nv_bfloat16*>(out), cin, cm, cout, hw,
      skip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows (axis 0) or columns (axis 1) of the pass-1 output tile for a k x k
// depthwise conv: 8 x 32 for bfloat16 x (the tensor-core kernel), 14 x 14
// (k = 3) or 12 x 12 (k = 5) for float32 x. psum has one row per tile.
int fused_ir_chw_tile_size(int ksize, int bf16, int axis) {
  if (bf16) return axis == 0 ? kOtH : kOtW;
  return kSide - 2 * (ksize / 2);
}

#ifdef DT_PASS1_PROBE
// The probe build only: the bf16 pass 1 writes kProbeSlots int64 a block
// (grid order: tile, then 64 mid channels, then image) to buf, or nothing
// when buf is null. Returns a cudaError_t.
int fused_ir_chw_probe(void* buf) {
  long long* p = static_cast<long long*>(buf);
  return static_cast<int>(cudaMemcpyToSymbol(g_pass1_probe, &p, sizeof(p)));
}

// Pixels of a channel that the bf16 product covers for a k x k conv (the
// staged, haloed tile padded to whole n8 tiles a warp), and staged rows
int fused_ir_chw_probe_geometry(int ksize, int what) {
  if (ksize == 3) return what == 0 ? Bf16Tile<3>::NPAD : Bf16Tile<3>::HH;
  return what == 0 ? Bf16Tile<5>::NPAD : Bf16Tile<5>::HH;
}
#endif

// x (B, Cin, H, W) and h (B, Cm, H, W) in float32 (bf16 == 0) or bfloat16;
// b1 (Cm), dw (k, k, Cm), bdw (Cm) float32; psum (B, ceil(H/t) *
// ceil(W/t), Cm) float32, t = fused_ir_chw_tile_size(k, bf16, axis). float32 x
// reads w1 (Cin, Cm) float32; bfloat16 x reads w1_packed, W1 split into bf16
// hi and lo in the product's order (ops/fused_mbconv.py `pack_w1`:
// (ceil(Cm/64), ceil(Cin/32), 2, 2, 4, 32, 8), 16-byte aligned), and with
// tma != 0 stages x by TMA (needs W % 8 == 0 and x 16-byte aligned), else
// by plain loads. act: 0 hard swish, 1 silu. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments it cannot take).
int fused_ir_chw_pass1(const void* x, const void* w1, const void* w1_packed,
                       const void* b1, const void* dw, const void* bdw, void* h,
                       void* psum, int batch, int cin, int cm, int height,
                       int width, int ksize, int act, int bf16, int tma,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((ksize != 3 && ksize != 5) || act < 0 || act > 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    const bool aligned = reinterpret_cast<size_t>(x) % 16 == 0;
    if (reinterpret_cast<size_t>(w1_packed) % 16 != 0 || (tma && (width % 8 != 0 || !aligned)))
      return static_cast<int>(cudaErrorInvalidValue);
#define DT_BF16(K, A, TMA)                                                            \
  return launch_pass1_bf16<K, A, TMA>(x, w1_packed, b1, dw, bdw, h, psum, batch, cin, \
                                      cm, height, width, s)
    switch (ksize * 100 + act * 10 + (tma ? 1 : 0)) {
      case 300: DT_BF16(3, 0, false);
      case 301: DT_BF16(3, 0, true);
      case 310: DT_BF16(3, 1, false);
      case 311: DT_BF16(3, 1, true);
      case 500: DT_BF16(5, 0, false);
      case 501: DT_BF16(5, 0, true);
      case 510: DT_BF16(5, 1, false);
      default: DT_BF16(5, 1, true);
    }
#undef DT_BF16
  }
#define DT_PASS1(K, A)                                                          \
  launch_pass1<float, K, A>(x, w1, b1, dw, bdw, h, psum, batch, cin, cm, height, \
                            width, s)
  switch (ksize * 10 + act) {
    case 30: DT_PASS1(3, 0); break;
    case 31: DT_PASS1(3, 1); break;
    case 50: DT_PASS1(5, 0); break;
    default: DT_PASS1(5, 1); break;
  }
#undef DT_PASS1
  return static_cast<int>(cudaGetLastError());
}

// h (B, Cm, H*W), x (B, Cin, H*W), out (B, Cout, H*W) in x's dtype;
// gate (B, Cm), sse_w (Cm), sse_b (1), w2 (Cm, Cout), b2 (Cout) float32;
// wsk (Cin, Cout) and bsk (Cout) float32, read only when skip == 2.
// skip: 0 none, 1 identity, 2 conv. float32 x reads w2, sse_w and wsk;
// bfloat16 x reads their bf16 hi + lo splits in the product's order
// (ops/fused_mbconv.py `pack_w2`, `pack_sse`, `pack_w1` of wsk; 16-byte
// aligned) and with tma != 0 stages h and x by TMA (needs HW % 8 == 0 and
// h, and x unless skip == 0, 16-byte aligned), else by plain loads.
// Returns cudaGetLastError() (cudaErrorInvalidValue for arguments it
// cannot take).
int fused_ir_chw_pass2(const void* h, const void* x, const void* gate,
                       const void* sse_w, const void* sse_b, const void* w2,
                       const void* b2, const void* wsk, const void* bsk,
                       const void* w2_packed, const void* sse_packed,
                       const void* wsk_packed, void* out, int batch, int cin, int cm,
                       int cout, int hw, int skip, int bf16, int tma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (skip < 0 || skip > 2 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    auto misaligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 != 0; };
    if (w2_packed == nullptr || sse_packed == nullptr || misaligned(w2_packed) ||
        misaligned(sse_packed) || (skip == 2 && (wsk_packed == nullptr || misaligned(wsk_packed))))
      return static_cast<int>(cudaErrorInvalidValue);
    if (tma && (hw % 8 != 0 || misaligned(h) || (skip != 0 && misaligned(x))))
      return static_cast<int>(cudaErrorInvalidValue);
    if (tma)
      return launch_pass2_bf16<true>(h, x, gate, sse_packed, sse_b, w2_packed, b2, wsk_packed,
                                     bsk, out, batch, cin, cm, cout, hw, skip, s);
    return launch_pass2_bf16<false>(h, x, gate, sse_packed, sse_b, w2_packed, b2, wsk_packed,
                                    bsk, out, batch, cin, cm, cout, hw, skip, s);
  }
  launch_pass2(h, x, gate, sse_w, sse_b, w2, b2, wsk, bsk, out, batch, cin, cm, cout,
                      hw, skip, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
