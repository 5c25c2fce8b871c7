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
// and by bytes only for the thin 512^2 cells.
//
// What this simple design does: every multiply-add runs in float32 on the
// CUDA cores, from shared-memory tiles. Pass 1 takes one block per
// (output tile, 64 or 32 mid channels, image); the output tile is 14x14
// (k=3) or 12x12 (k=5), so that its haloed tile is 16x16 pixels, one a
// thread.
// It runs the expand as a register-tiled GEMM over the haloed pixels
// (Cin in steps of 16, the next step fetched into registers while the
// current one is summed: Cin reaches 688), writes y for the haloed tile
// to shared memory and runs the depthwise conv from there. The partial
// sums are written per tile and channel to a buffer (no atomics, so runs
// repeat exactly). Pass 2 takes one block per (128 pixels, 32 output
// channels, image).
//
// What it leaves for later work: the tensor cores (wgmma on bf16 tiles of
// the 1x1 convolutions), TMA loads, the halo recompute of pass 1 (the
// expand runs on 16x16 pixels for a 14x14 output tile), x read once per
// 64 mid channels in pass 1 and h once per 32 output channels in pass 2,
// and the launch count per block (two kernels plus the small gate ops,
// 22 times per forward).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

// skip: 0 none, 1 identity (cin == cout), 2 conv
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pass2_kernel(const T* __restrict__ h, const T* __restrict__ x,
                 const float* __restrict__ gate,
                 const float* __restrict__ sse_w,
                 const float* __restrict__ sse_b,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ wsk,
                 const float* __restrict__ bsk, T* __restrict__ out, int cin,
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
  const T* hb = h + (size_t)b * cm * hw + p;
  const T* xb = x + (size_t)b * cin * hw + p;
  const float* gb = gate + (size_t)b * cm;

  // sSE logit: the thread groups split the channels, summed in fixed order
  float z = 0.f;
  if (valid)
    for (int c = grp; c < cm; c += kGroups)
      z = fmaf(sse_w[c], to_f32(hb[(size_t)c * hw]), z);
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
        const float hv = to_f32(hb[(size_t)c * hw]);
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
        vs[j][pix] = (valid && c < cin) ? to_f32(xb[(size_t)c * hw]) : 0.f;
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
  T* ob = out + (size_t)b * cout * hw + p;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int co = co0 + grp * kPer + k;
    if (co >= cout) break;
    float v = acc[k] + b2[co];
    if (skip == 2) {
      v += accs[k] + bsk[co];
    } else if (skip == 1) {
      v += to_f32(xb[(size_t)co * hw]);
    }
    ob[(size_t)co * hw] = from_f32<T>(v);
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

template <typename T>
void launch_pass2(const void* h, const void* x, const void* gate,
                  const void* sse_w, const void* sse_b, const void* w2,
                  const void* b2, const void* wsk, const void* bsk, void* out,
                  int batch, int cin, int cm, int cout, int hw, int skip,
                  cudaStream_t stream) {
  const dim3 grid((hw + kPix2 - 1) / kPix2, (cout + kCoTile - 1) / kCoTile,
                  batch);
  pass2_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(x),
      static_cast<const float*>(gate), static_cast<const float*>(sse_w),
      static_cast<const float*>(sse_b), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wsk),
      static_cast<const float*>(bsk), static_cast<T*>(out), cin, cm, cout, hw,
      skip);
}

}  // namespace

extern "C" {

// Side of the square pass-1 output tile for a k x k depthwise conv
// (14 for k = 3, 12 for k = 5): psum has one row per tile.
int fused_ir_chw_tile_size(int ksize) { return kSide - 2 * (ksize / 2); }

// x (B, Cin, H, W) and h (B, Cm, H, W) in float32 (bf16 == 0) or bfloat16;
// w1 (Cin, Cm), b1 (Cm), dw (k, k, Cm), bdw (Cm) float32;
// psum (B, ceil(H/t) * ceil(W/t), Cm) float32, t = fused_ir_chw_tile_size(k).
// act: 0 hard swish, 1 silu. Returns cudaGetLastError() after the launch.
int fused_ir_chw_pass1(const void* x, const void* w1, const void* b1,
                       const void* dw, const void* bdw, void* h, void* psum,
                       int batch, int cin, int cm, int height, int width,
                       int ksize, int act, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DT_PASS1(T, K, A)                                                   \
  launch_pass1<T, K, A>(x, w1, b1, dw, bdw, h, psum, batch, cin, cm, height, \
                        width, s)
  const int key = (bf16 ? 100 : 0) + ksize * 10 + act;
  switch (key) {
    case 30: DT_PASS1(float, 3, 0); break;
    case 31: DT_PASS1(float, 3, 1); break;
    case 50: DT_PASS1(float, 5, 0); break;
    case 51: DT_PASS1(float, 5, 1); break;
    case 130: DT_PASS1(__nv_bfloat16, 3, 0); break;
    case 131: DT_PASS1(__nv_bfloat16, 3, 1); break;
    case 150: DT_PASS1(__nv_bfloat16, 5, 0); break;
    case 151: DT_PASS1(__nv_bfloat16, 5, 1); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DT_PASS1
  return static_cast<int>(cudaGetLastError());
}

// h (B, Cm, H*W), x (B, Cin, H*W), out (B, Cout, H*W) in x's dtype;
// gate (B, Cm), sse_w (Cm), sse_b (1), w2 (Cm, Cout), b2 (Cout) float32;
// wsk (Cin, Cout) and bsk (Cout) float32, read only when skip == 2.
// skip: 0 none, 1 identity, 2 conv. Returns cudaGetLastError().
int fused_ir_chw_pass2(const void* h, const void* x, const void* gate,
                       const void* sse_w, const void* sse_b, const void* w2,
                       const void* b2, const void* wsk, const void* bsk,
                       void* out, int batch, int cin, int cm, int cout, int hw,
                       int skip, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (skip < 0 || skip > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    launch_pass2<__nv_bfloat16>(h, x, gate, sse_w, sse_b, w2, b2, wsk, bsk,
                                out, batch, cin, cm, cout, hw, skip, s);
  else
    launch_pass2<float>(h, x, gate, sse_w, sse_b, w2, b2, wsk, bsk, out,
                        batch, cin, cm, cout, hw, skip, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
