// Fused, BN-folded inverted-residual block on NHWC tensors: two CUDA
// kernels for Hopper (sm_90a), with a plain C interface loaded by ctypes
// (deadtrees_tpu_torch/ops/_build.py, wrappers in ops/fused_cell.py).
//
// Replaces two TPU kernels that compute the same block in this layout:
//   deadtrees_tpu/ops/fused_cell.py `fused_ir_fat` (Pallas `_p1_kernel`,
//     `_p2_kernel`): hswish or silu, k = 3 or 5, h stored in x's dtype;
//   deadtrees_tpu/ops/fused_mbconv.py `fused_inverted_residual` (Pallas
//     `_pass1_kernel`, `_pass2_kernel`): hswish, k = 3, h stored in float32.
// The caller picks h's type; the arithmetic is float32 throughout.
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
// memory.
//
// What this simple design does: every multiply-add is float32 on the CUDA
// cores, from shared-memory tiles, with register-tiled products. Pass 1
// takes one block per (2-D output tile, 32 or 64 mid channels, image): the
// output tile is 14x14 (k=3) or 12x12 (k=5), its haloed tile 16x16 pixels.
// x's haloed tile streams through shared memory 16 channels a step, each
// half-warp reading 16 neighbouring channels of one pixel (C_in reaches
// 688), the next step fetched into registers while the current one is
// summed. y of the haloed tile goes to shared memory, zeroed outside the
// image (the depthwise conv's zero padding applies to y, not x: a halo
// pixel must not carry act(b1)); the depthwise conv runs from there, and h
// is staged once more in shared memory so that each warp writes 32
// neighbouring channels of a pixel. Per-tile channel sums of the float32 h
// go to psum with no atomics, so runs repeat exactly. Pass 2 takes one
// block per (64 pixels, 64 output channels, image): each warp reduces the
// sSE logit of 8 pixels over C_mid with a fixed shuffle tree, then the
// projection runs as a 64x64 register-tiled product (4x4 outputs a
// thread) over C_mid in steps of 32, and the conv skip as a second one
// over C_in.
//
// What it leaves for later work: the tensor cores (wgmma on bf16 tiles of
// the 1x1 convolutions), TMA loads, the halo recompute of pass 1 (the
// expand runs on 16x16 pixels for a 14x14 output tile), x read once per 64
// mid channels in pass 1, h read once per 64 output channels in pass 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

// Pass 1. One block per (output tile, CMB mid channels, image), CMB 32 or
// 64; 256 threads. Staging: thread t fetches channel c0 + t % 16 of haloed
// column t / 16, all 16 rows, for each step of 16 input channels. The
// expand is kernel 1's register-tiled product: warp w owns mid channels
// w*CPT..w*CPT+CPT-1 (CPT = CMB / 8), lane l the haloed pixels 4l..4l+3
// and 128+4l..128+4l+3.
template <typename TX, typename TH, int K, int ACT, int CMB>
__global__ void __launch_bounds__(kThreads, 2)
    nhwc_p1_kernel(const TX* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ dw,
                   const float* __restrict__ bdw, TH* __restrict__ h,
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
  const TX* xp = x + (size_t)b * height * row + (size_t)(col_in ? sx : 0) * cin + kc;
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
      float s = hv;  // the float32 h, before rounding to h's type
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
            from_f32<TH>(hs[p * HS + c]);
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

template <typename TX, typename TH, int K, int ACT, int CMB>
int launch_pass1_cmb(const void* x, const void* w1, const void* b1,
                     const void* dw, const void* bdw, void* h, void* psum,
                     int batch, int cin, int cm, int height, int width,
                     cudaStream_t stream) {
  constexpr int OT = kSide - 2 * (K / 2);
  constexpr size_t smem = pass1_smem_floats<K, CMB>() * sizeof(float);
  auto kernel = nhwc_p1_kernel<TX, TH, K, ACT, CMB>;
  // above 48 KB a block's dynamic shared memory must be allowed first
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (height + OT - 1) / OT;
  const int tiles_w = (width + OT - 1) / OT;
  const dim3 grid(tiles_h * tiles_w, (cm + CMB - 1) / CMB, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(dw),
      static_cast<const float*>(bdw), static_cast<TH*>(h),
      static_cast<float*>(psum), cin, cm, height, width, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

// 64 mid channels a block (x read half as often) for C_mid above 64, unless
// that pads C_mid further than 32 a block would (kernel 1's rule)
template <typename TX, typename TH, int K, int ACT>
int launch_pass1(const void* x, const void* w1, const void* b1,
                 const void* dw, const void* bdw, void* h, void* psum,
                 int batch, int cin, int cm, int height, int width,
                 cudaStream_t stream) {
  if (cm > 64 && (cm + 63) / 64 * 64 == (cm + 31) / 32 * 32)
    return launch_pass1_cmb<TX, TH, K, ACT, 64>(x, w1, b1, dw, bdw, h, psum, batch,
                                                cin, cm, height, width, stream);
  return launch_pass1_cmb<TX, TH, K, ACT, 32>(x, w1, b1, dw, bdw, h, psum, batch,
                                              cin, cm, height, width, stream);
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

}  // namespace

extern "C" {

// Side of the square pass-1 output tile for a k x k depthwise conv
// (14 for k = 3, 12 for k = 5): psum has one row per tile.
int fused_ir_nhwc_tile_size(int ksize) { return kSide - 2 * (ksize / 2); }

// x (B, H, W, Cin) in float32 (x_bf16 == 0) or bfloat16; h (B, H, W, Cm)
// in float32 (h_bf16 == 0) or bfloat16; w1 (Cin, Cm), b1 (Cm),
// dw (k, k, Cm), bdw (Cm) float32; psum (B, ceil(H/t) * ceil(W/t), Cm)
// float32, t = fused_ir_nhwc_tile_size(k). act: 0 hard swish, 1 silu.
// Types: (x, h) = (f32, f32) or (bf16, bf16) with any k and act, or
// (bf16, f32) with k = 3 and hard swish. Returns cudaGetLastError().
int fused_ir_nhwc_pass1(const void* x, const void* w1, const void* b1,
                        const void* dw, const void* bdw, void* h, void* psum,
                        int batch, int cin, int cm, int height, int width,
                        int ksize, int act, int x_bf16, int h_bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
#define DT_PASS1(TX, TH, K, A)                                                  \
  return launch_pass1<TX, TH, K, A>(x, w1, b1, dw, bdw, h, psum, batch, cin, cm, \
                                    height, width, s)
  const int key = x_bf16 * 1000 + h_bf16 * 100 + ksize * 10 + act;
  switch (key) {
    case 30: DT_PASS1(float, float, 3, 0);
    case 31: DT_PASS1(float, float, 3, 1);
    case 50: DT_PASS1(float, float, 5, 0);
    case 51: DT_PASS1(float, float, 5, 1);
    case 1130: DT_PASS1(bf, bf, 3, 0);
    case 1131: DT_PASS1(bf, bf, 3, 1);
    case 1150: DT_PASS1(bf, bf, 5, 0);
    case 1151: DT_PASS1(bf, bf, 5, 1);
    case 1030: DT_PASS1(bf, float, 3, 0);
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
