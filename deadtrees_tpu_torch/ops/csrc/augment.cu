// Fused colour jitter + normalize of a uint8 training batch: one CUDA
// kernel for Hopper (sm_90a), with a plain C interface loaded by ctypes
// (deadtrees_tpu_torch/ops/_build.py, wrapper in ops/augment.py).
//
// Replaces the TPU kernel deadtrees_tpu/ops/augment_pallas.py
// `augment_pallas` (Pallas `_augment_kernel`). What it computes, for every
// element v of image b (after the dihedral flips and rotations):
//
//   x   = floor(clip(v * alpha_b + beta_b * mean_b, 0, 255))
//   out = (x - 255 m_c) / (255 s_c)
//
// with the products and the sum each rounded to float32 (no FMA
// contraction) and an IEEE division, so that it agrees bit for bit with
// the plain PyTorch version: a contracted FMA can put the floor on the
// other side of an integer, one grey step (about 0.02 after the divide).
// mean_b is the image's mean over pixels and bands, computed by the
// wrapper from an exact integer sum.
//
// Layouts: the input is the batch as the host sends it, NHWC uint8
// (B, H*W, C); the output is float32 NCHW (B, C, H*W), the layout the
// model reads, so no permute pass follows.
//
// What bounds it on this card: bytes. It reads C bytes and writes 4*C
// bytes per pixel and does a handful of operations on each, far below
// the card's ratio of operations to bytes. The flagship batch (16 x 512^2
// x 4) moves 83.9 MB: 25 us at 3.35 TB/s, once per training batch.
//
// What this simple design does: each thread takes 4 consecutive pixels of
// one image. When H*W is a multiple of 4 and C is 3 or 4, it reads them
// with one 16-byte load (C = 4) or three 4-byte loads (C = 3) and writes
// one 16-byte store of 4 floats into each band plane; any other shape
// takes a scalar path, one pixel a thread. The TPU kernel's lane-folded
// (H, W*C) blocks and its scalar table in SMEM mean nothing here.
//
// What it leaves for later work: fusing the dihedral index map into the
// load (today torch writes the flipped/rotated uint8 batch first), TMA,
// and the per-image mean (a separate torch reduction).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;  // pixels a thread on the vector path

__device__ __forceinline__ float jitter_normalize(float v, float alpha, float bm,
                                                  float m255, float s255) {
  float t = __fadd_rn(__fmul_rn(v, alpha), bm);
  t = floorf(fminf(fmaxf(t, 0.0f), 255.0f));
  return __fdiv_rn(__fsub_rn(t, m255), s255);
}

// H*W % 4 == 0, C in {3, 4}: 4 pixels a thread, vector loads and stores.
template <int kC>
__global__ void __launch_bounds__(kThreads)
augment_vec_kernel(const uint8_t* __restrict__ img, const float* __restrict__ alpha,
                   const float* __restrict__ beta, const float* __restrict__ mean,
                   const float* __restrict__ chan, float* __restrict__ out, int hw) {
  const int b = blockIdx.y;
  const long long p0 = static_cast<long long>(blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (p0 >= hw) return;
  const float a = alpha[b];
  const float bm = __fmul_rn(beta[b], mean[b]);
  // byte offset (b*hw + p0)*kC is a multiple of 4*kC and the wrapper
  // passes a 16-byte aligned base: aligned for the loads
  const uint8_t* src = img + (static_cast<size_t>(b) * hw + p0) * kC;
  uint32_t words[kC];
  if constexpr (kC == 4) {
    const uint4 w = *reinterpret_cast<const uint4*>(src);
    words[0] = w.x;
    words[1] = w.y;
    words[2] = w.z;
    words[3] = w.w;
  } else {
#pragma unroll
    for (int i = 0; i < kC; ++i) words[i] = reinterpret_cast<const uint32_t*>(src)[i];
  }
  float* dst = out + static_cast<size_t>(b) * kC * hw + p0;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float m255 = chan[c];
    const float s255 = chan[kC + c];
    float r[kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int byte = p * kC + c;  // pixel p, band c
      const float v = static_cast<float>((words[byte >> 2] >> (8 * (byte & 3))) & 0xffu);
      r[p] = jitter_normalize(v, a, bm, m255, s255);
    }
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(c) * hw) =
        make_float4(r[0], r[1], r[2], r[3]);
  }
}

// Any H*W and C: one pixel a thread.
__global__ void __launch_bounds__(kThreads)
augment_scalar_kernel(const uint8_t* __restrict__ img, const float* __restrict__ alpha,
                      const float* __restrict__ beta, const float* __restrict__ mean,
                      const float* __restrict__ chan, float* __restrict__ out, int hw,
                      int c_count) {
  const int b = blockIdx.y;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= hw) return;
  const float a = alpha[b];
  const float bm = __fmul_rn(beta[b], mean[b]);
  const uint8_t* src = img + (static_cast<size_t>(b) * hw + p) * c_count;
  float* dst = out + static_cast<size_t>(b) * c_count * hw + p;
  for (int c = 0; c < c_count; ++c) {
    dst[static_cast<size_t>(c) * hw] =
        jitter_normalize(static_cast<float>(src[c]), a, bm, chan[c], chan[c_count + c]);
  }
}

}  // namespace

extern "C" {

// img: (B, hw, C) uint8; alpha, beta, mean: (B,) float32; chan: (2*C,)
// float32 [255*m_0.., 255*s_0..]; out: (B, C, hw) float32. All on the
// device, contiguous. Returns cudaGetLastError() after the launch.
int augment_jitter_normalize(const void* img, const void* alpha, const void* beta,
                             const void* mean, const void* chan, void* out, int batch,
                             int hw, int c_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(img);
  const float* al = static_cast<const float*>(alpha);
  const float* be = static_cast<const float*>(beta);
  const float* mu = static_cast<const float*>(mean);
  const float* ch = static_cast<const float*>(chan);
  float* o = static_cast<float*>(out);
  if (hw % kPix == 0 && (c_count == 3 || c_count == 4)) {
    const dim3 grid((hw / kPix + kThreads - 1) / kThreads, batch);
    if (c_count == 4) {
      augment_vec_kernel<4><<<grid, kThreads, 0, s>>>(in, al, be, mu, ch, o, hw);
    } else {
      augment_vec_kernel<3><<<grid, kThreads, 0, s>>>(in, al, be, mu, ch, o, hw);
    }
  } else {
    const dim3 grid((hw + kThreads - 1) / kThreads, batch);
    augment_scalar_kernel<<<grid, kThreads, 0, s>>>(in, al, be, mu, ch, o, hw, c_count);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
