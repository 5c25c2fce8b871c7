// The 1x1 expand of the fused inverted-residual pass 1 on the tensor
// cores, and the asynchronous-copy helpers around it (sm_90a). Included by
// fused_ir_chw.cu (both bf16 passes) and fused_ir_nhwc.cu (the bf16 pass 1).
//
// The product: acc[m, n] += sum_k W1T[m, k] x[k, n], m a mid channel, k an
// input channel, n a pixel of the staged (haloed) tile. It runs as
// mma.sync.m16n8k16 bf16 products with float32 accumulation. x is bf16 on
// this route; W1 is float32 and is split once, at fold time, into
// hi = bf16(W1) and lo = bf16(W1 - hi) (ops/fused_mbconv.py `pack_w1`), and
// the product sums x*hi + x*lo, so it stays within about 2^-16 of the
// float32 product.
//
// Layouts, for one chunk of kKc = 32 input channels:
// - x: [32 channels][pixels] bf16 in shared memory, pixels contiguous (the
//   CHW layout: MN-major for the product's B operand), `ns` pixels from one
//   channel to the next; fragments come from ldmatrix.trans.
// - W: the packed weights of a block's kCmb = 64 mid channels, in the order
//   the product reads them: [k16 step (2)][hi, lo][m16 tile (4)][lane (32)]
//   [8 bf16], each lane's 8 values its A fragment (rows g and g + 8, columns
//   2t, 2t + 1, 2t + 8, 2t + 9 of the 16 x 16 tile, g = lane / 4,
//   t = lane % 4, in register order), so a lane loads its fragment with one
//   16-byte shared load and a warp's loads are conflict-free. 8 KB a chunk.
// - x, K-major (the NHWC layout, `expand_chunk_kmajor`): [pixels][32
//   channels] bf16, 64 bytes a pixel, in the TMA 64-byte swizzle (the
//   16-byte quarter q of pixel p's row sits at quarter q ^ ((p >> 1) & 3),
//   so that the 8 pixel rows of an ldmatrix hit 8 different bank groups);
//   fragments come from ldmatrix without .trans.
// A warp takes two m16 tiles (32 mid channels, `wm` of the two halves)
// and NTW n8 tiles (pixels from wn * NTW * 8) of the block's product.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int kKc = 32;                       // input channels a chunk
constexpr int kCmb = 64;                      // mid channels a block
constexpr int kWChunkElems = 2 * 2 * 4 * 32 * 8;  // packed bf16 a chunk
constexpr int kWChunkBytes = kWChunkElems * 2;    // 8 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned address of dynamic shared memory at or after
// p (a swizzled TMA box needs it); the block allocates 1024 bytes more
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---- mbarrier and the bulk / tensor copies (one thread issues them) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from 16-byte aligned global memory to shared
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one box of a 4-D tensor map; coordinates innermost first, signed: the
// part of the box outside the tensor is zero-filled
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// one box of a 3-D tensor map (the CHW pass 2: pixels, channels, image)
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- the product ----

__device__ __forceinline__ void mma_bf16(float* d, const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// B fragments of two n8 tiles (k16 x 16 pixels) from an MN-major tile
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// B fragment of one n8 tile (lanes 0-15 give the addresses)
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// B fragments of two n8 tiles (16 pixels x k16) from a K-major tile
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// B fragment of one n8 tile from a K-major tile (lanes 0-15 give the addresses)
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// acc[i][j] (m16 tile wm * 2 + i, n8 tile wn * NTW + j of the block) +=
// one chunk's product. xs: the chunk's x, [32][ns] bf16; ws: its packed
// weights. The C fragment: acc[i][j][0..1] at (row g, columns 2t, 2t + 1),
// [2..3] at row g + 8.
template <int NTW>
__device__ __forceinline__ void expand_chunk(const __nv_bfloat16* xs, int ns,
                                             const __nv_bfloat16* ws, float (*acc)[NTW][4],
                                             int wm, int wn, int lane) {
  const uint4* wv = reinterpret_cast<const uint4*>(ws);
  // ldmatrix rows: lanes 0-7 channels 0-7, 8-15 channels 8-15 of the first
  // n8 tile; lanes 16-31 the same of the next tile
  const int krow = lane & 15;
  const int tile_off = (lane >> 4) * 8;
  const uint32_t base = smem_u32(xs + (size_t)krow * ns + wn * NTW * 8 + tile_off);
#pragma unroll
  for (int ks = 0; ks < kKc / 16; ++ks) {
    uint4 a[2][2];  // [m16 tile][hi, lo]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) a[i][hl] = wv[((ks * 2 + hl) * 4 + wm * 2 + i) * 32 + lane];
    const uint32_t kb = base + (uint32_t)(ks * 16 * ns * 2);
#pragma unroll
    for (int j = 0; j < NTW; j += 2) {
      uint32_t b[4];
      if (j + 1 < NTW) {
        ldsm_x4_trans(kb + j * 16, b);
      } else {
        ldsm_x2_trans(kb + j * 16, b);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hl = 0; hl < 2; ++hl) {
          mma_bf16(acc[i][j], a[i][hl], b[0], b[1]);
          if (j + 1 < NTW) mma_bf16(acc[i][j + 1], a[i][hl], b[2], b[3]);
        }
    }
  }
}

// expand_chunk for a K-major chunk: xs is [pixels][32 channels] bf16 in the
// 64-byte swizzle (the box of a TMA load with CU_TENSOR_MAP_SWIZZLE_64B, its
// base 512-byte aligned), the product the same.
template <int NTW>
__device__ __forceinline__ void expand_chunk_kmajor(const __nv_bfloat16* xs,
                                                    const __nv_bfloat16* ws,
                                                    float (*acc)[NTW][4], int wm, int wn,
                                                    int lane) {
  const uint4* wv = reinterpret_cast<const uint4*>(ws);
  // ldmatrix rows: lane l gives row l % 8 of matrix l / 8; the matrices are
  // (tile j, channels 0-7), (tile j, 8-15), (tile j + 1, 0-7), (tile j + 1, 8-15)
  const int mat = lane >> 3;
  const int prow = (mat >> 1) * 8 + (lane & 7);  // pixel within the pair of n8 tiles
  const int khalf = mat & 1;
  const uint32_t base = smem_u32(xs);
#pragma unroll
  for (int ks = 0; ks < kKc / 16; ++ks) {
    uint4 a[2][2];  // [m16 tile][hi, lo]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) a[i][hl] = wv[((ks * 2 + hl) * 4 + wm * 2 + i) * 32 + lane];
    const int quarter = ks * 2 + khalf;  // 16-byte quarter of the pixel's 64 bytes
#pragma unroll
    for (int j = 0; j < NTW; j += 2) {
      const int p = (wn * NTW + j) * 8 + prow;
      const uint32_t addr = base + (uint32_t)(p * 64 + ((quarter ^ ((p >> 1) & 3)) << 4));
      uint32_t b[4];
      if (j + 1 < NTW) {
        ldsm_x4(addr, b);
      } else {
        ldsm_x2(addr, b);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hl = 0; hl < 2; ++hl) {
          mma_bf16(acc[i][j], a[i][hl], b[0], b[1]);
          if (j + 1 < NTW) mma_bf16(acc[i][j + 1], a[i][hl], b[2], b[3]);
        }
    }
  }
}

// ---- host side ----

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda at link time
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

}  // namespace tc
