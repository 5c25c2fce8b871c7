// The 1x1 products of the fused inverted-residual block on the tensor
// cores (the expand of pass 1; the gated operand and the products of the
// bf16 pass 2), and the asynchronous-copy helpers around them (sm_90a).
// Included by fused_ir_chw.cu and fused_ir_nhwc.cu (both bf16 passes of
// each).
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

// B fragments at k16 step ks of n8 tile `tile` (b[0], b[1]) and, with
// `two`, of tile + 1 (b[2], b[3]) from a K-major chunk in the 64-byte
// swizzle (above; base its shared address). ldmatrix rows: lane l gives row
// l % 8 of matrix l / 8; the matrices are (tile, channels 0-7), (tile,
// 8-15), (tile + 1, 0-7), (tile + 1, 8-15).
__device__ __forceinline__ void ldsm_kmajor(uint32_t base, int tile, int ks, int lane, bool two,
                                            uint32_t* b) {
  const int mat = lane >> 3;
  const int p = tile * 8 + (mat >> 1) * 8 + (lane & 7);
  const int quarter = ks * 2 + (mat & 1);  // 16-byte quarter of the pixel's 64 bytes
  const uint32_t addr = base + (uint32_t)(p * 64 + ((quarter ^ ((p >> 1) & 3)) << 4));
  if (two)
    ldsm_x4(addr, b);
  else
    ldsm_x2(addr, b);
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
  const uint32_t base = smem_u32(xs);
#pragma unroll
  for (int ks = 0; ks < kKc / 16; ++ks) {
    uint4 a[2][2];  // [m16 tile][hi, lo]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) a[i][hl] = wv[((ks * 2 + hl) * 4 + wm * 2 + i) * 32 + lane];
#pragma unroll
    for (int j = 0; j < NTW; j += 2) {
      uint32_t b[4];
      ldsm_kmajor(base, wn * NTW + j, ks, lane, j + 1 < NTW, b);
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

// ---- the bf16 pass 2 (fused_ir_chw.cu and fused_ir_nhwc.cu) ----
//
// A block of 8 warps takes 64 outputs (4 m16 tiles) x 128 pixels (16 n8
// tiles) and runs over chunks of 32 mid channels (h steps) and, for the
// conv skip, of 32 input channels (x steps). The A operands are packed as
// W1 is above: W2^T (`w2_packed`), Wsk^T (`wsk_packed`), the sSE tile
// (`sse_packed`: [k16 step][lane][8], row 0 hi(w_sse), row 1 lo(w_sse)),
// and (W2 * gate)^T, which the block forms per chunk (gate_chunk).

// The gated A operand of chunk c: thread tid takes lane tid % 32 of m16
// tile (tid / 32) % 4 at k16 step tid / 128, rebuilds W2 = hi + lo, scales
// each column by its channel's gate and splits the product into hi + lo.
__device__ __forceinline__ void gate_chunk(const uint4* wv, uint4* gv, const float* gb, int c,
                                           int cm, int tid) {
  const int ks = tid >> 7;
  const int mt = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int ih = ((ks * 2) * 4 + mt) * 32 + lane;
  const int il = ((ks * 2 + 1) * 4 + mt) * 32 + lane;
  const int c0 = c * kKc + ks * 16 + 2 * (lane & 3);
  float g[4];  // the gates of the fragment's columns 2t, 2t + 1, 2t + 8, 2t + 9
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ch = c0 + (q & 1) + (q >> 1) * 8;
    g[q] = ch < cm ? gb[ch] : 0.f;
  }
  const uint4 hi = wv[ih];
  const uint4 lo = wv[il];
  uint4 oh, ol;
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hi);
  const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&lo);
  __nv_bfloat162* oh2 = reinterpret_cast<__nv_bfloat162*>(&oh);
  __nv_bfloat162* ol2 = reinterpret_cast<__nv_bfloat162*>(&ol);
#pragma unroll
  for (int r = 0; r < 4; ++r) {  // register r: columns 2t, 2t + 1 (r < 2) or 2t + 8, 2t + 9
    const float2 fh = __bfloat1622float2(h2[r]);
    const float2 fl = __bfloat1622float2(l2[r]);
    const float v0 = (fh.x + fl.x) * g[2 * (r >> 1)];
    const float v1 = (fh.y + fl.y) * g[2 * (r >> 1) + 1];
    const __nv_bfloat162 top = __floats2bfloat162_rn(v0, v1);
    const float2 ft = __bfloat1622float2(top);
    oh2[r] = top;
    ol2[r] = __floats2bfloat162_rn(v0 - ft.x, v1 - ft.y);
  }
  gv[ih] = oh;
  gv[il] = ol;
}

// One k16 step's products of a warp: m16 tiles wm * 2 + i (those holding an
// output: live0, live1), the warp's n8 tiles j = 0..3 with B fragments
// bh[j]. An h step adds W2^T h to accp (wv: the packed W2 chunk), (W2 g)^T
// h to accg (gv: the gated chunk) and, for n8 tiles 2 wm and 2 wm + 1, the
// sSE tile's product to accz (sv); with SPLIT (float32 h, split into bf16
// hi in bh and lo in bl) also the hi A operands and the sSE tile against
// the lo halves: Whi hhi + Wlo hhi + Whi hlo. An x step adds Wsk^T x to
// accg (wv: the packed Wsk chunk).
template <bool SPLIT>
__device__ __forceinline__ void pass2_products(const uint32_t (*bh)[2], const uint32_t (*bl)[2],
                                               bool hstep, int ks, const uint4* wv,
                                               const uint4* gv, const uint4* sv,
                                               float (*accp)[4][4], float (*accg)[4][4],
                                               float (*accz)[4], int wm, int lane, bool live0,
                                               bool live1) {
  if (hstep) {
    // n8 tile 2 wm + jj by a select on wm (0 or 1): an index computed from
    // wm would put the fragments in local memory
    const uint4 as = sv[ks * 32 + lane];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      mma_bf16(accz[jj], as, wm ? bh[2 + jj][0] : bh[jj][0], wm ? bh[2 + jj][1] : bh[jj][1]);
      if (SPLIT)
        mma_bf16(accz[jj], as, wm ? bl[2 + jj][0] : bl[jj][0], wm ? bl[2 + jj][1] : bl[jj][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!(i ? live1 : live0)) continue;
    const int mt = wm * 2 + i;
    const uint4 ph = wv[((ks * 2) * 4 + mt) * 32 + lane];
    const uint4 pl = wv[((ks * 2 + 1) * 4 + mt) * 32 + lane];
    if (hstep) {
      const uint4 gh = gv[((ks * 2) * 4 + mt) * 32 + lane];
      const uint4 gl = gv[((ks * 2 + 1) * 4 + mt) * 32 + lane];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_bf16(accp[i][j], ph, bh[j][0], bh[j][1]);
        mma_bf16(accp[i][j], pl, bh[j][0], bh[j][1]);
        mma_bf16(accg[i][j], gh, bh[j][0], bh[j][1]);
        mma_bf16(accg[i][j], gl, bh[j][0], bh[j][1]);
        if (SPLIT) {
          mma_bf16(accp[i][j], ph, bl[j][0], bl[j][1]);
          mma_bf16(accg[i][j], gh, bl[j][0], bl[j][1]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_bf16(accg[i][j], ph, bh[j][0], bh[j][1]);
        mma_bf16(accg[i][j], pl, bh[j][0], bh[j][1]);
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
