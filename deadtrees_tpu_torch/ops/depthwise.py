"""Depthwise k×k convolution on NHWC tensors.

Counterpart of ``deadtrees_tpu.ops.depthwise.depthwise_conv2d``: SAME
(k // 2) zero padding, stride 1 or 2, float32 accumulation, output in x's
dtype, the JAX package's NHWC layout and (k, k, 1, C) kernel.

Routes, as in JAX:

- ``force=None`` or ``"torch"``: the library depthwise convolution
  (``F.conv2d(groups=C)``), the JAX default ``force="xla"``;
- ``force="cuda"``: the hand-written kernel (``csrc/depthwise.cu``) on a
  CUDA tensor; it raises on any other device. It takes any odd k, stride 1
  and 2 and any H and W itself, so nothing falls back.

The kernel stages a haloed input tile in shared memory. Its tiling is
planned here, in :func:`depthwise_tile_plan`, and handed to the kernel as
arguments, so the plan is checked without a card; the C side recomputes
none of it. The wrapper adds the number of persistent blocks: as many as
fit on the card at once (the occupancy of the plan, asked of the CUDA
runtime once per plan, times the card's SM count), up to the tiles.

The plain PyTorch version of the kernel is :func:`depthwise_conv2d_reference`
(the k² shifted multiply-adds in float32, the JAX kernel's own
arithmetic). The kernel is the ``torch.library`` custom op
``deadtrees::depthwise_conv2d`` (the kernel on CUDA, the plain version on
the CPU), opaque to the compiler.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from deadtrees_tpu_torch.ops.launches import LAUNCHES

FORCES = (None, "torch", "cuda")

DW_THREADS = 256  # most threads a block
DW_PIXELS = 4  # output columns a thread (kP in csrc/depthwise.cu)
DW_SMEM_BUDGET = 96 * 1024  # bytes a block, both stages (measured best of 64-128 KB)
DW_SMEM_MAX = 232448  # the most dynamic shared memory a block may take (H100)
DW_BLOCKS_PER_SM = 2  # tiles the plan asks for per SM, where the shape allows
H100_SMS = 132  # the plan's SM count when the caller gives none

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


class DwPlan(NamedTuple):
    """How the kernel tiles one call. A tile is ``th`` × ``tw`` output
    pixels and ``cbv`` × ``v`` channels; a block stages a tile's haloed
    input in shared memory (two stages: the next tile's copies overlap this
    one's arithmetic) and a thread computes ``v`` channels of
    ``DW_PIXELS`` neighbouring output columns in ``rows`` output rows."""

    vector: bool  # 16-byte asynchronous copies (else plain element loads)
    v: int  # channels a thread
    cbv: int  # channel vectors a block
    th: int  # output rows a tile
    tw: int  # output columns a tile
    rows: int  # output rows a thread
    threads: int
    smem_bytes: int  # both stages
    grid: Tuple[int, int, int]  # tiles: (column tiles × channel chunks, row tiles, batch)

    @property
    def tiles(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _smem_bytes(th, tw, cb, k, stride, itemsize) -> int:
    """Two stages of (haloed input tile, padded to 16 bytes; float32
    weights of the chunk), as csrc/depthwise.cu lays them out."""
    ih, iw = (th - 1) * stride + k, (tw - 1) * stride + k
    staged = -(-ih * iw * cb * itemsize // 16) * 16
    return 2 * (staged + k * k * cb * 4)


@functools.lru_cache(maxsize=None)
def depthwise_tile_plan(height: int, width: int, channels: int, k: int, stride: int,
                        itemsize: int, *, batch: int = 1, vector: bool = True,
                        sms: int = H100_SMS) -> DwPlan:
    """The kernel's tiling for x (batch, height, width, channels).

    ``vector`` asks for the 16-byte staging; it is granted when a channel
    run of 16 bytes divides ``channels`` (the caller also needs x 16-byte
    aligned). The channel chunk is 8 channel vectors (32 channels on the
    plain path: a pixel's chunk is then 128 bytes, read without bank
    conflicts) where that leaves at most an eighth of the last chunk's
    vectors idle, else the largest divisor of the channel vectors up to 8,
    unless that divisor is under half of it. The tile is the one that stages the fewest input
    pixels per output pixel (halo and ragged edges counted), among those
    within the shared-memory budget, with at least 128 threads and
    :data:`DW_BLOCKS_PER_SM` tiles for each of the card's ``sms`` SMs
    where such tiles exist."""
    ho, wo = (height - 1) // stride + 1, (width - 1) // stride + 1
    v = 16 // itemsize
    vector = vector and channels % v == 0
    if not vector:
        v = 1
    cv = channels // v
    limit = min(cv, 8 if vector else 32)
    best = max(d for d in range(1, limit + 1) if cv % d == 0)
    ragged = -(-cv // limit) * limit - cv  # idle vectors of a full-width chunking
    cbv = limit if ragged <= cv // 8 or 2 * best < limit else best
    chunks = -(-cv // cbv)
    groups = sorted({1 << i for i in range(9)} | {-(-wo // DW_PIXELS)})
    cands = []
    for g in groups:
        if g * cbv > DW_THREADS or g > -(-wo // DW_PIXELS):
            continue
        tw = g * DW_PIXELS
        for r in (1 << i for i in range(9)):
            threads = cbv * g * r
            if threads > DW_THREADS or r > ho:
                continue
            for rows in (1, 2, 4, 8):
                th = r * rows
                if th > max(ho, r):
                    continue
                smem = _smem_bytes(th, tw, cbv * v, k, stride, itemsize)
                if smem > DW_SMEM_BUDGET:
                    continue
                ih, iw = (th - 1) * stride + k, (tw - 1) * stride + k
                rt, ct = -(-ho // th), -(-wo // tw)
                cost = ih * iw * rt * ct / (ho * wo)
                blocks = ct * chunks * rt * batch
                cands.append((cost, -threads, th, tw, rows, threads, smem, blocks, ct, rt))
    if not cands:
        raise ValueError(f"no depthwise tile fits {DW_SMEM_BUDGET} bytes at "
                         f"{(height, width, channels)}, k={k}")
    most_threads = max(c[5] for c in cands)
    cands = [c for c in cands if c[5] >= min(128, most_threads)]
    most_blocks = max(c[7] for c in cands)
    cands = [c for c in cands if c[7] >= min(DW_BLOCKS_PER_SM * sms, most_blocks)]
    _, _, th, tw, rows, threads, smem, _, ct, rt = min(cands)
    return DwPlan(vector, v, cbv, th, tw, rows, threads, smem, (ct * chunks, rt, batch))


def _check(x: torch.Tensor, kernel: torch.Tensor, strides: int) -> int:
    """Validate the call; returns k."""
    if x.dim() != 4:
        raise ValueError(f"expected x of shape (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype}; expected float32 or bfloat16")
    k = kernel.shape[0]
    if tuple(kernel.shape) != (k, k, 1, x.shape[-1]) or k % 2 == 0:
        raise ValueError(
            f"kernel shape {tuple(kernel.shape)}; expected (k, k, 1, {x.shape[-1]}), k odd"
        )
    if strides not in (1, 2):
        raise ValueError(f"strides={strides}; expected 1 or 2")
    return k


def depthwise_conv2d_reference(x: torch.Tensor, kernel: torch.Tensor, *,
                               strides: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: k² shifted multiply-adds of
    the zero-padded float32 input, taps in row-major order; output in x's
    dtype."""
    k = _check(x, kernel, strides)
    p = k // 2
    _, hh, ww, _ = x.shape
    ho, wo = (hh - 1) // strides + 1, (ww - 1) // strides + 1
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    w = kernel.float()
    acc = None
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, dy: dy + strides * (ho - 1) + 1: strides,
                     dx: dx + strides * (wo - 1) + 1: strides] * w[dy, dx, 0]
            acc = tap if acc is None else acc + tap
    return acc.to(x.dtype)


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from deadtrees_tpu_torch.ops import _build

        lib = _build.load("depthwise")
        lib.depthwise_nhwc.argtypes = [_P] * 3 + [_I] * 15 + [_P]
        lib.depthwise_nhwc.restype = _I
        lib.depthwise_blocks_per_sm.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
        lib.depthwise_blocks_per_sm.restype = _I
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device: int, bf16: bool, vector: bool, k: int, strides: int, threads: int,
                   smem_bytes: int) -> int:
    """Blocks of ``threads`` threads and ``smem_bytes`` of shared memory
    that fit on one SM at once (the CUDA runtime's occupancy of the kernel
    instantiation), asked once for each."""
    per_sm = _I(0)
    status = _kernels().depthwise_blocks_per_sm(int(bf16), int(vector), k, strides, threads,
                                                smem_bytes, ctypes.byref(per_sm))
    if status != 0:
        raise RuntimeError(f"depthwise occupancy query failed: CUDA error {status}")
    return max(per_sm.value, 1)


@torch.library.custom_op("deadtrees::depthwise_conv2d", mutates_args=())
def _depthwise_op(x: torch.Tensor, kernel: torch.Tensor, strides: int) -> torch.Tensor:
    """Kernel 5 (the kernel on CUDA, the plain version on the CPU)."""
    if x.device.type == "cpu":
        return depthwise_conv2d_reference(x, kernel, strides=strides)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch(x, kernel, kernel.shape[0], strides)


@_depthwise_op.register_fake
def _(x, kernel, strides):
    bsz, hh, ww, c = x.shape
    return x.new_empty((bsz, (hh - 1) // strides + 1, (ww - 1) // strides + 1, c))


def _launch(x: torch.Tensor, kernel: torch.Tensor, k: int, strides: int) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    if kernel.device != x.device:
        raise ValueError(f"kernel must be on {x.device}")
    bsz, hh, ww, c = x.shape
    w = kernel.reshape(k, k, c).float().contiguous()
    out = torch.empty((bsz, (hh - 1) // strides + 1, (ww - 1) // strides + 1, c),
                      dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if w.data_ptr() % 16:
        w = w.clone()  # the 16-byte weight copies need an aligned start
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    bf16 = x.dtype == torch.bfloat16
    plan = depthwise_tile_plan(hh, ww, c, k, strides, x.element_size(), batch=bsz,
                               vector=x.data_ptr() % 16 == 0, sms=_sm_count(device))
    if plan.tiles >= 2**31:
        raise ValueError(f"{plan.tiles} tiles exceed the kernel's tile index")
    lib = _kernels()
    with torch.cuda.device(device):
        per_sm = _blocks_per_sm(device, bf16, plan.vector, k, strides, plan.threads,
                                plan.smem_bytes)
        blocks = min(plan.tiles, per_sm * _sm_count(device))
        status = lib.depthwise_nhwc(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), bsz, hh, ww, c, k, strides,
            int(bf16), int(plan.vector), plan.cbv, plan.th, plan.tw, plan.rows,
            plan.threads, plan.smem_bytes, blocks, torch.cuda.current_stream().cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"depthwise_nhwc launch failed: CUDA error {status}")
    LAUNCHES["depthwise_conv2d"] += 1
    return out


def depthwise_conv2d(
    x: torch.Tensor,  # (B, H, W, C)
    kernel: torch.Tensor,  # (k, k, 1, C) flax/HWIO depthwise kernel
    *,
    strides: int = 1,
    force: Optional[str] = None,  # None / "torch" (library conv) | "cuda"
) -> torch.Tensor:
    """Depthwise conv with k // 2 zero padding; (B, Ho, Wo, C) in x's
    dtype, Ho = (H - 1) // strides + 1 (likewise Wo)."""
    if force not in FORCES:
        raise ValueError(f"force={force!r}; expected one of {FORCES}")
    k = _check(x, kernel, strides)
    if force == "cuda":
        if x.device.type != "cuda":
            raise ValueError(f"force='cuda': no kernel for device {x.device}")
        return torch.ops.deadtrees.depthwise_conv2d(x, kernel, strides)
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)  # (C, 1, k, k)
    out = F.conv2d(x.permute(0, 3, 1, 2), w, stride=strides, padding=k // 2,
                   groups=x.shape[-1])
    return out.permute(0, 2, 3, 1)
