"""Fused, BN-folded inverted-residual block on NHWC tensors: the fat
decoder cells (C_in ≥ 64) of the ``fused_decoder="nhwc"`` route.

Counterpart of ``deadtrees_tpu.ops.fused_cell.fused_ir_fat``. The block
runs as two hand-written CUDA kernels (``csrc/fused_ir_nhwc.cu``, built at
first CUDA use by ``ops/_build.py``; for bf16 x both run their 1×1
products on the tensor cores):

  pass 1:  y = act(x·W1 + b1), zero outside the image
           h = act(dw_k×k(y) + b_dw)             stored in x's dtype
           per-tile channel sums of the float32 h
  (torch, tiny):  gate = σ(cse2(relu(cse1(mean h))))  per (B, C)
  pass 2:  scse = h·gate + h·σ(h·w_sse + b_sse)
           out  = scse·W2 + b2  (+ x·Wsk + bsk, or x, or nothing)

The same kernel pair, with h stored in float32, backs
``fused_mbconv.fused_inverted_residual`` (kernel 3); :func:`nhwc_pass1`
and :func:`nhwc_pass2` take the launch-count name of their caller.

The wrapper launches the kernels for a CUDA tensor and takes the plain
PyTorch version (:func:`fused_ir_fat_reference`: float32 arithmetic, h
rounded to x's dtype between the passes) only for a CPU tensor; any other
device, dtype or shape it cannot take raises.

Each pass is a ``torch.library`` custom op, opaque to the compiler, with
the folded parameters flat in its schema (``fused_mbconv.flat``):
``deadtrees::fused_ir_fat_pass1`` / ``_pass2`` (kernel 2) and
``deadtrees::fused_inverted_residual_pass1`` / ``_pass2`` (kernel 3,
the same kernels with h in float32), each raising its own launch count.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deadtrees_tpu_torch.ops.fused_mbconv import (
    ACTIVATIONS,
    FoldedBlockParams,
    _act,
    _check,
    _check_pass2_inputs,
    _check_status,
    _cuda_check,
    _I,
    _on_a_kernel_device,
    _P,
    _ptr,
    _resolve_skip,
    cse_gate,
    flat,
    pack_w1,
    with_pass2_operands,
)
from deadtrees_tpu_torch.ops.launches import LAUNCHES

_lib = None


def _pick_th(hh: int, ww: int, cin: int, cmid: int, halo: int) -> Optional[int]:
    """The JAX kernel's H-tile choice (``deadtrees_tpu.ops.fused_cell._pick_th``):
    the largest of 64..4 rows dividing H whose TPU VMEM estimate fits 10 MB.
    The port uses it only as the routing predicate of ``_one_block_nhwc``,
    so that the same blocks take the fat-cell kernels as in JAX."""
    budget = 10 * 1024 * 1024
    for th in (64, 32, 16, 8, 4):
        if hh % th != 0:
            continue
        rows = th + 2 * halo
        est = 4 * ww * (rows * cin + 2 * rows * cmid + 2 * th * cmid)
        if est <= budget:
            return th
    return None


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------


def nhwc_pass1_reference(x, fp, *, activation="hswish", ksize=3, h_dtype=None):
    """Pass 1 in plain PyTorch: (h in ``h_dtype`` (default x's dtype),
    (B, 1, C_mid) float32 sums of h)."""
    act = _act(activation)
    cm = fp.w1.shape[1]
    y = act(x.float() @ fp.w1 + fp.b1)
    h = act(F.conv2d(y.permute(0, 3, 1, 2), fp.dw.permute(2, 0, 1)[:, None], fp.b_dw,
                     padding=ksize // 2, groups=cm)).permute(0, 2, 3, 1)
    return h.to(h_dtype or x.dtype), h.sum((1, 2))[:, None, :]


def nhwc_pass2_reference(h, x, gate, fp, *, skip="auto"):
    """Pass 2 in plain PyTorch, reading h as stored; output in x's dtype."""
    skip = _resolve_skip(fp, skip)
    hf = h.float()
    s = torch.sigmoid(hf @ fp.sse_w + fp.sse_b)
    scse = hf * gate[:, None, None, :] + hf * s
    out = scse @ fp.w2 + fp.b2
    if skip == "conv":
        out = out + (x.float() @ fp.wsk + fp.bsk)
    elif skip == "identity":
        out = out + x.float()
    return out.to(x.dtype)


def fused_ir_fat_reference(x, fp, *, activation="hswish", ksize=3, skip="auto"):
    """The whole block in plain PyTorch, with the kernels' precision:
    float32 arithmetic, h rounded to x's dtype between the passes."""
    skip = _check(x, fp, activation, ksize, skip, nhwc=True)
    h, sums = nhwc_pass1_reference(x, fp, activation=activation, ksize=ksize)
    gate = cse_gate(sums.sum(1), fp, x.shape[1] * x.shape[2])
    return nhwc_pass2_reference(h, x, gate, fp, skip=skip)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def pass1_tile(ksize: int, x_dtype: torch.dtype) -> Tuple[int, int]:
    """(rows, columns) of the NHWC pass 1's output tile: 8 × 32 for
    bfloat16 x (the tensor-core kernel), 14 × 14 (k = 3) or 12 × 12 (k =
    5) for float32 x. ``csrc/fused_ir_nhwc.cu`` reports the same
    (``fused_ir_nhwc_tile_size``), checked when the library loads."""
    if x_dtype == torch.bfloat16:
        return 8, 32
    side = 16 - 2 * (ksize // 2)
    return side, side


def pass1_tiles(hh: int, ww: int, ksize: int, x_dtype: torch.dtype) -> int:
    """The pass 1's output tiles on an H × W image: psum's rows."""
    th, tw = pass1_tile(ksize, x_dtype)
    return -(-hh // th) * -(-ww // tw)


def pass1_staging(x: torch.Tensor) -> Optional[str]:
    """How the tensor-core pass 1 stages bf16 x: ``"tma"`` (C_in % 8 == 0
    and x 16-byte aligned: TMA needs 16-byte pixel strides) or
    ``"plain"``; None for float32 x (the float32 kernel)."""
    if x.dtype != torch.bfloat16:
        return None
    return "tma" if x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0 else "plain"


def bind_kernels(lib):
    """Declare the C interface of a build of ``csrc/fused_ir_nhwc.cu``
    and check that its pass-1 tiles are :func:`pass1_tile`'s."""
    lib.fused_ir_nhwc_tile_size.argtypes = [_I, _I, _I]
    lib.fused_ir_nhwc_tile_size.restype = _I
    lib.fused_ir_nhwc_pass1.argtypes = [_P] * 8 + [_I] * 10 + [_P]
    lib.fused_ir_nhwc_pass1.restype = _I
    lib.fused_ir_nhwc_pass2.argtypes = [_P] * 13 + [_I] * 9 + [_P]
    lib.fused_ir_nhwc_pass2.restype = _I
    for ksize in (3, 5):
        for dtype in (torch.float32, torch.bfloat16):
            want = pass1_tile(ksize, dtype)
            got = tuple(lib.fused_ir_nhwc_tile_size(ksize, int(dtype == torch.bfloat16), axis)
                        for axis in (0, 1))
            if got != want:
                raise RuntimeError(f"fused_ir_nhwc.cu tiles k{ksize} {dtype} as {got}, "
                                   f"pass1_tile says {want}")
    return lib


def _kernels():
    global _lib
    if _lib is None:
        from deadtrees_tpu_torch.ops import _build

        _lib = bind_kernels(_build.load("fused_ir_nhwc"))
    return _lib


def _on_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")


def _launch_nhwc_pass1(x, fp, activation, ksize, h_dtype, count):
    # The TMA descriptors are encoded on the host from the tensors'
    # addresses and passed to the kernel by value (csrc/tc_expand.cuh): a
    # CUDA graph bakes them in at capture, which is right only while its
    # buffers stay where they were captured, as the CUDA-graph runtime's
    # static buffers do.
    _cuda_check(x, fp)
    lib = _kernels()
    bsz, hh, ww, cin = x.shape
    cm = fp.w1.shape[1]
    bf16 = x.dtype == torch.bfloat16
    packed = None
    if bf16:
        packed = fp.w1_packed3 if h_dtype == torch.float32 else fp.w1_packed
        if packed is None:
            raise ValueError("bf16 x needs the folded w1_packed (h in bf16) or w1_packed3 "
                             "(h in float32)")
    h = torch.empty((bsz, hh, ww, cm), dtype=h_dtype, device=x.device)
    psum = torch.empty((bsz, pass1_tiles(hh, ww, ksize, x.dtype), cm), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        status = lib.fused_ir_nhwc_pass1(
            x.data_ptr(), fp.w1.data_ptr(), _ptr(packed), fp.b1.data_ptr(),
            fp.dw.data_ptr(), fp.b_dw.data_ptr(), h.data_ptr(), psum.data_ptr(),
            bsz, cin, cm, hh, ww, ksize, ACTIVATIONS.index(activation),
            int(bf16), int(h_dtype == torch.bfloat16), int(pass1_staging(x) == "tma"),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_status(status, "fused_ir_nhwc_pass1")
    LAUNCHES[count] += 1
    return h, psum


def _launch_nhwc_pass2(h, x, gate, fp, skip, count):
    # the TMA descriptors rely on static buffers under a CUDA graph, as in
    # _launch_nhwc_pass1
    _cuda_check(x, fp)
    bsz, hh, ww, cin = x.shape
    cm = fp.w1.shape[1]
    cout = fp.w2.shape[1]
    _check_pass2_inputs(h, x, gate, cm, (bsz, hh, ww, cm), (x.dtype, torch.float32))
    lib = _kernels()
    out = torch.empty((bsz, hh, ww, cout), dtype=x.dtype, device=x.device)
    conv = skip == "conv"
    bf16 = x.dtype == torch.bfloat16
    w2p = ssep = wskp = None
    if bf16:
        w2p, ssep, wskp = fp.w2_packed, fp.sse_packed, fp.wsk_packed if conv else None
        if w2p is None or ssep is None or (conv and wskp is None):
            raise ValueError("bf16 x needs the folded w2_packed, sse_packed and, for a "
                             "conv skip, wsk_packed (pass2_operands)")
    with torch.cuda.device(x.device):
        status = lib.fused_ir_nhwc_pass2(
            h.data_ptr(), x.data_ptr(), gate.data_ptr(), fp.sse_w.data_ptr(),
            fp.sse_b.data_ptr(), fp.w2.data_ptr(), fp.b2.data_ptr(),
            _ptr(fp.wsk) if conv else None, _ptr(fp.bsk) if conv else None,
            _ptr(w2p), _ptr(ssep), _ptr(wskp),
            out.data_ptr(), bsz, cin, cm, cout, hh * ww,
            ("none", "identity", "conv").index(skip), int(bf16),
            int(h.dtype == torch.bfloat16), int(nhwc_pass2_staging(h, x, skip) == "tma"),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_status(status, "fused_ir_nhwc_pass2")
    LAUNCHES[count] += 1
    return out


def _pass1_op(name: str):
    """The custom op ``deadtrees::<name>``: the NHWC pass 1 raising the
    launch count ``name`` on CUDA, its plain version on the CPU."""

    @torch.library.custom_op(f"deadtrees::{name}", mutates_args=())
    def op(x: torch.Tensor, fp: Sequence[Optional[torch.Tensor]], activation: str,
           ksize: int, h_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        fp = FoldedBlockParams(*fp)
        if x.device.type == "cpu":
            return nhwc_pass1_reference(x, fp, activation=activation, ksize=ksize,
                                        h_dtype=h_dtype)
        _on_cuda(x)
        return _launch_nhwc_pass1(x, fp, activation, ksize, h_dtype, name)

    @op.register_fake
    def _(x, fp, activation, ksize, h_dtype):
        bsz, hh, ww, _ = x.shape
        cm = FoldedBlockParams(*fp).w1.shape[1]
        tiles = 1 if x.device.type == "cpu" else pass1_tiles(hh, ww, ksize, x.dtype)
        return (x.new_empty((bsz, hh, ww, cm), dtype=h_dtype),
                x.new_empty((bsz, tiles, cm), dtype=torch.float32))

    return op


def _pass2_op(name: str):
    """The custom op ``deadtrees::<name>``: the NHWC pass 2 raising the
    launch count ``name`` on CUDA, its plain version on the CPU; ``skip``
    resolved ("none", "identity" or "conv")."""

    @torch.library.custom_op(f"deadtrees::{name}", mutates_args=())
    def op(h: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
           fp: Sequence[Optional[torch.Tensor]], skip: str) -> torch.Tensor:
        fp = FoldedBlockParams(*fp)
        if x.device.type == "cpu":
            return nhwc_pass2_reference(h, x, gate, fp, skip=skip)
        _on_cuda(x)
        return _launch_nhwc_pass2(h, x, gate, fp, skip, name)

    @op.register_fake
    def _(h, x, gate, fp, skip):
        bsz, hh, ww, _ = x.shape
        return x.new_empty((bsz, hh, ww, FoldedBlockParams(*fp).w2.shape[1]))

    return op


# kernel 2 (h in x's dtype) and kernel 3 (h in float32): one pair of
# kernels, an op of its own each, keyed by its launch count
PASS1_OPS = {name: _pass1_op(name)
             for name in ("fused_ir_fat_pass1", "fused_inverted_residual_pass1")}
PASS2_OPS = {name: _pass2_op(name)
             for name in ("fused_ir_fat_pass2", "fused_inverted_residual_pass2")}


def nhwc_pass1_op(x, fp, *, activation="hswish", ksize=3, h_dtype=None,
                  count="fused_ir_fat_pass1"):
    """The NHWC pass 1 through its custom op (``count`` names it): the
    kernel on CUDA, :func:`nhwc_pass1_reference` on the CPU. The packed W1
    that a bf16 CUDA x needs is computed here, ahead of the op, when ``fp``
    lacks it."""
    _on_a_kernel_device(x)
    h_dtype = h_dtype or x.dtype
    if (x.dtype, h_dtype) == (torch.float32, torch.bfloat16):
        raise ValueError("h in bfloat16 needs x in bfloat16")
    if h_dtype != x.dtype and (activation != "hswish" or ksize != 3):
        raise ValueError("h in float32 for bfloat16 x is built for hswish, k = 3 only")
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        if h_dtype == torch.float32 and fp.w1_packed3 is None:
            fp = fp._replace(w1_packed3=pack_w1(fp.w1, terms=3))
        elif h_dtype == torch.bfloat16 and fp.w1_packed is None:
            fp = fp._replace(w1_packed=pack_w1(fp.w1))
    return PASS1_OPS[count](x, flat(fp), activation, ksize, h_dtype)


def nhwc_pass1(x, fp, *, activation="hswish", ksize=3, h_dtype=None,
               count="fused_ir_fat_pass1"):
    """Pass 1 on the card: (h in ``h_dtype`` (default x's dtype),
    (B, n_tiles, C_mid) float32 partial sums, one row per
    :func:`pass1_tile` tile). bf16 x runs the tensor-core kernel on
    ``fp.w1_packed`` (h in bf16) or ``fp.w1_packed3`` (h in float32: W1 in
    three bf16 terms), computed here when ``fp`` lacks it, staged as
    :func:`pass1_staging` says; float32 x runs the float32 kernel. Raises
    for a tensor that is not on a CUDA device; ``count`` names the launch
    count it raises (and the op: kernel 2's or kernel 3's)."""
    _on_cuda(x)
    return nhwc_pass1_op(x, fp, activation=activation, ksize=ksize, h_dtype=h_dtype,
                         count=count)


def nhwc_pass2_staging(h: torch.Tensor, x: torch.Tensor, skip: str) -> Optional[str]:
    """How the tensor-core pass 2 stages h (bf16 or float32) and bf16 x:
    ``"tma"`` (C_mid % 8 == 0 and h 16-byte aligned, and unless ``skip``
    (resolved) is "none" C_in % 8 == 0 and x 16-byte aligned: TMA needs
    16-byte pixel strides, and the identity skip reads x 16 bytes a load)
    or ``"plain"``; None for float32 x (the float32 kernel)."""
    if x.dtype != torch.bfloat16:
        return None
    ok = h.shape[-1] % 8 == 0 and h.data_ptr() % 16 == 0
    if skip != "none":
        ok = ok and x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0
    return "tma" if ok else "plain"


def nhwc_pass2_op(h, x, gate, fp, *, skip="auto", count="fused_ir_fat_pass2"):
    """The NHWC pass 2 through its custom op (``count`` names it): the
    kernel on CUDA, :func:`nhwc_pass2_reference` on the CPU. The packed
    operands that a bf16 CUDA x needs are computed here, ahead of the op,
    when ``fp`` lacks them."""
    _on_a_kernel_device(x)
    skip = _resolve_skip(fp, skip)
    fp = with_pass2_operands(fp, x, skip)
    return PASS2_OPS[count](h, x, gate, flat(fp), skip)


def nhwc_pass2(h, x, gate, fp, *, skip="auto", count="fused_ir_fat_pass2"):
    """Pass 2 on the card: the block output in x's dtype, reading h in the
    type pass 1 stored it. bf16 x runs the tensor-core kernel on the packed
    W2, w_sse and Wsk (``fused_mbconv.pass2_operands``), with h in bf16
    (kernel 2) or float32 (kernel 3, split into bf16 hi + lo in the
    kernel), staged as :func:`nhwc_pass2_staging` says; float32 x runs the
    float32 kernel. Raises for a tensor that is not on a CUDA device;
    ``count`` names the launch count it raises (and the op)."""
    _on_cuda(x)
    return nhwc_pass2_op(h, x, gate, fp, skip=skip, count=count)


def fused_ir_fat(
    x_nhwc: torch.Tensor,  # (B, H, W, C_in)
    fp: FoldedBlockParams,
    *,
    activation: str = "hswish",  # "hswish" (decoder) | "silu"
    ksize: int = 3,  # depthwise kernel size (3 or 5)
    skip: str = "auto",  # "auto" | "identity" | "conv" | "none"
) -> torch.Tensor:
    """One BN-folded inverted-residual block on NHWC tensors; returns
    (B, H, W, C_out) in x's dtype (float32 or bfloat16), any H and W.

    On a CUDA tensor this launches the two kernels (or raises); on a CPU
    tensor the two passes of :func:`fused_ir_fat_reference` run, each
    inside its op."""
    skip = _check(x_nhwc, fp, activation, ksize, skip, nhwc=True)
    h, psum = nhwc_pass1_op(x_nhwc, fp, activation=activation, ksize=ksize)
    gate = cse_gate(psum.sum(1), fp, x_nhwc.shape[1] * x_nhwc.shape[2])
    return nhwc_pass2_op(h, x_nhwc, gate, fp, skip=skip)
