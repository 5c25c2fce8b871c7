"""Fused, BN-folded inverted-residual block (the EfficientUnet++ decoder
hot op) on NCHW tensors.

Counterpart of ``deadtrees_tpu.ops.fused_mbconv.fused_inverted_residual_chw``.
The block runs as two hand-written CUDA kernels (``csrc/fused_ir_chw.cu``,
built at first CUDA use by ``ops/_build.py``; for bf16 x both run their
1×1 products on the tensor cores):

  pass 1:  y = act(x·W1 + b1), zero outside the image
           h = act(dw_k×k(y) + b_dw)             stored in x's dtype
           per-tile channel sums of the float32 h
  (torch, tiny):  gate = σ(cse2(relu(cse1(mean h))))  per (B, C)
  pass 2:  scse = h·gate + h·σ(h·w_sse + b_sse)
           out  = scse·W2 + b2  (+ x·Wsk + bsk, or x, or nothing)

The wrapper launches the kernels for a CUDA tensor and takes the plain
PyTorch version (:func:`fused_inverted_residual_chw_reference`, pass by
pass) only for a CPU tensor; any other device, dtype or shape it cannot
take raises. Each kernel keeps a launch count in :data:`LAUNCHES`.

Each pass is a ``torch.library`` custom op (``deadtrees::chw_pass1``,
``deadtrees::chw_pass2``; kernel 3's pair is
``deadtrees::fused_inverted_residual_pass1`` / ``_pass2`` in
``ops/fused_cell.py``), so a compiled program calls the kernel as one
opaque op and never traces into its plain version. Its schema takes the
folded parameters flat (:func:`flat`), as a list of optional tensors; the
op rebuilds :class:`FoldedBlockParams` inside. Its ``register_fake``
states the output shapes and dtypes: psum has one row per output tile of
:func:`chw_pass1_tile` on CUDA and one row on the CPU, as the plain
version sums the whole image.

BatchNorms are folded into the adjacent convs once, on load
(:func:`fold_inverted_residual`). The folded weights keep the JAX
package's orientation (kernels with the output channel last), which is
also the layout the kernels read.

:func:`fused_inverted_residual` is the counterpart of the JAX package's
NHWC variant of the block (hswish, k = 3, h in float32); it runs on the
NHWC kernel pair of ``ops/fused_cell.py``.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deadtrees_tpu_torch.ops.launches import LAUNCHES, reset_launch_counts  # noqa: F401

if TYPE_CHECKING:  # the models import the ops package; the ops import no model
    from deadtrees_tpu_torch.models.blocks import InvertedResidual

ACTIVATIONS = ("hswish", "silu")
SKIPS = ("auto", "identity", "conv", "none")


class FoldedBlockParams(NamedTuple):
    """BN-folded weights of one InvertedResidual (inference), float32;
    the ``*_packed*`` fields are the bf16 hi + lo splits that the
    tensor-core kernels read (W1 for pass 1, W2, Wsk and w_sse for pass 2:
    :func:`pack_w1`, :func:`pack_sse`; W1 in three terms for the NHWC pass
    1 with float32 h), filled by :func:`fold_inverted_residual` and
    computed by the wrappers when a hand-built tuple lacks them."""

    w1: torch.Tensor  # (C_in, C_mid) expand pointwise (folded bn)
    b1: torch.Tensor  # (C_mid,)
    dw: torch.Tensor  # (k, k, C_mid) depthwise (folded bn)
    b_dw: torch.Tensor  # (C_mid,)
    cse_w1: torch.Tensor  # (C_mid, C_se)
    cse_b1: torch.Tensor  # (C_se,)
    cse_w2: torch.Tensor  # (C_se, C_mid)
    cse_b2: torch.Tensor  # (C_mid,)
    sse_w: torch.Tensor  # (C_mid, 1)
    sse_b: torch.Tensor  # (1,)
    w2: torch.Tensor  # (C_mid, C_out) project pointwise (folded bn)
    b2: torch.Tensor  # (C_out,)
    wsk: Optional[torch.Tensor]  # (C_in, C_out) skip conv (folded bn) or None
    bsk: Optional[torch.Tensor]
    w1_packed: Optional[torch.Tensor] = None  # bf16, pack_w1(w1)
    w2_packed: Optional[torch.Tensor] = None  # bf16, pack_w1(w2)
    wsk_packed: Optional[torch.Tensor] = None  # bf16, pack_w1(wsk), or None
    sse_packed: Optional[torch.Tensor] = None  # bf16, pack_sse(sse_w)
    w1_packed3: Optional[torch.Tensor] = None  # bf16, pack_w1(w1, terms=3)


def flat(fp: FoldedBlockParams) -> List[Optional[torch.Tensor]]:
    """``fp`` as the flat tensor list of the custom ops' schema."""
    return list(fp)


# the tensor-core products' blocking (csrc/tc_expand.cuh kCmb, kKc)
PACK_MID = 64  # product rows (mid channels in pass 1, outputs in pass 2) a block
PACK_IN = 32  # input channels a chunk


def split_w1(w1: torch.Tensor, terms: int = 2) -> Tuple[torch.Tensor, ...]:
    """W1 as ``terms`` bf16 terms, each the bf16 rounding of what the
    ones before it leave: hi = bf16(W1), lo = bf16(W1 - hi) (and lo2 =
    bf16(W1 - hi - lo)). hi + lo is within about 2^-16·|W1| of W1, hi + lo
    + lo2 within about 2^-24·|W1|, so x·hi + x·lo (+ x·lo2) keeps the
    float32 product's accuracy for bf16 x."""
    rest = w1.float()
    out = []
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return tuple(out)


def pack_w1(w1: torch.Tensor, terms: int = 2) -> torch.Tensor:
    """W1 (C_in, C_mid) float32 → the bf16 operand of the tensor-core
    pass 1, in the order the product reads it, zero-padded to whole
    blocks: (ceil(C_mid/64), ceil(C_in/32), k16 step 2, term (hi, lo and,
    with ``terms=3``, lo2: :func:`split_w1`), m16 tile 4, lane 32, 8). Lane
    l = 4g + t holds the mma.m16n8k16 A fragment of its 16×16 tile of W1ᵀ:
    rows g, g+8 × columns 2t, 2t+1 in register order (row g, row g+8) for
    columns 2t.., then the same for 2t+8.. Pass 2 packs W2 (C_mid, C_out)
    and Wsk (C_in, C_out) the same way: their rows are then the output
    channels."""
    cin, cm = w1.shape
    mb, kc = -(-cm // PACK_MID), -(-cin // PACK_IN)
    wt = torch.zeros((mb * PACK_MID, kc * PACK_IN), dtype=torch.float32, device=w1.device)
    wt[:cm, :cin] = w1.float().t()
    hl = torch.stack(split_w1(wt, terms))  # (terms, M, K)
    # M = mb·64 + mt·16 + rh·8 + g; K = kc·32 + ks·16 + ch·8 + t·2 + e
    hl = hl.reshape(terms, mb, 4, 2, 8, kc, 2, 2, 4, 2)
    # -> (mb, kc, ks, term, mt, g, t, ch, rh, e)
    return hl.permute(1, 5, 6, 0, 2, 4, 8, 7, 3, 9).reshape(
        mb, kc, 2, terms, 4, 32, 8).contiguous()


def pack_sse(sse_w: torch.Tensor) -> torch.Tensor:
    """w_sse (C_mid, 1) float32 → the sSE operand of the tensor-core pass
    2: one m16 A tile a k16 step whose row 0 is hi(w_sse) and row 1
    lo(w_sse) (:func:`split_w1`), rows 2-15 zero, so that one product gives
    both halves of the logit; (ceil(C_mid/32), k16 step 2, lane 32, 8) bf16
    in the fragment order of :func:`pack_w1`."""
    cm = sse_w.shape[0]
    kc = -(-cm // PACK_IN)
    a = torch.zeros((16, kc * PACK_IN), dtype=torch.float32, device=sse_w.device)
    hi, lo = split_w1(sse_w[:, 0])
    a[0, :cm], a[1, :cm] = hi.float(), lo.float()
    # M = rh·8 + g; K = kc·32 + ks·16 + ch·8 + t·2 + e -> (kc, ks, g, t, ch, rh, e)
    a = a.reshape(2, 8, kc, 2, 2, 4, 2).permute(2, 3, 1, 5, 4, 0, 6)
    return a.reshape(kc, 2, 32, 8).to(torch.bfloat16).contiguous()


def fold_bn_into_conv(
    kernel, bn_scale, bn_bias, bn_mean, bn_var, conv_bias=None, eps=1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN(conv(x) + b0) == conv'(x) + b': scale the kernel's output
    channels (its LAST axis), b' = (b0 - mean)·s + bias."""
    s = bn_scale / torch.sqrt(bn_var + eps)
    k = kernel * s
    b0 = conv_bias if conv_bias is not None else 0.0
    return k, (b0 - bn_mean) * s + bn_bias


@torch.no_grad()
def fold_inverted_residual(block: InvertedResidual) -> FoldedBlockParams:
    """Fold one port ``InvertedResidual`` (eval-mode BatchNorms) into
    :class:`FoldedBlockParams` on the block's device."""
    seq = block.block
    if block.kernel_size != seq[3].kernel_size[0]:
        raise ValueError("inconsistent depthwise kernel size")

    def bn(m):
        return (m.weight.float(), m.bias.float(), m.running_mean.float(),
                m.running_var.float())

    def conv1x1(m):  # (O, I, 1, 1) -> (I, O): output channel last
        return m.weight[:, :, 0, 0].float().t()

    def fold(conv, norm, kernel):
        k, b = fold_bn_into_conv(kernel, *bn(norm), conv_bias=conv.bias, eps=norm.eps)
        return k.contiguous(), b.contiguous()

    w1, b1 = fold(seq[0], seq[1], conv1x1(seq[0]))
    dw, b_dw = fold(seq[3], seq[4], seq[3].weight[:, 0].float().permute(1, 2, 0))
    cse, sse = seq[6].cSE, seq[6].sSE
    w2, b2 = fold(seq[7], seq[8], conv1x1(seq[7]))
    wsk = bsk = None
    if block.skip_conv is not None:
        wsk, bsk = fold(block.skip_conv[0], block.skip_conv[1],
                        conv1x1(block.skip_conv[0]))

    def c(t):
        return t.detach().float().contiguous()

    sse_w = c(conv1x1(sse[0]))
    return FoldedBlockParams(
        w1=w1, b1=b1, dw=dw, b_dw=b_dw,
        cse_w1=c(conv1x1(cse[1])), cse_b1=c(cse[1].bias),
        cse_w2=c(conv1x1(cse[3])), cse_b2=c(cse[3].bias),
        sse_w=sse_w, sse_b=c(sse[0].bias),
        w2=w2, b2=b2, wsk=wsk, bsk=bsk, w1_packed=pack_w1(w1), w2_packed=pack_w1(w2),
        wsk_packed=None if wsk is None else pack_w1(wsk), sse_packed=pack_sse(sse_w),
        w1_packed3=pack_w1(w1, terms=3),
    )


def _act(name: str):
    return {"hswish": F.hardswish, "silu": F.silu}[name]


def _resolve_skip(fp: FoldedBlockParams, skip: str) -> str:
    if skip not in SKIPS:
        raise ValueError(f"skip={skip!r}; expected one of {SKIPS}")
    if skip == "auto":
        return "conv" if fp.wsk is not None else "identity"
    return skip


def _check(x: torch.Tensor, fp: FoldedBlockParams, activation: str, ksize: int,
           skip: str, *, nhwc: bool = False) -> str:
    """Validate the call (x NCHW, or NHWC with ``nhwc=True``); returns the
    resolved skip mode."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation={activation!r}; expected one of {ACTIVATIONS}")
    if ksize not in (3, 5):
        raise ValueError(f"ksize={ksize}; expected 3 or 5")
    if x.dim() != 4:
        layout = "(B, H, W, C)" if nhwc else "(B, C, H, W)"
        raise ValueError(f"expected x of shape {layout}, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype}; expected float32 or bfloat16")
    skip = _resolve_skip(fp, skip)
    cin = x.shape[-1] if nhwc else x.shape[1]
    cm = fp.w1.shape[1]
    cout = fp.w2.shape[1]
    expect = {
        "w1": (cin, cm), "b1": (cm,), "dw": (ksize, ksize, cm), "b_dw": (cm,),
        "cse_b2": (cm,), "sse_w": (cm, 1), "sse_b": (1,), "w2": (cm, cout),
        "b2": (cout,),
    }
    if skip == "conv":
        if fp.wsk is None:
            raise ValueError("skip='conv' needs folded skip weights (wsk)")
        expect.update(wsk=(cin, cout), bsk=(cout,))
    for name, shape in expect.items():
        got = tuple(getattr(fp, name).shape)
        if got != shape:
            raise ValueError(f"folded {name} has shape {got}, expected {shape}")
    if fp.cse_w1.shape[0] != cm or fp.cse_w2.shape != (fp.cse_w1.shape[1], cm):
        raise ValueError("folded cSE weights do not match C_mid")
    if skip == "identity" and cin != cout:
        raise ValueError(f"identity skip needs C_in == C_out, got {cin} -> {cout}")
    return skip


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------


def chw_pass1_reference(x, fp, *, activation="hswish", ksize=3):
    """Pass 1 in plain PyTorch: (h in x's dtype, (B, 1, C_mid) float32
    sums of h)."""
    act = _act(activation)
    cm = fp.w1.shape[1]
    y = act(F.conv2d(x.float(), fp.w1.t()[:, :, None, None], fp.b1))
    h = act(F.conv2d(y, fp.dw.permute(2, 0, 1)[:, None], fp.b_dw,
                     padding=ksize // 2, groups=cm))
    return h.to(x.dtype), h.sum((2, 3))[:, None, :]


def cse_gate(sums: torch.Tensor, fp: FoldedBlockParams, hw: int) -> torch.Tensor:
    """cSE gate per (B, C_mid) from the per-image channel sums of h."""
    with torch.autocast(sums.device.type, enabled=False):
        pooled = sums / hw
        z = torch.relu(pooled @ fp.cse_w1 + fp.cse_b1)
        return torch.sigmoid(z @ fp.cse_w2 + fp.cse_b2).contiguous()


def chw_pass2_reference(h, x, gate, fp, *, skip="auto"):
    """Pass 2 in plain PyTorch, reading h as stored."""
    skip = _resolve_skip(fp, skip)
    hf = h.float()
    s = torch.sigmoid(
        torch.einsum("bchw,c->bhw", hf, fp.sse_w[:, 0]) + fp.sse_b[0]
    )[:, None]
    scse = hf * gate[:, :, None, None] + hf * s
    out = F.conv2d(scse, fp.w2.t()[:, :, None, None], fp.b2)
    if skip == "conv":
        out = out + F.conv2d(x.float(), fp.wsk.t()[:, :, None, None], fp.bsk)
    elif skip == "identity":
        out = out + x.float()
    return out.to(x.dtype)


def fused_inverted_residual_chw_reference(
    x, fp, *, activation="hswish", ksize=3, skip="auto"
):
    """The whole block in plain PyTorch, with the kernels' precision:
    float32 arithmetic, h rounded to x's dtype between the passes."""
    skip = _check(x, fp, activation, ksize, skip)
    h, sums = chw_pass1_reference(x, fp, activation=activation, ksize=ksize)
    gate = cse_gate(sums.sum(1), fp, x.shape[2] * x.shape[3])
    return chw_pass2_reference(h, x, gate, fp, skip=skip)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def chw_pass1_tile(ksize: int, x_dtype: torch.dtype) -> Tuple[int, int]:
    """(rows, columns) of kernel 1's pass-1 output tile: 8 × 32 for
    bfloat16 x (the tensor-core kernel), 14 × 14 (k = 3) or 12 × 12 (k =
    5) for float32 x. ``csrc/fused_ir_chw.cu`` reports the same
    (``fused_ir_chw_tile_size``), checked when the library is bound."""
    if x_dtype == torch.bfloat16:
        return 8, 32
    side = 16 - 2 * (ksize // 2)
    return side, side


def chw_pass1_tiles(hh: int, ww: int, ksize: int, x_dtype: torch.dtype) -> int:
    """The pass 1's output tiles on an H × W image: psum's rows on CUDA."""
    th, tw = chw_pass1_tile(ksize, x_dtype)
    return -(-hh // th) * -(-ww // tw)


def bind_kernels(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``csrc/fused_ir_chw.cu`` and
    check that its pass-1 tiles are :func:`chw_pass1_tile`'s."""
    lib.fused_ir_chw_tile_size.argtypes = [_I, _I, _I]
    lib.fused_ir_chw_tile_size.restype = _I
    lib.fused_ir_chw_pass1.argtypes = [_P] * 8 + [_I] * 9 + [_P]
    lib.fused_ir_chw_pass1.restype = _I
    lib.fused_ir_chw_pass2.argtypes = [_P] * 13 + [_I] * 8 + [_P]
    lib.fused_ir_chw_pass2.restype = _I
    for ksize in (3, 5):
        for dtype in (torch.float32, torch.bfloat16):
            want = chw_pass1_tile(ksize, dtype)
            got = tuple(lib.fused_ir_chw_tile_size(ksize, int(dtype == torch.bfloat16), axis)
                        for axis in (0, 1))
            if got != want:
                raise RuntimeError(f"fused_ir_chw.cu tiles k{ksize} {dtype} as {got}, "
                                   f"chw_pass1_tile says {want}")
    return lib


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from deadtrees_tpu_torch.ops import _build

        _lib = bind_kernels(_build.load("fused_ir_chw"))
    return _lib


def _cuda_check(x: torch.Tensor, fp: FoldedBlockParams) -> None:
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} exceeds the kernel grid (65535)")
    for name, t in fp._asdict().items():
        if t is None:
            continue
        dtype = torch.bfloat16 if "_packed" in name else torch.float32
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"folded {name} must be a contiguous {dtype} tensor on {x.device}"
            )
    cin, cm = fp.w1.shape
    cout = fp.w2.shape[1]

    def blocks(rows, k, terms=2):
        return (-(-rows // PACK_MID), -(-k // PACK_IN), 2, terms, 4, 32, 8)

    for name, want, how in (("w1_packed", blocks(cm, cin), "pack_w1(w1)"),
                            ("w1_packed3", blocks(cm, cin, 3), "pack_w1(w1, terms=3)"),
                            ("w2_packed", blocks(cout, cm), "pack_w1(w2)"),
                            ("wsk_packed", blocks(cout, cin), "pack_w1(wsk)"),
                            ("sse_packed", (-(-cm // PACK_IN), 2, 32, 8), "pack_sse(sse_w)")):
        t = getattr(fp, name)
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"folded {name} has shape {tuple(t.shape)}, expected {want} "
                             f"({how})")


def _check_status(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {status}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _on_a_kernel_device(x: torch.Tensor) -> None:
    """CPU (the plain version) and CUDA (the kernel) are the ops' devices."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")


def pass1_staging(x: torch.Tensor) -> Optional[str]:
    """How the tensor-core pass 1 stages bf16 x: ``"tma"`` (W % 8 == 0 and
    x 16-byte aligned: TMA needs 16-byte row strides) or ``"plain"``;
    None for float32 x (the float32 kernel)."""
    if x.dtype != torch.bfloat16:
        return None
    return "tma" if x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0 else "plain"


def _launch_chw_pass1(x, fp, activation, ksize):
    # The TMA descriptors are encoded on the host from the tensors'
    # addresses and passed to the kernel by value (csrc/tc_expand.cuh): a
    # CUDA graph bakes them in at capture, which is right only while its
    # buffers stay where they were captured, as the CUDA-graph runtime's
    # static buffers do.
    _cuda_check(x, fp)
    lib = _kernels()
    bsz, cin, hh, ww = x.shape
    cm = fp.w1.shape[1]
    bf16 = x.dtype == torch.bfloat16
    if bf16 and fp.w1_packed is None:
        raise ValueError("bf16 x needs the folded w1_packed (pack_w1(w1))")
    tma = pass1_staging(x) == "tma"
    h = torch.empty((bsz, cm, hh, ww), dtype=x.dtype, device=x.device)
    psum = torch.empty((bsz, chw_pass1_tiles(hh, ww, ksize, x.dtype), cm),
                       dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.fused_ir_chw_pass1(
            x.data_ptr(), fp.w1.data_ptr(), _ptr(fp.w1_packed if bf16 else None),
            fp.b1.data_ptr(), fp.dw.data_ptr(), fp.b_dw.data_ptr(), h.data_ptr(),
            psum.data_ptr(), bsz, cin, cm, hh, ww, ksize, ACTIVATIONS.index(activation),
            int(bf16), int(tma), torch.cuda.current_stream().cuda_stream,
        )
    _check_status(status, "fused_ir_chw_pass1")
    LAUNCHES["fused_ir_chw_pass1"] += 1
    return h, psum


@torch.library.custom_op("deadtrees::chw_pass1", mutates_args=())
def _chw_pass1_op(x: torch.Tensor, fp: Sequence[Optional[torch.Tensor]], activation: str,
                  ksize: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1's pass 1 (the kernel on CUDA, the plain version on the CPU)."""
    fp = FoldedBlockParams(*fp)
    if x.device.type == "cpu":
        return chw_pass1_reference(x, fp, activation=activation, ksize=ksize)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch_chw_pass1(x, fp, activation, ksize)


@_chw_pass1_op.register_fake
def _(x, fp, activation, ksize):
    bsz, _, hh, ww = x.shape
    cm = FoldedBlockParams(*fp).w1.shape[1]
    tiles = 1 if x.device.type == "cpu" else chw_pass1_tiles(hh, ww, ksize, x.dtype)
    return (x.new_empty((bsz, cm, hh, ww)),
            x.new_empty((bsz, tiles, cm), dtype=torch.float32))


def chw_pass1(x, fp, *, activation="hswish", ksize=3):
    """Pass 1: (h in x's dtype, (B, n_tiles, C_mid) float32 partial sums;
    one row of whole-image sums on the CPU). A CUDA tensor launches the
    kernel; a CPU tensor takes the plain version; both through the
    ``deadtrees::chw_pass1`` op. bf16 x runs the tensor-core kernel on
    ``fp.w1_packed`` (computed here, ahead of the op, when ``fp`` lacks
    it), staged by TMA when W % 8 == 0 and x is 16-byte aligned, else by
    plain loads; float32 x runs the float32 kernel."""
    _on_a_kernel_device(x)
    if x.device.type == "cuda" and x.dtype == torch.bfloat16 and fp.w1_packed is None:
        fp = fp._replace(w1_packed=pack_w1(fp.w1))
    return torch.ops.deadtrees.chw_pass1(x, flat(fp), activation, ksize)


def pass2_staging(h: torch.Tensor, x: torch.Tensor, skip: str) -> Optional[str]:
    """How the tensor-core pass 2 stages bf16 h and x: ``"tma"`` (H·W % 8
    == 0, and h and, unless ``skip`` is "none", x 16-byte aligned: TMA
    needs 16-byte row strides) or ``"plain"``; None for float32 x (the
    float32 kernel)."""
    if x.dtype != torch.bfloat16:
        return None
    aligned = h.data_ptr() % 16 == 0 and (skip == "none" or x.data_ptr() % 16 == 0)
    return "tma" if aligned and (x.shape[-2] * x.shape[-1]) % 8 == 0 else "plain"


def pass2_operands(fp: FoldedBlockParams, skip: str):
    """(W2, w_sse, Wsk) as the tensor-core pass 2 reads them: the folded
    packed fields, computed here when ``fp`` lacks them (Wsk None unless
    ``skip`` is "conv")."""
    w2p = fp.w2_packed if fp.w2_packed is not None else pack_w1(fp.w2)
    ssep = fp.sse_packed if fp.sse_packed is not None else pack_sse(fp.sse_w)
    wskp = None
    if skip == "conv":
        wskp = fp.wsk_packed if fp.wsk_packed is not None else pack_w1(fp.wsk)
    return w2p, ssep, wskp


def with_pass2_operands(fp: FoldedBlockParams, x: torch.Tensor, skip: str) -> FoldedBlockParams:
    """``fp`` with the packed pass-2 operands a bf16 CUDA x needs filled in
    (:func:`pass2_operands`); as it is otherwise. The ops run ahead of this
    so that nothing is packed inside a captured call."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        return fp
    w2p, ssep, wskp = pass2_operands(fp, skip)
    return fp._replace(w2_packed=w2p, sse_packed=ssep,
                       wsk_packed=wskp if wskp is not None else fp.wsk_packed)


def _check_pass2_inputs(h, x, gate, cm, h_shape, h_dtypes):
    if (tuple(h.shape) != h_shape or h.dtype not in h_dtypes or not h.is_contiguous()
            or h.device != x.device):
        raise ValueError("h must be the contiguous pass-1 output for x")
    if (tuple(gate.shape) != (x.shape[0], cm) or gate.dtype != torch.float32
            or not gate.is_contiguous()):
        raise ValueError("gate must be a contiguous (B, C_mid) float32 tensor")


def _launch_chw_pass2(h, x, gate, fp, skip):
    # the TMA descriptors rely on static buffers under a CUDA graph, as in
    # _launch_chw_pass1
    _cuda_check(x, fp)
    bsz, cin, hh, ww = x.shape
    cm = fp.w1.shape[1]
    cout = fp.w2.shape[1]
    _check_pass2_inputs(h, x, gate, cm, (bsz, cm, hh, ww), (x.dtype,))
    lib = _kernels()
    out = torch.empty((bsz, cout, hh, ww), dtype=x.dtype, device=x.device)
    conv = skip == "conv"
    bf16 = x.dtype == torch.bfloat16
    w2p = ssep = wskp = None
    if bf16:
        w2p, ssep, wskp = fp.w2_packed, fp.sse_packed, fp.wsk_packed if conv else None
        if w2p is None or ssep is None or (conv and wskp is None):
            raise ValueError("bf16 x needs the folded w2_packed, sse_packed and, for a "
                             "conv skip, wsk_packed (pass2_operands)")
    with torch.cuda.device(x.device):
        status = lib.fused_ir_chw_pass2(
            h.data_ptr(), x.data_ptr(), gate.data_ptr(), fp.sse_w.data_ptr(),
            fp.sse_b.data_ptr(), fp.w2.data_ptr(), fp.b2.data_ptr(),
            _ptr(fp.wsk) if conv else None, _ptr(fp.bsk) if conv else None,
            _ptr(w2p), _ptr(ssep), _ptr(wskp),
            out.data_ptr(), bsz, cin, cm, cout, hh * ww,
            ("none", "identity", "conv").index(skip), int(bf16),
            int(pass2_staging(h, x, skip) == "tma"), torch.cuda.current_stream().cuda_stream,
        )
    _check_status(status, "fused_ir_chw_pass2")
    LAUNCHES["fused_ir_chw_pass2"] += 1
    return out


@torch.library.custom_op("deadtrees::chw_pass2", mutates_args=())
def _chw_pass2_op(h: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
                  fp: Sequence[Optional[torch.Tensor]], skip: str) -> torch.Tensor:
    """Kernel 1's pass 2 (the kernel on CUDA, the plain version on the
    CPU); ``skip`` resolved ("none", "identity" or "conv")."""
    fp = FoldedBlockParams(*fp)
    if x.device.type == "cpu":
        return chw_pass2_reference(h, x, gate, fp, skip=skip)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch_chw_pass2(h, x, gate, fp, skip)


@_chw_pass2_op.register_fake
def _(h, x, gate, fp, skip):
    bsz, _, hh, ww = x.shape
    return x.new_empty((bsz, FoldedBlockParams(*fp).w2.shape[1], hh, ww))


def chw_pass2(h, x, gate, fp, *, skip="auto"):
    """Pass 2: the block output in x's dtype, through the
    ``deadtrees::chw_pass2`` op. A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version. bf16 x runs the tensor-core kernel on
    the packed W2, w_sse and Wsk (:func:`pass2_operands`, computed here,
    ahead of the op, when ``fp`` lacks them), staged by TMA or plain loads
    (:func:`pass2_staging`); float32 x runs the float32 kernel."""
    _on_a_kernel_device(x)
    skip = _resolve_skip(fp, skip)
    fp = with_pass2_operands(fp, x, skip)
    return torch.ops.deadtrees.chw_pass2(h, x, gate, flat(fp), skip)


def fused_inverted_residual_chw_reference(
    x, fp, *, activation="hswish", ksize=3, skip="auto"
):
    """The whole block in plain PyTorch, with the kernels' precision:
    float32 arithmetic, h rounded to x's dtype between the passes."""
    skip = _check(x, fp, activation, ksize, skip)
    h, sums = chw_pass1_reference(x, fp, activation=activation, ksize=ksize)
    gate = cse_gate(sums.sum(1), fp, x.shape[2] * x.shape[3])
    return chw_pass2_reference(h, x, gate, fp, skip=skip)


def fused_inverted_residual_chw(
    x_chw: torch.Tensor,  # (B, C_in, H, W)
    fp: FoldedBlockParams,
    *,
    activation: str = "hswish",  # "hswish" (decoder) | "silu" (encoder)
    ksize: int = 3,  # depthwise kernel size (3 or 5)
    skip: str = "auto",  # "auto" | "identity" | "conv" | "none"
) -> torch.Tensor:
    """One BN-folded inverted-residual block; returns (B, C_out, H, W) in
    x's dtype (float32 or bfloat16), any H and W.

    On a CUDA tensor this launches the two kernels (or raises); on a CPU
    tensor the two passes of :func:`fused_inverted_residual_chw_reference`
    run, each inside its op."""
    skip = _check(x_chw, fp, activation, ksize, skip)
    h, psum = chw_pass1(x_chw, fp, activation=activation, ksize=ksize)
    gate = cse_gate(psum.sum(1), fp, x_chw.shape[2] * x_chw.shape[3])
    return chw_pass2(h, x_chw, gate, fp, skip=skip)


# ---------------------------------------------------------------------------
# the NHWC block with h in float32 (kernel 3)
# ---------------------------------------------------------------------------


def fused_inverted_residual_reference(x_nhwc: torch.Tensor, fp: FoldedBlockParams):
    """:func:`fused_inverted_residual` in plain PyTorch: float32
    arithmetic, h kept in float32 between the passes."""
    from deadtrees_tpu_torch.ops import fused_cell

    skip = _check(x_nhwc, fp, "hswish", 3, "auto", nhwc=True)
    h, sums = fused_cell.nhwc_pass1_reference(x_nhwc, fp, h_dtype=torch.float32)
    gate = cse_gate(sums.sum(1), fp, x_nhwc.shape[1] * x_nhwc.shape[2])
    return fused_cell.nhwc_pass2_reference(h, x_nhwc, gate, fp, skip=skip)


def fused_inverted_residual(x_nhwc: torch.Tensor, fp: FoldedBlockParams) -> torch.Tensor:
    """One BN-folded inverted-residual block on NHWC tensors, hswish and a
    3×3 depthwise conv, with h stored in float32 between the passes
    (counterpart of ``deadtrees_tpu.ops.fused_mbconv.fused_inverted_residual``);
    returns (B, H, W, C_out) in x's dtype.

    It runs on the NHWC kernel pair of ``ops/fused_cell.py``
    (``csrc/fused_ir_nhwc.cu``) with h in float32 for a CUDA tensor, and
    the passes of :func:`fused_inverted_residual_reference` for a CPU
    tensor, through the ``deadtrees::fused_inverted_residual_pass1`` /
    ``_pass2`` ops. The JAX kernel routes an identity skip through an
    ``eye(C_in, C_out)`` product; here it adds x: in float32, x·I equals x
    exactly."""
    from deadtrees_tpu_torch.ops import fused_cell

    skip = _check(x_nhwc, fp, "hswish", 3, "auto", nhwc=True)
    _on_a_kernel_device(x_nhwc)
    h, psum = fused_cell.nhwc_pass1_op(x_nhwc, fp, h_dtype=torch.float32,
                                       count="fused_inverted_residual_pass1")
    gate = cse_gate(psum.sum(1), fp, x_nhwc.shape[1] * x_nhwc.shape[2])
    return fused_cell.nhwc_pass2_op(h, x_nhwc, gate, fp, skip=skip,
                                    count="fused_inverted_residual_pass2")
