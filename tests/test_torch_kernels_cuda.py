"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and ``nvcc``; elsewhere they skip. The file
imports neither JAX nor the JAX package, so it also runs on a machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Bars: float32 max error < 1e-3·max(1, max|ref|) (CUDA-core float32 sums
in another order); bfloat16 < 2e-2·max(1, max|ref|) (h and the output are
rounded to bfloat16, and a rounding may land on the other side of a tie).
The augment kernel rounds as its plain version does: bit-equal; so do
the EDT's two kernels with their plain version on the card (every bit,
the sign of a zero included; torch's float32 sqrt on the CPU is not
correctly rounded, one ulp off on some integers). The
depthwise kernel sums the taps in the plain version's order: float32
within 1e-5·max(1, max|ref|), bfloat16 within one rounding of the output.
The tensor-core NHWC pass 2 keeps its sums at float32 level and rounds
out to bfloat16 once, as its plain version does: within one bf16 ulp of
max(1, max|ref|) (ULP_BAR). Kernel 3's float32 h from the tensor-core pass
1 within K3_H_BAR·max(1, max|ref|) (the tensor cores' float32 sums).
"""

import numpy as np
import pytest
import torch

from deadtrees_tpu_torch.losses import functional as tfn
from deadtrees_tpu_torch.ops import augment as aug
from deadtrees_tpu_torch.ops import depthwise as dwm
from deadtrees_tpu_torch.ops import fused_cell as fc
from deadtrees_tpu_torch.ops import fused_mbconv as fm
from deadtrees_tpu_torch.ops.launches import LAUNCHES, reset_launch_counts

pytestmark = pytest.mark.cuda

BAR = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
ULP_BAR = 2.0 ** -7  # one bf16 ulp (8 significant bits) at max(1, max|ref|)
# kernel 3's float32 h: at most 1.7e-6 of max(1, max|ref|) at the flagship's
# 14 fat shapes (chip_smoke.py phase 9, tools/time_passes.py; PERF.md) and
# 5.6e-7 in the h-f32 cases below; a pass 1 that multiplies W1 in two bf16
# terms and sums over C_in in the mma's own accumulator reads 3.1e-6 to 6.8e-6
# in those cases
K3_H_BAR = 2.5e-6


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, see the module docstring)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _folded(cin, cout, ksize, conv_skip, gen, device):
    def n(*shape, s=0.2):
        return (torch.randn(shape, generator=gen) * s).to(device)

    return fm.FoldedBlockParams(
        w1=n(cin, cin, s=cin ** -0.5), b1=n(cin, s=0.1),
        dw=n(ksize, ksize, cin), b_dw=n(cin, s=0.1),
        cse_w1=n(cin, 8), cse_b1=n(8, s=0.1), cse_w2=n(8, cin), cse_b2=n(cin, s=0.1),
        sse_w=n(cin, 1, s=cin ** -0.5), sse_b=n(1, s=0.1),
        w2=n(cin, cout, s=cin ** -0.5), b2=n(cout, s=0.1),
        wsk=n(cin, cout, s=cin ** -0.5) if conv_skip else None,
        bsk=n(cout, s=0.1) if conv_skip else None,
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "cin,cout,hh,ww,ksize,act,skip",
    [
        (48, 32, 40, 72, 3, "hswish", "auto"),  # ragged rows, projected skip; bf16: TMA
        (32, 32, 33, 17, 3, "hswish", "auto"),  # ragged, identity skip; bf16: plain loads
        (128, 40, 45, 70, 5, "silu", "none"),  # bf16: plain loads, two chunks of 64 mid
        (24, 40, 45, 70, 5, "hswish", "conv"),  # fewer than 32 input channels
        (64, 64, 16, 16, 3, "silu", "identity"),
        (688, 256, 32, 32, 3, "hswish", "conv"),  # the flagship's widest cell; bf16: TMA
        (72, 72, 37, 40, 5, "silu", "auto"),  # k5, ragged rows; bf16: TMA, C_in % 32 != 0
        (96, 48, 20, 44, 3, "hswish", "auto"),  # W % 8 != 0; bf16: plain loads, 12 of 32 last
        (96, 48, 20, 56, 3, "hswish", "auto"),  # W % 32 != 0; bf16: TMA, 24 of 32 last columns
    ],
)
def test_kernel_matches_plain(card, dtype, cin, cout, hh, ww, ksize, act, skip):
    """Both passes against the plain block; bf16 pass 1 stages x by TMA
    where W % 8 == 0 and by plain loads elsewhere."""
    gen = torch.Generator().manual_seed(cin * 1000 + hh)
    conv = skip == "conv" or (skip == "auto" and cin != cout)
    fp = _folded(cin, cout, ksize, conv, gen, card)
    x = torch.randn((2, cin, hh, ww), generator=gen).to(card, dtype)
    want_stage = None if dtype == torch.float32 else ("tma" if ww % 8 == 0 else "plain")
    assert fm.pass1_staging(x) == want_stage
    ref = fm.fused_inverted_residual_chw_reference(
        x, fp, activation=act, ksize=ksize, skip=skip)
    reset_launch_counts()
    got = fm.fused_inverted_residual_chw(x, fp, activation=act, ksize=ksize, skip=skip)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_ir_chw_pass1"] == 1 and LAUNCHES["fused_ir_chw_pass2"] == 1
    assert got.dtype == dtype and got.shape == (2, cout, hh, ww)
    err = float((got.float() - ref.float()).abs().max())
    assert err < BAR[dtype] * max(1.0, float(ref.float().abs().max())), err
    h_ref, s_ref = fm.chw_pass1_reference(x, fp, activation=act, ksize=ksize)
    h, psum = fm.chw_pass1(x, fp, activation=act, ksize=ksize)
    torch.cuda.synchronize()
    assert float((h.float() - h_ref.float()).abs().max()) < BAR[dtype] * max(
        1.0, float(h_ref.float().abs().max()))
    hw = hh * ww
    assert float((psum.sum(1) - s_ref.sum(1)).abs().max()) / hw < BAR[dtype] * max(
        1.0, float(s_ref.abs().max()) / hw)


def test_bf16_pass1_on_a_misaligned_view_and_without_packed_weights(card):
    """A view one element into its storage is not 16-byte aligned: TMA
    cannot take it, so it stages by plain loads; a hand-built
    FoldedBlockParams without ``w1_packed`` gets it computed by the
    wrapper, with the same result as the packed one."""
    gen = torch.Generator().manual_seed(11)
    fp = _folded(64, 64, 3, False, gen, card)
    shape = (2, 64, 24, 32)
    n = 2 * 64 * 24 * 32
    x = torch.randn((n + 1,), generator=gen).to(card, torch.bfloat16)[1:].view(shape)
    assert fm.pass1_staging(x) == "plain"
    h_ref, _ = fm.chw_pass1_reference(x, fp)
    h, _ = fm.chw_pass1(x, fp)
    packed = fp._replace(w1_packed=fm.pack_w1(fp.w1))
    h2, _ = fm.chw_pass1(x.contiguous().clone(), packed)
    torch.cuda.synchronize()
    bar = BAR[torch.bfloat16] * max(1.0, float(h_ref.float().abs().max()))
    assert float((h.float() - h_ref.float()).abs().max()) < bar
    assert torch.equal(h, h2)


def test_wrapper_raises_on_what_the_kernel_cannot_take(card):
    gen = torch.Generator().manual_seed(0)
    fp = _folded(16, 16, 3, False, gen, card)
    x = torch.randn((1, 16, 8, 8), generator=gen).to(card)
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_inverted_residual_chw(x.transpose(2, 3), fp)
    cpu_fp = fm.FoldedBlockParams(*(None if t is None else t.cpu() for t in fp))
    with pytest.raises(ValueError, match="folded"):
        fm.fused_inverted_residual_chw(x, cpu_fp)


def _close(got, ref, dtype):
    return float((got.float() - ref.float()).abs().max()) < BAR[dtype] * max(
        1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize(
    "cin,cout,hh,ww,skip,stage",
    [
        (48, 32, 40, 72, "conv", "tma"),  # C_out < 64, two boxes of 64 pixels a block
        (40, 40, 33, 17, "identity", "plain"),  # HW % 8 != 0; C_mid % 32 != 0
        (72, 96, 24, 24, "none", "tma"),  # C_out % 64 != 0, C_mid % 32 != 0
        (128, 40, 45, 70, "none", "plain"),  # HW % 8 != 0, four chunks
        (104, 104, 16, 20, "identity", "tma"),  # the last pixel block: 64 of 128
        (88, 48, 37, 40, "conv", "tma"),  # ragged pixel blocks, conv over 3 chunks of x
        (688, 256, 32, 32, "conv", "tma"),  # the flagship's widest cell
        (16, 16, 64, 64, "identity", "tma"),  # one chunk, a third of it channels
    ],
)
def test_bf16_pass2_matches_plain(card, cin, cout, hh, ww, skip, stage):
    """The tensor-core pass 2 against its plain version on the same h, x
    and gate, through both stagings and every skip."""
    gen = torch.Generator().manual_seed(cin * 100 + cout + hh)
    fp = _folded(cin, cout, 3, skip == "conv", gen, card)
    x = torch.randn((2, cin, hh, ww), generator=gen).to(card, torch.bfloat16)
    h = torch.randn((2, cin, hh, ww), generator=gen).to(card, torch.bfloat16)
    gate = torch.rand((2, cin), generator=gen).to(card)
    assert fm.pass2_staging(h, x, skip) == stage
    ref = fm.chw_pass2_reference(h, x, gate, fp, skip=skip)
    reset_launch_counts()
    got = fm.chw_pass2(h, x, gate, fp, skip=skip)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_ir_chw_pass2"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (2, cout, hh, ww)
    assert _close(got, ref, torch.bfloat16), float((got.float() - ref.float()).abs().max())


@pytest.mark.parametrize("skip", ["conv", "identity"])
def test_bf16_pass2_on_a_misaligned_view_and_without_packed_weights(card, skip):
    """x one element into its storage is not 16-byte aligned: pass 2 then
    stages by plain loads (x is read for the skip), with the result of the
    TMA staging on an aligned copy; a hand-built FoldedBlockParams without
    the packed fields gets them computed by the wrapper, as fold fills
    them."""
    gen = torch.Generator().manual_seed(21)
    fp = _folded(64, 64, 3, skip == "conv", gen, card)
    shape = (2, 64, 24, 32)
    n = 2 * 64 * 24 * 32
    x = torch.randn((n + 1,), generator=gen).to(card, torch.bfloat16)[1:].view(shape)
    h = torch.randn(shape, generator=gen).to(card, torch.bfloat16)
    gate = torch.rand((2, 64), generator=gen).to(card)
    assert fm.pass2_staging(h, x, skip) == "plain"
    assert fm.pass2_staging(h, x, "none") == "tma"  # x is not read
    ref = fm.chw_pass2_reference(h, x, gate, fp, skip=skip)
    got = fm.chw_pass2(h, x, gate, fp, skip=skip)
    w2p, ssep, wskp = fm.pass2_operands(fp, skip)
    packed = fp._replace(w2_packed=w2p, sse_packed=ssep, wsk_packed=wskp)
    x2 = x.contiguous().clone()
    assert fm.pass2_staging(h, x2, skip) == "tma"
    got2 = fm.chw_pass2(h, x2, gate, packed, skip=skip)
    torch.cuda.synchronize()
    assert _close(got, ref, torch.bfloat16)
    assert torch.equal(got, got2)


def test_bf16_pass2_rejects_malformed_packed_weights(card):
    gen = torch.Generator().manual_seed(2)
    fp = _folded(64, 32, 3, True, gen, card)
    x = torch.randn((1, 64, 8, 8), generator=gen).to(card, torch.bfloat16)
    h = torch.randn((1, 64, 8, 8), generator=gen).to(card, torch.bfloat16)
    gate = torch.rand((1, 64), generator=gen).to(card)
    w2p, ssep, wskp = fm.pass2_operands(fp, "conv")
    with pytest.raises(ValueError, match="w2_packed"):
        fm.chw_pass2(h, x, gate, fp._replace(w2_packed=w2p.float()))
    with pytest.raises(ValueError, match="sse_packed"):
        fm.chw_pass2(h, x, gate, fp._replace(sse_packed=ssep[:1].contiguous()))
    with pytest.raises(ValueError, match="wsk_packed"):
        fm.chw_pass2(h, x, gate, fp._replace(wsk_packed=wskp[:, :1].contiguous()))


@pytest.mark.parametrize(
    "cin,hh,ww,ksize,act,stage,h_dtype",
    [
        (64, 20, 44, 3, "hswish", "tma", torch.bfloat16),  # H % 8 != 0, W % 32 != 0
        (64, 20, 44, 3, "hswish", "tma", torch.float32),  # the same as kernel 3
        (96, 16, 64, 3, "hswish", "tma", torch.bfloat16),  # whole tiles
        (688, 9, 33, 3, "hswish", "tma", torch.bfloat16),  # the widest cell: 22 chunks
        (688, 9, 33, 3, "hswish", "tma", torch.float32),
        (60, 13, 40, 3, "hswish", "plain", torch.bfloat16),  # C_in % 8 != 0
        (60, 13, 40, 3, "hswish", "plain", torch.float32),
        (88, 45, 70, 5, "silu", "tma", torch.bfloat16),  # k5 silu, ragged
        (72, 12, 30, 5, "hswish", "tma", torch.bfloat16),  # k5, W < 32, C_in % 32 != 0
        (100, 17, 17, 3, "silu", "plain", torch.bfloat16),  # C_mid % 8 != 0: scalar h stores
    ],
    ids=lambda v: {torch.bfloat16: "h-bf16", torch.float32: "h-f32"}.get(v, None),
)
def test_nhwc_bf16_pass1_matches_plain(card, record_property, cin, hh, ww, ksize, act, stage,
                                       h_dtype):
    """The tensor-core NHWC pass 1 (h in bf16 as kernel 2, in float32 as
    kernel 3, which JAX builds for hswish k = 3) against its plain
    version: h, and the per-tile sums over the 8 × 32 tiles."""
    gen = torch.Generator().manual_seed(cin * 10 + hh + ksize)
    fp = _folded(cin, cin, ksize, False, gen, card)
    x = torch.randn((2, hh, ww, cin), generator=gen).to(card, torch.bfloat16)
    assert fc.pass1_staging(x) == stage
    h_ref, s_ref = fc.nhwc_pass1_reference(x, fp, activation=act, ksize=ksize, h_dtype=h_dtype)
    reset_launch_counts()
    h, psum = fc.nhwc_pass1(x, fp, activation=act, ksize=ksize, h_dtype=h_dtype)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_ir_fat_pass1"] == 1
    assert h.dtype == h_dtype and h.shape == h_ref.shape
    assert psum.shape == (2, -(-hh // 8) * -(-ww // 32), cin)
    if h_dtype == torch.float32:
        rel = float((h - h_ref).abs().max()) / max(1.0, float(h_ref.abs().max()))
        record_property("k3_h_rel_err", rel)
        assert rel < K3_H_BAR, rel
    else:
        assert _close(h, h_ref, torch.bfloat16)
    hw = hh * ww
    assert float((psum.sum(1) - s_ref.sum(1)).abs().max()) / hw < BAR[torch.bfloat16] * max(
        1.0, float(s_ref.abs().max()) / hw)


def test_nhwc_bf16_pass1_on_a_misaligned_view(card):
    """A view one element into its storage stages by plain loads, with the
    result of the TMA staging on an aligned copy (and of a tuple whose
    packed W1 the wrapper computes)."""
    gen = torch.Generator().manual_seed(13)
    fp = _folded(64, 64, 3, False, gen, card)
    shape = (2, 20, 40, 64)
    n = 2 * 20 * 40 * 64
    x = torch.randn((n + 1,), generator=gen).to(card, torch.bfloat16)[1:].view(shape)
    assert fc.pass1_staging(x) == "plain"
    h, psum = fc.nhwc_pass1(x, fp)
    x2 = x.contiguous().clone()
    assert fc.pass1_staging(x2) == "tma"
    h2, psum2 = fc.nhwc_pass1(x2, fp._replace(w1_packed=fm.pack_w1(fp.w1)))
    torch.cuda.synchronize()
    assert torch.equal(h, h2) and torch.equal(psum, psum2)


def _within_ulp(got, ref):
    err = float((got.float() - ref.float()).abs().max())
    return err <= ULP_BAR * max(1.0, float(ref.float().abs().max())), err


@pytest.mark.parametrize("h_dtype", [torch.bfloat16, torch.float32], ids=["h-bf16", "h-f32"])
@pytest.mark.parametrize(
    "cin,cout,hh,ww,skip,stage",
    [
        (48, 32, 40, 72, "conv", "tma"),  # C_out < 64: half the warps hold no output
        (40, 40, 33, 17, "identity", "tma"),  # ragged H·W (49 of 128 pixels last), C % 32 != 0
        (72, 96, 24, 24, "none", "tma"),  # two output blocks, the second 32 of 64
        (60, 48, 20, 20, "conv", "plain"),  # C % 8 != 0
        (100, 100, 9, 13, "identity", "plain"),  # C % 8 != 0: one store an output
        (88, 48, 37, 40, "conv", "tma"),  # ragged, conv over 3 chunks of x
        (688, 256, 32, 32, "conv", "tma"),  # the flagship's widest cell
        (16, 16, 64, 64, "identity", "tma"),  # one chunk, half of it channels
    ],
)
def test_nhwc_bf16_pass2_matches_plain(card, h_dtype, cin, cout, hh, ww, skip, stage):
    """The tensor-core NHWC pass 2, h in bf16 (kernel 2) or float32 (kernel
    3), against its plain version on the same h, x and gate, through both
    stagings and every skip."""
    gen = torch.Generator().manual_seed(cin * 100 + cout + hh)
    fp = _folded(cin, cout, 3, skip == "conv", gen, card)
    x = torch.randn((2, hh, ww, cin), generator=gen).to(card, torch.bfloat16)
    h = torch.randn((2, hh, ww, cin), generator=gen).to(card, h_dtype)
    gate = torch.rand((2, cin), generator=gen).to(card)
    assert fc.nhwc_pass2_staging(h, x, skip) == stage
    ref = fc.nhwc_pass2_reference(h, x, gate, fp, skip=skip)
    reset_launch_counts()
    got = fc.nhwc_pass2(h, x, gate, fp, skip=skip)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_ir_fat_pass2"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (2, hh, ww, cout)
    ok, err = _within_ulp(got, ref)
    assert ok, err


@pytest.mark.parametrize("h_dtype", [torch.bfloat16, torch.float32], ids=["h-bf16", "h-f32"])
@pytest.mark.parametrize("skip", ["conv", "identity"])
def test_nhwc_bf16_pass2_stagings_are_bit_equal(card, h_dtype, skip):
    """h or x one element into its storage is not 16-byte aligned: pass 2
    then stages by plain loads, with the result of the TMA staging on
    aligned tensors; a hand-built FoldedBlockParams without the packed
    fields gets them computed by the wrapper, as fold fills them."""
    gen = torch.Generator().manual_seed(23)
    fp = _folded(64, 64, 3, skip == "conv", gen, card)
    shape = (2, 24, 40, 64)
    x = torch.randn(shape, generator=gen).to(card, torch.bfloat16)
    h = torch.randn(shape, generator=gen).to(card, h_dtype)
    gate = torch.rand((2, 64), generator=gen).to(card)

    def misaligned(t):
        buf = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
        buf[1:].copy_(t.flatten())
        return buf[1:].view(t.shape)

    x1, h1 = misaligned(x), misaligned(h)
    assert fc.nhwc_pass2_staging(h, x, skip) == "tma"
    assert fc.nhwc_pass2_staging(h, x1, skip) == "plain"
    assert fc.nhwc_pass2_staging(h1, x, skip) == "plain"
    w2p, ssep, wskp = fm.pass2_operands(fp, skip)
    packed = fp._replace(w2_packed=w2p, sse_packed=ssep, wsk_packed=wskp)
    got = fc.nhwc_pass2(h, x, gate, packed, skip=skip)
    got_x1 = fc.nhwc_pass2(h, x1, gate, fp, skip=skip)
    got_h1 = fc.nhwc_pass2(h1, x, gate, fp, skip=skip)
    torch.cuda.synchronize()
    assert torch.equal(got, got_x1) and torch.equal(got, got_h1)
    ok, err = _within_ulp(got, fc.nhwc_pass2_reference(h, x, gate, fp, skip=skip))
    assert ok, err


def test_nhwc_bf16_pass2_rejects_malformed_packed_weights(card):
    gen = torch.Generator().manual_seed(4)
    fp = _folded(64, 32, 3, True, gen, card)
    x = torch.randn((1, 8, 8, 64), generator=gen).to(card, torch.bfloat16)
    gate = torch.rand((1, 64), generator=gen).to(card)
    w2p, ssep, wskp = fm.pass2_operands(fp, "conv")
    for h in (x.clone(), x.float()):
        with pytest.raises(ValueError, match="w2_packed"):
            fc.nhwc_pass2(h, x, gate, fp._replace(w2_packed=w2p.float()))
        with pytest.raises(ValueError, match="sse_packed"):
            fc.nhwc_pass2(h, x, gate, fp._replace(sse_packed=ssep[:1].contiguous()))
        with pytest.raises(ValueError, match="wsk_packed"):
            fc.nhwc_pass2(h, x, gate, fp._replace(wsk_packed=wskp[:, :1].contiguous()))


MEAN = (0.3661029729, 0.3875165941, 0.3501133538, 0.5797285859)
STD = (0.2388708549, 0.2103625723, 0.2050272174, 0.2025812523)


@pytest.mark.parametrize(
    "shape",
    [(16, 512, 512, 4), (1, 256, 256, 4), (2, 40, 72, 4), (3, 64, 48, 3), (2, 33, 17, 4)],
    ids=["flagship", "256", "ragged", "rgb", "odd"],
)
def test_augment_kernel_matches_plain(card, shape):
    gen = torch.Generator().manual_seed(shape[1])
    img = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(card)
    alpha = (0.85 + 0.3 * torch.rand(shape[0], generator=gen)).to(card)
    beta = (0.4 * torch.rand(shape[0], generator=gen) - 0.2).to(card)
    ref = aug.augment_jitter_normalize_reference(img, alpha, beta, MEAN, STD)
    reset_launch_counts()
    got = aug.augment_jitter_normalize(img, alpha, beta, MEAN, STD)
    torch.cuda.synchronize()
    assert LAUNCHES["augment_jitter_normalize"] == 1
    assert got.shape == ref.shape == (shape[0], shape[3], shape[1], shape[2])
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "cin,cout,hh,ww,ksize,act,skip",
    [
        (64, 32, 40, 72, 3, "hswish", "auto"),  # ragged, projected skip
        (96, 96, 33, 17, 3, "hswish", "auto"),  # ragged, identity skip
        (128, 40, 45, 70, 5, "silu", "none"),  # 64 mid channels a block
        (72, 40, 29, 30, 5, "hswish", "conv"),  # 32 mid channels a block
        (64, 64, 16, 16, 3, "silu", "identity"),
        (688, 256, 32, 32, 3, "hswish", "conv"),  # the flagship's widest cell
    ],
)
def test_nhwc_kernels_match_plain(card, dtype, cin, cout, hh, ww, ksize, act, skip):
    """The NHWC pair as kernel 2 (h in x's dtype) and, for hswish k = 3,
    as kernel 3 (h in float32)."""
    gen = torch.Generator().manual_seed(cin * 1000 + hh + 7)
    conv = skip == "conv" or (skip == "auto" and cin != cout)
    fp = _folded(cin, cout, ksize, conv, gen, card)
    x = torch.randn((2, hh, ww, cin), generator=gen).to(card, dtype)
    ref = fc.fused_ir_fat_reference(x, fp, activation=act, ksize=ksize, skip=skip)
    reset_launch_counts()
    got = fc.fused_ir_fat(x, fp, activation=act, ksize=ksize, skip=skip)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_ir_fat_pass1"] == 1 and LAUNCHES["fused_ir_fat_pass2"] == 1
    assert got.dtype == dtype and got.shape == (2, hh, ww, cout)
    err = float((got.float() - ref.float()).abs().max())
    assert err < BAR[dtype] * max(1.0, float(ref.float().abs().max())), err
    if act == "hswish" and ksize == 3 and skip == "auto":
        ref3 = fm.fused_inverted_residual_reference(x, fp)
        got3 = fm.fused_inverted_residual(x, fp)
        torch.cuda.synchronize()
        assert LAUNCHES["fused_inverted_residual_pass1"] == 1
        assert LAUNCHES["fused_inverted_residual_pass2"] == 1
        err3 = float((got3.float() - ref3.float()).abs().max())
        assert err3 < BAR[dtype] * max(1.0, float(ref3.float().abs().max())), err3


def test_nhwc_wrappers_raise_on_what_the_kernels_cannot_take(card):
    gen = torch.Generator().manual_seed(1)
    fp = _folded(64, 64, 3, False, gen, card)
    x = torch.randn((1, 8, 8, 64), generator=gen).to(card)
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_ir_fat(x.transpose(1, 2), fp)
    cpu_fp = fm.FoldedBlockParams(*(None if t is None else t.cpu() for t in fp))
    with pytest.raises(ValueError, match="folded"):
        fc.fused_ir_fat(x, cpu_fp)
    with pytest.raises(ValueError, match="bfloat16"):  # h in bf16 needs x in bf16
        fc.nhwc_pass1(x, fp, h_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hswish"):  # kernel 3's h type, other modes
        fc.nhwc_pass1(x.to(torch.bfloat16), fp, activation="silu", h_dtype=torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape,ksize,strides",
    [
        ((2, 64, 64, 32), 3, 1),
        ((2, 33, 17, 24), 5, 1),  # ragged
        ((2, 64, 64, 48), 3, 2),
        ((1, 45, 31, 40), 5, 2),  # ragged, stride 2
        ((1, 20, 12, 6), 7, 1),  # a k the kernel takes at run time; plain-load staging
        # the b5 encoder's channel classes
        ((2, 64, 64, 24), 3, 1),
        ((2, 32, 32, 48), 3, 1),
        ((1, 32, 32, 240), 3, 1),
        ((1, 16, 16, 1056), 5, 1),
        ((1, 8, 8, 3072), 3, 1),
        ((2, 32, 32, 240), 5, 2),
        ((1, 17, 19, 1056), 3, 2),
    ],
)
def test_depthwise_kernel_matches_plain(card, dtype, shape, ksize, strides):
    gen = torch.Generator().manual_seed(shape[1] * 10 + ksize + shape[-1])
    x = torch.randn(shape, generator=gen).to(card, dtype)
    k = torch.randn((ksize, ksize, 1, shape[-1]), generator=gen).to(card)
    plan = dwm.depthwise_tile_plan(*shape[1:], ksize, strides, x.element_size(),
                                   batch=shape[0])
    assert plan.vector == (shape[-1] % (16 // x.element_size()) == 0)
    ref = dwm.depthwise_conv2d_reference(x, k, strides=strides)
    reset_launch_counts()
    got = dwm.depthwise_conv2d(x, k, strides=strides, force="cuda")
    torch.cuda.synchronize()
    assert LAUNCHES["depthwise_conv2d"] == 1
    assert got.dtype == dtype and got.shape == ref.shape
    bar = (1e-5 if dtype == torch.float32 else 1e-2) * max(1.0, float(ref.float().abs().max()))
    assert float((got.float() - ref.float()).abs().max()) <= bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_depthwise_occupancy_is_asked_once_per_plan(card, dtype):
    """The wrapper asks the CUDA runtime for a plan's occupancy on its
    first call only; at least one block of every encoder-class plan fits
    on an SM."""
    gen = torch.Generator().manual_seed(5)
    for c, ksize in ((24, 3), (240, 3), (1056, 5), (3072, 3)):
        x = torch.randn((2, 16, 16, c), generator=gen).to(card, dtype)
        k = torch.randn((ksize, ksize, 1, c), generator=gen).to(card)
        dwm.depthwise_conv2d(x, k, force="cuda")
        misses = dwm._blocks_per_sm.cache_info().misses
        dwm.depthwise_conv2d(x, k, force="cuda")
        assert dwm._blocks_per_sm.cache_info().misses == misses
        plan = dwm.depthwise_tile_plan(16, 16, c, ksize, 1, x.element_size(), batch=2,
                                       sms=dwm._sm_count(card.index or 0))
        assert dwm._blocks_per_sm(card.index or 0, dtype == torch.bfloat16, plan.vector, ksize,
                                  1, plan.threads, plan.smem_bytes) >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_depthwise_kernel_on_a_misaligned_view(card, dtype):
    """A contiguous view that starts one element into its storage is not
    16-byte aligned: the kernel stages it by plain loads, one channel a
    thread."""
    gen = torch.Generator().manual_seed(3)
    shape = (2, 20, 24, 32)
    n = 2 * 20 * 24 * 32
    x = torch.randn((n + 1,), generator=gen).to(card, dtype)[1:].view(shape)
    k = torch.randn((3, 3, 1, 32), generator=gen).to(card)
    ref = dwm.depthwise_conv2d_reference(x, k)
    reset_launch_counts()
    got = dwm.depthwise_conv2d(x, k, force="cuda")
    torch.cuda.synchronize()
    assert LAUNCHES["depthwise_conv2d"] == 1
    bar = (1e-5 if dtype == torch.float32 else 1e-2) * max(1.0, float(ref.float().abs().max()))
    assert float((got.float() - ref.float()).abs().max()) <= bar


def test_depthwise_wrapper_raises_on_what_the_kernel_cannot_take(card):
    x = torch.randn((1, 8, 8, 4), device=card)
    k = torch.randn((3, 3, 1, 4), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        dwm.depthwise_conv2d(x.transpose(1, 2), k, force="cuda")
    with pytest.raises(ValueError, match="kernel must be on"):
        dwm.depthwise_conv2d(x, k.cpu(), force="cuda")
    with pytest.raises(ValueError, match="device"):
        dwm.depthwise_conv2d(x.cpu(), k.cpu(), force="cuda")


def test_scene_batches_match_single_scenes_on_the_card(card, monkeypatch):
    """``predict_scenes`` (two dispatches in flight, pinned staging, the
    side stream) gives each scene's ``predict_scene`` map, bit for bit, on
    a b0 at subtile 64: 5 scenes, 2 a dispatch, so both staging buffers are
    refilled and the tail group is padded. With CUDA hidden and no device
    asked for, the scene entry points raise."""
    from deadtrees_tpu_torch.infer import make_scene_predictor, predict_scene, predict_scenes
    from deadtrees_tpu_torch.models import create_model, init_model

    hp = dict(architecture="efficientunet++", encoder_name="timm-efficientnet-b0",
              decoder_channels=[24, 16, 16, 8, 8], in_channels=4, classes=3)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        model = init_model(create_model(**hp), generator=gen).to(card).eval()
    rng = np.random.default_rng(0)
    scenes = [rng.integers(0, 256, (100, 150, 4), np.uint8) for _ in range(5)]
    kw = dict(tile_shape=(128, 192), subtile=64, batch_size=4)
    batched = predict_scenes(model, scenes, scenes_per_dispatch=2, **kw)
    for scene, got in zip(scenes, batched):
        assert got.shape == (100, 150) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, predict_scene(model, scene, **kw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_scene_predictor(model, subtile=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_scenes(model, scenes[:1], **kw)


def _edt_masks(n=64):
    """The 64² masks of the EDT's CPU tests (tests/test_torch_losses.py::_masks)."""
    rng = np.random.default_rng(0)
    masks = {
        "random": rng.random((n, n)) > 0.7,
        "all_false": np.zeros((n, n), bool),
        "all_true": np.ones((n, n), bool),
        "single_pixel": np.zeros((n, n), bool),
        "blob": np.zeros((n, n), bool),
    }
    masks["single_pixel"][17, 40] = True
    masks["blob"][10:30, 5:20] = True
    return masks


def _edt_case(name):
    """A float32 one-hot (..., K, H, W) on the CPU."""
    rng = np.random.default_rng(len(name))
    if name == "cell":  # the training batch: 32-pixel class regions, one tile of class 0
        seg = torch.from_numpy(rng.integers(0, 3, (16, 16, 16)))
        seg = seg.repeat_interleave(32, 1).repeat_interleave(32, 2)
        seg[1] = 0
        seg[2] = torch.from_numpy(rng.integers(0, 3, (512, 512)))
        return tfn.class2one_hot(seg, 3)
    if name == "masks64":  # each mask as a class, its complement as the other
        m = torch.from_numpy(np.stack(list(_edt_masks().values())))
        return torch.stack([m, ~m], 1).float()
    hh, ww = {"37x61": (37, 61), "1x300": (1, 300), "300x1": (300, 1),
              "4x8192": (4, 8192)}[name]
    return torch.from_numpy(rng.random((2, 2, hh, ww)) > 0.9).float()


@pytest.mark.parametrize("name", ["cell", "masks64", "37x61", "1x300", "300x1", "4x8192"])
def test_edt_kernels_match_plain(card, name):
    """The two kernels against the plain version on the card, bit for bit,
    with one launch of each; against the plain version on the CPU within
    one ulp (the CPU's float32 sqrt is not correctly rounded)."""
    seg = _edt_case(name)
    dev = seg.to(card)
    reset_launch_counts()
    got = tfn.batch_one_hot2dist(dev)
    torch.cuda.synchronize()
    assert LAUNCHES["edt_columns"] == 1 and LAUNCHES["edt_rows"] == 1
    assert got.shape == seg.shape and got.dtype == torch.float32
    want = tfn.batch_one_hot2dist_reference(dev)
    diff = float((got - want).abs().max())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), diff
    if name != "cell":  # 96 planes of 512² take the CPU's plain version tens of seconds
        cpu = tfn.batch_one_hot2dist_reference(seg)
        torch.testing.assert_close(got.cpu(), cpu, rtol=2.0**-23, atol=0)


def test_edt_kernels_absent_and_full_classes_and_scipy(card):
    """An absent class reads a zero map, a class that fills the tile
    -999,999 (sqrt(1e12) − 1); on the masks with both classes the maps
    agree with scipy's exact EDT, as tests/test_torch_losses.py's
    ``test_edt_matches_jax`` holds the plain version."""
    from scipy.ndimage import distance_transform_edt

    masks = _edt_masks()
    got = tfn.batch_one_hot2dist(_edt_case("masks64").to(card)).cpu().numpy()
    for i, (name, m) in enumerate(masks.items()):
        cls = got[i, 0]
        if name == "all_false":
            assert not cls.any()
        elif name == "all_true":
            assert (cls == -999999.0).all()
        else:
            want = np.where(m, -(distance_transform_edt(m) - 1.0), distance_transform_edt(~m))
            np.testing.assert_allclose(cls, want, rtol=0, atol=1e-5, err_msg=name)


def test_edt_wrapper_raises_on_what_the_kernels_cannot_take(card):
    """No fallback: the wrapper raises, and launches nothing."""
    reset_launch_counts()
    bad = [torch.zeros((2, 3, 8, 8), dtype=torch.float64, device=card),
           torch.zeros((2, 3, 8, 8), dtype=torch.bool, device=card),
           torch.zeros((1, 1, 8193, 1), device=card), torch.zeros((1, 1, 2, 8193), device=card),
           torch.zeros((0, 3, 8, 8), device=card), torch.zeros((8,), device=card)]
    for seg in bad:
        with pytest.raises(ValueError):
            tfn.batch_one_hot2dist(seg)
        with pytest.raises(ValueError):
            torch.ops.deadtrees.signed_distance_maps(seg)
    assert LAUNCHES["edt_columns"] == LAUNCHES["edt_rows"] == 0


# the MiT-B5 U-Net's attention at bs 1, 1024²: (heads, queries, keys) of
# each stage, head size 64
MIT_STAGES = [(1, 65536, 1024), (2, 16384, 1024), (5, 4096, 1024), (8, 1024, 1024)]


@pytest.mark.parametrize("heads,n,m", MIT_STAGES, ids=["stage1", "stage2", "stage3", "stage4"])
def test_fused_attention_matches_plain(card, heads, n, m):
    """The pinned fused backend against the plain path, forward and the
    gradients of q, k and v, bf16 operands. Bar: BAR[bf16]·max(1,
    max|plain|). Both round P to bfloat16 for the PV product and their
    outputs to bfloat16; the fused kernel sums the keys in blocks with a
    running maximum and rounds dS to bfloat16 for dQ and dK, where the
    plain path keeps dS in float32: a rounding may land on the other side
    of a tie."""
    from deadtrees_tpu_torch.core import trace
    from deadtrees_tpu_torch.models import segformer

    g = torch.Generator(device=card).manual_seed(n + heads)

    def leaf(*shape):
        return torch.randn(shape, generator=g, device=card).bfloat16().requires_grad_()

    # the model's layouts: q split from (B, N, C) tokens, k and v from the
    # two halves of the kv projection's (B, M, 2C)
    x, kv = leaf(1, n, heads * 64), leaf(1, m, 2 * heads * 64)
    q = segformer.split_heads(x, heads)
    k, v = (segformer.split_heads(t, heads) for t in kv.chunk(2, dim=-1))
    do = torch.randn((1, heads, n, 64), generator=g, device=card).bfloat16()
    trace.reset()
    trace.enable()
    try:
        fused = segformer.attention(q, k, v)
    finally:
        trace.disable()
    assert trace.snapshot()["counters"]["model.attention_fused"] == (1.0, 1)
    plain = segformer.plain_attention(q, k, v)
    got = (fused,) + torch.autograd.grad(fused, (x, kv), do)
    want = (plain,) + torch.autograd.grad(plain, (x, kv), do)
    for name, a, b in zip(("out", "dq", "dkv"), got, want):
        assert a.dtype == torch.bfloat16
        bar = BAR[torch.bfloat16] * max(1.0, float(b.float().abs().max()))
        assert float((a.float() - b.float()).abs().max()) < bar, name


def test_fused_attention_raises_where_its_backend_cannot_take_the_input(card):
    """No fallback to another backend: float32 operands, which neither
    fused backend takes, and a head size above the kernels' largest."""
    from deadtrees_tpu_torch.models import segformer

    f32 = torch.randn((1, 1, 256, 64), device=card)
    wide = torch.randn((1, 1, 256, 512), device=card, dtype=torch.bfloat16)
    for t in (f32, wide):
        with pytest.raises(RuntimeError):
            segformer.fused_attention(t, t, t)


def test_mit_stages_replayed_as_cuda_graphs_match_eager(card, monkeypatch):
    """A U-Net on mit_b0 under bf16 autocast: the encoder's graphed
    forward and backward (``models/mit.py``) against the same model run
    eagerly, loss and every gradient, on two batches (the second a replay
    of graphs captured on the first). Bar: BAR[bf16]·max(1, max|eager|) a
    gradient; the replay runs the eager pass's kernels, and cuBLAS may
    pick another kernel inside a capture."""
    from deadtrees_tpu_torch.core import trace
    from deadtrees_tpu_torch.models import create_model

    torch.manual_seed(0)
    graphed = create_model("unet", "mit_b0", in_channels=4, classes=3).to(card).train()
    eager = create_model("unet", "mit_b0", in_channels=4, classes=3).to(card).train()
    eager.load_state_dict(graphed.state_dict())
    monkeypatch.setattr(eager.encoder, "_graph", lambda x: None)
    g = torch.Generator(device=card).manual_seed(1)
    for step in range(2):
        x = torch.randn((2, 4, 128, 128), generator=g, device=card)
        losses, grads = [], []
        for model in (graphed, eager):
            model.zero_grad(set_to_none=True)
            trace.reset()
            trace.enable()
            try:
                loss = model(x).float().square().mean()
            finally:
                trace.disable()
            assert trace.snapshot()["counters"]["model.attention_fused"] == (8.0, 8)
            loss.backward()
            losses.append(float(loss))
            grads.append([p.grad.float().clone() for p in model.parameters()])
        assert graphed.encoder._graphed is not None and eager.encoder._graphed is None
        assert abs(losses[0] - losses[1]) <= BAR[torch.bfloat16] * abs(losses[1])
        for a, b in zip(*grads):
            assert float((a - b).abs().max()) <= BAR[torch.bfloat16] * max(1.0, float(b.abs().max()))


# train-mode BatchNorm (ops/batchnorm.py, ops/csrc/batchnorm_op.cpp): (shape, dtype, channels-last,
# misaligned) of the kernels' paths: 16-byte vectors on NCHW (the b5's
# stem and deepest widths at bs 16) and on NHWC (the MiT decoder's
# layout), single elements where C % 8, H·W % 8 or the alignment rule
# them out, float32
BN_CASES = {
    "b5_stem_bf16": ((16, 48, 256, 256), torch.bfloat16, False, False),
    "b5_deep_bf16": ((16, 3072, 16, 16), torch.bfloat16, False, False),
    "mit_decoder_nhwc_bf16": ((8, 16, 256, 256), torch.bfloat16, True, False),
    "nhwc_c12_bf16": ((4, 12, 33, 35), torch.bfloat16, True, False),
    "odd_hw_f32": ((3, 20, 37, 61), torch.float32, False, False),
    "nhwc_f32": ((4, 96, 30, 30), torch.float32, True, False),
    "misaligned_bf16": ((2, 24, 64, 64), torch.bfloat16, False, True),
}


def _bn_inputs_on(card, shape, dtype, channels_last, misaligned):
    g = torch.Generator(device=card).manual_seed(sum(shape))
    n, c, h, w = shape
    x = (torch.randn(shape, generator=g, device=card) * 3 + 1.5).to(dtype)
    if misaligned:  # one element into its storage: single-element loads
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(shape)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(shape, generator=g, device=card).to(dtype)
    if channels_last:
        dy = dy.contiguous(memory_format=torch.channels_last)
    params = [torch.randn(c, generator=g, device=card), torch.randn(c, generator=g, device=card),
              torch.randn(c, generator=g, device=card),
              torch.rand(c, generator=g, device=card) + 0.5]
    return x, dy, params


def _bn_forward_backward(forward, backward, x, dy, params, momentum):
    w, b, rm, rv = (p.clone() for p in params)
    nbt = torch.zeros((), dtype=torch.int64, device=x.device)
    y, mean, invstd = forward(x, w, b, rm, rv, nbt, momentum, 1e-5)
    dx, dw, db = backward(dy, x, w, mean, invstd)
    return {"y": y, "mean": mean, "invstd": invstd, "running_mean": rm, "running_var": rv,
            "num_batches_tracked": nbt, "dx": dx, "dweight": dw, "dbias": db}


@pytest.mark.parametrize("name", sorted(BN_CASES))
def test_batchnorm_kernels_match_plain(card, name):
    """The four kernels against float64 and against the plain version on
    the same card tensors. Bars, with their reasons: mean within 1e-5 of
    the channel's standard deviation and var relative 1e-5 of float64
    statistics, invstd relative 1e-5 of the plain version's (float32 sums
    in another order); dweight and dbias within 1e-5 of the sum of their
    terms' magnitudes of float64 sums, and within 1e-3 of it of the plain
    version's (PyTorch's NCHW bf16 backward reads up to 3.3e-4 of that sum
    off float64); y and dx within one ulp of their largest magnitude in
    bfloat16, 1e-5 of it in float32, of the plain version's (y is
    x·scale + shift where the plain version takes (x − mean)·invstd·w + b;
    a rounding to bfloat16 may land on the other side of a tie). The
    running buffers are the kernels' own statistics moved by momentum in
    the plain version's float32 operations, bit for bit; two runs are
    bit-identical; 2 + 2 launches; outputs in x's type and layout."""
    from deadtrees_tpu_torch.ops import batchnorm as bn

    bn.load()
    shape, dtype, channels_last, misaligned = BN_CASES[name]
    x, dy, params = _bn_inputs_on(card, shape, dtype, channels_last, misaligned)
    kernels = (torch.ops.deadtrees.batch_norm_train, torch.ops.deadtrees.batch_norm_train_backward)
    reset_launch_counts()
    got = _bn_forward_backward(*kernels, x, dy, params, 0.1)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] for k in bn.KERNELS} == dict.fromkeys(bn.KERNELS, 1)
    again = _bn_forward_backward(*kernels, x, dy, params, 0.1)
    for key in got:
        assert torch.equal(got[key], again[key]), key
    stats = _bn_forward_backward(*kernels, x, dy, params, 1.0)  # running = the batch's
    want = _bn_forward_backward(bn.batch_norm_train_reference,
                                bn.batch_norm_train_backward_reference, x, dy, params, 1.0)
    for key in ("y", "dx"):
        assert got[key].dtype == dtype and got[key].stride() == x.stride(), key
    dims = (0, 2, 3)
    var, mean = torch.var_mean(x.double(), dim=dims, correction=0)
    std = torch.sqrt(var + 1e-5)
    assert torch.equal(stats["running_mean"], stats["mean"])
    assert torch.equal(got["num_batches_tracked"].cpu(), torch.tensor(1))
    assert float(((got["mean"] - mean).abs() / std).max()) <= 1e-5
    assert float(((stats["running_var"] - var).abs() / var).max()) <= 1e-5
    assert float(((got["invstd"] - want["invstd"]).abs() / want["invstd"]).max()) <= 1e-5
    w0, b0, rm0, rv0 = params
    assert torch.equal(got["running_mean"], rm0 * 0.9 + got["mean"] * 0.1)
    assert torch.equal(got["running_var"], rv0 * 0.9 + stats["running_var"] * 0.1)
    rel = ULP_BAR if dtype == torch.bfloat16 else 1e-5
    for key in ("y", "dx"):
        ref = want[key].float()
        floor = 1.0 if key == "y" else 0.0
        bar = rel * max(floor, float(ref.abs().max()))
        assert float((got[key].float() - ref).abs().max()) <= bar, key
    xhat = (x.double() - mean[:, None, None]) / std[:, None, None]
    for key, terms in (("dbias", dy.double()), ("dweight", dy.double() * xhat)):
        scale = terms.abs().sum(dims)
        assert bool(((got[key] - terms.sum(dims)).abs() <= 1e-5 * scale).all()), key
        assert bool(((got[key] - want[key]).abs() <= 1e-3 * scale).all()), key


def test_batchnorm_module_on_the_card_is_the_op(card):
    """``BatchNorm2d`` in train mode under bf16 autocast, through autograd:
    the op's kernels, 2 launches forward and 2 backward, the same numbers
    as the ops called directly."""
    from deadtrees_tpu_torch.models.blocks import BatchNorm2d
    from deadtrees_tpu_torch.ops import batchnorm as bn

    x, dy, params = _bn_inputs_on(card, (4, 40, 32, 32), torch.bfloat16, False, False)
    module = BatchNorm2d(40).to(card).train()
    with torch.no_grad():
        for p, v in zip((module.weight, module.bias, module.running_mean, module.running_var),
                        params):
            p.copy_(v)
    xg = x.clone().requires_grad_()
    reset_launch_counts()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = module(xg)
    y.backward(dy)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] for k in bn.KERNELS} == dict.fromkeys(bn.KERNELS, 1)
    want = _bn_forward_backward(torch.ops.deadtrees.batch_norm_train,
                                torch.ops.deadtrees.batch_norm_train_backward, x, dy, params, 0.1)
    assert torch.equal(y, want["y"]) and torch.equal(xg.grad, want["dx"])
    assert torch.equal(module.weight.grad, want["dweight"])
    assert torch.equal(module.bias.grad, want["dbias"])
    assert torch.equal(module.running_var, want["running_var"])
    assert int(module.num_batches_tracked) == 1


def test_batchnorm_wrapper_raises_on_what_the_kernels_cannot_take(card):
    """No fallback: the CUDA implementation raises, and launches nothing."""
    from deadtrees_tpu_torch.ops import batchnorm as bn

    bn.load()
    c = 8
    ok = [torch.ones(c, device=card), torch.zeros(c, device=card), torch.zeros(c, device=card),
          torch.ones(c, device=card), torch.zeros((), dtype=torch.int64, device=card)]
    bad_x = [torch.zeros((2, c, 4, 4), dtype=torch.float16, device=card),
             torch.zeros((2, c, 4, 8), device=card)[..., ::2],
             torch.zeros((2, 4, c, 4), device=card).transpose(1, 2),
             torch.zeros((2, c, 16), device=card)]
    reset_launch_counts()
    for x in bad_x:
        with pytest.raises(ValueError):
            torch.ops.deadtrees.batch_norm_train(x, *ok, 0.1, 1e-5)
    x = torch.zeros((2, c, 4, 4), device=card)
    for i, bad in ((0, ok[0].bfloat16()), (1, torch.zeros(c + 1, device=card)),
                   (3, ok[3].double()), (4, torch.zeros((), dtype=torch.int32, device=card))):
        args = list(ok)
        args[i] = bad
        with pytest.raises(ValueError):
            torch.ops.deadtrees.batch_norm_train(x, *args, 0.1, 1e-5)
    assert all(LAUNCHES[k] == 0 for k in bn.KERNELS)
