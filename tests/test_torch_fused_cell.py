"""The port's NHWC fused blocks against the JAX ones.

``fused_ir_fat`` (kernel 2) at the shapes of tests/test_fused_cell.py and
``fused_inverted_residual`` (kernel 3) at those of
tests/test_fused_mbconv.py. On a CPU tensor the port runs each kernel's
plain PyTorch version; the JAX side runs its Pallas kernel in interpret
mode, as its own tests do. Same inputs (numpy, seeded), the JAX tests'
bar: max error < 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_mbconv import (
    _carried_block,
    _flax_block,
    _random_folded,
    _tensor_core_pass2,
)

from deadtrees_tpu.ops import fused_cell as jfc
from deadtrees_tpu.ops import fused_mbconv as jfm
from deadtrees_tpu_torch.ops import fused_cell as tfc
from deadtrees_tpu_torch.ops import fused_mbconv as tfm
from deadtrees_tpu_torch.ops.launches import LAUNCHES, reset_launch_counts


def _pair(cin, cout, shape, seed):
    """(x of ``shape + (cin,)``, JAX folded params, the port's folded
    params) for one randomized flax InvertedResidual carried into the
    port's block."""
    _, _, variables = _flax_block(cin, cout, 8, seed=seed)
    x = np.random.default_rng(seed).normal(size=shape + (cin,)).astype(np.float32)
    fp_j = jfm.fold_inverted_residual(variables["params"], variables["batch_stats"])
    fp = tfm.fold_inverted_residual(_carried_block(variables, cin, cout))
    return x, fp_j, fp


@pytest.mark.parametrize(
    "cin,cout,hw",
    [(48, 16, 16), (32, 32, 16), (40, 16, 8)],
    ids=["conv-skip", "identity", "odd-channels"],
)
def test_fused_ir_fat_matches_jax(cin, cout, hw):
    x, fp_j, fp = _pair(cin, cout, (2, hw, hw), seed=0)
    want = np.asarray(jfc.fused_ir_fat(jnp.asarray(x), fp_j, interpret=True))
    reset_launch_counts()
    got = tfc.fused_ir_fat(torch.from_numpy(x), fp)
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES  # CPU: the plain version
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err < 1e-3, f"max err {err}"


def test_fused_ir_fat_multi_tile_matches_jax():
    """H = 96 spans several JAX tiles (and many port tiles): the cSE pool
    sums over all of them and halo rows carry no act(b1)."""
    x, fp_j, fp = _pair(32, 32, (3, 96, 8), seed=1)
    want = np.asarray(jfc.fused_ir_fat(jnp.asarray(x), fp_j, interpret=True))
    got = tfc.fused_ir_fat(torch.from_numpy(x), fp).numpy()
    err = np.abs(got - want).max()
    assert err < 1e-3, f"max err {err}"


@pytest.mark.parametrize("ksize,act,skip", [(5, "silu", "conv"), (3, "silu", "identity")])
def test_fused_ir_fat_modes_match_jax(ksize, act, skip):
    rng = np.random.default_rng(7)
    cin, cout = 24, (16 if skip == "conv" else 24)
    fp_j, fp = _random_folded(rng, cin, cin, cout, ksize, skip)
    x = rng.normal(size=(2, 12, 12, cin)).astype(np.float32)
    want = np.asarray(jfc.fused_ir_fat(
        jnp.asarray(x), fp_j, interpret=True, activation=act, ksize=ksize, skip=skip))
    got = tfc.fused_ir_fat(torch.from_numpy(x), fp, activation=act, ksize=ksize, skip=skip)
    err = np.abs(got.numpy() - want).max()
    assert err < 1e-3, f"max err {err}"


@pytest.mark.parametrize(
    "cin,cout,hw", [(16, 16, 32), (24, 16, 16), (16, 32, 8), (16, 16, 24)],
    ids=["identity", "conv-skip", "widen", "ragged-24"],
)
def test_fused_inverted_residual_matches_jax(cin, cout, hw):
    x, fp_j, fp = _pair(cin, cout, (2, hw, hw), seed=3)
    want = np.asarray(jfm.fused_inverted_residual(jnp.asarray(x), fp_j, interpret=True))
    got = tfm.fused_inverted_residual(torch.from_numpy(x), fp)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err < 1e-3, f"max err {err}"


def test_fat_bfloat16_matches_jax():
    """bf16 input: h rounds to bf16 between the passes on both sides (the
    fat cell), or stays float32 (kernel 3). Bar 2e-2·max(1, max|ref|):
    one bf16 rounding may land on the other side of a tie."""
    rng = np.random.default_rng(5)
    fp_j, fp = _random_folded(rng, 24, 24, 16, 3, "conv")
    x = rng.normal(size=(2, 16, 16, 24)).astype(np.float32)
    x_j = jnp.asarray(x, jnp.bfloat16)
    x_t = torch.from_numpy(np.asarray(x_j.astype(jnp.float32))).to(torch.bfloat16)
    for jfn, tfn in ((lambda a: jfc.fused_ir_fat(a, fp_j, interpret=True),
                      lambda a: tfc.fused_ir_fat(a, fp)),
                     (lambda a: jfm.fused_inverted_residual(a, fp_j, interpret=True),
                      lambda a: tfm.fused_inverted_residual(a, fp))):
        want = np.asarray(jfn(x_j).astype(jnp.float32))
        got = tfn(x_t)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err < 2e-2 * max(1.0, np.abs(want).max()), f"max err {err}"


# the tensor-core NHWC pass 2 against its plain version, both in float32 on
# the same h: the splits' remainders (below 2⁻¹⁶ of each product term)
TC_PASS2_F32_BAR = 1e-5


@pytest.mark.parametrize("h_dtype", [torch.bfloat16, torch.float32], ids=["h-bf16", "h-f32"])
@pytest.mark.parametrize("cin,cout,skip", [(24, 16, "conv"), (40, 40, "identity"),
                                           (72, 48, "conv")])
def test_tensor_core_nhwc_pass2_arithmetic_matches_jax(h_dtype, cin, cout, skip):
    """The tensor-core NHWC pass 2 restated in numpy (W2, the re-split
    (W2 ⊙ gate) and Wsk as bf16 hi + lo A operands, out = acc_g + s·acc_p;
    float32 h split into bf16 hi + lo as the kernel splits it), after the
    plain pass 1 and the cSE gate on x holding bf16 values. h in bf16
    (kernel 2): against ``fused_ir_fat`` on bf16 x, under the bf16 bar of
    test_fat_bfloat16_matches_jax. h in float32 (kernel 3): against
    ``fused_inverted_residual`` on the same values in float32, at the JAX
    tests' 1e-3. Both: against the port's plain pass 2 on the same h, in
    float32, within TC_PASS2_F32_BAR·max(1, max|ref|)."""
    rng = np.random.default_rng(cin + cout)
    fp_j, fp = _random_folded(rng, cin, cin, cout, 3, skip)
    hw = 16
    x = jnp.asarray(rng.normal(size=(2, hw, hw, cin)), jnp.bfloat16)
    x32 = torch.from_numpy(np.asarray(x.astype(jnp.float32)))  # bf16 values in float32
    x_in = x32.to(torch.bfloat16) if h_dtype == torch.bfloat16 else x32
    h, sums = tfc.nhwc_pass1_reference(x_in, fp, h_dtype=h_dtype)
    gate = tfm.cse_gate(sums.sum(1), fp, hw * hw)

    def pixels_last(t):  # (B, H, W, C) -> (B, C, H·W)
        return t.reshape(2, hw * hw, -1).transpose(1, 2)

    got = _tensor_core_pass2(pixels_last(h), pixels_last(x32), gate, fp, skip,
                             split_h=h_dtype == torch.float32)
    got = torch.from_numpy(got).transpose(1, 2).reshape(2, hw, hw, cout)
    plain = tfc.nhwc_pass2_reference(h, x32, gate, fp, skip=skip)
    err = float((got - plain).abs().max())
    assert err < TC_PASS2_F32_BAR * max(1.0, float(plain.abs().max())), err
    if h_dtype == torch.bfloat16:
        want = np.asarray(jfc.fused_ir_fat(x, fp_j, interpret=True, skip=skip)
                          .astype(jnp.float32))
        got = got.to(torch.bfloat16).float().numpy()
        err = np.abs(got - want).max()
        assert err < 2e-2 * max(1.0, np.abs(want).max()), f"max err {err}"
    else:
        want = np.asarray(jfm.fused_inverted_residual(x.astype(jnp.float32), fp_j,
                                                      interpret=True))
        err = np.abs(got.numpy() - want).max()
        assert err < 1e-3, f"max err {err}"


def test_nhwc_pass2_staging():
    """TMA stages bf16 x's pass 2 when C_mid % 8 == 0 and h is 16-byte
    aligned, and, unless the skip is "none", C_in % 8 == 0 and x 16-byte
    aligned; plain loads otherwise; float32 x has no staging (the float32
    kernel)."""
    def t(c, dtype=torch.bfloat16, offset=0):
        n = 2 * 4 * 4 * c
        return torch.zeros((n + offset,), dtype=dtype)[offset:].view(2, 4, 4, c)

    for h_dtype in (torch.bfloat16, torch.float32):
        h = t(64, h_dtype)
        assert all(tfc.nhwc_pass2_staging(h, t(48), s) == "tma"
                   for s in ("conv", "identity", "none"))
        assert tfc.nhwc_pass2_staging(t(64, h_dtype, 1), t(48), "none") == "plain"
        assert tfc.nhwc_pass2_staging(t(60, h_dtype), t(48), "none") == "plain"
        for x in (t(48, offset=1), t(44)):  # misaligned view, C_in % 8 != 0
            assert tfc.nhwc_pass2_staging(h, x, "conv") == "plain"
            assert tfc.nhwc_pass2_staging(h, x, "identity") == "plain"
            assert tfc.nhwc_pass2_staging(h, x, "none") == "tma"  # x is not read
    assert tfc.nhwc_pass2_staging(t(64, torch.float32), t(48, torch.float32), "conv") is None


def test_h_dtype_of_the_two_kernels():
    """Kernel 2 keeps h in x's dtype, kernel 3 in float32: the passes'
    plain versions say so."""
    rng = np.random.default_rng(9)
    _, fp = _random_folded(rng, 16, 16, 16, 3, "identity")
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 16)).astype(np.float32)).to(torch.bfloat16)
    h, sums = tfc.nhwc_pass1_reference(x, fp)
    assert h.dtype == torch.bfloat16 and sums.dtype == torch.float32
    h32, _ = tfc.nhwc_pass1_reference(x, fp, h_dtype=torch.float32)
    assert h32.dtype == torch.float32
    torch.testing.assert_close(h32.to(torch.bfloat16), h, rtol=0, atol=0)


def test_pick_th_is_the_jax_rule():
    for args in [(32, 32, 688, 688, 1), (256, 256, 256, 256, 1), (2, 2, 432, 432, 1),
                 (4, 4, 152, 152, 1), (512, 512, 64, 64, 1), (12, 12, 96, 96, 1)]:
        assert tfc._pick_th(*args) == jfc._pick_th(*args), args


def test_nhwc_wrappers_reject_what_the_kernels_cannot_take():
    rng = np.random.default_rng(6)
    _, fp = _random_folded(rng, 16, 16, 16, 3, "identity")
    x = torch.zeros((1, 8, 8, 16))
    with pytest.raises(ValueError, match="activation"):
        tfc.fused_ir_fat(x, fp, activation="relu")
    with pytest.raises(ValueError, match="ksize"):
        tfc.fused_ir_fat(x, fp, ksize=7)
    with pytest.raises(ValueError, match="dtype"):
        tfc.fused_ir_fat(x.half(), fp)
    with pytest.raises(ValueError, match="shape"):
        tfc.fused_ir_fat(torch.zeros((1, 8, 8, 8)), fp)
    with pytest.raises(ValueError, match="wsk"):
        tfc.fused_ir_fat(x, fp, skip="conv")
    with pytest.raises(ValueError, match="device"):
        tfc.fused_ir_fat(x.to("meta"), fp)
    with pytest.raises(ValueError, match="device"):
        tfm.fused_inverted_residual(x.to("meta"), fp)
    with pytest.raises(ValueError, match="dw"):  # kernel 3 is k = 3 only
        tfm.fused_inverted_residual(x, fp._replace(dw=torch.zeros((5, 5, 16))))
    with pytest.raises(ValueError, match="device"):  # the passes alone need the card
        tfc.nhwc_pass1(x, fp)


def _cuda_constants(name):
    """The ``constexpr int`` values of ``csrc/<name>.cu``."""
    import re
    from pathlib import Path

    src = (Path(tfc.__file__).parent / "csrc" / f"{name}.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_nhwc_psum_geometry_follows_the_bf16_tile():
    """bf16 x tiles the output 8 × 32 (the tensor-core pass 1), float32 x
    14 × 14 or 12 × 12: psum's rows per image, on both axes, are the
    kernel's tiles (the constants of csrc/fused_ir_nhwc.cu), and a library
    that tiles otherwise is refused when it is bound."""
    const = _cuda_constants("fused_ir_nhwc")
    for k in (3, 5):
        assert tfc.pass1_tile(k, torch.bfloat16) == (const["kOtHN"], const["kOtWN"]) == (8, 32)
        side = const["kSide"] - 2 * (k // 2)
        assert tfc.pass1_tile(k, torch.float32) == (side, side)
    assert tfc.pass1_tiles(40, 72, 3, torch.bfloat16) == 5 * 3
    assert tfc.pass1_tiles(41, 64, 5, torch.bfloat16) == 6 * 2
    assert tfc.pass1_tiles(40, 72, 3, torch.float32) == 3 * 6
    assert tfc.pass1_tiles(40, 72, 5, torch.float32) == 4 * 6
    # the per-tile sums of h over those tiles add up to the per-image sums
    rng = np.random.default_rng(3)
    _, fp = _random_folded(rng, 16, 16, 16, 3, "identity")
    x = torch.from_numpy(rng.normal(size=(2, 20, 40, 16)).astype(np.float32))
    h, sums = tfc.nhwc_pass1_reference(x, fp)
    th, tw = tfc.pass1_tile(3, torch.bfloat16)
    tiles = [h[:, y:y + th, c:c + tw].sum((1, 2)) for y in range(0, 20, th)
             for c in range(0, 40, tw)]
    assert len(tiles) == tfc.pass1_tiles(20, 40, 3, torch.bfloat16)
    torch.testing.assert_close(torch.stack(tiles, 1).sum(1), sums[:, 0], rtol=1e-5, atol=1e-4)

    class FakeLib:
        def __init__(self, tile):
            for name in ("fused_ir_nhwc_pass1", "fused_ir_nhwc_pass2"):
                setattr(self, name, lambda *a: 0)
            self.fused_ir_nhwc_tile_size = tile

    def tile_of(k, bf16, axis):
        return (8, 32)[axis] if bf16 else 16 - 2 * (k // 2)

    assert tfc.bind_kernels(FakeLib(lambda *a: tile_of(*a))) is not None
    with pytest.raises(RuntimeError, match="tiles"):
        tfc.bind_kernels(FakeLib(lambda k, bf16, axis: 16 - 2 * (k // 2)))
