"""The port's fused inverted-residual block against the JAX one.

On a CPU tensor ``deadtrees_tpu_torch.ops.fused_mbconv.fused_inverted_residual_chw``
runs its plain PyTorch version; the JAX side runs the Pallas kernel in
interpret mode, as tests/test_fused_mbconv.py does. Same inputs (numpy,
seeded), same parametrizations, the JAX test's bar (max error < 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deadtrees_tpu.models.blocks import InvertedResidual as JaxInvertedResidual
from deadtrees_tpu.ops import fused_mbconv as jfm
from deadtrees_tpu_torch.models.blocks import InvertedResidual
from deadtrees_tpu_torch.models.convert import state_dict_from_inverted_residual
from deadtrees_tpu_torch.ops import fused_mbconv as tfm


def _randomized_variables(module, x):
    """init, then randomize BN stats so folding is actually exercised."""
    variables = module.init(jax.random.PRNGKey(0), x, train=False)
    rng = np.random.default_rng(1)

    def jiggle(path, leaf):
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return jnp.asarray(rng.uniform(-0.3, 0.3, leaf.shape), leaf.dtype)
        if "var" in name:
            return jnp.asarray(rng.uniform(0.7, 1.3, leaf.shape), leaf.dtype)
        if "scale" in name:
            return jnp.asarray(rng.uniform(0.8, 1.2, leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(jiggle, variables)


def _carried_block(variables, cin, cout):
    """The port's InvertedResidual with the flax block's weights."""
    block = InvertedResidual(cin, cout).eval()
    np_vars = jax.tree_util.tree_map(np.asarray, variables)
    block.load_state_dict(
        state_dict_from_inverted_residual(np_vars["params"], np_vars["batch_stats"])
    )
    return block


def _flax_block(cin, cout, hw, seed):
    module = JaxInvertedResidual(
        features=cout, expansion_ratio=1, squeeze_ratio=1, dtype=jnp.float32
    )
    x = np.random.default_rng(seed).normal(size=(2, hw, hw, cin)).astype(np.float32)
    return module, x, _randomized_variables(module, jnp.asarray(x))


@pytest.mark.parametrize("cin,cout,hw", [(16, 16, 32), (24, 16, 16), (16, 32, 8)])
def test_fused_chw_matches_jax(cin, cout, hw):
    module, x, variables = _flax_block(cin, cout, hw, seed=3)
    fp_j = jfm.fold_inverted_residual(variables["params"], variables["batch_stats"])
    x_chw = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    want = np.asarray(jfm.fused_inverted_residual_chw(jnp.asarray(x_chw), fp_j, interpret=True))

    block = _carried_block(variables, cin, cout)
    fp = tfm.fold_inverted_residual(block)
    got = tfm.fused_inverted_residual_chw(torch.from_numpy(x_chw), fp)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err < 1e-3, f"max err {err}"

    # and the port's own unfused block agrees with its fused path
    with torch.no_grad():
        plain = block(torch.from_numpy(x_chw)).numpy()
    assert np.abs(got.numpy() - plain).max() < 1e-3


@pytest.mark.parametrize("cin,cout", [(16, 16), (24, 16)])
def test_fold_matches_jax(cin, cout):
    _, _, variables = _flax_block(cin, cout, 8, seed=4)
    fp_j = jfm.fold_inverted_residual(variables["params"], variables["batch_stats"])
    fp = tfm.fold_inverted_residual(_carried_block(variables, cin, cout))
    for name, want in fp_j._asdict().items():
        got = getattr(fp, name)
        if want is None:
            assert got is None, name
            continue
        assert tuple(got.shape) == tuple(want.shape), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, err_msg=name)


def _random_folded(rng, cin, cmid, cout, ksize, skip):
    """The generalized-mode weights of tests/test_fused_mbconv.py, as
    numpy arrays (one draw order, fed to both packages)."""
    arrays = dict(
        w1=rng.normal(0, 0.2, (cin, cmid)), b1=rng.normal(0, 0.1, (cmid,)),
        dw=rng.normal(0, 0.2, (ksize, ksize, cmid)), b_dw=rng.normal(0, 0.1, (cmid,)),
        cse_w1=rng.normal(0, 0.2, (cmid, 4)), cse_b1=rng.normal(0, 0.1, (4,)),
        cse_w2=rng.normal(0, 0.2, (4, cmid)), cse_b2=rng.normal(0, 0.1, (cmid,)),
        sse_w=rng.normal(0, 0.2, (cmid, 1)), sse_b=rng.normal(0, 0.1, (1,)),
        w2=rng.normal(0, 0.2, (cmid, cout)), b2=rng.normal(0, 0.1, (cout,)),
        wsk=rng.normal(0, 0.2, (cin, cout)) if skip == "conv" else None,
        bsk=rng.normal(0, 0.1, (cout,)) if skip == "conv" else None,
    )
    as_j = {k: None if v is None else jnp.asarray(v, jnp.float32) for k, v in arrays.items()}
    as_t = {k: None if v is None else torch.tensor(v, dtype=torch.float32)
            for k, v in arrays.items()}
    return jfm.FoldedBlockParams(**as_j), tfm.FoldedBlockParams(**as_t)


@pytest.mark.parametrize(
    "ksize,act,skip", [(5, "silu", "none"), (3, "silu", "identity"), (5, "hswish", "conv")]
)
def test_fused_chw_generalized_modes_match_jax(ksize, act, skip):
    rng = np.random.default_rng(0)
    cin, cmid, cout, hw = 16, 16, 16 if skip != "conv" else 24, 16
    fp_j, fp_t = _random_folded(rng, cin, cmid, cout, ksize, skip)
    x = rng.normal(size=(2, cin, hw, hw)).astype(np.float32)
    want = np.asarray(jfm.fused_inverted_residual_chw(
        jnp.asarray(x), fp_j, interpret=True, activation=act, ksize=ksize, skip=skip))
    got = tfm.fused_inverted_residual_chw(
        torch.from_numpy(x), fp_t, activation=act, ksize=ksize, skip=skip)
    err = np.abs(got.numpy() - want).max()
    assert err < 1e-3, f"max err {err}"


def test_fused_chw_bfloat16_matches_jax():
    """bf16 input: h is stored in bf16 between the passes on both sides.
    Bar 2e-2 x max(1, max|ref|): one bf16 rounding of h may land on the
    other side of a tie when the f32 sums are taken in another order."""
    rng = np.random.default_rng(5)
    fp_j, fp_t = _random_folded(rng, 24, 24, 16, 3, "conv")
    x = rng.normal(size=(2, 24, 16, 16)).astype(np.float32)
    x_j = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(
        jfm.fused_inverted_residual_chw(x_j, fp_j, interpret=True).astype(jnp.float32)
    )
    got = tfm.fused_inverted_residual_chw(
        torch.from_numpy(np.asarray(x_j.astype(jnp.float32))).to(torch.bfloat16), fp_t
    )
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err < 2e-2 * max(1.0, np.abs(want).max()), f"max err {err}"


def test_wrapper_rejects_what_the_kernel_cannot_take():
    rng = np.random.default_rng(6)
    _, fp = _random_folded(rng, 16, 16, 16, 3, "identity")
    x = torch.zeros((1, 16, 8, 8))
    with pytest.raises(ValueError, match="activation"):
        tfm.fused_inverted_residual_chw(x, fp, activation="relu")
    with pytest.raises(ValueError, match="ksize"):
        tfm.fused_inverted_residual_chw(x, fp, ksize=7)
    with pytest.raises(ValueError, match="dtype"):
        tfm.fused_inverted_residual_chw(x.half(), fp)
    with pytest.raises(ValueError, match="shape"):
        tfm.fused_inverted_residual_chw(torch.zeros((1, 8, 8, 8)), fp)
    with pytest.raises(ValueError, match="wsk"):
        tfm.fused_inverted_residual_chw(x, fp, skip="conv")
    with pytest.raises(ValueError, match="device"):
        tfm.fused_inverted_residual_chw(x.to("meta"), fp)


# ---------------------------------------------------------------------------
# W1 split into bf16 hi + lo for the tensor-core pass 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin,cm", [(16, 16), (48, 40), (688, 688)])
def test_w1_split_reconstructs_w1(cin, cm):
    rng = np.random.default_rng(cin)
    w1 = torch.tensor(rng.normal(0, cin ** -0.5, (cin, cm)), dtype=torch.float32)
    w1[0, 0] = 0.0
    hi, lo = tfm.split_w1(w1)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.float() + lo.float() - w1).abs()
    assert bool((err <= 2.0 ** -16 * w1.abs()).all()), float(err.max())


def _fragment_unpack(packed, cin, cm):
    """W1 back from the packed operand by the mma.m16n8k16 A-fragment
    layout of the PTX ISA (row-major A, bf16): lane l = 4g + t holds
    a0,a1 = A[g][2t, 2t+1], a2,a3 = A[g+8][2t, 2t+1], a4,a5 = A[g][2t+8,
    2t+9], a6,a7 = A[g+8][2t+8, 2t+9] of each 16×16 tile of W1ᵀ."""
    mb, kc = packed.shape[:2]
    out = np.zeros((2, mb * 64, kc * 32), np.float32)  # [hi, lo] W1ᵀ
    p = packed.float().numpy()
    for b in range(mb):
        for c in range(kc):
            for ks in range(2):
                for hl in range(2):
                    for mt in range(4):
                        for lane in range(32):
                            g, t = divmod(lane, 4)
                            v = p[b, c, ks, hl, mt, lane]
                            r0 = b * 64 + mt * 16 + g
                            c0 = c * 32 + ks * 16 + 2 * t
                            for j, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                                out[hl, r0 + dr, c0 + dc: c0 + dc + 2] = v[2 * j: 2 * j + 2]
    return out[:, :cm, :cin]


@pytest.mark.parametrize("cin,cm", [(16, 16), (40, 72), (96, 130)])
def test_pack_w1_follows_the_mma_fragment_layout(cin, cm):
    rng = np.random.default_rng(cm)
    w1 = torch.tensor(rng.normal(0, 0.3, (cin, cm)), dtype=torch.float32)
    packed = tfm.pack_w1(w1)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (-(-cm // 64), -(-cin // 32), 2, 2, 4, 32, 8)
    hi, lo = tfm.split_w1(w1)
    got = _fragment_unpack(packed, cin, cm)
    np.testing.assert_array_equal(got[0], hi.float().t().numpy())
    np.testing.assert_array_equal(got[1], lo.float().t().numpy())
    # the zero padding past C_in and C_mid
    full = _fragment_unpack(packed, packed.shape[1] * 32, packed.shape[0] * 64)
    assert not full[:, cm:].any() and not full[:, :, cin:].any()


@pytest.mark.parametrize("cin,cout", [(24, 16), (688, 256)])
def test_split_w1_block_matches_jax_bfloat16(cin, cout):
    """The plain block fed W1 rebuilt as float(hi) + float(lo), the
    precision of the tensor-core pass 1, against the JAX kernel (interpret
    mode) on bf16 x, under the bf16 bar of test_fused_chw_bfloat16_matches_jax;
    C_in = 688 is the flagship's widest decoder cell."""
    rng = np.random.default_rng(cin + 7)
    fp_j, fp_t = _random_folded(rng, cin, cin, cout, 3, "conv")
    hi, lo = tfm.split_w1(fp_t.w1)
    fp_split = fp_t._replace(w1=hi.float() + lo.float())
    x = rng.normal(size=(1, cin, 16, 16)).astype(np.float32)
    x_j = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(
        jfm.fused_inverted_residual_chw(x_j, fp_j, interpret=True).astype(jnp.float32))
    got = tfm.fused_inverted_residual_chw(
        torch.from_numpy(np.asarray(x_j.astype(jnp.float32))).to(torch.bfloat16), fp_split)
    err = np.abs(got.float().numpy() - want).max()
    assert err < 2e-2 * max(1.0, np.abs(want).max()), f"max err {err}"


def test_fold_fills_the_packed_weights():
    """fold_inverted_residual stores pack_w1(w1), the operand that the
    wrapper computes for a hand-built FoldedBlockParams without it."""
    _, _, variables = _flax_block(40, 24, 8, seed=6)
    fp = tfm.fold_inverted_residual(_carried_block(variables, 40, 24))
    assert fp.w1_packed is not None
    assert torch.equal(fp.w1_packed, tfm.pack_w1(fp.w1))
    hand = tfm.FoldedBlockParams(*fp[:-1])
    assert hand.w1_packed is None
    assert torch.equal(tfm.pack_w1(hand.w1), fp.w1_packed)
    x = torch.zeros((1, 40, 8, 8))
    tfm._cuda_check(x, fp)  # the bf16 field passes the kernel's checks
    with pytest.raises(ValueError, match="w1_packed"):
        tfm._cuda_check(x, fp._replace(w1_packed=fp.w1_packed.float()))
    with pytest.raises(ValueError, match="w1_packed"):
        tfm._cuda_check(x, fp._replace(w1_packed=fp.w1_packed[:, :1].contiguous()))


def test_a_probe_build_is_a_library_of_its_own():
    """``tools/probe_pass1.py`` builds fused_ir_chw.cu with a macro: that
    variant gets its own library name and flags, and the plain library's
    stay as they were."""
    from deadtrees_tpu_torch.ops import _build

    probe = ("DT_PASS1_PROBE",)
    assert _build._flags() == _build.NVCC_FLAGS
    assert _build._flags(probe) == (*_build.NVCC_FLAGS, "-DDT_PASS1_PROBE")
    plain, variant = _build._target("fused_ir_chw"), _build._target("fused_ir_chw", probe)
    assert plain.name.startswith("fused_ir_chw-") and plain.parent == variant.parent
    assert variant.name.startswith("fused_ir_chw-dt_pass1_probe-") and variant != plain
