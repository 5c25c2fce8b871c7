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


@pytest.mark.parametrize("cin,cm", [(16, 16), (48, 40), (688, 688)])
def test_w1_split_in_three_terms_reconstructs_w1(cin, cm):
    """hi + lo + lo2 (the NHWC pass 1 with float32 h) rebuilds W1 within
    2⁻²⁴·|W1|; its first two terms are the two-term split."""
    rng = np.random.default_rng(cin + 1)
    w1 = torch.tensor(rng.normal(0, cin ** -0.5, (cin, cm)), dtype=torch.float32)
    w1[0, 0] = 0.0
    parts = tfm.split_w1(w1, 3)
    assert len(parts) == 3 and all(t.dtype == torch.bfloat16 for t in parts)
    assert all(torch.equal(a, b) for a, b in zip(parts, tfm.split_w1(w1)))
    err = (sum(t.double() for t in parts) - w1.double()).abs()
    assert bool((err <= 2.0 ** -24 * w1.double().abs()).all()), float(err.max())


def _fragment_unpack(packed, cin, cm):
    """W1 back from the packed operand by the mma.m16n8k16 A-fragment
    layout of the PTX ISA (row-major A, bf16): lane l = 4g + t holds
    a0,a1 = A[g][2t, 2t+1], a2,a3 = A[g+8][2t, 2t+1], a4,a5 = A[g][2t+8,
    2t+9], a6,a7 = A[g+8][2t+8, 2t+9] of each 16×16 tile of W1ᵀ."""
    mb, kc, _, terms = packed.shape[:4]
    out = np.zeros((terms, mb * 64, kc * 32), np.float32)  # [hi, lo(, lo2)] W1ᵀ
    p = packed.float().numpy()
    for b in range(mb):
        for c in range(kc):
            for ks in range(2):
                for hl in range(terms):
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


@pytest.mark.parametrize("cin,cm", [(16, 16), (96, 130)])
def test_pack_w1_in_three_terms_follows_the_mma_fragment_layout(cin, cm):
    """pack_w1(w1, terms=3), kernel 3's NHWC pass 1 operand: hi, lo and
    lo2 of each fragment side by side, in the two-term pack's order."""
    rng = np.random.default_rng(cm + 1)
    w1 = torch.tensor(rng.normal(0, 0.3, (cin, cm)), dtype=torch.float32)
    packed = tfm.pack_w1(w1, terms=3)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (-(-cm // 64), -(-cin // 32), 2, 3, 4, 32, 8)
    got = _fragment_unpack(packed, cin, cm)
    for term, want in zip(got, tfm.split_w1(w1, 3), strict=True):
        np.testing.assert_array_equal(term, want.float().t().numpy())
    assert torch.equal(packed[:, :, :, :2], tfm.pack_w1(w1))


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
    """fold_inverted_residual stores pack_w1(w1), pack_w1(w1, terms=3)
    (and pass 2's operands: pack_w1(w2), pack_w1(wsk), pack_sse(sse_w)),
    the operands that the wrappers compute for a hand-built
    FoldedBlockParams without them."""
    _, _, variables = _flax_block(40, 24, 8, seed=6)
    fp = tfm.fold_inverted_residual(_carried_block(variables, 40, 24))
    assert fp.w1_packed is not None
    assert torch.equal(fp.w1_packed, tfm.pack_w1(fp.w1))
    assert torch.equal(fp.w1_packed3, tfm.pack_w1(fp.w1, terms=3))
    n = len(jfm.FoldedBlockParams._fields)
    hand = tfm.FoldedBlockParams(*fp[:n])
    assert hand.w1_packed is None
    assert torch.equal(tfm.pack_w1(hand.w1), fp.w1_packed)
    w2p, ssep, wskp = tfm.pass2_operands(hand, "conv")
    assert torch.equal(w2p, fp.w2_packed) and torch.equal(wskp, fp.wsk_packed)
    assert torch.equal(ssep, fp.sse_packed)
    assert tfm.pass2_operands(hand, "identity")[2] is None
    x = torch.zeros((1, 40, 8, 8))
    tfm._cuda_check(x, fp)  # the bf16 field passes the kernel's checks
    with pytest.raises(ValueError, match="w1_packed"):
        tfm._cuda_check(x, fp._replace(w1_packed=fp.w1_packed.float()))
    with pytest.raises(ValueError, match="w1_packed"):
        tfm._cuda_check(x, fp._replace(w1_packed=fp.w1_packed[:, :1].contiguous()))
    with pytest.raises(ValueError, match="w1_packed3"):  # two terms where three belong
        tfm._cuda_check(x, fp._replace(w1_packed3=fp.w1_packed))
    with pytest.raises(ValueError, match="w1_packed3"):
        tfm._cuda_check(x, fp._replace(w1_packed3=fp.w1_packed3.float()))


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


# ---------------------------------------------------------------------------
# pass 2's operands for the tensor cores: W2ᵀ, (W2 ⊙ gate)ᵀ, the sSE tile, Wskᵀ
# ---------------------------------------------------------------------------


def _sse_unpack(packed, cm):
    """The sSE A tiles (16 × K) back from pack_sse's fragment order, by the
    same mma.m16n8k16 A layout as _fragment_unpack."""
    p = packed.float().numpy()
    kc = p.shape[0]
    out = np.zeros((16, kc * 32), np.float32)
    for c in range(kc):
        for ks in range(2):
            for lane in range(32):
                g, t = divmod(lane, 4)
                c0 = c * 32 + ks * 16 + 2 * t
                for j, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                    out[g + dr, c0 + dc: c0 + dc + 2] = p[c, ks, lane, 2 * j: 2 * j + 2]
    return out[:, :cm]


@pytest.mark.parametrize("cin,cm,cout", [(16, 16, 16), (40, 72, 40), (688, 688, 256)])
def test_pass2_packing_follows_the_mma_fragment_layout(cin, cm, cout):
    """W2ᵀ and Wskᵀ are packed as pack_w1 packs W1ᵀ (their rows the output
    channels), w_sse as one m16 tile a k16 step with hi in row 0 and lo in
    row 1; hi + lo rebuilds each within 2⁻¹⁶ of its float32 weights."""
    rng = np.random.default_rng(cm + cout)
    w2 = torch.tensor(rng.normal(0, cm ** -0.5, (cm, cout)), dtype=torch.float32)
    wsk = torch.tensor(rng.normal(0, cin ** -0.5, (cin, cout)), dtype=torch.float32)
    sse = torch.tensor(rng.normal(0, cm ** -0.5, (cm, 1)), dtype=torch.float32)
    for w, k in ((w2, cm), (wsk, cin)):
        packed = tfm.pack_w1(w)
        assert tuple(packed.shape) == (-(-cout // 64), -(-k // 32), 2, 2, 4, 32, 8)
        got = _fragment_unpack(packed, k, cout)
        hi, lo = tfm.split_w1(w)
        np.testing.assert_array_equal(got[0], hi.float().t().numpy())
        np.testing.assert_array_equal(got[1], lo.float().t().numpy())
        err = np.abs(got[0] + got[1] - w.t().numpy())
        assert (err <= 2.0 ** -16 * np.abs(w.t().numpy())).all(), err.max()
    packed = tfm.pack_sse(sse)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (-(-cm // 32), 2, 32, 8)
    tile = _sse_unpack(packed, cm)
    hi, lo = tfm.split_w1(sse[:, 0])
    np.testing.assert_array_equal(tile[0], hi.float().numpy())
    np.testing.assert_array_equal(tile[1], lo.float().numpy())
    assert not tile[2:].any() and not _sse_unpack(packed, packed.shape[0] * 32)[:, cm:].any()
    err = np.abs(tile[0] + tile[1] - sse[:, 0].numpy())
    assert (err <= 2.0 ** -16 * np.abs(sse[:, 0].numpy())).all(), err.max()


def _bf16_split(a):
    """hi + lo of a float32 numpy array, as bf16 values in float32."""
    hi, lo = tfm.split_w1(torch.from_numpy(a))
    return hi.float().numpy(), lo.float().numpy()


def _tensor_core_pass2(h, x, gate, fp, skip, split_h=False):
    """The tensor-core pass 2's arithmetic in numpy float32, from the
    packed operands it reads: z = (hi + lo)(w_sse)·h; acc_p = W2ᵀh with
    W2 = hi + lo; acc_g = (W2 ⊙ gate)ᵀh, the gated weights formed per image
    from hi + lo and split again into hi + lo (+ Wskᵀx with Wsk = hi + lo);
    out = acc_g + σ(z + b_sse)·acc_p + b2 (+ bsk, or + x). h and x are
    (B, C, pixels). With ``split_h`` (float32 h, the NHWC kernel 3) h is
    split into bf16 hi + lo and each product sums Ahi·hhi + Alo·hhi +
    Ahi·hlo, the sSE logit also Alo·hlo."""
    cin, cm = fp.w1.shape
    cout = fp.w2.shape[1]
    w2 = _fragment_unpack(tfm.pack_w1(fp.w2), cm, cout)  # [hi, lo] of W2ᵀ
    sse = _sse_unpack(tfm.pack_sse(fp.sse_w), cm)
    hf = h.float().numpy()  # (B, C_mid, P) as stored
    xf = x.float().numpy()
    out = np.empty((hf.shape[0], cout, hf.shape[2]), np.float32)

    def product(a_hi, a_lo, hb, hb_lo):
        acc = a_hi @ hb + a_lo @ hb
        return acc if hb_lo is None else acc + a_hi @ hb_lo

    for b in range(hf.shape[0]):
        hb, hb_lo = _bf16_split(hf[b]) if split_h else (hf[b], None)
        z = sse[0] @ hb + sse[1] @ hb
        if split_h:
            z = z + sse[0] @ hb_lo + sse[1] @ hb_lo
        s = 1.0 / (1.0 + np.exp(-(z + fp.sse_b.numpy()[0])))
        acc_p = product(w2[0], w2[1], hb, hb_lo)
        ghi, glo = _bf16_split((w2[0] + w2[1]) * gate.numpy()[b][None, :])
        acc_g = product(ghi, glo, hb, hb_lo)
        o = acc_g + s[None, :] * acc_p + fp.b2.numpy()[:, None]
        if skip == "conv":
            wsk = _fragment_unpack(tfm.pack_w1(fp.wsk), cin, cout)
            o = o + wsk[0] @ xf[b] + wsk[1] @ xf[b] + fp.bsk.numpy()[:, None]
        elif skip == "identity":
            o = o + xf[b]
        out[b] = o
    return out


@pytest.mark.parametrize("cin,cout,skip", [(24, 16, "conv"), (40, 40, "identity"),
                                           (72, 48, "none")])
def test_tensor_core_pass2_arithmetic_matches_jax_bfloat16(cin, cout, skip):
    """The rewritten pass 2, (W2 ⊙ gate)ᵀh + s·(W2ᵀh) with hi + lo weights,
    after the plain pass 1 (h rounded to bf16) and the cSE gate, against
    the JAX kernel (interpret mode) on bf16 x, under the bf16 bar of
    test_fused_chw_bfloat16_matches_jax."""
    rng = np.random.default_rng(cin + cout)
    fp_j, fp_t = _random_folded(rng, cin, cin, cout, 3, "conv" if skip == "conv" else "none")
    x = rng.normal(size=(2, cin, 16, 16)).astype(np.float32)
    x_j = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jfm.fused_inverted_residual_chw(
        x_j, fp_j, interpret=True, skip=skip).astype(jnp.float32))
    x_t = torch.from_numpy(np.asarray(x_j.astype(jnp.float32))).to(torch.bfloat16)
    h, sums = tfm.chw_pass1_reference(x_t, fp_t)
    gate = tfm.cse_gate(sums.sum(1), fp_t, 16 * 16)
    got = _tensor_core_pass2(h.reshape(2, cin, -1), x_t.reshape(2, cin, -1), gate, fp_t, skip)
    got = torch.from_numpy(got).to(torch.bfloat16).float().numpy().reshape(want.shape)
    err = np.abs(got - want).max()
    assert err < 2e-2 * max(1.0, np.abs(want).max()), f"max err {err}"
    # and it is the plain pass 2 up to the split's 2⁻¹⁶
    plain = tfm.chw_pass2_reference(h, x_t, gate, fp_t, skip=skip).float().numpy()
    assert np.abs(got - plain).max() < 2e-2 * max(1.0, np.abs(plain).max())
