"""The port's weight and activation quantization against the JAX package.

``quantize_params`` / ``dequantize_params`` / ``quantized_nbytes`` run the
JAX functions' numpy code, so ``q``, ``scale`` and the bfloat16-rounded
weights are bit-equal. ``calibrate_decoder`` on the same float32 feature
pyramid gives the same per-channel scales (rtol 1e-4: float32 sums in
another order); the int8 block agrees with JAX's on the same scales, and
with no quantized site it restates ``folded_block_nhwc`` (the port's copy
of the JAX drift guard, 2e-5). Geometry of tests/test_act_quant.py: b0,
decoder channels (24, 16, 16, 8, 8), 32².
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import numpy_variables

from deadtrees_tpu.infer import act_quant as jaq
from deadtrees_tpu.infer import quantize as jq
from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu.ops import fused_decoder as jfd
from deadtrees_tpu_torch.infer import act_quant as taq
from deadtrees_tpu_torch.infer import quantize as tq
from deadtrees_tpu_torch.models import create_model, state_dict_from_variables
from deadtrees_tpu_torch.ops import fused_decoder as tfd

HP = dict(in_channels=4, classes=3, decoder_channels=(24, 16, 16, 8, 8))


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_create_model("efficientunet++", "timm-efficientnet-b0", dtype=jnp.float32, **HP)
    variables = numpy_variables(jmodel, 32, seed=5)
    model = create_model("efficientunet++", "timm-efficientnet-b0", dtype=torch.float32,
                         **HP).eval()
    model.load_state_dict(state_dict_from_variables(variables))
    img = np.random.default_rng(2).normal(size=(2, 32, 32, 4)).astype(np.float32)
    feats = [np.asarray(f) for f in jax.jit(
        lambda v, x: jfd.encode_features(jmodel, v, x))(variables, jnp.asarray(img))]
    return variables, model, feats


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_quantize_params_bit_equal(pair):
    variables, _, _ = pair
    want = jq.quantize_params(variables["params"])
    got = tq.quantize_params(variables["params"])
    lw, lg = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in lw] == [p for p, _ in lg]
    assert any(p[-1] == "q" for p, _ in lg)
    for (path, a), (_, b) in zip(lw, lg):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(path))
    assert tq.quantized_nbytes(got) == jq.quantized_nbytes(want)
    # the dequantized bfloat16 weights the w8 engines serve
    deq_j = jax.jit(lambda t: jq.dequantize_params(t, dtype=jnp.bfloat16))(want)
    deq_t = tq.dequantize_params(got, dtype=torch.bfloat16)
    for (path, a), (_, b) in zip(_leaves(deq_j), _leaves(deq_t)):
        a = np.asarray(jnp.asarray(a).astype(jnp.float32))
        np.testing.assert_array_equal(b.float().numpy(), a, err_msg=str(path))


def test_quantize_roundtrip_error_bounded():
    w = np.random.default_rng(0).normal(size=(3, 3, 16, 32)).astype(np.float32)
    q = tq.quantize_params({"k": w, "b": np.zeros(32, np.float32)})
    assert q["k"]["q"].dtype == np.int8 and q["b"].dtype == np.float32
    err = np.abs(tq.dequantize_params(q)["k"].numpy() - w)
    assert (err <= np.abs(w).max(axis=(0, 1, 2)) / 254.0 + 1e-7).all()
    assert tq.argmax_agreement(np.array([1, 2, 0]), np.array([1, 2, 2])) == pytest.approx(2 / 3)


def test_calibrate_decoder_matches_jax(pair):
    variables, model, feats = pair
    folded_j = jfd.fold_effunetpp_decoder(variables)
    want = jax.jit(lambda f: jaq.calibrate_decoder(f, folded_j, HP["decoder_channels"]))(
        [jnp.asarray(f) for f in feats])
    folded = tfd.fold_effunetpp_decoder(model)
    got = taq.calibrate_decoder([torch.from_numpy(f) for f in feats], folded,
                                HP["decoder_channels"])
    assert set(got) == set(want) and len(got) == 66  # 22 blocks × y, h, s
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-4, err_msg=k)


def test_int8_decoder_matches_jax(pair):
    """The whole int8 decoder (all three sites) on the same scales."""
    variables, model, feats = pair
    folded_j = jfd.fold_effunetpp_decoder(variables)
    dc = HP["decoder_channels"]

    @jax.jit
    def jax_int8(f):
        scales = jaq.calibrate_decoder(f, folded_j, dc)
        return scales, fused_decoder_nhwc_j(f, scales)

    def fused_decoder_nhwc_j(f, scales):
        return jfd.fused_decoder_nhwc(f, folded_j, dc, block_fn=jaq.make_int8_block_fn(scales))

    scales_j, want = jax_int8([jnp.asarray(f) for f in feats])
    want = np.asarray(want)
    scales = {k: torch.from_numpy(np.asarray(v)) for k, v in scales_j.items()}
    got = tfd.fused_decoder_nhwc(
        [torch.from_numpy(f) for f in feats], tfd.fold_effunetpp_decoder(model), dc,
        block_fn=taq.make_int8_block_fn(scales)).numpy()
    # a value next to a rounding boundary of the int8 grid may take the
    # neighbouring code when the float32 sums before it are taken in another
    # order; the step then travels on through the grid: bounded at 1 % of
    # the decoded range at a pixel and 0.1 % of the mean magnitude overall
    err = np.abs(got - want)
    assert err.max() < 1e-2 * max(1.0, np.abs(want).max()), err.max()
    assert err.mean() < 1e-3 * np.abs(want).mean(), err.mean()


def test_no_sites_block_matches_plain_nhwc_block(pair):
    """Drift guard: ``folded_block_int8`` with no quant site restates
    ``folded_block_nhwc`` (the JAX guard's bar, 2e-5)."""
    _, model, _ = pair
    folded = tfd.fold_effunetpp_decoder(model)
    rng = np.random.default_rng(3)
    blocks = [fp for fps in folded.values() for fp in fps][:4]
    assert any(fp.wsk is None for fp in blocks) and any(fp.wsk is not None for fp in blocks)
    for fp in blocks:
        x = torch.from_numpy(rng.normal(size=(2, 16, 16, fp.w1.shape[0])).astype(np.float32))
        want = tfd.folded_block_nhwc(x, fp)
        got = taq.folded_block_int8(x, fp, scales={}, sites=frozenset())
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
