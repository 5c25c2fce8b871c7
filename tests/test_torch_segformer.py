"""The port's SegFormer against the JAX package's.

mit-b0 at 64² in float32: the JAX model's variables (``jax.eval_shape``
filled from a seeded numpy generator) go through the port's
``state_dict_from_variables``; the logits must match ``model.apply``
within 2e-3 with equal argmax, in eval and in train mode (with the
decoder BatchNorm's updated statistics). The tree comes back bit for
bit, every MiT variant's tree is the JAX one, and the half-pixel bilinear
resize the decoder uses equals ``jax.image.resize`` at the borders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu_torch.models import (
    create_model,
    state_dict_from_variables,
    tensor_variables_from_state_dict,
    variables_from_state_dict,
)
from tests.test_torch_models import _paths, numpy_variables

SIZE = 64
KW = dict(in_channels=4, classes=3)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    jmodel = jax_create_model("segformer", "mit-b0", dtype=jnp.float32, **KW)
    variables = numpy_variables(jmodel, SIZE)
    model = create_model("segformer", "mit-b0", dtype=torch.float32, **KW)
    model.load_state_dict(state_dict_from_variables(variables, encoder_name="mit-b0"))
    return jmodel, variables, model


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_logits_match_jax(case, train):
    jmodel, variables, model = case
    model.train(train)
    x = np.random.default_rng(4).normal(size=(2, SIZE, SIZE, 4)).astype(np.float32)
    if train:
        want, updates = jax.jit(lambda v, a: jmodel.apply(
            v, a, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    else:
        want = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    err = np.abs(got - want).max()
    assert err < 2e-3, f"logits max err {err}"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if train:
        stats = variables_from_state_dict(model.state_dict())["batch_stats"]["BatchNorm_0"]
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats[k], np.asarray(updates["batch_stats"]["BatchNorm_0"][k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_round_trip_is_exact(case):
    _, variables, _ = case
    model = create_model("segformer", "mit-b0", dtype=torch.float32, **KW)
    model.load_state_dict(state_dict_from_variables(variables))
    assert model.architecture == "segformer" and model.encoder_name == "mit-b0"
    back = variables_from_state_dict(model.state_dict())
    for coll in ("params", "batch_stats"):
        assert _paths(back[coll]) == _paths(variables[coll])
        for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back[coll]),
                                  jax.tree_util.tree_leaves_with_path(variables[coll])):
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("name", ["mit-b1", "mit-b2", "resnet34"])
def test_variant_trees_match_jax(name):
    """The encoder-name rule of the JAX factory (a non-MiT name builds
    mit-b0) and the trees of the wider and deeper variants."""
    jmodel = jax_create_model("segformer", name, dtype=jnp.float32, **KW)
    want = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 4)), train=False))
    with torch.device("meta"):
        model = create_model("segformer", name, **KW)
    assert model.encoder_name == jmodel.encoder_name.lower()
    got = tensor_variables_from_state_dict(model.state_dict())
    for coll in ("params", "batch_stats"):
        assert _paths(got[coll]) == _paths(want[coll]), coll


@pytest.mark.parametrize("scale", [2, 4, 8])
def test_bilinear_resize_matches_jax_at_the_borders(scale):
    x = np.random.default_rng(scale).normal(size=(1, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 5 * scale, 7 * scale, 3),
                                       method="bilinear"))
    got = F.interpolate(_nchw(x), scale_factor=scale, mode="bilinear",
                        align_corners=False).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:, :, -1], want[:, :, -1], rtol=0, atol=1e-5)


def test_bfloat16_forward_stays_close():
    """In bfloat16 the residual stream stays bfloat16 (flax's compute type)
    and the logits come out float32 near the float32 model's."""
    model = create_model("segformer", "mit-b0", dtype=torch.float32, **KW).eval()
    x = torch.randn(1, 4, SIZE, SIZE, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = model(x)
        model.dtype = torch.bfloat16
        with model.autocast("cpu"):
            feats = model.encode(x)
        got = model(x)
    assert all(f.dtype == torch.bfloat16 for f in feats)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - ref).abs().max() < 0.1 * max(1.0, ref.abs().max().item())
