"""The port's EfficientUnet++ against the JAX model, weights carried across.

JAX ``init_model`` variables (filled from a seeded numpy generator, BN
statistics randomized as in tests/test_fused_decoder.py) go through the port's
``state_dict_from_variables``; the port model's logits must match
``model.apply`` under the bar of tests/test_convert_flagship.py (max error
< 3e-3 and equal argmax), for both encoder conventions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu.models import init_model as jax_init_model
from deadtrees_tpu.models.convert import convert_effunetpp_checkpoint
from deadtrees_tpu_torch.models import (
    create_model,
    init_model,
    state_dict_from_variables,
    variables_from_state_dict,
)

DEC_CH = (32, 24, 16, 12, 8)
B5_DEC_CH = (256, 128, 64, 32, 16)


def numpy_variables(model, image_size, seed=1):
    """The tree of JAX ``init_model`` (its shapes through ``jax.eval_shape``)
    filled from a seeded numpy generator: conv kernels from a normal of std
    1/sqrt(fan_in), small biases, BN scales near 1 and randomized running
    statistics, as tests/test_fused_decoder.py randomizes them. Filling
    from numpy keeps the eager flax initializers, which compile one small
    program per parameter on the CPU, out of the test's time."""
    shapes = jax.eval_shape(
        lambda: jax_init_model(model, jax.random.PRNGKey(0), image_size=image_size)
    )
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "kernel" in name:
            draw = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif "scale" in name:
            draw = rng.uniform(0.8, 1.2, shape)
        elif "mean" in name:
            draw = rng.uniform(-0.2, 0.2, shape)
        elif "var" in name:
            draw = rng.uniform(0.8, 1.2, shape)
        else:
            draw = rng.normal(0.0, 0.05, shape)
        return draw.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _paths(tree):
    return {
        jax.tree_util.keystr(p): tuple(np.shape(v))
        for p, v in jax.tree_util.tree_leaves_with_path(tree)
    }


@pytest.mark.parametrize(
    "conventions,size",
    [({}, 64), ({"encoder_bn_eps": 1e-5}, 64), ({"encoder_pad_type": "same"}, 64)],
    ids=["default", "bn_eps_1e-5", "pad_same"],
)
def test_logits_match_jax(conventions, size):
    kw = dict(in_channels=4, classes=3, decoder_channels=DEC_CH, **conventions)
    jmodel = jax_create_model(
        "efficientunet++", "timm-efficientnet-b0", dtype=jnp.float32, **kw
    )
    variables = numpy_variables(jmodel, size)
    model = create_model(
        "efficientunet++", "timm-efficientnet-b0", dtype=torch.float32, **kw
    ).eval()
    model.load_state_dict(state_dict_from_variables(variables))

    x = np.random.default_rng(0).normal(size=(1, size, size, 4)).astype(np.float32)
    apply = jax.jit(lambda v, img: jmodel.apply(v, img, train=False))
    want = np.asarray(apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err < 3e-3, f"logits max err {err}"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_state_dict_round_trip_is_exact():
    jmodel = jax_create_model(
        "efficientunet++", "timm-efficientnet-b0", in_channels=4, classes=3,
        decoder_channels=DEC_CH, dtype=jnp.float32,
    )
    variables = numpy_variables(jmodel, 32)
    model = create_model("efficientunet++", "timm-efficientnet-b0",
                         decoder_channels=DEC_CH)
    model.load_state_dict(state_dict_from_variables(variables))

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    for back in (
        convert_effunetpp_checkpoint(sd, width_mult=1.0, depth_mult=1.0),
        variables_from_state_dict(model.state_dict()),
    ):
        for coll in ("params", "batch_stats"):
            assert _paths(back[coll]) == _paths(variables[coll])
            for (p, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(back[coll]),
                jax.tree_util.tree_leaves_with_path(variables[coll]),
            ):
                np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))


def test_b5_tree_structure_matches_jax():
    """The port's flagship converts to exactly the flax tree of the JAX
    flagship (paths and shapes; eval_shape, so no b5 compute runs)."""
    jmodel = jax_create_model("efficientunet++", "timm-efficientnet-b5")
    want = jax.eval_shape(
        lambda: jax_init_model(jmodel, jax.random.PRNGKey(0), image_size=64)
    )
    model = init_model(create_model(), generator=torch.Generator().manual_seed(0))
    assert sum(len(stage) for stage in model.encoder.blocks) == 39
    assert len(model.decoder.blocks) == 11
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    got = convert_effunetpp_checkpoint(sd, width_mult=1.6, depth_mult=2.2)
    for coll in ("params", "batch_stats"):
        assert _paths(got[coll]) == _paths(want[coll]), coll
    assert _paths(variables_from_state_dict(model.state_dict())["params"]) == _paths(
        want["params"]
    )


def test_create_model_rejects_what_it_does_not_build():
    with pytest.raises(TypeError):
        create_model(foo=1)
    with pytest.raises(TypeError):
        create_model(encoder_options={"bn_eps": 1e-5, "stride": 2})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model("unet", "resnet18")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model("efficientunet++", "resnet34")
    with pytest.raises(NotImplementedError):
        create_model("fpn")
    # the hparams keys the JAX trainer writes are all accepted
    hp = {"architecture": "efficientunet++", "encoder_name": "timm-efficientnet-b0",
          "decoder_channels": list(DEC_CH), "in_channels": 4, "classes": 3,
          "encoder_weights": None}
    model = create_model(**hp)
    assert model.dtype == torch.bfloat16
    # encoder_options is a real parameter; explicit knobs win over it
    m = create_model(encoder_name="timm-efficientnet-b0", decoder_channels=DEC_CH,
                     encoder_options={"bn_eps": 1e-5, "pad_type": "same"},
                     encoder_pad_type="static")
    assert m.encoder.bn1.eps == 1e-5
    assert m.encoder.conv_stem.pad_type == "static"
