"""The port's model zoo against the JAX package's, weights carried across.

Every architecture and encoder family at 64² with the JAX converter
tests' decoder widths (``DEC_CH``): the JAX model's variables (its
``jax.eval_shape`` tree filled from a seeded numpy generator,
``tests/test_torch_models.py``) go through the port's
``state_dict_from_variables``, and the port's float32 logits must match
``model.apply`` within 2e-3 with equal argmax (the bar of
tests/test_convert_unet.py). The same tree must come back bit for bit
through ``variables_from_state_dict``, and the JAX package's own
``convert_*_checkpoint`` must read the port's ``state_dict()`` (so a
reference ``.ckpt`` and a port model share one key layout).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deadtrees_tpu.models import ENCODERS as JAX_ENCODERS
from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu.models.convert import (
    convert_effunetpp_checkpoint,
    convert_resunet_checkpoint,
    convert_resunetpp_checkpoint,
    convert_unet_checkpoint,
    convert_unetpp_checkpoint,
)
from deadtrees_tpu_torch.models import ENCODERS as PORT_ENCODERS
from deadtrees_tpu_torch.models import (
    canonical_architecture,
    create_model,
    state_dict_from_variables,
    tensor_variables_from_state_dict,
    variables_from_state_dict,
)
from tests.test_torch_models import _paths, fill_tree

DEC_CH = (16, 16, 8, 8, 8)
SIZE = 64

# (architecture, encoder, decoder_attention_type): the parity cases
PARITY = [
    ("unet", "resnet18", None),
    ("unet++", "resnet18", None),
    ("resunet", "resnet18", None),
    ("resunet++", "resnet18", None),
    ("unet", "resnet34", None),
    ("unet", "resnet50", None),
    ("efficientunet++", "resnet18", None),
    ("unet", "resnet18", "scse"),
    ("unet", "resnet18", "se"),
]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _kw(attention):
    kw = dict(in_channels=4, classes=3, decoder_channels=DEC_CH)
    if attention is not None:
        kw["decoder_attention_type"] = attention
    return kw


def meta_tree(arch, encoder, attention=None):
    """The port model's flax-layout tree, built on the meta device (shapes
    only: nothing is allocated or drawn)."""
    with torch.device("meta"):
        model = create_model(arch, encoder, **_kw(attention))
    return tensor_variables_from_state_dict(model.state_dict())


def port_tree(arch, encoder, attention=None, seed=1):
    """The variables of ``numpy_variables`` without tracing the JAX model:
    the port's own tree (which ``test_tree_matches_jax`` holds to the JAX
    tree) filled the same way."""
    return fill_tree(meta_tree(arch, encoder, attention), seed)


@functools.lru_cache(maxsize=None)
def jax_case(arch, encoder, attention):
    """(JAX model, its numpy-filled variables) of a case, made once."""
    jmodel = jax_create_model(arch, encoder, dtype=jnp.float32, **_kw(attention))
    return jmodel, port_tree(arch, encoder, attention)


def port_model(arch, encoder, attention, variables, encoder_name=None):
    """The port's model holding ``variables``, built on the meta device and
    given the converted tensors (no initializer runs)."""
    with torch.device("meta"):
        model = create_model(arch, encoder, dtype=torch.float32, **_kw(attention))
    model.load_state_dict(state_dict_from_variables(variables, encoder_name=encoder_name),
                          assign=True)
    return model


def _input(seed=0, batch=1):
    return np.random.default_rng(seed).normal(size=(batch, SIZE, SIZE, 4)).astype(np.float32)


def _torch_logits(model, x):
    with torch.no_grad():
        out = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    return out.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("arch,encoder,attention", PARITY,
                         ids=[f"{a}-{e}-{t}" for a, e, t in PARITY])
def test_logits_match_jax(arch, encoder, attention):
    jmodel, variables = jax_case(arch, encoder, attention)
    model = port_model(arch, encoder, attention, variables, encoder).eval()
    assert model.architecture == jmodel.architecture.replace("++", "plusplus")
    x = _input()
    want = np.asarray(jax.jit(lambda v, img: jmodel.apply(v, img, train=False))(
        variables, jnp.asarray(x)))
    got = _torch_logits(model, x)
    assert got.shape == want.shape == (1, SIZE, SIZE, 3)
    err = np.abs(got - want).max()
    assert err < 2e-3, f"logits max err {err}"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_train_mode_forward_matches_jax():
    """ResUnet++ (ASPP, the attention gate, conv pairs, ResNet) in train
    mode: the logits and every updated BatchNorm statistic against JAX's
    mutable apply, two images of 64²."""
    jmodel, variables = jax_case("resunet++", "resnet18", None)
    model = port_model("resunet++", "resnet18", None, variables).train()
    x = _input(seed=3, batch=2)
    want, updates = jax.jit(
        lambda v, img: jmodel.apply(v, img, train=True, mutable=["batch_stats"])
    )(variables, jnp.asarray(x))
    got = _torch_logits(model, x)
    err = np.abs(got - np.asarray(want)).max()
    assert err < 2e-3, f"train logits max err {err}"
    new = variables_from_state_dict(model.state_dict())["batch_stats"]
    want_stats = jax.tree_util.tree_leaves_with_path(updates["batch_stats"])
    got_stats = dict(jax.tree_util.tree_leaves_with_path(new))
    assert len(want_stats) == len(got_stats)
    for path, leaf in want_stats:
        np.testing.assert_allclose(got_stats[path], np.asarray(leaf), rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


ROUND_TRIP = PARITY + [("resunet++", "timm-efficientnet-b0", "scse")]


@pytest.mark.parametrize("arch,encoder,attention", ROUND_TRIP,
                         ids=[f"{a}-{e}-{t}" for a, e, t in ROUND_TRIP])
def test_variables_round_trip_is_exact(arch, encoder, attention):
    """flax tree → port state dict → flax tree, bit for bit, with and
    without ``encoder_name`` (the structure is read off the tree)."""
    _, variables = jax_case(arch, encoder, attention)
    model = port_model(arch, encoder, attention, variables)
    for name in (None, encoder):
        back = variables_from_state_dict(model.state_dict(), encoder_name=name)
        for coll in ("params", "batch_stats"):
            assert _paths(back[coll]) == _paths(variables[coll]), coll
            for (p, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(back[coll]),
                jax.tree_util.tree_leaves_with_path(variables[coll]),
            ):
                np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))


JAX_CONVERTERS = {
    "unet": convert_unet_checkpoint,
    "resunet": convert_resunet_checkpoint,
    "unet++": convert_unetpp_checkpoint,
    "resunet++": convert_resunetpp_checkpoint,
}


@pytest.mark.parametrize("arch", sorted(JAX_CONVERTERS))
def test_jax_converters_read_the_port_state_dict(arch):
    """The reference key layout: the JAX package's converter of a
    Lightning ``.ckpt`` (``model.``-prefixed) reads the port's
    ``state_dict()`` into exactly the JAX model's tree, leaf for leaf."""
    jmodel, variables = jax_case(arch, "resnet18", None)
    model = port_model(arch, "resnet18", None, variables)
    sd = {f"model.{k}": v.numpy() for k, v in model.state_dict().items()}
    got = JAX_CONVERTERS[arch](sd, encoder_name="resnet18")
    for coll in ("params", "batch_stats"):
        assert _paths(got[coll]) == _paths(variables[coll]), coll
        for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got[coll]),
                                  jax.tree_util.tree_leaves_with_path(variables[coll])):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(p))


def test_effunetpp_on_resnet_converts_with_jax():
    jmodel, variables = jax_case("efficientunet++", "resnet18", None)
    model = port_model("efficientunet++", "resnet18", None, variables)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    got = convert_effunetpp_checkpoint(sd, encoder_name="resnet18")
    for coll in ("params", "batch_stats"):
        assert _paths(got[coll]) == _paths(variables[coll]), coll


@pytest.mark.parametrize("arch", ["unet", "unet++", "resunet", "resunet++",
                                  "efficientunet++"])
def test_every_architecture_builds_on_every_encoder(arch):
    """The JAX package's ARCHITECTURES × ENCODERS: the port builds each
    and says what it built, on the meta device (an alias ``timm-X`` is the
    registry entry of ``X`` in both packages)."""
    assert set(PORT_ENCODERS) == set(JAX_ENCODERS)
    for encoder in sorted(JAX_ENCODERS):
        if encoder.startswith("timm-"):
            assert PORT_ENCODERS[encoder] is PORT_ENCODERS[encoder[len("timm-"):]]
            assert JAX_ENCODERS[encoder] is JAX_ENCODERS[encoder[len("timm-"):]]
            continue
        with torch.device("meta"):
            model = create_model(arch, encoder, decoder_channels=DEC_CH)
        assert model.architecture == canonical_architecture(arch), encoder
        assert model.encoder_name == encoder


TREE_CASES = [("unet", "resnet34", "scse"), ("unet++", "resnet50", "se"),
              ("resunet", "timm-efficientnet-b3", None), ("resunet++", "resnet50", None),
              ("resunet++", "timm-efficientnet-b0", "scse"), ("efficientunet++", "resnet34", None)]


@pytest.mark.parametrize("arch,encoder,attention", TREE_CASES,
                         ids=[f"{a}-{e}-{t}" for a, e, t in TREE_CASES])
def test_tree_matches_jax(arch, encoder, attention):
    """Paths and shapes of the port's tree equal the JAX model's
    (``jax.eval_shape``), the attention modules included."""
    jmodel = jax_create_model(arch, encoder, dtype=jnp.float32, **_kw(attention))
    want = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 4)), train=False))
    got = meta_tree(arch, encoder, attention)
    for coll in ("params", "batch_stats"):
        assert _paths(got[coll]) == _paths(want[coll]), coll


def test_resnet_rejects_the_efficientnet_conventions():
    with pytest.raises(TypeError, match="ResNet"):
        create_model("unet", "resnet18", encoder_bn_eps=1e-3)
    with pytest.raises(TypeError, match="ResNet"):
        create_model("unet", "resnet34", encoder_options={"pad_type": "same"})
    with pytest.raises(ValueError, match="Attention"):
        create_model("unet", "resnet18", decoder_attention_type="cbam")
    with pytest.raises(ValueError, match="attention"):
        create_model("efficientunet++", "resnet18", decoder_attention_type="scse")


@pytest.mark.parametrize("arch,encoder", [("unet", "resnet34"), ("segformer", "mit-b0")])
def test_multistage_freeze_keeps_the_encoder_batchnorms_on_running_statistics(arch, encoder):
    """The freeze stage: a ResNet's BatchNorms stay in eval mode while the
    decoder's train; SegFormer, with no encoder subtree in either package,
    trains whole."""
    with torch.device("meta"):
        model = create_model(arch, encoder, **_kw(None))
    model.train(True, encoder_train=False)
    norms = [(n, m) for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert norms
    for name, m in norms:
        assert m.training == (not name.startswith("encoder.")), name
    model.train(True)
    assert all(m.training for _, m in norms)
