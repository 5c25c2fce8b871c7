"""The port's optimizer state in the JAX package's bytes, both ways.

The b0 EfficientUnet++ with narrow decoder channels: its parameters as a
flax-layout tree (the port's ``variables_from_state_dict``), the same
numpy gradients through optax (the JAX ``make_optimizer``) and through
the port's ``Optimizer``, for k = 1 and k = 2 (``optax.MultiSteps``, left
between two micro-steps so that the accumulator is not zero).
``flax.serialization.to_bytes`` of the optax state loads into the port
with ``mu``, ``nu`` and the accumulator bit-equal, the port's bytes load
back through ``flax.serialization.from_bytes(tx.init(params), ...)``
bit-equal, and three more steps on both sides then agree to rtol 1e-6,
atol 1e-7 (the bar of ``test_optimizer_matches_optax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from deadtrees_tpu.train import OptimizerConfig as JaxOptimizerConfig
from deadtrees_tpu.train import make_optimizer as jax_make_optimizer
from deadtrees_tpu_torch.models import (
    create_model,
    init_model,
    state_dict_from_variables,
    variables_from_state_dict,
)
from deadtrees_tpu_torch.train import Optimizer, OptimizerConfig
from deadtrees_tpu_torch.train.optim import (
    optimizer_from_bytes,
    optimizer_state_dict,
    optimizer_to_bytes,
)

CFG = dict(learning_rate=1e-2, cosineannealing_tmax=3, gradient_clip_val=0.5, steps_per_epoch=2)


def _model():
    model = create_model("efficientunet++", "timm-efficientnet-b0", in_channels=4, classes=3,
                         decoder_channels=(32, 24, 16, 12, 8), dtype=torch.float32)
    return init_model(model, generator=torch.Generator().manual_seed(3))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _port_tree(model, tensors):
    names = [n for n, _ in model.named_parameters()]
    return variables_from_state_dict(dict(zip(names, tensors)))["params"]


def _grads(params, rng, scale):
    return jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32), params)


@pytest.mark.parametrize("k", [1, 2])
def test_optimizer_state_round_trips_through_flax_bytes(k):
    cfg = dict(CFG, accumulate_grad_batches=k)
    rng = np.random.default_rng(k)
    jmodel = _model()
    params = variables_from_state_dict(jmodel.state_dict())["params"]
    names = [n for n, _ in jmodel.named_parameters()]
    grads = [_grads(params, rng, s) for s in (1e-3, 1.0, 2e-3, 0.5, 3e-3, 1e-3)]

    def port_grads(tree):
        sd = state_dict_from_variables({"params": tree})
        return [sd[n] for n in names]

    tx = jax_make_optimizer(JaxOptimizerConfig(**cfg))

    @jax.jit
    def jax_step(g, s, p):
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    jax_init = jax.jit(tx.init)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax_init(jp)
    model = _model()
    opt = Optimizer(list(model.parameters()), OptimizerConfig(**cfg))
    first = 3 if k == 2 else 2  # k = 2: stop between two micro-steps
    for g in grads[:first]:
        jp, js = jax_step(g, js, jp)
        opt.load_grads(port_grads(g))
        opt.step()
    assert opt.count == (1 if k == 2 else 2) and opt.mini_step == (1 if k == 2 else 0)

    # the port's bytes have flax's layout and load in flax, bit-equal
    state = optimizer_state_dict(opt, model)
    want = serialization.to_state_dict(js)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, state)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, want))
    restored = serialization.from_bytes(jax_init(jp), optimizer_to_bytes(opt, model))
    inner = restored.inner_opt_state if k == 2 else restored
    mine = [opt.mu, opt.nu] + ([opt.acc] if k == 2 else [])
    theirs = [inner[1].mu, inner[1].nu] + ([restored.acc_grads] if k == 2 else [])
    for ours, tree in zip(mine, theirs):
        for a, b in zip(_leaves(_port_tree(model, ours)), _leaves(tree)):
            np.testing.assert_array_equal(a, b)
    assert int(inner[1].count) == int(inner[2].count) == opt.count
    if k == 2:
        assert int(restored.mini_step) == 1 and int(restored.gradient_step) == 1

    # JAX's bytes load into a fresh port optimizer, bit-equal to optax's state
    fresh = Optimizer(list(model.parameters()), OptimizerConfig(**cfg))
    optimizer_from_bytes(fresh, model, serialization.to_bytes(js))
    jinner = js.inner_opt_state if k == 2 else js
    for ours, tree in zip([fresh.mu, fresh.nu] + ([fresh.acc] if k == 2 else []),
                          [jinner[1].mu, jinner[1].nu] + ([js.acc_grads] if k == 2 else [])):
        for a, b in zip(_leaves(_port_tree(model, ours)), _leaves(tree)):
            np.testing.assert_array_equal(a, b)
    assert (fresh.count, fresh.mini_step) == (opt.count, opt.mini_step)

    # three more steps: the reloaded port optimizer and optax agree
    with torch.no_grad():
        for p, v in zip(model.parameters(), port_grads(jax.tree_util.tree_map(np.asarray, jp))):
            p.copy_(v)
    for i, g in enumerate(grads[first:first + 3]):
        jp, js = jax_step(g, js, jp)
        fresh.load_grads(port_grads(g))
        fresh.step()
        got = _leaves(_port_tree(model, list(model.parameters())))
        for a, b in zip(got, _leaves(jp)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=f"step {i}")


def test_state_of_another_k_or_model_is_refused():
    model = _model()
    opt1 = Optimizer(list(model.parameters()), OptimizerConfig(**CFG))
    opt2 = Optimizer(list(model.parameters()), OptimizerConfig(**CFG, accumulate_grad_batches=2))
    with pytest.raises(ValueError, match="accumulate_grad_batches=2"):
        optimizer_from_bytes(opt2, model, optimizer_to_bytes(opt1, model))
    with pytest.raises(ValueError, match="this model's parameters"):
        optimizer_to_bytes(opt1, _model())
