"""The train, eval and predict steps as compiled programs, on the CPU.

The geometry of ``tests/test_torch_train_step.py``: the b0 EfficientUnet++
with decoder channels (32, 24, 16, 12, 8) at 64², bs 2, float32, its JAX
variables made from numpy. Programs compile with ``aot_eager`` and
``fullgraph=True``. One compiled model runs every check of the train step
in order (module fixture), so that each program compiles once:

- a step against the JAX train step, both optimizers replaced by ones
  that keep the gradients (``tests/test_torch_train_step.py``'s way and
  bars): loss parts rtol 1e-5, the gradients' global norm, the gradients
  and the new ``batch_stats`` rtol 1e-4 with an absolute floor of 1e-4 ×
  the tree's largest magnitude;
- three steps against the same steps run eagerly (``disable_compile()``):
  parameters, Adam state and BatchNorm buffers within rtol 1e-6 / atol
  1e-7 (``tests/test_torch_optim_state.py``'s bar), the buffers bit-equal;
- no recompile across those steps, an epoch change and a learning-rate
  change inside a stage (``torch._dynamo.config.error_on_recompile``);
- a NaN batch through the compiled step, the guard inside its update
  program: parameters, Adam state and BatchNorm buffers bit-equal to
  before, the step counted;
- a compiled ``remat=True`` step (the forward checkpointed): its
  recompute in the backward leaves the BatchNorm buffers where the
  compiled plain step and the eager ``remat=True`` step leave them,
  bit-equal, and its gradients agree with the plain step's.

The eval and predict steps are in ``tests/test_torch_compiled_eval.py``.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deadtrees_tpu.losses.functional import batch_one_hot2dist, class2one_hot
from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu.train import build_loss as jax_build_loss
from deadtrees_tpu.train import make_train_step as jax_make_train_step
from deadtrees_tpu_torch.core import compile_opts, snapshot
from deadtrees_tpu_torch.core.compile_opts import disable_compile, graphs_compiled
from deadtrees_tpu_torch.models import (
    create_model,
    state_dict_from_variables,
    variables_from_state_dict,
)
from deadtrees_tpu_torch.train import (
    Optimizer,
    OptimizerConfig,
    TrainState,
    build_loss,
    make_train_step,
)
from tests.test_torch_models import numpy_variables
from tests.test_torch_train_step import (
    GradRecorder,
    _assert_trees_close,
    _jax_state,
    _port_batch,
    _port_grads_tree,
)

K = 3
N = 64
KW = dict(in_channels=4, classes=K, decoder_channels=(32, 24, 16, 12, 8))
LOSSES = ["GDICE", "FOCAL", "BOUNDARY-RAMPED"]  # the ramp reads the epoch tensor
# one update an epoch, T_max 2: the learning rate changes at every step
CFG = dict(learning_rate=1e-3, cosineannealing_tmax=2, steps_per_epoch=1)


@pytest.fixture(autouse=True, scope="module")
def aot_eager():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    old = os.environ.get(compile_opts.ENV)
    os.environ[compile_opts.ENV] = "backend=aot_eager"
    yield
    torch.set_num_threads(n)
    if old is None:
        del os.environ[compile_opts.ENV]
    else:
        os.environ[compile_opts.ENV] = old


@pytest.fixture(scope="module")
def data():
    jmodel = jax_create_model("efficientunet++", "timm-efficientnet-b0", dtype=jnp.float32, **KW)
    variables = numpy_variables(jmodel, N, seed=7)
    rng = np.random.default_rng(0)
    mask = np.zeros((2, N, N), np.int32)
    mask[:, 8:40, 8:30] = 1
    mask[:, 44:60, 2:20] = 2
    img = (mask[..., None] * 0.3 + rng.normal(size=(2, N, N, 4))).astype(np.float32)
    lu = rng.integers(0, 2, (2, N, N)).astype(np.int32)
    distmap = np.asarray(batch_one_hot2dist(class2one_hot(jnp.asarray(mask), K)))
    batch = {"image": img, "mask": mask, "distmap": distmap, "lu": lu}
    return jmodel, variables, batch


def _port(variables, remat=False):
    model = create_model("efficientunet++", "timm-efficientnet-b0", dtype=torch.float32, **KW)
    model.load_state_dict(state_dict_from_variables(variables))
    step = make_train_step(model, build_loss(LOSSES, K), num_classes=K, remat=remat)
    return model, step


def _state(model, opt):
    return ([t.detach().clone() for t in model.parameters()], [t.clone() for t in opt.mu],
            [t.clone() for t in opt.nu], {k: v.clone() for k, v in model.state_dict().items()
                                          if "running" in k or "num_batches" in k})


@pytest.fixture(scope="module")
def run(data):
    """The compiled step's whole run, in order; its results for the tests."""
    jmodel, variables, batch = data
    out = {}
    jstep = jax_make_train_step(jmodel, jax_build_loss(LOSSES, K), num_classes=K)
    jb = {k: jnp.asarray(batch[k]) for k in ("image", "mask", "distmap")}
    out["jax"] = jstep(_jax_state(variables), jb, jnp.int32(0))

    pb = _port_batch(batch)
    model, step = _port(variables)
    rec = GradRecorder()
    _, out["first"] = step(TrainState(model, rec), pb, 0)
    out["first_grads"] = _port_grads_tree(model, rec.grads)
    out["first_stats"] = snapshot(variables_from_state_dict(model.state_dict())["batch_stats"])
    model.load_state_dict(state_dict_from_variables(variables))  # back to the start

    opt = Optimizer(model.parameters(), OptimizerConfig(**CFG))
    state = TrainState(model, opt)
    step(state, pb, 0)  # the update program's entry for this optimizer
    before = graphs_compiled()
    torch._dynamo.config.error_on_recompile = True
    try:  # an epoch change (1 → 2) and a new learning rate at every step
        out["metrics"] = [step(state, pb, epoch)[1] for epoch in (1, 2)]
    finally:
        torch._dynamo.config.error_on_recompile = False
    out["recompiles"] = graphs_compiled() - before
    out["programs"] = [len(p.compiles) for p in step.programs]
    out["compiled"] = _state(model, opt) + (int(opt.count),)

    eager_model, eager_step = _port(variables)
    eager_opt = Optimizer(eager_model.parameters(), OptimizerConfig(**CFG))
    eager_state = TrainState(eager_model, eager_opt)
    with disable_compile():
        for epoch in (0, 1, 2):
            eager_step(eager_state, pb, epoch)
    out["eager"] = _state(eager_model, eager_opt) + (int(eager_opt.count),)

    bad = dict(pb)
    bad["image"] = pb["image"].clone()
    bad["image"][0, 0, 0, 0] = float("nan")
    out["before_nan"] = _state(model, opt) + (int(opt.count),)
    before = graphs_compiled()
    _, out["nan_metrics"] = step(state, bad, 2)
    out["nan_programs"] = graphs_compiled() - before
    out["after_nan"] = _state(model, opt) + (int(opt.count),)
    out["steps"] = state.step
    return out


def test_compiled_step_matches_jax(run):
    new_j, mj = run["jax"]
    mt = run["first"]
    for k in ("dice_loss", "focal_loss", "boundary_loss", "total_loss", "dice", "dice_with_bg"):
        assert float(mt[k]) == pytest.approx(float(mj[k]), rel=1e-5), k
    assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]), rel=1e-4)
    _assert_trees_close(run["first_grads"], new_j.opt_state)
    _assert_trees_close(run["first_stats"], new_j.batch_stats)


def test_compiled_steps_match_eager_steps(run):
    got, want = run["compiled"], run["eager"]
    for a_list, b_list in zip(got[:3], want[:3]):
        for a, b in zip(a_list, b_list):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    for k, v in want[3].items():
        assert torch.equal(got[3][k], v), k
    assert got[4] == want[4] == 3


def test_no_recompile_across_steps_epochs_and_learning_rates(run):
    # the forward (with its backward); the update, once per optimizer
    assert run["programs"] == [1, 2]
    assert run["recompiles"] == 0
    losses = [float(m["total_loss"]) for m in [run["first"]] + run["metrics"]]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_nan_batch_changes_nothing_in_the_compiled_step(run):
    assert not np.isfinite(float(run["nan_metrics"]["total_loss"]))
    before, after = run["before_nan"], run["after_nan"]
    for a_list, b_list in zip(before[:3], after[:3]):
        assert all(torch.equal(a, b) for a, b in zip(a_list, b_list))
    assert all(torch.equal(after[3][k], v) for k, v in before[3].items())
    assert before[4] == after[4] == 3 and run["steps"] == 4
    assert run["nan_programs"] == 0  # the NaN batch ran the same programs


def test_compiled_remat_step_moves_batchnorm_once(data):
    _, variables, batch = data
    pb = _port_batch(batch)
    out = {}
    for name, remat, eager in (("plain", False, False), ("remat", True, False),
                               ("eager_remat", True, True)):
        model, step = _port(variables, remat=remat)
        rec = GradRecorder()
        with disable_compile() if eager else contextlib.nullcontext():
            _, m = step(TrainState(model, rec), pb, 0)
        # compiled, or not at all (a graph of an earlier test may serve it)
        assert bool(step.programs[0]._compiled) != eager, name
        # on CUDA both programs run eagerly unless asked for (compile_opts)
        assert [p.by_default for p in step.programs] == [False, False]
        out[name] = (m, rec.grads, {k: v for k, v in model.state_dict().items()
                                    if "running" in k or "num_batches" in k})
    (m0, g0, s0), (m1, g1, s1), (_, _, s2) = out["plain"], out["remat"], out["eager_remat"]
    assert float(m1["total_loss"]) == pytest.approx(float(m0["total_loss"]), rel=1e-6)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for k, v in s0.items():
        assert torch.equal(s1[k], v), k
        assert torch.equal(s2[k], v), k
