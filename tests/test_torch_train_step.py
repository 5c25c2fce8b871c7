"""The port's train / eval steps and optimizer against the JAX package.

The b0 EfficientUnet++ with narrow decoder channels at 64², bs 2, float32.
JAX variables are made from numpy (tests/test_torch_models.py) and carried
into the port by ``models/convert.py``. To read the JAX step's gradients,
its optimizer is a transformation that keeps the (masked) gradients as its
state and emits zero updates; the port's step gets an optimizer that
records them. One JAX train step is compiled per variant (unfrozen and
frozen encoder), once for the module.

Bars: loss parts rtol 1e-5; gradients, their global norm and the new
``batch_stats`` rtol 1e-4, with an absolute floor of 1e-4 × the largest
magnitude in the whole tree, for elements that cancel to near zero (a
bias ahead of a train-mode BatchNorm has a gradient that is zero but for
rounding) and for float32 sums taken in another order through the depth
of the network. At 64² the deepest features are 2×2, so a BatchNorm there sees
n = 8 values and the biased and unbiased variances differ by 8/7: the
``batch_stats`` check covers the repaired running variance. (At 32² the
deepest BatchNorms see n = 2 values and normalize to ±d/sqrt(d² + eps):
in train mode the two packages' last-digit rounding differences then
grow through the encoder's last stages, to 0.7 at its output, so the
comparison would test the noise, not the port.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deadtrees_tpu.losses.functional import batch_one_hot2dist, class2one_hot
from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu.train import (
    OptimizerConfig as JaxOptimizerConfig,
    TrainState as JaxTrainState,
    build_loss as jax_build_loss,
    make_eval_step as jax_make_eval_step,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
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
    make_eval_step,
    make_predict_step,
    make_train_step,
)
from tests.test_torch_models import numpy_variables

K = 3
N = 64  # tile side
DEC_CH = (32, 24, 16, 12, 8)
KW = dict(in_channels=4, classes=K, decoder_channels=DEC_CH)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and torch's default of a thread per core then oversubscribes the
    machine; these small models run as fast on two. (On one thread torch's
    CPU convolutions sum in another order: the gradients then differ from
    JAX's by up to 3e-4 of the largest, outside the bar.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grad_keeper():
    """An optax transformation whose state is the last gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


class GradRecorder:
    """Stands in for the port's optimizer: keeps the gradients it gets."""

    def __init__(self):
        self.grads = None

    def step(self, grads):
        self.grads = [g.clone() for g in grads]
        return True


@pytest.fixture(scope="module")
def setup():
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
    jloss = jax_build_loss(["GDICE", "FOCAL", "BOUNDARY"], K)
    jstep = jax_make_train_step(jmodel, jloss, num_classes=K)
    return jmodel, variables, batch, jloss, jstep


def _jax_state(variables):
    copy = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), variables)
    return JaxTrainState.create(params=copy["params"], batch_stats=copy["batch_stats"],
                                tx=_grad_keeper())


def _jax_batch(batch):
    return {k: jnp.asarray(batch[k]) for k in ("image", "mask", "distmap")}


def _port(variables):
    model = create_model("efficientunet++", "timm-efficientnet-b0", dtype=torch.float32, **KW)
    model.load_state_dict(state_dict_from_variables(variables))
    return model


def _port_batch(batch, keys=("image", "mask", "distmap")):
    out = {}
    for k in keys:
        a = batch[k]
        out[k] = torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1) if a.ndim == 4 else a))
    return out


def _port_grads_tree(model, grads):
    sd = dict(model.state_dict())
    sd.update({n: g for (n, _), g in zip(model.named_parameters(), grads)})
    return variables_from_state_dict(sd)["params"]


def _assert_trees_close(got, want, rtol=1e-4):
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in got_l] == [jax.tree_util.keystr(p) for p, _ in want_l]
    tree_max = max(float(np.abs(np.asarray(w)).max()) for _, w in want_l)
    bad = []
    for (path, g), (_, w) in zip(got_l, want_l):
        g, w = np.asarray(g), np.asarray(w)
        floor = rtol * tree_max
        if not np.allclose(g, w, rtol=rtol, atol=floor):
            bad.append(f"{jax.tree_util.keystr(path)}: {float(np.abs(g - w).max()):.3g} "
                       f"(max |ref| {float(np.abs(w).max()):.3g})")
    assert not bad, f"tree max {tree_max:.3g}\n" + "\n".join(bad)


def _run_both(setup, frozen):
    jmodel, variables, batch, jloss, jstep = setup
    new_j, mj = jstep(_jax_state(variables), _jax_batch(batch), jnp.int32(0), frozen=frozen)
    model = _port(variables)
    rec = GradRecorder()
    state = TrainState(model, rec)
    step = make_train_step(model, build_loss(["GDICE", "FOCAL", "BOUNDARY"], K), num_classes=K)
    state, mt = step(state, _port_batch(batch), 0, frozen=frozen)
    return new_j, mj, model, rec, state, mt


@pytest.mark.parametrize("frozen", [False, True], ids=["train", "frozen_encoder"])
def test_train_step_matches_jax(setup, frozen):
    new_j, mj, model, rec, state, mt = _run_both(setup, frozen)
    for k in ("dice_loss", "focal_loss", "boundary_loss", "total_loss", "dice", "dice_with_bg"):
        assert float(mt[k]) == pytest.approx(float(mj[k]), rel=1e-5), k
    assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]), rel=1e-4)
    assert state.step == int(new_j.step) == 1
    _assert_trees_close(_port_grads_tree(model, rec.grads), new_j.opt_state)
    _assert_trees_close(variables_from_state_dict(model.state_dict())["batch_stats"],
                        new_j.batch_stats)
    if frozen:  # encoder gradients zeroed, encoder BN on running statistics
        enc = jax.tree_util.tree_leaves(_port_grads_tree(model, rec.grads)["encoder"])
        assert all(not np.any(g) for g in enc)
        want_bs = setup[1]["batch_stats"]["encoder"]
        _assert_trees_close(variables_from_state_dict(model.state_dict())["batch_stats"]["encoder"],
                            want_bs, rtol=0)


def test_running_variance_is_biased(setup):
    """One BN in train mode moves running_var toward the biased variance
    (flax), not torch's unbiased one."""
    from deadtrees_tpu_torch.models.blocks import BatchNorm2d

    bn = BatchNorm2d(3).train()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 1, 1)).astype(np.float32))
    bn(x)
    want = 0.9 * 1.0 + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, want, rtol=1e-6, atol=0)


def test_frozen_bn_step(setup):
    """frozen_bn: the loss is the eval-mode forward's (the JAX eval step's
    parts), batch_stats pass through unchanged, and every parameter, BN
    affine included, still trains."""
    jmodel, variables, batch, jloss, _ = setup
    jeval = jax_make_eval_step(jmodel, jloss, num_classes=K)
    want = jeval(_jax_state(variables), _jax_batch(batch), jnp.int32(0))
    model = _port(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = Optimizer(model.parameters(), OptimizerConfig(learning_rate=1e-3))
    step = make_train_step(model, build_loss(["GDICE", "FOCAL", "BOUNDARY"], K),
                           num_classes=K, frozen_bn=True)
    _, mt = step(TrainState(model, opt), _port_batch(batch), 0)
    for k in ("dice_loss", "focal_loss", "boundary_loss", "total_loss"):
        assert float(mt[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    after = model.state_dict()
    for k, v in before.items():
        if "running" in k or "num_batches" in k:
            assert torch.equal(after[k], v), k
    bn_w = [k for k in before if k.endswith("bn1.weight")]
    assert bn_w and all(not torch.equal(after[k], before[k]) for k in bn_w)


def test_eval_step_matches_jax(setup):
    jmodel, variables, batch, jloss, _ = setup
    jeval = jax_make_eval_step(jmodel, jloss, num_classes=K)
    jb = _jax_batch(batch)
    jb["lu"] = jnp.asarray(batch["lu"])
    want = jeval(_jax_state(variables), jb, jnp.int32(3))
    model = _port(variables)
    got = make_eval_step(model, build_loss(["GDICE", "FOCAL", "BOUNDARY"], K), num_classes=K)(
        None, _port_batch(batch, ("image", "mask", "distmap", "lu")), 3)
    for k in ("dice_loss", "focal_loss", "boundary_loss", "total_loss", "dice", "dice_with_bg"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))
    np.testing.assert_array_equal(got["cm_masked"].numpy(), np.asarray(want["cm_masked"]))
    classes, probs = make_predict_step(model)(_port_batch(batch)["image"])
    assert classes.shape == (2, N, N) and probs.shape == (2, K, N, N)
    assert make_predict_step(model, return_probs=False)(
        _port_batch(batch)["image"]).dtype == torch.uint8
    with pytest.raises(ValueError, match="views must be 4 or 8"):
        make_eval_step(model, None, num_classes=K, tta=2)


def test_nan_guard_keeps_state(setup):
    """A batch whose loss is not finite leaves parameters, BN running
    statistics and the optimizer state as they were; the step ticks (the
    JAX step does the same on the same batch)."""
    jmodel, variables, batch, jloss, jstep = setup
    bad = dict(batch)
    bad["image"] = batch["image"].copy()
    bad["image"][0, 0, 0, 0] = np.nan
    jstate = _jax_state(variables)
    new_j, _ = jstep(jstate, _jax_batch(bad), jnp.int32(0))
    _assert_trees_close(new_j.batch_stats, variables["batch_stats"], rtol=0)
    assert int(new_j.step) == 1

    model = _port(variables)
    opt = Optimizer(model.parameters(), OptimizerConfig(learning_rate=1e-3))
    step = make_train_step(model, build_loss(["GDICE", "FOCAL", "BOUNDARY"], K), num_classes=K)
    state = TrainState(model, opt)
    step(state, _port_batch(batch), 0)  # a good step first: nonzero Adam state
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mu = [m.clone() for m in opt.mu]
    state, m = step(state, _port_batch(bad), 0)
    assert not np.isfinite(float(m["total_loss"]))
    assert state.step == 2 and opt.count == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(torch.equal(a, b) for a, b in zip(opt.mu, mu))


def test_frozen_encoder_still_takes_momentum(setup):
    """As in the JAX step: frozen encoder gradients are zeroed before Adam,
    so after an unfrozen step the encoder weights keep moving on Adam's
    momentum during a frozen one."""
    _, variables, batch, _, _ = setup
    model = _port(variables)
    step = make_train_step(model, build_loss(["GDICE", "FOCAL", "BOUNDARY"], K), num_classes=K)
    state = TrainState(model, Optimizer(model.parameters(), OptimizerConfig(learning_rate=1e-3)))
    step(state, _port_batch(batch), 0)
    w = model.encoder.conv_stem.weight.detach().clone()
    rm = model.encoder.bn1.running_mean.clone()
    step(state, _port_batch(batch), 0, frozen=True)
    assert not torch.equal(model.encoder.conv_stem.weight, w)
    assert torch.equal(model.encoder.bn1.running_mean, rm)


def test_remat_step_matches_plain(setup):
    """remat recomputes the forward in the backward: same loss, gradients
    and BatchNorm statistics as the plain step."""
    _, variables, batch, _, _ = setup
    out = []
    for remat in (False, True):
        model = _port(variables)
        rec = GradRecorder()
        step = make_train_step(model, build_loss(["GDICE", "FOCAL", "BOUNDARY"], K),
                               num_classes=K, remat=remat)
        _, m = step(TrainState(model, rec), _port_batch(batch), 0)
        out.append((m, rec.grads, model.state_dict()))
    (m0, g0, s0), (m1, g1, s1) = out
    assert float(m1["total_loss"]) == pytest.approx(float(m0["total_loss"]), rel=1e-6)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-6, atol=0)


def test_optimizer_matches_optax():
    """The same numpy gradients through the port's optimizer and the optax
    chain of the JAX package for 6 steps: a clip that triggers (and one
    that does not), k = 2 accumulation, and a MultiStage lr reduce (fresh
    optimizers at lr/3 after step 4). Parameters agree to rtol 1e-6."""
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    scales = [0.01, 3.0, 0.02, 5.0, 0.05, 2.0]  # small and clipped global norms
    grads = [{k: (rng.normal(size=s) * sc).astype(np.float32) for k, s in shapes.items()}
             for sc in scales]
    cfg = dict(learning_rate=1e-2, cosineannealing_tmax=3, gradient_clip_val=0.5,
               steps_per_epoch=1, accumulate_grad_batches=2)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tx = jax_make_optimizer(JaxOptimizerConfig(**cfg))
    js = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in sorted(shapes)]
    opt = Optimizer(tp, OptimizerConfig(**cfg))
    applied = []
    for i, g in enumerate(grads):
        if i == 4:  # MultiStage: fresh Adam at lr / 3 in both
            tx = jax_make_optimizer(JaxOptimizerConfig(**cfg), lr_scale=1 / 3)
            js = tx.init(jp)
            opt = Optimizer(tp, OptimizerConfig(**cfg), lr_scale=1 / 3)
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        applied.append(opt.step([torch.from_numpy(g[k]) for k in sorted(shapes)]))
        for k, t in zip(sorted(shapes), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i} leaf {k}")
    assert applied == [False, True] * 3
    assert opt.count == 1
