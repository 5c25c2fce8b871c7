"""The port's training recipe held against the JAX package on the CPU.

The geometry of tests/test_torch_trainer.py (b0, decoder (32, 24, 16, 12,
8), 32² tiles, bs 2, float32) over train, val and test shards. The port's
``train()`` runs MultiStage, SWA and ``test_after_training``; one JAX
``Trainer`` is built on the same config for the module. Bars:

- ``test_after_training``: the port's ``test/*`` metrics on its best
  checkpoint equal JAX's ``Trainer.test(best_ckpt)`` over the same test
  shards to rel 1e-4, with equal confusion-matrix pixel counts;
- the eval step with ``tta`` 4 and 8 against JAX's: loss parts and Fscores
  to rel 1e-5, the confusion matrices equal;
- SWA: the running mean equals JAX's formula to rtol 1e-6; BatchNorm
  recalibration under the same weights over the same two batches matches
  JAX's ``bn_pass`` to the bar of tests/test_torch_train_step.py
  (rtol 1e-4, floor 1e-4 × the largest value), at 64² (at 32² the deepest
  BatchNorms see 2 values, see that file); ``swa.ckpt`` loads in
  ``deadtrees_tpu.core.load_model``;
- checkpoints with ``opt_state``: the port's resume in the JAX trainer and
  JAX's in the port, the Adam state bit-equal both ways.
"""

import logging
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deadtrees_tpu.core import load_model as jax_load_model
from deadtrees_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from deadtrees_tpu.train import make_eval_step as jax_make_eval_step
import deadtrees_tpu.train.trainer as jax_trainer_mod
from deadtrees_tpu.train.trainer import Trainer as JaxTrainer
from deadtrees_tpu_torch.core import load_checkpoint, snapshot
from deadtrees_tpu_torch.models import variables_from_state_dict
from deadtrees_tpu_torch.train import make_eval_step
from deadtrees_tpu_torch.train.optim import optimizer_state_dict
from deadtrees_tpu_torch.train.trainer import Trainer, train
from tests.test_torch_models import numpy_variables
from tests.test_torch_recipe import _assert_equal_trees, recipe_config, write_dataset
from tests.test_torch_train_step import _assert_trees_close

K = 3


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    dataset = write_dataset(tmp_path_factory.mktemp("data"))
    work = tmp_path_factory.mktemp("port")
    cfg = recipe_config(dataset)
    trainer = Trainer(cfg, work, device="cpu")
    result = train(cfg, work, trainer=trainer)
    jt = JaxTrainer(cfg, work_dir=tmp_path_factory.mktemp("jax"))
    with pytest.MonkeyPatch.context() as mp:
        # numpy-filled variables of the right shapes: the flax initializers
        # compile a program per parameter, and every test loads a checkpoint
        mp.setattr(jax_trainer_mod, "init_model",
                   lambda model, key, image_size: numpy_variables(model, image_size))
        jt._build()
    return cfg, trainer, result, jt


def _cm_from_log(records) -> np.ndarray:
    (msg,) = [r.getMessage() for r in records if r.getMessage().startswith("CM - DEFAULT")]
    return np.array([int(v) for v in re.findall(r"\d+", msg.split(":", 1)[1])]).reshape(K, K)


def test_test_after_training_matches_jax(runs, caplog):
    _, trainer, result, jt = runs
    with caplog.at_level(logging.INFO, logger="deadtrees_tpu.train.trainer"):
        want = jt.test(result["best_ckpt"])
    got = {k: v for k, v in result.items() if k.startswith("test/")}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    cm = _cm_from_log(caplog.records)
    assert cm.sum() == trainer.last_test_cm.sum() == 4 * 32 * 32


def _port_batch_as_jax(batch):
    out = {k: jnp.asarray(batch[k].numpy()) for k in ("mask", "lu")}
    out["image"] = jnp.asarray(batch["image"].permute(0, 2, 3, 1).numpy())
    out["distmap"] = jnp.asarray(batch["distmap"].permute(0, 2, 3, 1).numpy())
    return out


@pytest.mark.parametrize("tta", [4, 8])
def test_eval_step_with_tta_matches_jax(runs, tta):
    _, trainer, result, jt = runs
    ckpt = load_checkpoint(result["best_ckpt"])
    trainer._load_variables(ckpt)
    state = jt.state.replace(params=ckpt["params"], batch_stats=ckpt["batch_stats"])
    batch = next(iter(trainer.datamodule.test_batches()))
    want = jax_make_eval_step(jt.model, jt.loss, num_classes=K, tta=tta)(
        state, _port_batch_as_jax(batch), jnp.int32(0))
    got = make_eval_step(trainer.model, trainer.loss, num_classes=K, tta=tta)(None, batch, 0)
    for k in ("dice_loss", "focal_loss", "boundary_loss", "total_loss", "dice", "dice_with_bg"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))
    np.testing.assert_array_equal(got["cm_masked"].numpy(), np.asarray(want["cm_masked"]))


def test_swa_average_and_bn_recalibration_match_jax(runs):
    _, trainer, result, jt = runs
    params = list(trainer.model.parameters())
    names = [n for n, _ in trainer.model.named_parameters()]
    rng = np.random.default_rng(4)
    draws = [[torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)) for p in params]
             for _ in range(3)]
    trainer._swa_params, trainer._swa_count = None, 0
    for d in draws:
        with torch.no_grad():
            for p, v in zip(params, d):
                p.copy_(v)
        trainer._update_swa()
    trees = [variables_from_state_dict(dict(zip(names, d)))["params"] for d in draws]
    avg = trees[0]
    for n, tree in enumerate(trees[1:], start=1):
        avg = jax.tree_util.tree_map(lambda a, p, n=n: a + (p - a) / (n + 1), avg, tree)
    got = variables_from_state_dict(dict(zip(names, trainer._swa_params)))["params"]
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(avg)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)

    # the same weights, statistics and two batches through both recalibrations
    ckpt = load_checkpoint(result["swa_ckpt"])
    trainer._load_variables(ckpt)
    start = snapshot(variables_from_state_dict(trainer.model.state_dict()))  # not views
    images = [rng.normal(size=(2, 64, 64, 4)).astype(np.float32) for _ in range(2)]
    trainer._recalibrate_bn(
        [{"image": torch.from_numpy(x.transpose(0, 3, 1, 2).copy())} for x in images])
    got = variables_from_state_dict(trainer.model.state_dict())["batch_stats"]

    @jax.jit
    def bn_pass(params, batch_stats, img):
        _, mut = jt.model.apply({"params": params, "batch_stats": batch_stats}, img,
                                train=True, mutable=["batch_stats"])
        return mut["batch_stats"]

    want = start["batch_stats"]
    for x in images:
        want = bn_pass(start["params"], want, jnp.asarray(x))
    _assert_trees_close(got, want)

    jmodel, variables, hp = jax_load_model(result["swa_ckpt"])
    assert hp["encoder_name"] == "timm-efficientnet-b0"
    _assert_equal_trees(variables["params"], ckpt["params"])


def test_checkpoints_resume_across_packages(runs, tmp_path):
    cfg, trainer, result, jt = runs
    last = Path(result["best_ckpt"]).with_name("last.ckpt")
    port_opt = snapshot(optimizer_state_dict(trainer.state.optimizer, trainer.model))
    # the port's last.ckpt resumes in the JAX trainer, Adam bit-equal
    assert jt.resume(last) == 3
    inner = jt.state.opt_state
    for ours, theirs in ((port_opt["1"]["mu"], inner[1].mu), (port_opt["1"]["nu"], inner[1].nu)):
        _assert_equal_trees(ours, jax.tree_util.tree_map(np.asarray, theirs))
    assert int(inner[1].count) == int(jt.state.step) - 4 == trainer.state.optimizer.count
    # ... and what the JAX trainer writes resumes in the port, bit-equal
    path = tmp_path / "jax.ckpt"
    jax_save_checkpoint(path, params=jt.state.params, batch_stats=jt.state.batch_stats,
                        hparams=trainer.hparams, opt_state=jt.state.opt_state,
                        step=int(jt.state.step), epoch=2)
    t2 = Trainer(cfg, tmp_path, device="cpu")
    t2._build()
    assert t2.resume(path) == 3 and t2.state.step == trainer.state.step
    _assert_equal_trees(snapshot(optimizer_state_dict(t2.state.optimizer, t2.model)), port_opt)
    held = variables_from_state_dict(t2.model.state_dict())
    _assert_equal_trees(held["params"], load_checkpoint(last)["params"])
