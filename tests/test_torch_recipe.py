"""The port's training recipe on the CPU: the trainer's features end to end.

The geometry of tests/test_torch_trainer.py (b0, decoder (32, 24, 16, 12,
8), 32² tiles, bs 2) over train, val and test shards: ``train()`` with the
MultiStage schedule, SWA, ``test_after_training``, figures and a profiler
trace; preemption by ``request_stop`` and by a real SIGTERM; resume with
the Adam state, bit-equal on load, and at the learning-rate stage of the
resumed epoch; the asynchronous checkpoint writer and its snapshot; W&B's
fallback to CSV and the callback knobs; and the ``python -m
deadtrees_tpu_torch`` CLI in subprocesses. The checks held against the JAX
package's own numbers are in tests/test_torch_recipe_parity.py.
"""

import ast
import logging
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import deadtrees_tpu_torch.train.trainer as trainer_mod
from deadtrees_tpu_torch.core import (
    AsyncCheckpointWriter,
    load_checkpoint,
    save_checkpoint,
    snapshot,
)
from deadtrees_tpu_torch.core.msgpack_codec import pack_chunks, packb, unpackb
from deadtrees_tpu_torch.models import variables_from_state_dict
from deadtrees_tpu_torch.train import Optimizer, OptimizerConfig
from deadtrees_tpu_torch.train.optim import optimizer_state_dict, optimizer_to_bytes
from deadtrees_tpu_torch.train.trainer import Trainer, train
from tests.test_torch_trainer import _config, write_shard

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_dataset(d: Path) -> Path:
    write_shard(str(d / "train" / "train-combo-%06d.tar"), 4, 0, "tile")
    write_shard(str(d / "val" / "train-combo-%06d.tar"), 4, 1, "val")
    write_shard(str(d / "test" / "train-combo-%06d.tar"), 4, 2, "test")
    return d


def recipe_config(dataset, **over):
    """MultiStage (unfreeze at 1, lr/3 at 2), SWA from 1, 3 epochs, test
    after training."""
    cfg = _config(dataset, **over)
    cfg["trainer"] = dict(cfg["trainer"], max_epochs=3)
    cfg["callbacks"] = dict(
        cfg["callbacks"],
        multistage={"unfreeze_epoch": 1, "lr_reduce_epoch": 2, "lr_reduce_fraction": 3},
        swa={"swa_epoch_start": 1},
    )
    cfg["test_after_training"] = True
    return cfg


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("data"))


@pytest.fixture(scope="module")
def recipe(dataset, tmp_path_factory):
    work = tmp_path_factory.mktemp("recipe")
    cfg = recipe_config(dataset)
    cfg["trainer"]["profiler_dir"] = str(work / "profile")
    trainer = Trainer(cfg, work, device="cpu")
    return trainer, train(cfg, work, trainer=trainer), work


def _file_state(path):
    ckpt = load_checkpoint(path)
    return ckpt, unpackb(ckpt["opt_state"]) if "opt_state" in ckpt else None


def _assert_equal_trees(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_equal_trees(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _assert_trainer_holds(trainer, path, variables_path=None):
    """The trainer's Adam state and step equal the checkpoint file's, and
    its parameters and BN statistics those of ``variables_path`` (default:
    the same file), bit for bit."""
    ckpt, opt = _file_state(path)
    held = variables_from_state_dict(trainer.model.state_dict())
    want = load_checkpoint(variables_path) if variables_path else ckpt
    _assert_equal_trees(held["params"], want["params"])
    _assert_equal_trees(held["batch_stats"], want["batch_stats"])
    _assert_equal_trees(snapshot(optimizer_state_dict(trainer.state.optimizer, trainer.model)), opt)
    assert trainer.state.step == int(ckpt["step"])


def test_recipe_end_to_end(recipe):
    trainer, result, work = recipe
    for k in ("dice", "dice_with_bg", "total_loss", "dice_loss", "focal_loss", "boundary_loss"):
        assert np.isfinite(result[f"test/{k}"]), k
    assert trainer.last_test_cm.sum() == 4 * 32 * 32
    assert sum(trainer.stats["test"].values()) == 4
    assert "preempted" not in result
    rows = (work / "metrics" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 4 and "steps_per_sec" in rows[0]
    assert trainer.state.step == 6 and trainer._swa_count == 2
    assert [len(trainer.timings[k]) for k in ("epoch_s", "save_s", "swa_recal_s", "test_s")] \
        == [3, 3, 1, 1]
    figures = sorted(p.name for p in (work / "figures").glob("*.png"))
    assert figures == [f"{kind}_epoch{e:03d}.png" for kind in ("cm_val", "samples")
                       for e in range(3)]
    assert (work / "profile" / "trace.json").stat().st_size > 0
    # last.ckpt holds the Adam state the loop ended with; test() put the
    # best checkpoint's weights in the model
    _assert_trainer_holds(trainer, work / "checkpoints" / "last.ckpt", result["best_ckpt"])
    ckpt, opt = _file_state(work / "checkpoints" / "last.ckpt")
    assert int(ckpt["epoch"]) == 2 and int(opt["1"]["count"]) == 2  # fresh Adam at epoch 2


def test_swa_checkpoint(recipe):
    trainer, result, work = recipe
    ckpt = load_checkpoint(result["swa_ckpt"])
    assert int(ckpt["epoch"]) == -1 and "opt_state" not in ckpt
    names = [n for n, _ in trainer.model.named_parameters()]
    avg = variables_from_state_dict(dict(zip(names, trainer._swa_params)))["params"]
    _assert_equal_trees(ckpt["params"], avg)
    # the recalibrated statistics moved; the trainer's own are put back
    held = variables_from_state_dict(trainer.model.state_dict())["batch_stats"]
    enc = ckpt["batch_stats"]["encoder"]["BatchNorm_0"]["mean"]
    assert not np.array_equal(enc, held["encoder"]["BatchNorm_0"]["mean"])


def test_checkpoint_written_from_buffers_is_flax_bytes(recipe, tmp_path):
    """The writer streams views of the snapshot (``pack_chunks``, the Adam
    state as a nested bin): the file equals the one written from the
    joined bytes of the Adam state."""
    trainer, _, _ = recipe
    kw = trainer._ckpt_kwargs(2)
    save_checkpoint(tmp_path / "tree.ckpt", **kw)
    kw["opt_state"] = optimizer_to_bytes(trainer.state.optimizer, trainer.model)
    save_checkpoint(tmp_path / "bytes.ckpt", **kw)
    assert (tmp_path / "tree.ckpt").read_bytes() == (tmp_path / "bytes.ckpt").read_bytes()
    tree = snapshot(kw["params"])
    assert b"".join(pack_chunks(tree)) == packb(tree)


def _stop_after_step(monkeypatch, holder, n=1):
    """The train step asks the trainer to stop after its n-th call."""
    orig = trainer_mod.make_train_step

    def patched(*a, **k):
        step = orig(*a, **k)

        def wrapped(state, batch, epoch, frozen=False):
            out = step(state, batch, epoch, frozen=frozen)
            if state.step >= n:
                holder["trainer"].request_stop()
            return out

        return wrapped

    monkeypatch.setattr(trainer_mod, "make_train_step", patched)
    return orig


def test_preemption_then_bit_equal_resume(dataset, tmp_path, monkeypatch):
    holder = {}
    orig = _stop_after_step(monkeypatch, holder)
    work = tmp_path / "run"
    trainer = Trainer(recipe_config(dataset), work, device="cpu")
    holder["trainer"] = trainer
    result = trainer.fit()
    assert result["preempted"] == 1.0
    last = work / "checkpoints" / "last.ckpt"
    ckpt, opt = _file_state(last)
    assert int(ckpt["epoch"]) == -1 and int(ckpt["step"]) == 1
    assert int(opt["1"]["count"]) == 1 and "swa_ckpt" not in result
    _assert_trainer_holds(trainer, last)

    monkeypatch.setattr(trainer_mod, "make_train_step", orig)
    cfg = recipe_config(dataset)
    cfg["trainer"] = dict(cfg["trainer"], max_epochs=2, resume_from_checkpoint=str(last))
    t2 = Trainer(cfg, tmp_path / "run2", device="cpu")
    t2._build()
    assert t2.resume(last) == 0
    _assert_trainer_holds(t2, last)
    res2 = t2.fit()  # builds and resumes again, then runs epochs 0 and 1
    assert "preempted" not in res2 and "val/dice" in res2 and "swa_ckpt" in res2
    assert t2.state.step == 1 + 4


def test_preempted_run_writes_no_swa_and_tests_nothing(dataset, tmp_path, monkeypatch):
    """Stopped in epoch 1 with SWA running since epoch 0: last.ckpt at
    epoch 0, then neither swa.ckpt nor a test after training."""
    holder = {}
    _stop_after_step(monkeypatch, holder, n=3)
    cfg = recipe_config(dataset)
    cfg["callbacks"]["swa"] = {"swa_epoch_start": 0}
    trainer = Trainer(cfg, tmp_path, device="cpu")
    holder["trainer"] = trainer
    result = train(cfg, tmp_path, trainer=trainer)
    assert result["preempted"] == 1.0 and trainer._swa_count == 1
    assert not any(k.startswith("test/") for k in result) and "swa_ckpt" not in result
    assert not (tmp_path / "checkpoints" / "swa.ckpt").exists()
    ckpt, _ = _file_state(tmp_path / "checkpoints" / "last.ckpt")
    assert int(ckpt["epoch"]) == 0 and int(ckpt["step"]) == 3


@pytest.mark.parametrize("saved_epoch,scale", [(0, 1.0), (1, 1 / 3), (3, 1 / 3)])
def test_resume_keeps_the_learning_rate_stage(dataset, tmp_path, saved_epoch, scale):
    """A run resumed after lr_reduce_epoch (2) runs at lr / 3; the JAX
    trainer would restore it at lr."""
    cfg = recipe_config(dataset)
    t = Trainer(cfg, tmp_path, device="cpu")
    t._build()
    path = tmp_path / "e.ckpt"
    t._ckpt_saver(saved_epoch)(path)
    t._ckpt_writer.wait()
    t2 = Trainer(cfg, tmp_path, device="cpu")
    t2._build()
    assert t2.resume(path) == saved_epoch + 1
    lr = cfg["model"]["training"]["learning_rate"]
    assert t2.state.optimizer.schedule(0) == pytest.approx(lr * scale, rel=1e-12)


def test_sigterm_trap(dataset, tmp_path):
    trainer = Trainer(recipe_config(dataset), tmp_path, device="cpu")
    before = signal.getsignal(signal.SIGTERM)
    with trainer._sigterm_trap():
        os.kill(os.getpid(), signal.SIGTERM)
        assert trainer._stop_requested
    assert signal.getsignal(signal.SIGTERM) is before
    # off the main thread signal.signal raises; the trap then does nothing
    other = Trainer(recipe_config(dataset), tmp_path, device="cpu")
    errors = []

    def run():
        try:
            with other._sigterm_trap():
                pass
        except Exception as e:  # pragma: no cover - the failure being tested
            errors.append(e)

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive() and errors == [] and not other._stop_requested


def test_async_writer_orders_and_reports(tmp_path):
    w = AsyncCheckpointWriter()
    kw = dict(params={"a": np.ones(3, np.float32)}, batch_stats={}, hparams={})
    path = tmp_path / "x.ckpt"
    w.save(path, **kw)
    w.delete(path)
    w.wait()
    assert not path.exists() and not path.with_name("x.ckpt.dtpu").exists()
    blocker = tmp_path / "file"
    blocker.write_text("")
    w.save(blocker / "a.ckpt", **kw)  # a file as the parent directory
    w.save(tmp_path / "ok.ckpt", **kw)
    w.save(blocker / "b.ckpt", **kw)
    with pytest.raises(OSError):
        w.wait()
    assert (tmp_path / "ok.ckpt").exists()
    w.wait()  # the failures were reported once
    w.close()


def test_async_save_then_in_place_step_writes_the_state_before(tmp_path):
    """The CPU-view trap: a queued write must not see a later in-place
    optimizer step."""
    p = torch.zeros(5)
    opt = Optimizer([p], OptimizerConfig(learning_rate=0.1))
    opt.step([torch.ones(5)])
    before = p.clone()
    w = AsyncCheckpointWriter()
    gate = threading.Event()
    w._pool.submit(gate.wait)  # the worker stays busy until the step is done
    w.save(tmp_path / "s.ckpt", params={"p": p}, batch_stats={"mu": opt.mu[0]}, hparams={})
    opt.step([torch.ones(5)])
    assert not torch.equal(p, before)
    gate.set()
    w.close()
    ckpt = load_checkpoint(tmp_path / "s.ckpt")
    np.testing.assert_array_equal(ckpt["params"]["p"], before.numpy())
    assert not np.shares_memory(snapshot({"p": p})["p"], p.numpy())


def test_wandb_falls_back_to_csv_and_knobs_are_read(dataset, tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` raises
    cfg = _config(dataset, logger={"kind": "wandb", "project": "p", "save_dir": "metrics"})
    cfg["trainer"] = dict(cfg["trainer"], max_epochs=1)
    cfg["callbacks"] = dict(cfg["callbacks"], watch_model={"log_freq": 100},
                            upload_ckpts_as_artifact={"upload_best_only": False},
                            log_confusion_matrix=False, log_image_predictions=False)
    trainer = Trainer(cfg, tmp_path, device="cpu")
    with caplog.at_level(logging.WARNING):
        trainer.fit()
    assert "wandb unavailable" in caplog.text and trainer.metrics.wandb is None
    assert (tmp_path / "metrics" / "metrics.csv").exists()
    assert trainer.watch_params and trainer.watch_log_freq == 100
    assert trainer.upload_ckpts and not trainer.upload_best_only
    assert not trainer.log_cm_figures and not trainer.log_sample_figures
    assert not list(tmp_path.glob("figures/*.png"))
    cfg2 = _config(dataset)
    cfg2["callbacks"] = dict(cfg2["callbacks"], watch_model=False, upload_ckpts_as_artifact=False)
    t2 = Trainer(cfg2, tmp_path, device="cpu")
    t2._build()
    assert not t2.watch_params and not t2.upload_ckpts
    assert t2.log_cm_figures and t2.log_sample_figures and t2.sample_figure_count == 8
    assert t2._ckpt_writer is not None  # asynchronous writes by default
    cfg2["callbacks"]["model_checkpoint"] = dict(cfg2["callbacks"]["model_checkpoint"],
                                                 async_write=False)
    t3 = Trainer(cfg2, tmp_path, device="cpu")
    t3._build()
    assert t3._ckpt_writer is None


def _cli(*args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "deadtrees_tpu_torch", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout, env=env)


def _printed_dict(stdout: str) -> dict:
    line = stdout.strip().splitlines()[-1]
    return ast.literal_eval(line.replace("nan", "None"))


def test_cli_train_eval_version(dataset, tmp_path):
    out = _cli("version")
    assert out.returncode == 0 and out.stdout.strip()
    tiny = ["experiment=flagship_b5_multistage", f"data_dir={dataset}",
            f"run_dir={tmp_path / 'runs'}", f"logger.save_dir={tmp_path / 'metrics'}",
            "model.network.encoder_name=timm-efficientnet-b0",
            "model.network.decoder_channels=[32,24,16,12,8]", "datamodule.batch_size=2",
            "trainer.precision=f32", "trainer.max_epochs=3", "trainer.limit_train_batches=2",
            "trainer.limit_val_batches=1", "callbacks.multistage.unfreeze_epoch=1",
            "callbacks.multistage.lr_reduce_epoch=2", "callbacks.swa.swa_epoch_start=1",
            "print_config=false"]
    out = _cli("train", "--device", "cpu", *tiny)
    assert out.returncode == 0, out.stderr[-3000:]
    result = _printed_dict(out.stdout)
    assert "NEW STAGE (epoch 2)" in out.stderr and "SWA: averaged 2 epochs" in out.stderr
    assert Path(result["swa_ckpt"]).exists() and "test/dice" in result
    assert "CM - DEFAULT - PIXEL" in out.stderr
    out = _cli("eval", "--device", "cpu", f"bestmodel={result['best_ckpt']}", "tta=8", *tiny)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = _printed_dict(out.stdout)
    assert sorted(metrics) == sorted(k for k in result if k.startswith("test/"))
    out = _cli("eval", "--device", "cpu", *tiny)
    assert out.returncode != 0 and "bestmodel" in out.stderr
    out = _cli("train", *tiny)  # no --device: CUDA, which this machine lacks
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
