"""Training runtime: the fit loop.

Counterpart of ``deadtrees_tpu.train.trainer.Trainer`` for one device:
``Trainer(config, work_dir, device=None).fit()`` takes the JAX trainer's
composed config dict (the same keys) and runs

- the datamodule, model, loss and optimizer built from the config;
- the epoch loop: train steps (``steps.py``) capped by
  ``limit_train_batches``, validation capped by ``limit_val_batches`` with
  summed confusion matrices, mean metrics per epoch;
- the MultiStage schedule: encoder frozen until ``unfreeze_epoch``, a
  fresh Adam at ``lr / lr_reduce_fraction`` from ``lr_reduce_epoch``;
- best-on-monitor and last checkpoints in the JAX package's ``DTPU1``
  format (``deadtrees_tpu.core.load_model`` and the port's
  ``TorchInference`` both load them), early stopping, a CSV metrics log,
  ``steps_per_sec`` and the per-file sample counters.

It runs on CUDA unless ``device="cpu"`` is passed (the tests do). SWA,
W&B, figures, asynchronous checkpoint writes, SIGTERM preemption,
``resume_from_checkpoint``, ``profiler_dir``, ``test()`` and
``devices > 1`` are not ported yet: configuring one raises
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import csv
import itertools
import logging
import time
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from deadtrees_tpu_torch.core.checkpoint import BestCheckpointKeeper, save_checkpoint
from deadtrees_tpu_torch.data.pipeline import DataConfig, DeadtreesDataModule
from deadtrees_tpu_torch.infer.engine import resolve_device
from deadtrees_tpu_torch.models import create_model, init_model, variables_from_state_dict
from deadtrees_tpu_torch.train.loss import build_loss
from deadtrees_tpu_torch.train.optim import (
    MultiStageConfig,
    OptimizerConfig,
    cosine_annealing_schedule,
    make_optimizer,
)
from deadtrees_tpu_torch.train.steps import TrainState, make_eval_step, make_train_step

log = logging.getLogger(__name__)

_QUEUED = "is not ported yet (ROADMAP.md, slice A queue)"


class MetricsLogger:
    """CSV metrics sink."""

    def __init__(self, save_dir: Path):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.rows: List[Dict[str, Any]] = []

    def log(self, metrics: Dict[str, float], step: int) -> None:
        self.rows.append({"step": step, **{k: float(v) for k, v in metrics.items()}})

    def flush(self) -> None:
        if not self.rows:
            return
        keys = sorted({k for r in self.rows for k in r})
        with open(self.save_dir / "metrics.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.rows)


def _mean_metrics(batch_metrics: List[Dict[str, Any]], prefix: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    if not batch_metrics:
        return out
    for k in batch_metrics[0]:
        if k in ("cm", "cm_masked"):
            continue
        out[f"{prefix}/{k}"] = float(np.mean([float(m[k]) for m in batch_metrics]))
    return out


def _refuse_unported(cfg: Dict[str, Any]) -> None:
    """Raise for every configured feature the port does not have yet."""
    tc = cfg.get("trainer", {})
    cb = cfg.get("callbacks", {})
    lg = cfg.get("logger") or {}
    mck = cb.get("model_checkpoint", {})
    checks = {
        "callbacks.swa (SWA)": cb.get("swa"),
        "logger.kind: wandb (W&B)": lg.get("kind") == "wandb",
        "callbacks.log_confusion_matrix (figures)": cb.get("log_confusion_matrix"),
        "callbacks.log_image_predictions (figures)": cb.get("log_image_predictions"),
        "model_checkpoint.async_write": mck.get("async_write") is True,
        "trainer.handle_sigterm (preemption)": tc.get("handle_sigterm") is True,
        "trainer.resume_from_checkpoint": tc.get("resume_from_checkpoint"),
        "trainer.profiler_dir": tc.get("profiler_dir"),
        "test_after_training": cfg.get("test_after_training"),
        "trainer.devices > 1": (tc.get("devices") or 1) > 1,
    }
    for name, configured in checks.items():
        if configured:
            raise NotImplementedError(f"{name} {_QUEUED}")


class Trainer:
    def __init__(
        self,
        config: Dict[str, Any],
        work_dir: Optional[Union[str, Path]] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        _refuse_unported(config)
        self.cfg = config
        self.work_dir = Path(work_dir or ".")
        self.device = resolve_device(device)
        self.stats = {"train": Counter(), "val": Counter()}

    # -- assembly ----------------------------------------------------------
    def _build(self) -> None:
        cfg = self.cfg
        tc = cfg.get("trainer", {})
        mc = cfg["model"]["network"]
        tr = cfg["model"]["training"]
        dmc = cfg.get("datamodule", {})
        seed = cfg.get("seed") or 0
        np.random.seed(seed)
        torch.manual_seed(seed)

        classes = mc.get("classes", 3)
        self.num_classes = len(classes) if isinstance(classes, (list, tuple)) else int(classes)
        self.in_channels = int(mc.get("in_channels", 4))

        data_dir = cfg.get("data_dir")
        sub = [Path(data_dir) / s for s in ("train", "val", "test")]
        if all(p.is_dir() for p in sub):
            data_dir = [str(p) for p in sub]
        self.datamodule = DeadtreesDataModule(
            DataConfig(
                data_dir=data_dir,
                pattern=dmc.get("pattern", "*.tar"),
                batch_size=int(dmc.get("batch_size", 32)),
                pattern_extra=dmc.get("pattern_extra"),
                in_channels=self.in_channels,
                classes=self.num_classes,
                distmap=True,
                seed=seed,
                process_count=dmc.get("process_count"),
                device=self.device,
            )
        )
        self.datamodule.setup()

        dtype = torch.bfloat16 if tc.get("precision", "bf16") == "bf16" else torch.float32
        self.hparams = {
            "architecture": mc.get("architecture", "efficientunet++"),
            "encoder_name": mc.get("encoder_name", "timm-efficientnet-b5"),
            "decoder_channels": list(mc.get("decoder_channels", (256, 128, 64, 32, 16))),
            "in_channels": self.in_channels,
            "classes": self.num_classes,
            "encoder_weights": mc.get("encoder_weights"),
        }
        model = create_model(**self.hparams, dtype=dtype)
        self.model = init_model(model, generator=torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info(f"Model: {self.hparams['architecture']} ({n_params / 1e6:.1f}M params)")

        # the schedule counts applied UPDATES: steps_per_epoch / k
        self.grad_accum = max(1, int(tc.get("accumulate_grad_batches", 1)))
        self.opt_config = OptimizerConfig(
            learning_rate=float(tr.get("learning_rate", 3e-4)),
            cosineannealing_tmax=int(tr.get("cosineannealing_tmax", 10)),
            gradient_clip_val=float(tc.get("gradient_clip_val", 0.5)),
            steps_per_epoch=max(-(-max(self.datamodule.steps_per_epoch, 1) // self.grad_accum), 1),
            accumulate_grad_batches=self.grad_accum,
        )
        self.state = TrainState(self.model, make_optimizer(self.model.parameters(), self.opt_config))

        self.loss = build_loss(mc.get("losses", ["GDICE", "FOCAL", "BOUNDARY"]), self.num_classes)
        self.train_step = make_train_step(
            self.model, self.loss, num_classes=self.num_classes,
            remat=bool(tc.get("remat", False)), frozen_bn=bool(tc.get("frozen_bn", False)),
        )
        self.eval_step = make_eval_step(self.model, self.loss, num_classes=self.num_classes)

        cb = cfg.get("callbacks", {})
        ms = cb.get("multistage")
        self.multistage = (
            MultiStageConfig(
                unfreeze_epoch=int(ms.get("unfreeze_epoch", 20)),
                lr_reduce_epoch=ms.get("lr_reduce_epoch"),
                lr_reduce_fraction=ms.get("lr_reduce_fraction"),
            )
            if ms else None
        )
        if self.multistage and mc.get("encoder_weights") is None:
            log.warning("MultiStage encoder freeze requested without pretrained encoder weights")
        mck = cb.get("model_checkpoint", {})
        self.keeper = BestCheckpointKeeper(
            self.work_dir / mck.get("dirpath", "checkpoints/"),
            monitor=mck.get("monitor", "val/dice"),
            mode=mck.get("mode", "max"),
        )
        es = cb.get("early_stopping", {})
        self.es_patience = int(es.get("patience", 200))
        self.es_monitor = es.get("monitor", "val/dice")
        lg = cfg.get("logger") or {}
        self.metrics = MetricsLogger(self.work_dir / lg.get("save_dir", "logs/metrics"))

    # -- loops --------------------------------------------------------------
    def _run_val_epoch(self, epoch: int, max_batches: Optional[int]) -> Dict[str, float]:
        batch_metrics, cms, cms_masked = [], [], []
        with contextlib.closing(self.datamodule.val_batches()) as batches:
            # islice stops before the data module finishes a batch it won't use
            for batch in itertools.islice(batches, max_batches):
                self.stats["val"].update(batch.pop("files", []))
                m = self.eval_step(self.state, batch, epoch)
                cms.append(m["cm"])
                if "cm_masked" in m:
                    cms_masked.append(m["cm_masked"])
                batch_metrics.append(m)
        out = _mean_metrics(batch_metrics, "val")
        if cms:
            self.last_cm = torch.stack(cms).sum(0).cpu().numpy()
            self.last_cm_masked = (
                torch.stack(cms_masked).sum(0).cpu().numpy() if cms_masked else None
            )
        return out

    def _save(self, epoch: int):
        def save(path):
            variables = variables_from_state_dict(
                self.model.state_dict(), encoder_name=self.hparams["encoder_name"]
            )
            save_checkpoint(
                path, **variables, hparams=self.hparams, step=self.state.step, epoch=epoch
            )

        return save

    def fit(self) -> Dict[str, Any]:
        self._build()
        tc = self.cfg.get("trainer", {})
        max_epochs = int(tc.get("max_epochs", 300))
        min_epochs = int(tc.get("min_epochs", 1))
        limit_train = tc.get("limit_train_batches")
        limit_val = tc.get("limit_val_batches")
        detect_anomaly = bool(tc.get("detect_anomaly", False))
        generator = torch.Generator().manual_seed(self.cfg.get("seed") or 0)
        best = None
        since_improve = 0
        last_val: Dict[str, float] = {}

        for epoch in range(max_epochs):
            frozen = bool(self.multistage and epoch < self.multistage.unfreeze_epoch)
            if (
                self.multistage
                and self.multistage.lr_reduce_epoch is not None
                and epoch == int(self.multistage.lr_reduce_epoch)
            ):
                log.info(f"NEW STAGE (epoch {epoch}): fresh Adam at lr/"
                         f"{self.multistage.lr_reduce_fraction}")
                self.state.replace_optimizer(make_optimizer(
                    self.model.parameters(), self.opt_config,
                    lr_scale=1.0 / float(self.multistage.lr_reduce_fraction),
                ))

            t0 = time.perf_counter()
            n_steps = 0
            train_metrics: List[Dict] = []
            cap = None if limit_train is None else int(limit_train)
            with contextlib.closing(self.datamodule.train_batches(generator)) as batches:
                for i, batch in enumerate(itertools.islice(batches, cap)):
                    self.stats["train"].update(batch.pop("files", []))
                    batch.pop("lu", None)  # unused in training
                    self.state, m = self.train_step(self.state, batch, epoch, frozen=frozen)
                    if detect_anomaly and not np.isfinite(float(m["total_loss"])):
                        log.warning(f"Non-finite loss at epoch {epoch} step {i}")
                    train_metrics.append(m)
                    n_steps += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0

            epoch_train = _mean_metrics(train_metrics, "train")
            val = self._run_val_epoch(epoch, int(limit_val) if limit_val is not None else None)
            last_val = val
            lr = cosine_annealing_schedule(self.opt_config, self.opt_config.learning_rate)(
                self.state.step // self.grad_accum
            )
            self.metrics.log(
                {**epoch_train, **val, "epoch": epoch, "lr": lr,
                 "steps_per_sec": n_steps / max(dt, 1e-9)},
                step=self.state.step,
            )
            log.info(
                f"epoch {epoch}: train_loss={epoch_train.get('train/total_loss', float('nan')):.4f} "
                f"val_dice={val.get('val/dice', float('nan')):.4f} ({n_steps} steps, {dt:.1f}s)"
            )
            monitored = val.get(self.es_monitor)
            if monitored is not None:
                improved = self.keeper.is_improvement(monitored)
                self.keeper.update(monitored, epoch, self._save(epoch))
                if improved:
                    since_improve = 0
                    best = monitored
                else:
                    since_improve += 1
                if since_improve >= self.es_patience and epoch + 1 >= min_epochs:
                    log.info(f"Early stopping at epoch {epoch}")
                    break
        self.teardown()
        self.metrics.flush()

        result: Dict[str, Any] = dict(last_val)
        if best is not None:
            result["best/" + self.es_monitor] = best
        if self.keeper.best_path:
            result["best_ckpt"] = str(self.keeper.best_path)
        return result

    def test(self, ckpt_path: Optional[str] = None, tta: Optional[int] = None):
        raise NotImplementedError(f"Trainer.test() {_QUEUED}")

    def teardown(self) -> None:
        """Dump the per-file sample counters."""
        for split in ("train", "val"):
            with open(self.work_dir / f"{split}_stats.csv", "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["filename", "count"])
                w.writerows(sorted(self.stats[split].items()))
