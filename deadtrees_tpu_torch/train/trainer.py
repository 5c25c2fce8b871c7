"""Training runtime: the fit / validate / test loop.

Counterpart of ``deadtrees_tpu.train.trainer``:
``Trainer(config, work_dir, device=None)`` takes the JAX trainer's composed
config dict (the same keys, ``config.compose`` of the repo's ``configs/``)
and :func:`train` runs the recipe:

- the datamodule, model, loss and optimizer built from the config;
- the epoch loop: train steps (``steps.py``) capped by
  ``limit_train_batches``, validation capped by ``limit_val_batches`` with
  summed confusion matrices, mean metrics per epoch;
- the MultiStage schedule: encoder frozen until ``unfreeze_epoch``, a
  fresh Adam at ``lr / lr_reduce_fraction`` from ``lr_reduce_epoch``;
- best-on-monitor and last checkpoints in the JAX package's ``DTPU1``
  format, holding the Adam state as the JAX package's own bytes
  (``optim.optimizer_state_dict``), written by an asynchronous writer
  unless ``model_checkpoint.async_write: false``; early stopping;
- ``resume_from_checkpoint``: parameters, BatchNorm statistics, the Adam
  state, step and epoch, with the optimizer built at the learning-rate
  stage of the resumed epoch (the JAX trainer restores a run resumed after
  ``lr_reduce_epoch`` at the first stage's rate, 3 × too high);
- preemption: ``request_stop()``, or SIGTERM under the trap that ``fit``
  installs unless ``trainer.handle_sigterm: false``, ends the run at the
  next step boundary with ``last.ckpt`` at ``epoch - 1``; a preempted run
  then only waits for its writes: no ``swa.ckpt`` and no test after
  training (the JAX trainer does both inside the preemption's grace
  window, from a partial SWA average that no checkpoint keeps);
- SWA from ``callbacks.swa.swa_epoch_start``: a running mean of the
  parameters once per epoch, BatchNorm recalibration on 10 train batches
  under the average, ``swa.ckpt``;
- ``test(ckpt_path, tta)`` over the test shards; ``test_after_training``
  on the best checkpoint in :func:`train`;
- a CSV metrics log (W&B when ``logger.kind: wandb`` and the package
  imports), confusion-matrix and sample figures per val epoch (skipped
  when matplotlib is absent), a ``torch.profiler`` trace into
  ``trainer.profiler_dir`` (``trace.json``) with the port's own spans of
  the same fit beside it (``spans.json``, a chrome trace on the same
  clock: ``core/trace.py``), and the per-file sample counters.

``Trainer.timings`` keeps the host-clock seconds of each epoch, each
checkpoint save as the loop sees it, the resume load, the SWA BatchNorm
recalibration (``swa_bn_batches`` batches) and each ``test()`` loop.

It runs on CUDA unless ``device="cpu"`` is passed (the tests do).

Data parallelism (``trainer.devices: N``, N ranks of the process group:
``python -m torch.distributed.run --nproc-per-node N -m
deadtrees_tpu_torch train trainer.devices=N ...``; ``parallel/mesh.py``):
the trainer raises unless the world size is N (``null``: whatever it is).
Each rank steps on its local slice of the global batch (the data module
yields it) through the data-parallel steps (``steps.py``); the parameters
and the optimizer state are rank 0's on every rank after the build, a
resume, a new learning-rate stage and a checkpoint loaded by ``test``;
an epoch takes at most the smallest rank's steps; validation and test
metrics and the confusion matrices are the global batch's, the same on
every rank; only rank 0 writes the metrics file, checkpoints, figures,
``swa.ckpt`` and the sample counters, while every rank takes part in the
collectives (SWA's BatchNorm recalibration included). The launcher
delivers SIGTERM to every rank, and the ranks agree at each step boundary
whether any of them was asked to stop (one all_reduce over the control
group), so all stop at the same boundary.

The steps are compiled programs (``train/steps.py``), built once per run;
the fresh optimizer of the lr-reduce stage compiles the update program
once more, as the JAX trainer's new ``tx`` retraces its step. SWA's
BatchNorm recalibration is one program a batch. On CUDA these programs
run eagerly unless ``DEADTREES_COMPILE_OPTS`` is set
(``core/compile_opts.py``); the augment program compiles. The distance maps of the
data path stay eager, as the JAX package's are not jitted at the top
level (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import csv
import itertools
import logging
import signal
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from deadtrees_tpu_torch.core import trace
from deadtrees_tpu_torch.core.artifacts import pointer_path
from deadtrees_tpu_torch.core.checkpoint import (
    AsyncCheckpointWriter,
    BestCheckpointKeeper,
    load_checkpoint,
    save_checkpoint,
)
from deadtrees_tpu_torch.data.pipeline import DataConfig, DeadtreesDataModule
from deadtrees_tpu_torch.infer.engine import resolve_device
from deadtrees_tpu_torch.models import (
    create_model,
    init_model,
    state_dict_from_variables,
    tensor_variables_from_state_dict,
)
from deadtrees_tpu_torch.parallel.mesh import Mesh, any_rank, barrier, create_mesh, replicate
from deadtrees_tpu_torch.train.loss import build_loss
from deadtrees_tpu_torch.train.optim import (
    MultiStageConfig,
    OptimizerConfig,
    cosine_annealing_schedule,
    make_optimizer,
    optimizer_from_bytes,
    optimizer_state_dict,
)
from deadtrees_tpu_torch.train.steps import (
    TrainState,
    bn_buffers,
    make_eval_step,
    make_predict_step,
    make_train_step,
    step_program,
)

log = logging.getLogger(__name__)

SWA_BN_BATCHES = 10


class MetricsLogger:
    """CSV metrics sink (+ W&B when asked for and importable)."""

    def __init__(self, save_dir: Path, use_wandb: bool = False, wandb_cfg=None,
                 enabled: bool = True):
        # several ranks: rank 0 alone writes files and talks to W&B
        self.enabled = enabled
        self.save_dir = Path(save_dir)
        if enabled:
            self.save_dir.mkdir(parents=True, exist_ok=True)
        self.rows: List[Dict[str, Any]] = []
        self.wandb = None
        if use_wandb and enabled:
            try:
                import wandb

                wandb.init(project=(wandb_cfg or {}).get("project", "deadtrees-tpu"))
                self.wandb = wandb
            except Exception as e:
                log.warning(f"wandb unavailable ({e}); falling back to CSV only")

    def log(self, metrics: Dict[str, float], step: int) -> None:
        self.rows.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
        if self.wandb:
            self.wandb.log(metrics, step=step)

    def log_param_histograms(self, model: torch.nn.Module, step: int) -> None:
        """Per-parameter histograms (the reference's ``wandb.watch``).
        No-op without W&B."""
        if not self.wandb:
            return
        hists = {
            f"params/{name}": self.wandb.Histogram(p.detach().float().cpu().numpy().ravel())
            for name, p in model.named_parameters()
        }
        self.wandb.log(hists, step=step)

    def log_artifact(self, path, kind: str = "checkpoint") -> None:
        """Checkpoint upload as a W&B artifact. No-op without W&B."""
        if not self.wandb:
            return
        art = self.wandb.Artifact(f"run-{kind}", type=kind)
        art.add_file(str(path))
        self.wandb.log_artifact(art)

    def flush(self) -> None:
        if not self.rows or not self.enabled:
            return
        keys = sorted({k for r in self.rows for k in r})
        with open(self.save_dir / "metrics.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.rows)

    def finish(self) -> None:
        self.flush()
        if self.wandb:
            self.wandb.finish()


def _mean_metrics(batch_metrics: List[Dict[str, Any]], prefix: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    if not batch_metrics:
        return out
    for k in batch_metrics[0]:
        if k in ("cm", "cm_masked"):
            continue
        out[f"{prefix}/{k}"] = float(np.mean([float(m[k]) for m in batch_metrics]))
    return out


def _mesh(cfg: Dict[str, Any], device: torch.device) -> Mesh:
    """This rank's mesh; raises unless the process group has
    ``trainer.devices`` ranks (``null``: any number)."""
    devices = cfg.get("trainer", {}).get("devices")
    try:
        return create_mesh(devices, device=device)
    except ValueError as e:
        raise ValueError(
            f"trainer.devices={devices}: {e}. Launch one process a device: python -m "
            f"torch.distributed.run --nproc-per-node {devices} -m deadtrees_tpu_torch train "
            f"trainer.devices={devices} ...") from None


class Trainer:
    def __init__(
        self,
        config: Dict[str, Any],
        work_dir: Optional[Union[str, Path]] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.cfg = config
        self.work_dir = Path(work_dir or ".")
        self.device = resolve_device(device)
        self.mesh = _mesh(config, self.device)
        self.is_main = self.mesh.rank == 0
        self.stats = {"train": Counter(), "val": Counter(), "test": Counter()}
        self.timings: Dict[str, List[float]] = {
            k: [] for k in ("epoch_s", "save_s", "resume_s", "swa_recal_s", "test_s")}
        self._stop_requested = False

    # -- preemption ---------------------------------------------------------
    def request_stop(self) -> None:
        """Ask the fit loop to stop at the next step boundary, write
        last.ckpt and return normally with ``result['preempted'] = 1.0``.
        Thread-safe; what the SIGTERM trap calls."""
        self._stop_requested = True

    @contextlib.contextmanager
    def _sigterm_trap(self):
        """A SIGTERM handler for the duration of ``fit()``, the previous one
        restored after. ``signal.signal`` works on the main thread only;
        elsewhere the fit runs without the trap."""

        def handler(*_):
            log.warning("SIGTERM: stopping at the next step boundary and checkpointing")
            self.request_stop()

        try:
            prev = signal.signal(signal.SIGTERM, handler)
        except ValueError:  # not the main thread
            yield
            return
        try:
            yield
        finally:
            signal.signal(signal.SIGTERM, prev)

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
        self.class_names = list(classes) if isinstance(classes, (list, tuple)) else None
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
                batch_size_extra=dmc.get("batch_size_extra"),
                num_workers=int(dmc.get("num_workers", 2)),
                use_native=bool(dmc.get("use_native", True)),
                cache_dir=dmc.get("cache_dir"),
                in_channels=self.in_channels,
                classes=self.num_classes,
                distmap=True,
                seed=seed,
                process_index=dmc.get("process_index"),
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
        replicate(self.state, self.mesh)
        log.info(f"Mesh: {self.mesh.size} rank(s) on axis 'data'")

        self.loss = build_loss(mc.get("losses", ["GDICE", "FOCAL", "BOUNDARY"]), self.num_classes)
        self.train_step = make_train_step(
            self.model, self.loss, num_classes=self.num_classes,
            remat=bool(tc.get("remat", False)), frozen_bn=bool(tc.get("frozen_bn", False)),
            mesh=self.mesh,
        )
        self.eval_step = make_eval_step(self.model, self.loss, num_classes=self.num_classes,
                                        mesh=self.mesh)
        self.predict_step = make_predict_step(self.model)

        def bn_pass(img: torch.Tensor) -> None:
            self.model(img)  # train mode: only the running statistics move

        # several ranks: the global batch's statistics
        self._bn_pass = step_program(bn_pass, self.device, self.mesh)

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
        # the snapshot is taken on the loop's thread; encode and write on a worker
        self._ckpt_writer = (
            AsyncCheckpointWriter()
            if mck.get("async_write", True) is not False and self.is_main else None
        )
        es = cb.get("early_stopping", {})
        self.es_patience = int(es.get("patience", 200))
        self.es_monitor = es.get("monitor", "val/dice")

        # W&B-extras knobs (configs/callbacks/wandb.yaml): `false` disables
        # a feature, a mapping tunes it, absent keys keep these defaults
        wm = cb.get("watch_model", {})
        self.watch_params = wm is not False
        self.watch_log_freq = int(wm.get("log_freq", 0)) if isinstance(wm, dict) else 0
        self._last_hist_step: Optional[int] = None
        uca = cb.get("upload_ckpts_as_artifact", {})
        self.upload_ckpts = uca is not False
        self.upload_best_only = (
            bool(uca.get("upload_best_only", True)) if isinstance(uca, dict) else True
        )
        self.log_cm_figures = bool(cb.get("log_confusion_matrix", True))
        lip = cb.get("log_image_predictions", {})
        self.log_sample_figures = lip is not False
        self.sample_figure_count = int(lip.get("num_samples", 8)) if isinstance(lip, dict) else 8

        swa = cb.get("swa")
        self.swa_start: Optional[int] = int(swa.get("swa_epoch_start", 0)) if swa else None
        self._swa_params: Optional[List[torch.Tensor]] = None
        self._swa_count = 0

        lg = cfg.get("logger") or {}
        self.metrics = MetricsLogger(
            self.work_dir / lg.get("save_dir", "logs/metrics"),
            use_wandb=lg.get("kind") == "wandb",
            wandb_cfg=lg,
            enabled=self.is_main,
        )

    def _stage_optimizer(self, epoch: int):
        """A fresh optimizer at the learning-rate stage of ``epoch``."""
        ms = self.multistage
        scale = 1.0
        if ms and ms.lr_reduce_epoch is not None and epoch >= int(ms.lr_reduce_epoch):
            scale = 1.0 / float(ms.lr_reduce_fraction)
        return make_optimizer(self.model.parameters(), self.opt_config, lr_scale=scale)

    def _stop(self) -> bool:
        """Whether to stop at this step boundary: asked on any rank (every
        rank asks at the same boundaries)."""
        return any_rank(self._stop_requested, self.mesh)

    @torch.no_grad()
    def _check_replicas(self, epoch: int) -> None:
        """Several ranks: raise unless every rank holds the same parameters
        and BatchNorm buffers. A checksum of their bits (the sums of the
        words and of their squares, int64) is all-reduced as its maximum
        and its minimum: one all_reduce an epoch."""
        if not self.mesh.distributed:
            return
        sums = torch.zeros(2, dtype=torch.int64, device=self.device)
        for t in self.model.state_dict().values():
            words = t.detach().reshape(-1)
            words = words.view(torch.int32) if words.element_size() == 4 else words
            words = words.to(torch.int64)
            sums += torch.stack([words.sum(), (words * words).sum()])
        both = torch.cat([sums, -sums])
        torch.distributed.all_reduce(both, op=torch.distributed.ReduceOp.MAX,
                                     group=self.mesh.group)
        if not torch.equal(both[:2], -both[2:]):
            raise RuntimeError(f"epoch {epoch}: the ranks' parameters drifted apart")
        log.info(f"epoch {epoch}: the {self.mesh.size} ranks hold equal parameters and "
                 f"BatchNorm buffers (checksum {both[:2].tolist()})")

    def _epoch_step_cap(self, limit_train) -> Optional[int]:
        """Steps this rank may take this epoch: with several processes at
        most the smallest rank's (``steps_per_epoch``), so that no rank
        waits in a collective for one whose stream ran dry; one process
        runs to the end of its stream."""
        cap = None if limit_train is None else int(limit_train)
        if self.datamodule.process_count > 1:
            safe = int(self.datamodule.steps_per_epoch)
            cap = safe if cap is None else min(cap, safe)
        return cap

    # -- loops --------------------------------------------------------------
    def _run_val_epoch(self, epoch: int, max_batches: Optional[int]) -> Dict[str, float]:
        batch_metrics, cms, cms_masked = [], [], []
        first_batch = None
        with contextlib.closing(self.datamodule.val_batches()) as batches:
            # islice stops before the data module finishes a batch it won't use
            for batch in itertools.islice(batches, max_batches):
                self.stats["val"].update(batch.pop("files", []))
                m = self.eval_step(self.state, batch, epoch)
                if first_batch is None:
                    first_batch = batch
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
            if self.log_cm_figures and self.is_main:
                self._save_cm_figures(self.last_cm, self.last_cm_masked, epoch)
        if first_batch is not None and self.log_sample_figures and self.is_main:
            self._save_sample_figure(first_batch, epoch)
        return out

    def _save_figure(self, fig, name: str) -> None:
        import matplotlib.pyplot as plt

        out = self.work_dir / "figures"
        out.mkdir(parents=True, exist_ok=True)
        fig.savefig(out / name, dpi=72)
        plt.close(fig)

    def _save_cm_figures(self, cm, cm_masked, epoch: int) -> None:
        try:
            from deadtrees_tpu_torch.visualization import show_cm

            def norm(m):
                row = m.sum(axis=1, keepdims=True)
                return np.where(row > 0, m / np.maximum(row, 1), 0.0)

            fig = show_cm(norm(cm), None if cm_masked is None else norm(cm_masked),
                          class_names=self.class_names)
            self._save_figure(fig, f"cm_val_epoch{epoch:03d}.png")
        except Exception as e:
            log.debug(f"CM figure skipped: {e}")

    def _save_sample_figure(self, batch, epoch: int) -> None:
        try:
            import matplotlib  # noqa: F401 - without it, skip the forward too

            from deadtrees_tpu_torch.visualization import show

            _, probs = self.predict_step(batch["image"])
            fig = show(
                batch["image"].permute(0, 2, 3, 1).cpu().numpy(),
                batch["mask"].cpu().numpy(),
                probs.permute(0, 2, 3, 1).float().cpu().numpy(),
                n_samples=min(batch["image"].shape[0], self.sample_figure_count),
            )
            self._save_figure(fig, f"samples_epoch{epoch:03d}.png")
        except Exception as e:
            log.debug(f"sample figure skipped: {e}")

    def _load_variables(self, ckpt: Dict[str, Any]) -> None:
        self.model.load_state_dict(state_dict_from_variables(
            {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]},
            encoder_name=self.hparams["encoder_name"],
        ))

    def resume(self, ckpt_path) -> int:
        """Restore parameters, BatchNorm statistics, the Adam state and the
        step from a checkpoint; returns the epoch to resume FROM. The
        optimizer is built at the learning-rate stage of that epoch."""
        t0 = time.perf_counter()
        ckpt = load_checkpoint(ckpt_path)
        self._load_variables(ckpt)
        start_epoch = int(ckpt.get("epoch", -1)) + 1
        self.state.replace_optimizer(self._stage_optimizer(start_epoch))
        if "opt_state" in ckpt:
            optimizer_from_bytes(self.state.optimizer, self.model, ckpt["opt_state"])
        self.state.step = int(ckpt.get("step", 0))
        replicate(self.state, self.mesh)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["resume_s"].append(time.perf_counter() - t0)
        log.info(f"Resumed from {ckpt_path} at epoch {start_epoch}")
        return start_epoch

    @contextlib.contextmanager
    def _profiler(self, profiler_dir):
        if not profiler_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        was_on = trace.ENABLED
        trace.enable()  # the port's own spans of the profiled fit, beside the profiler's
        since = time.time_ns()
        prof = profile(activities=activities)
        prof.start()
        try:
            yield
        finally:
            prof.stop()
            snap = trace.snapshot()
            if not was_on:  # spans the fit turned on: not kept past their file
                trace.disable()
                trace.reset()
            out = Path(profiler_dir)
            out.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out / "trace.json"))
            trace.write_chrome(out / "spans.json",
                               [s for s in snap["spans"] if s.start_ns >= since],
                               snap["counters"], trace.trace_base_ns(out / "trace.json"))

    def fit(self) -> Dict[str, Any]:
        self._build()
        tc = self.cfg.get("trainer", {})
        max_epochs = int(tc.get("max_epochs", 300))
        min_epochs = int(tc.get("min_epochs", 1))
        limit_train = tc.get("limit_train_batches")
        limit_val = tc.get("limit_val_batches")
        detect_anomaly = bool(tc.get("detect_anomaly", False))

        start_epoch = 0
        if tc.get("resume_from_checkpoint"):
            start_epoch = self.resume(tc["resume_from_checkpoint"])

        generator = torch.Generator().manual_seed(self.cfg.get("seed") or 0)
        best = None
        since_improve = 0
        last_val: Dict[str, float] = {}
        preempted = False

        stack = contextlib.ExitStack()
        if tc.get("handle_sigterm", True):
            stack.enter_context(self._sigterm_trap())
        stack.enter_context(self._profiler(tc.get("profiler_dir")))
        try:
            for epoch in range(start_epoch, max_epochs):
                t_epoch = time.perf_counter()
                frozen = bool(self.multistage and epoch < self.multistage.unfreeze_epoch)
                if (
                    self.multistage
                    and self.multistage.lr_reduce_epoch is not None
                    and epoch == int(self.multistage.lr_reduce_epoch)
                ):
                    log.info(f"NEW STAGE (epoch {epoch}): fresh Adam at lr/"
                             f"{self.multistage.lr_reduce_fraction}")
                    self.state.replace_optimizer(self._stage_optimizer(epoch))
                    replicate(self.state, self.mesh)

                t0 = time.perf_counter()
                n_steps = 0
                train_metrics: List[Dict] = []
                cap = self._epoch_step_cap(limit_train)
                stop = False
                with contextlib.closing(self.datamodule.train_batches(generator)) as batches:
                    for i, batch in enumerate(itertools.islice(batches, cap)):
                        stop = self._stop()
                        if stop:
                            break
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

                if stop or self._stop():
                    # the mid-epoch state as last.ckpt with epoch - 1: resume
                    # replays the interrupted epoch in full
                    log.warning(f"Stop requested: checkpointing mid-epoch {epoch} after "
                                f"{n_steps} step(s) and exiting cleanly")
                    self._timed_save(self._ckpt_saver(epoch - 1), self.keeper.directory / "last.ckpt")
                    preempted = True
                    break

                epoch_train = _mean_metrics(train_metrics, "train")
                self._check_replicas(epoch)
                if self.mesh.distributed:
                    epoch_train["replicas_equal"] = 1.0
                val = self._run_val_epoch(epoch, int(limit_val) if limit_val is not None else None)
                last_val = val
                if self.mesh.distributed:
                    log.info(f"epoch {epoch}, rank {self.mesh.rank}: val {val}")
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

                if self.swa_start is not None and epoch >= self.swa_start:
                    self._update_swa()

                step_now = self.state.step
                if self.watch_params and (
                    self._last_hist_step is None
                    or step_now - self._last_hist_step >= self.watch_log_freq
                ):
                    self.metrics.log_param_histograms(self.model, step_now)
                    self._last_hist_step = step_now

                monitored = val.get(self.es_monitor)
                stop_early = False
                if monitored is not None:
                    improved = self.keeper.is_improvement(monitored)
                    t_save = time.perf_counter()
                    self.keeper.update(
                        monitored, epoch, self._ckpt_saver(epoch),
                        save_many_fn=self._ckpt_saver_many(epoch),
                        delete_fn=self._ckpt_deleter(),
                    )
                    self.timings["save_s"].append(time.perf_counter() - t_save)
                    if improved:
                        since_improve = 0
                        best = monitored
                    else:
                        since_improve += 1
                    stop_early = since_improve >= self.es_patience and epoch + 1 >= min_epochs
                self.timings["epoch_s"].append(time.perf_counter() - t_epoch)
                if stop_early:
                    log.info(f"Early stopping at epoch {epoch}")
                    break
                if self._stop():     # landed between epochs: the keeper
                    preempted = True  # already saved last.ckpt
                    break
        finally:
            stack.close()
            if self._ckpt_writer is not None:
                # every queued write on disk (and its error raised) before
                # anything reads the files back, without masking an error
                # already in flight
                if sys.exc_info()[0] is None:
                    self._ckpt_writer.wait()
                else:
                    try:
                        self._ckpt_writer.wait()
                    except Exception:
                        log.exception("asynchronous checkpoint write failed")
            if sys.exc_info()[0] is None:
                barrier(self.mesh)  # rank 0's files on disk before any rank reads them
            self.teardown()

        result: Dict[str, Any] = dict(last_val)
        if preempted:
            log.warning("Preempted: the checkpoints are on disk; resume with "
                        "trainer.resume_from_checkpoint")
            result["preempted"] = 1.0
        if best is not None:
            result["best/" + self.es_monitor] = best
        if self.keeper.best_path:
            log.info(f"Best checkpoint path:\n{self.keeper.best_path}")
            result["best_ckpt"] = str(self.keeper.best_path)
            if self.upload_ckpts:
                self.metrics.log_artifact(self.keeper.best_path, "checkpoint")
        if self.upload_ckpts and not self.upload_best_only:
            last = self.keeper.directory / "last.ckpt"
            if last.exists():
                self.metrics.log_artifact(last, "checkpoint-last")
        if self._swa_params is not None and not preempted:
            swa_path = self._finalize_swa()
            result["swa_ckpt"] = str(swa_path)
            if self.upload_ckpts and not self.upload_best_only:
                self.metrics.log_artifact(swa_path, "checkpoint-swa")
        if self.mesh.distributed:
            from deadtrees_tpu_torch.ops.launches import LAUNCHES

            peak = (torch.cuda.max_memory_allocated(self.device) / 2**30
                    if self.device.type == "cuda" else float("nan"))
            log.info(f"rank {self.mesh.rank} of {self.mesh.size}: {self.state.step} steps, "
                     f"kernel launches {dict(LAUNCHES)}, peak device memory {peak:.3f} GiB")
        self.metrics.finish()
        return result

    # -- SWA ----------------------------------------------------------------
    @torch.no_grad()
    def _update_swa(self) -> None:
        """avg + (p - avg) / (n + 1) over copies of the parameters."""
        params = [p.detach() for p in self.model.parameters()]
        n = self._swa_count
        if self._swa_params is None:
            self._swa_params = [p.clone() for p in params]
        else:
            diff = torch._foreach_sub(params, self._swa_params)
            torch._foreach_div_(diff, float(n + 1))
            torch._foreach_add_(self._swa_params, diff)
        self._swa_count = n + 1

    @torch.no_grad()
    def _recalibrate_bn(self, batches) -> int:
        """Move the BatchNorm running statistics, from where they are, over
        ``batches`` in train mode under the model's current parameters
        (the BatchNorms' flax-semantics momentum), one program a batch (the
        JAX trainer's jitted ``bn_pass``); returns the batch count."""
        self.model.train(True)
        seen = 0
        for batch in batches:
            self._bn_pass(batch["image"])
            seen += 1
        return seen

    def _finalize_swa(self) -> Path:
        """Recalibrate BN under the averaged parameters with up to 10 train
        batches, then save swa.ckpt; the trainer's own parameters and
        statistics are put back after."""
        log.info(f"SWA: averaged {self._swa_count} epochs; recalibrating BN")
        params = list(self.model.parameters())
        buffers = bn_buffers(self.model)
        live = [t.detach().clone() for t in params + buffers]
        with torch.no_grad():
            for p, a in zip(params, self._swa_params):
                p.copy_(a)
        try:
            t0 = time.perf_counter()
            generator = torch.Generator().manual_seed(0)
            with contextlib.closing(self.datamodule.train_batches(generator)) as batches:
                self.swa_bn_batches = self._recalibrate_bn(
                    itertools.islice(batches, SWA_BN_BATCHES))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings["swa_recal_s"].append(time.perf_counter() - t0)
            path = self.keeper.directory / "swa.ckpt"
            if self.is_main:
                save_checkpoint(path, **self._variables(), hparams=self.hparams,
                                step=self.state.step, epoch=-1)
            barrier(self.mesh)
        finally:
            with torch.no_grad():
                for t, v in zip(params + buffers, live):
                    t.copy_(v)
        return path

    # -- checkpoints ----------------------------------------------------------
    def _variables(self) -> Dict[str, Dict]:
        return tensor_variables_from_state_dict(
            self.model.state_dict(), encoder_name=self.hparams["encoder_name"])

    def _ckpt_kwargs(self, epoch: int) -> Dict[str, Any]:
        return dict(
            **self._variables(),
            hparams=self.hparams,
            opt_state=optimizer_state_dict(self.state.optimizer, self.model),
            step=self.state.step,
            epoch=epoch,
        )

    def _timed_save(self, save, path) -> None:
        t0 = time.perf_counter()
        save(path)
        self.timings["save_s"].append(time.perf_counter() - t0)

    def _ckpt_saver(self, epoch: int):
        def save(path):
            if not self.is_main:
                return
            if self._ckpt_writer is not None:
                self._ckpt_writer.save(path, **self._ckpt_kwargs(epoch))
            else:
                save_checkpoint(path, **self._ckpt_kwargs(epoch))

        return save

    def _ckpt_saver_many(self, epoch: int):
        """One snapshot → several paths (the keeper's last + best)."""
        single = self._ckpt_saver(epoch)

        def save_many(paths):
            if not self.is_main:
                return
            if self._ckpt_writer is not None:
                self._ckpt_writer.save_many(paths, **self._ckpt_kwargs(epoch))
            else:
                for p in paths:
                    single(p)

        return save_many

    def _ckpt_deleter(self):
        """Old-best removal, ordered after its write when saves are async."""

        def delete(path):
            if not self.is_main:
                return
            if self._ckpt_writer is not None:
                self._ckpt_writer.delete(path)
            else:
                Path(path).unlink(missing_ok=True)
                pointer_path(path).unlink(missing_ok=True)

        return delete

    def test(self, ckpt_path: Optional[str] = None, tta: Optional[int] = None) -> Dict[str, float]:
        """The test loop over the test shards, from a checkpoint when one is
        given. ``tta`` (or the config key ``tta``): dihedral views for the
        test metrics only (built per call)."""
        tta = int(self.cfg.get("tta", 0) or 0) if tta is None else int(tta)
        eval_step = self.eval_step
        if tta:
            eval_step = make_eval_step(self.model, self.loss, num_classes=self.num_classes,
                                       tta=tta, mesh=self.mesh)
        if ckpt_path:
            if self._ckpt_writer is not None:
                self._ckpt_writer.wait()  # the file may still be in flight
            barrier(self.mesh)  # ... on rank 0, which writes it
            self._load_variables(load_checkpoint(ckpt_path))
            replicate(self.model, self.mesh)
        t0 = time.perf_counter()
        batch_metrics, cms, cms_masked = [], [], []
        with contextlib.closing(self.datamodule.test_batches()) as batches:
            for batch in batches:
                self.stats["test"].update(batch.pop("files", []))
                m = eval_step(self.state, batch, 0)
                cms.append(m["cm"])
                if "cm_masked" in m:
                    cms_masked.append(m["cm_masked"])
                batch_metrics.append(m)
        out = _mean_metrics(batch_metrics, "test")
        self.timings["test_s"].append(time.perf_counter() - t0)
        self.last_test_cm = None
        if cms:
            self.last_test_cm = torch.stack(cms).sum(0).cpu().numpy()
            log.info(f"CM - DEFAULT - PIXEL:\n{self.last_test_cm}")
            if cms_masked:
                log.info(f"CM - FORESTONLY - PIXEL:\n{torch.stack(cms_masked).sum(0).cpu().numpy()}")
        return out

    def teardown(self) -> None:
        """Dump the per-file sample counters (rank 0's)."""
        if not self.is_main:
            return
        for split in ("train", "val"):
            with open(self.work_dir / f"{split}_stats.csv", "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["filename", "count"])
                w.writerows(sorted(self.stats[split].items()))


def train(
    config: Dict[str, Any],
    work_dir: Optional[Union[str, Path]] = None,
    device: Optional[Union[str, torch.device]] = None,
    *,
    trainer: Optional[Trainer] = None,
) -> Any:
    """Fit, then ``test_after_training`` on the best checkpoint when the
    data has test shards and the fit was not preempted. Returns the value of ``optimized_metric`` when
    the config names one, else the result dict. ``trainer``: a Trainer to
    run (for a caller that reads it afterwards) instead of a new one."""
    trainer = trainer or Trainer(config, work_dir=work_dir, device=device)
    result = trainer.fit()
    if (config.get("test_after_training") and trainer.datamodule.test_shards
            and "preempted" not in result):
        result.update(trainer.test(result.get("best_ckpt")))
        trainer.teardown()
    optimized = config.get("optimized_metric")
    if optimized:
        return result.get(optimized)
    return result
