"""Training cells: the per-batch loop of the recipe's ``Trainer.fit``.

Set-up writes the traffic's shards into a fresh directory under the
temporary directory, composes the recipe's config as the CLI does
(``configs/``, the configuration's overrides, the traffic's batch size and
reader threads), builds the Trainer's data module, model, loss, steps and
optimizer (``Trainer._build``), loads the seed's weights, and takes the
optimizer of the traffic's epoch (MultiStage: a fresh Adam at the stage's
rate, the encoder trainable). It then runs the first ``checked_steps``
steps through the window's own feed and call, keeping what the output
check compares, and hands the same trainer and batch stream to the window.

The window repeats ``next()`` on the looping batch stream (upload, kernel
4, the EDT: ``data/pipeline.py``) and ``train_step`` (``train/steps.py``)
until ``--seconds`` have passed, then synchronises.

The check (after the window, the program freed): the reference rebuilds
each checked batch from the raw tiles and the generator's state, runs the
same steps in float32, and compares the batch (kernel 4's image, the
distance maps), each step's loss, the first gradient as Adam got it
(its first moment / (1 − b1)) leaf by leaf, and each leaf's change over
the checked steps.
"""

from __future__ import annotations

import contextlib
import gc
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.harness import flops
from port_bench.harness import traffic as gen
from port_bench.harness import weights
from port_bench.harness.record import Record, checks, leaf_gaps
from port_bench.reference import batch as ref_batch
from port_bench.reference import model as ref_model
from port_bench.reference import step as ref_step
from port_bench.reference.core import Numerics, float32_exact

RANGES = ("window", "batch", "step", "augment", "edt")
B1 = 0.9


def seed31(seed: int) -> int:
    """The recipe seeds numpy, which takes 32 bits."""
    return int(seed) % (2**31 - 1)


def compose(config: Dict, traffic: Dict, data_dir: Path, seed: int, root: Path) -> Dict:
    from deadtrees_tpu_torch.config import compose as compose_config

    overrides = list(config["program"]["overrides"]) + [
        f"data_dir={data_dir}", f"seed={seed31(seed)}", "logger=csv",
        f"datamodule.batch_size={traffic['batch_size']}",
        f"datamodule.num_workers={traffic['num_workers']}",
    ]
    cfg = compose_config(root / "configs", "config", overrides=overrides)
    _hold_to_config(cfg, config, traffic)
    return cfg


def _hold_to_config(cfg: Dict, config: Dict, traffic: Dict) -> None:
    """Raise where the composed recipe departs from the configuration file."""
    net, tr, cb = cfg["model"]["network"], cfg["model"]["training"], cfg["callbacks"]
    recipe = config["recipe"]
    got = {
        "decoder_channels": list(net["decoder_channels"]),
        "in_channels": int(net["in_channels"]),
        "classes": len(net["classes"]) if isinstance(net["classes"], list) else net["classes"],
        "losses": list(net["losses"]),
        "learning_rate": float(tr["learning_rate"]),
        "cosineannealing_tmax": int(tr["cosineannealing_tmax"]),
        "gradient_clip_val": float(cfg["trainer"]["gradient_clip_val"]),
        "precision": cfg["trainer"]["precision"],
        "unfreeze_epoch": int(cb["multistage"]["unfreeze_epoch"]),
        "lr_reduce_epoch": int(cb["multistage"]["lr_reduce_epoch"]),
        "lr_reduce_fraction": float(cb["multistage"]["lr_reduce_fraction"]),
        "batch_size": int(cfg["datamodule"]["batch_size"]),
    }
    want = {"decoder_channels": config["decoder_channels"], "in_channels": config["in_channels"],
            "classes": config["classes"], "precision": config["precision"],
            "batch_size": traffic["batch_size"], **recipe}
    diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    if diff:
        raise ValueError(f"the composed recipe departs from the configuration: {diff}")


def stage_lr(config: Dict, epoch: int) -> float:
    """The learning rate of the first updates of ``epoch``'s stage: the
    base rate, divided by the reduce fraction from its epoch on; the
    cosine schedule starts the stage's fresh Adam at its top."""
    r = config["recipe"]
    lr = r["learning_rate"]
    return lr / r["lr_reduce_fraction"] if epoch >= r["lr_reduce_epoch"] else lr


class Run:
    def __init__(self, cell, seed: int, device: torch.device, root: Path):
        self.cell, self.seed, self.device, self.root = cell, int(seed), device, root
        self.config, self.traffic = cell.config, cell.traffic
        self.setup_parts: Dict[str, float] = {}
        self.checked: List[Dict] = []
        self.steps_losses: List[torch.Tensor] = []
        self.tmp: Optional[Path] = None

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from deadtrees_tpu_torch.train.trainer import Trainer

        t = time.perf_counter()
        self.tmp = Path(tempfile.mkdtemp(prefix="port_bench-"))
        data = self.tmp / "data"
        gen.write_train_shards(data, self.seed, self.traffic)
        cfg = compose(self.config, self.traffic, data, self.seed, self.root)
        self.setup_parts["inputs_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.trainer = Trainer(cfg, work_dir=self.tmp / "work", device=self.device)
        self.trainer._build()
        model = self.trainer.model
        model.load_state_dict(weights.make(self.config, self.seed, self.device), strict=True)
        epoch = self.traffic["epoch"]
        self.trainer.state.replace_optimizer(self.trainer._stage_optimizer(epoch))
        self.names = [n for n, _ in model.named_parameters()]
        p0 = [p.detach().clone() for p in model.parameters()]
        self.setup_parts["build_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.generator = torch.Generator().manual_seed(seed31(self.seed))
        self.batches = self.trainer.datamodule.train_batches(self.generator, loop=True)
        opt = self.trainer.state.optimizer
        for k in range(self.traffic["checked_steps"]):
            state = self.generator.get_state()
            batch = next(self.batches)
            rec = {"state": state, "files": batch.pop("files")}
            batch.pop("lu", None)
            rec["image"] = batch["image"].cpu()
            rec["distmap"] = batch["distmap"].cpu()
            self.trainer.state, m = self.trainer.train_step(self.trainer.state, batch, epoch,
                                                            frozen=False)
            rec["loss"] = float(m["total_loss"])
            if k == 0:
                norms = (torch.stack([v.norm() for v in opt.mu]) / (1 - B1)).tolist()
                rec["grad_norms"] = dict(zip(self.names, norms))
            self.checked.append(rec)
        self.delta_norms = dict(zip(self.names, torch.stack(
            [(p.detach() - q).norm() for p, q in zip(model.parameters(), p0)]).tolist()))
        del p0
        _sync(self.device)
        self.setup_parts["warmup_s"] = time.perf_counter() - t
        self.setup_parts.update(_build_seconds(self.trainer))

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float, tracer=None) -> Record:
        from torch.profiler import record_function

        epoch = self.traffic["epoch"]
        bs = self.traffic["batch_size"]
        spans: Dict[str, list] = {"batch": [], "step": []}
        with _instrumented(tracer is not None):
            if tracer is not None:
                tracer.start()
            with record_function("window"):
                t0 = time.perf_counter()
                while True:
                    with record_function("batch"):
                        a = time.perf_counter()
                        batch = next(self.batches)
                        b = time.perf_counter()
                    batch.pop("files")
                    batch.pop("lu", None)
                    with record_function("step"):
                        self.trainer.state, m = self.trainer.train_step(
                            self.trainer.state, batch, epoch, frozen=False)
                    c = time.perf_counter()
                    spans["batch"].append((a, b))
                    spans["step"].append((b, c))
                    self.steps_losses.append(m["total_loss"])
                    if c - t0 >= seconds:
                        break
                _sync(self.device)
                t1 = time.perf_counter()
            trace = tracer.stop() if tracer is not None else None
        steps = len(spans["step"])
        failed = int((~torch.isfinite(torch.stack(self.steps_losses))).sum())
        return Record(
            cell=self.cell.name, window_s=t1 - t0, setup_s=0.0,
            counters={"steps": steps, "samples": steps * bs, "failed": failed},
            spans=spans, setup=dict(self.setup_parts),
            facts={"augment_shape": (bs, self.traffic["tile"], self.traffic["tile"],
                                     self.config["in_channels"]),
                   "flops_per_sample": _flops_per_sample(self.config, self.traffic)},
            trace=trace)

    # -- the check ------------------------------------------------------------
    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        close = getattr(self.batches, "close", None)
        if close is not None:
            close()
        del self.batches, self.trainer
        self.steps_losses.clear()
        gc.collect()
        torch.cuda.empty_cache()

    def program_outputs(self) -> Dict:
        return {"images": [r["image"] for r in self.checked],
                "distmaps": [r["distmap"] for r in self.checked],
                "losses": [r["loss"] for r in self.checked],
                "grad_norms": self.checked[0]["grad_norms"],
                "delta_norms": self.delta_norms}

    def check(self) -> List[Check]:
        ref = reference_outputs(self.config, self.traffic, self.seed, self.device,
                                [r["files"] for r in self.checked],
                                [r["state"] for r in self.checked])
        worst: Dict[str, list] = {}
        got = compare(self.program_outputs(), ref, worst)
        for k, leaves in worst.items():
            say(f"leaf gaps of {k}: max {leaves[0][0]:.6g}, tenth {leaves[len(leaves) // 10][0]:.6g},"
                f" median {leaves[len(leaves) // 2][0]:.6g}; worst: " + "; ".join(
                f"{n} {g:.4g} (program {self.program_outputs()[k][n]:.6g}, reference "
                f"{ref[k][n]:.6g})" for g, n in leaves[:5]))
        return checks(got, self.cell.limits)

    def close(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _instrumented(on: bool):
    """In a traced run, the data module's calls of kernel 4's program and of
    the EDT inside ranges of their own (the program has no spans yet)."""
    if not on:
        yield
        return
    from torch.profiler import record_function

    from deadtrees_tpu_torch.data import pipeline

    saved = {n: getattr(pipeline, n) for n in ("augment_batch", "batch_one_hot2dist")}

    def wrap(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    pipeline.augment_batch = wrap("augment", saved["augment_batch"])
    pipeline.batch_one_hot2dist = wrap("edt", saved["batch_one_hot2dist"])
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(pipeline, n, fn)


def _build_seconds(trainer) -> Dict[str, float]:
    from deadtrees_tpu_torch.data import augment
    from deadtrees_tpu_torch.ops import _build

    programs = [augment._PROGRAM, *trainer.train_step.programs]
    return {"nvcc_s": sum(_build.build_seconds.values()),
            "compile_s": sum(s for p in programs for s, _ in p.compiles)}


def _flops_per_sample(config: Dict, traffic: Dict) -> float:
    """Forward and backward FLOPs of one sample, counted on the reference
    over meta tensors at the traffic's tile."""
    params = {l.name: torch.empty(l.shape, device="meta") for l in ref_model.leaves(config)}
    x = torch.empty((1, config["in_channels"], traffic["tile"], traffic["tile"]),
                    device="meta")
    ops = flops.forward_flops(lambda: ref_model.forward(params, x, config, train=True))
    return float(flops.training_flops(ops))


def reference_outputs(config: Dict, traffic: Dict, seed: int, device, files: List[List[str]],
                      states: List[torch.Tensor], numerics: str = "float32",
                      batch_dtype=torch.float32, half_batch: bool = False) -> Dict:
    """The checked steps by the reference: the batches from the raw tiles
    and the generator's states, then the float32 steps. ``numerics``
    ``"fp8"`` with ``batch_dtype`` bfloat16 is the control; ``half_batch``
    a fault (the loss of the first half of each batch alone)."""
    with float32_exact():
        return _reference_steps(config, traffic, seed, device, files, states, numerics,
                                batch_dtype, half_batch)


def _reference_steps(config, traffic, seed, device, files, states, numerics, batch_dtype,
                     half_batch) -> Dict:
    leaves = [l for l in ref_model.leaves(config) if l.is_param]
    names = [l.name for l in leaves]
    params = weights.make(config, seed, device)
    adam = ref_step.Adam([params[n] for n in names], stage_lr(config, traffic["epoch"]),
                         config["recipe"]["gradient_clip_val"])
    start = [params[n].clone() for n in names]
    mean, std = traffic["normalize"]["mean"], traffic["normalize"]["std"]
    out: Dict = {"images": [], "distmaps": [], "losses": []}
    for k, (keys, state) in enumerate(zip(files, states)):
        raw = [gen.train_sample(seed, gen.sample_index(key), traffic) for key in keys]
        image_u8 = torch.from_numpy(np.stack([r[0] for r in raw]))
        mask_u8 = torch.from_numpy(np.stack([r[1] for r in raw]))
        p = ref_batch.draw(state, len(raw))
        image, mask = ref_batch.augment(image_u8, mask_u8, p, mean, std, batch_dtype)
        distmap = ref_batch.distmaps(mask.numpy(), config["classes"], batch_dtype)
        out["images"].append(image)
        out["distmaps"].append(distmap)
        rows = slice(0, len(raw) // 2 if half_batch else len(raw))
        parts, g = ref_step.grads(params, names, image[rows].to(device), mask[rows].to(device),
                                  distmap[rows].to(device), config,
                                  config["recipe"]["losses"], Numerics(numerics))
        out["losses"].append(parts["total_loss"])
        clipped = adam.step(g)
        if k == 0:
            out["grad_norms"] = {n: float(c.norm()) for n, c in zip(names, clipped)}
        del g, clipped
    out["delta_norms"] = {n: float((params[n] - s0).norm()) for n, s0 in zip(names, start)}
    return out


def compare(got: Dict, want: Dict, worst: Optional[Dict[str, list]] = None
            ) -> Dict[str, float]:
    """The numbers the check holds to their limits (program or stand-in
    ``got`` against the reference ``want``). Leaves whose reference
    gradient is under a thousandth of the median leaf's are nought to
    rounding (a bias before a train-mode BatchNorm): neither their
    gradient nor their change is compared. ``worst`` receives each leaf
    comparison's gaps, worst first. ``grad_gap_median`` is the median
    leaf's gradient gap: in bf16 the worst leaf's is the rounding of a
    near-total cancellation (PERF.md, Findings)."""
    g1 = want["grad_norms"]
    median = statistics.median(g1.values())
    moved = [n for n, v in g1.items() if v >= 1e-3 * median]
    gaps = {"grad_norms": leaf_gaps(got["grad_norms"], g1, moved),
            "delta_norms": leaf_gaps(got["delta_norms"], want["delta_norms"], moved)}
    if worst is not None:
        worst.update(gaps)
    return {
        "image_gap": max(float((a - b).abs().max()) for a, b in zip(got["images"], want["images"])),
        "distmap_gap": max(float((a - b).abs().max())
                           for a, b in zip(got["distmaps"], want["distmaps"])),
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
        "grad_gap": gaps["grad_norms"][0][0],
        "grad_gap_median": gaps["grad_norms"][len(gaps["grad_norms"]) // 2][0],
        "update_gap": gaps["delta_norms"][0][0],
    }
