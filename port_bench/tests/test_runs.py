"""Whole runs at the tests' size on the CPU, with and without a fault
planted under the timed path; the command without a card."""

from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from port_bench import control
from port_bench import run as bench
from port_bench.harness import spec
from port_bench.tests.conftest import REPO, TINY_LIMITS

CPU = torch.device("cpu")


def _run(root, cell, seed=2**31 + 17, seconds=1.0):
    args = SimpleNamespace(workload=cell, seed=seed, seconds=seconds, trace=0)
    return bench.run(args, root=root, device=CPU)


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "train.effunetpp-b5",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 3
    assert "torch.cuda.is_available() is false" in p.stderr
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["train.tiny", "scenes.tiny"])
def test_a_run_is_correct_and_reports_its_metrics(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"], res["checks"]
    compared = {k for k, v in TINY_LIMITS[cell].items() if v is not None}
    assert list(res)[-1] == "checks" and set(res["checks"]) == compared
    want = {m["name"] for m in spec.cell(cell, tiny_root).end_to_end}
    assert set(res["metrics"]) == want and all(v["value"] > 0 for v in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
    json.dumps(res)


def _train_step_fault(kind):
    from deadtrees_tpu_torch.train import trainer

    real = trainer.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def broken(state, batch, epoch, frozen=False):
            if kind == "unchanged":
                return state, {"total_loss": torch.tensor(1.0)}
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(state, half, epoch, frozen)

        broken.programs = step.programs
        return broken

    return trainer, "make_train_step", make


def _augment_fault():
    from deadtrees_tpu_torch.data import pipeline

    real = pipeline.augment_batch

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        out["image"][0, 0, 0, 0] += 1.0
        return out

    return pipeline, "augment_batch", altered


def _scene_fault(kind):
    from deadtrees_tpu_torch.infer import sliding

    real = sliding.make_scene_predictor

    def make(*args, **kwargs):
        predict = real(*args, **kwargs)

        def broken(scene, valid):
            out = predict(scene, valid).clone()
            if kind == "altered":
                out[0, :2, :2] ^= 0b01010101
            else:  # the second half of every scene's map left out
                out[:, out.shape[1] // 2:] = 0
            return out

        broken.program = predict.program
        return broken

    return sliding, "make_scene_predictor", make


@pytest.mark.parametrize("cell,fault", [
    ("train.tiny", lambda: _train_step_fault("unchanged")),
    ("train.tiny", lambda: _train_step_fault("half")),
    ("train.tiny", _augment_fault),
    ("scenes.tiny", lambda: _scene_fault("altered")),
    ("scenes.tiny", lambda: _scene_fault("half")),
], ids=["step-unchanged", "half-batch", "altered-image", "altered-map", "half-map"])
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(tiny_root, monkeypatch, cell, fault):
    module, name, broken = fault()
    monkeypatch.setattr(module, name, broken)
    res = _run(tiny_root, cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["train.tiny", "scenes.tiny"])
def test_the_control_and_each_fault_fail_a_limit(tiny_root, cell):
    got = control.readings(spec.cell(cell, tiny_root), 2**31 + 5, CPU)
    limits = {k: v for k, v in TINY_LIMITS[cell].items() if v is not None}
    for name, numbers in [("control", got["control"]), *got["faults"].items()]:
        assert any(numbers[k] > limits[k] for k in limits), (name, numbers)


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_every_per_layer_metric(tiny_root, card):
    # the tiny cell's limits are the CPU's float32 ones; on the card the
    # program's float32 convolutions run in TF32, so only the trace is held
    args = SimpleNamespace(workload="train.tiny", seed=3, seconds=2.0, trace=1)
    res = bench.run(args, root=tiny_root, device=card)
    assert res["checks"] and res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["busy_s"] > 0 and res["breakdown"]["device_ops"]
    assert {"idle_pct.train", "step_device_ms.train", "edt_ms.train"} <= set(res["metrics"])
