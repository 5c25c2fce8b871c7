"""Fixtures of the benchmark's own tests.

``tiny_root`` is a checkout of the benchmark with two added cells at a
size the CPU holds (``data/``): every file added, none edited. A test
that needs the card carries the repository's ``cuda`` marker and the
``card`` fixture, which decides at run time whether there is one.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_LIMITS = {
    "train.tiny": {"image_gap": 1e-4, "distmap_gap": 1e-3, "loss_gap": 1e-4, "grad_gap": None,
                   "grad_gap_median": 1e-3, "update_gap": 1e-2},
    "scenes.tiny": {"map_gap": 1e-3},
}


def make_root(root: Path) -> Path:
    """A copy of the benchmark with the tiny configuration, traffic mixes
    and limits added as files, and cells and metric entries for them."""
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "configs").symlink_to(REPO / "configs")
    shutil.copytree(DATA / "configs", root / "port_bench" / "configs", dirs_exist_ok=True)
    shutil.copytree(DATA / "traffic", root / "port_bench" / "traffic", dirs_exist_ok=True)
    for cell, limits in TINY_LIMITS.items():
        (root / "port_bench" / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-effunetpp", "source": "https://arxiv.org/abs/2106.11447",
                             "file": "port_bench/configs/tiny-effunetpp.json", "reduced": [],
                             "why": "the tests' size"})
    bench["workloads"] += [
        {"name": "train.tiny", "config": "tiny-effunetpp", "traffic": "tiny-train", "chips": 1,
         "why": "the tests' size"},
        {"name": "scenes.tiny", "config": "tiny-effunetpp", "traffic": "tiny-scenes", "chips": 1,
         "why": "the tests' size"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells = m.get("workloads", [])
        if any(c.startswith("train.") for c in cells):
            cells.append("train.tiny")
        if any(c.startswith("scenes.") for c in cells):
            cells.append("scenes.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2) + "\n")
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the card")
    return torch.device("cuda", 0)
