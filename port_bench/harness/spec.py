"""What a cell is made of, found by the names in ``BENCHMARK.json``.

- a configuration: the JSON file that ``configs[].file`` names;
- a traffic mix: ``port_bench/traffic/<traffic>.json``, whose ``kind``
  names the code that runs it, ``port_bench/kinds/<kind>.py``;
- the limits of its output check: ``port_bench/limits/<cell>.json``;
- each metric: a reader ``port_bench/metrics/<metric>.py`` with
  ``read(record) -> float or None``.

A cell reports the end-to-end metrics that list it under ``workloads``,
or that have no such key; and the per-layer metrics that list it, or that
have no such key and move one of its end-to-end metrics. Adding a cell,
a configuration, a traffic mix or a metric adds files and entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parents[1]


class SpecError(ValueError):
    """The benchmark's files do not describe the cell asked for."""


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    chips: int
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    here = root / HERE.name
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json; there are "
                        f"{[w['name'] for w in bench['workloads']]}")
    w = work[0]
    entry = [c for c in bench["configs"] if c["name"] == w["config"]]
    if not entry:
        raise SpecError(f"workload {name!r} names configuration {w['config']!r}, "
                        "which BENCHMARK.json does not list")
    config = _json(root / entry[0]["file"])
    traffic = _json(here / "traffic" / f"{w['traffic']}.json")
    if not (here / "kinds" / f"{traffic['kind']}.py").is_file():
        raise SpecError(f"traffic {w['traffic']!r} is of kind {traffic['kind']!r}, "
                        "for which port_bench/kinds holds no file")
    limits = _json(here / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]
    return Cell(name, config, traffic, int(w["chips"]), limits, e2e, per_layer)


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of ``port_bench/metrics/<metric>.py``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise SpecError(f"metric {metric!r} has no reader at {path}")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
