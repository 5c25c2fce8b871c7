"""The harness finds every part of a cell by its name in BENCHMARK.json."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from port_bench.harness import spec
from port_bench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves_with_a_reader_for_each_metric():
    bench = spec.benchmark(REPO)
    per_cell = {}
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], REPO)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"], REPO))
        per_cell[w["name"]] = ({m["name"] for m in cell.end_to_end},
                               {m["name"] for m in cell.per_layer})
    assert per_cell["train.effunetpp-b5"][0] == {"setup_s", "train_samples_per_s"}
    assert per_cell["scenes.effunetpp-b5"][0] == {"setup_s", "scene_tiles_per_s"}
    assert len(per_cell["train.unet-r34"][1]) == 6
    assert per_cell["scenes.effunetpp-b5"][1] == {"copy_ms.scenes", "forward_ms.scenes",
                                                   "mfu.scenes", "idle_pct.scenes"}


def test_benchmark_file_keeps_to_its_shape():
    bench = spec.benchmark(REPO)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").read_text().endswith("}\n")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert c["file"].startswith("port_bench/") and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in moves and set(m) <= {"name", "unit", "better", "source", "layer",
                                                  "moves", "workloads"}
    assert 1 <= bench["run_seconds"] <= 51


def test_cells_configurations_traffic_and_metrics_added_as_files_are_found(tiny_root, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root, symlinks=True)
    cell = spec.cell("train.tiny", root)
    assert cell.config["encoder"]["name"] == "timm-efficientnet-b0"
    assert cell.traffic["tile"] == 64 and cell.limits["loss_gap"] == 1e-4
    assert "mfu.train" in {m["name"] for m in cell.per_layer}

    # a further per-layer metric: a reader file and an entry, nothing edited
    (root / "port_bench" / "metrics" / "steps_counted.train.py").write_text(
        "def read(record):\n    return float(record.counters['steps'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_counted.train", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "model step", "moves": "train_samples_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("train.tiny", root)
    assert "steps_counted.train" in {m["name"] for m in cell.per_layer}
    assert "steps_counted.train" not in {m["name"] for m in spec.cell("scenes.tiny", root).per_layer}

    class Rec:
        counters = {"steps": 7}

    assert spec.reader("steps_counted.train", root)(Rec()) == 7.0


@pytest.mark.parametrize("missing", ["workload", "traffic", "limits", "reader"])
def test_a_missing_part_is_named(tiny_root, tmp_path, missing):
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root, symlinks=True)
    if missing == "traffic":
        (root / "port_bench" / "traffic" / "tiny-train.json").unlink()
    if missing == "limits":
        (root / "port_bench" / "limits" / "train.tiny.json").unlink()
    with pytest.raises(spec.SpecError):
        if missing == "reader":
            spec.reader("no_such_metric", root)
        else:
            spec.cell("train.none" if missing == "workload" else "train.tiny", root)
