"""The per-layer metrics read from the port's own spans and counters
(``harness/program_spans.py``): their entries, each reader on a hand-built
record, the traced window's switch, whole traced runs, and a port without
the spans."""

from __future__ import annotations

import re
from types import SimpleNamespace

import pytest
import torch

from port_bench import run as bench
from port_bench.harness import program_spans, spec
from port_bench.harness.record import Record
from port_bench.harness.trace import DeviceEvent, Trace, Tracer
from port_bench.tests.conftest import REPO

trace = pytest.importorskip("deadtrees_tpu_torch.core.trace")

TRAIN = {"queue_wait_ms.train", "decode_ms.train", "queue_depth.train",
         "augment_host_ms.train", "edt_host_ms.train", "step_host_ms.train",
         "idle_data_pct.train", "idle_step_pct.train"}
SCENES = {"stage_ms.scenes", "unpack_ms.scenes", "idle_host_pct.scenes"}
DEVICE = {"idle_data_pct.train", "idle_step_pct.train", "idle_host_pct.scenes"}
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

W0 = 1_790_000_000_000_000  # µs since the epoch
MS = 1000  # µs


@pytest.fixture(autouse=True)
def spans_off_after():
    yield
    trace.disable()
    trace.reset()


def test_the_entries_name_their_cells_and_keep_to_the_shape():
    bench_ = spec.benchmark(REPO)
    entries = {m["name"]: m for m in bench_["per_layer"]}
    layers = {m["layer"] for m in bench_["per_layer"][:10]}
    for name in TRAIN | SCENES:
        m = entries[name]
        assert m["layer"] in layers and UNIT.match(m["unit"])
        assert m["source"] == ("device_trace" if name in DEVICE else
                               "program_counter" if name == "queue_depth.train" else
                               "program_span")
        assert m["moves"] == ("scene_tiles_per_s" if name in SCENES else "train_samples_per_s")
    names = [m["name"] for m in bench_["per_layer"]]
    assert names[10:] == [n for n in names if n in TRAIN | SCENES]  # appended, in order
    for w in ("train.effunetpp-b5", "train.unet-r34"):
        got = {m["name"] for m in spec.cell(w, REPO).per_layer}
        assert TRAIN <= got and not SCENES & got
    got = {m["name"] for m in spec.cell("scenes.effunetpp-b5", REPO).per_layer}
    assert SCENES <= got and not TRAIN & got


def _record(spans, counters=(), cell="train.x", per=None):
    """A traced window of 1 s: the device busy over [0, 300) and [500, 800)
    ms, idle over [300, 500) and [800, 1000); ``spans`` in the port."""
    trace.reset()
    trace.enable()
    for name, a, b in spans:
        trace.record(name, (W0 + a * MS) * 1000, (W0 + b * MS) * 1000)
    for name, v in counters:
        trace.add(name, v)
    trace.disable()
    events = [DeviceEvent("k", "kernel", W0, W0 + 300 * MS, "step"),
              DeviceEvent("k", "kernel", W0 + 500 * MS, W0 + 800 * MS, "batch/edt")]
    return Record(cell=cell, window_s=1.0, setup_s=0.0, counters=per or {"steps": 2},
                  spans={}, setup={}, facts={},
                  trace=Trace(events, [], (float(W0), float(W0 + 1000 * MS))))


def _read(name, record):
    return spec.reader(name, REPO)(record)


def test_each_train_reader_on_a_hand_built_record():
    rec = _record([
        ("data.wait", -100, 50),  # began before the window: not counted
        ("data.wait", 250, 400),  # 100 ms of it in an idle gap
        ("data.augment", 320, 350),  # inside the wait's idle time: counted once
        ("data.edt", 450, 600),  # 50 ms idle
        ("data.decode", 100, 110), ("data.decode", 200, 220),
        ("train.forward", 850, 900),  # all three in the last idle gap
        ("train.backward", 900, 910), ("train.update", 910, 930),
        ("data.wait", 1000, 1100),  # began at the window's end: not counted
    ], counters=[("data.queue_depth", 2), ("data.queue_depth", 1), ("data.queue_depth", 0)])
    want = {"queue_wait_ms.train": 75.0, "augment_host_ms.train": 15.0,
            "edt_host_ms.train": 75.0, "decode_ms.train": 15.0, "queue_depth.train": 1.0,
            "step_host_ms.train": 40.0, "idle_data_pct.train": 15.0,
            "idle_step_pct.train": 8.0}
    for name, value in want.items():
        assert _read(name, rec) == pytest.approx(value, abs=1e-4), name  # µs floats near 2e15


def test_each_scene_reader_on_a_hand_built_record():
    rec = _record([("scenes.stage", 280, 320), ("scenes.unpack", 790, 820),
                   ("scenes.stage", 100, 120), ("scenes.unpack", 480, 500)],
                  per={"dispatches": 2})
    assert _read("stage_ms.scenes", rec) == pytest.approx(30.0)
    assert _read("unpack_ms.scenes", rec) == pytest.approx(25.0)
    # [300, 320) + [800, 820) + [480, 500)
    assert _read("idle_host_pct.scenes", rec) == pytest.approx(6.0, abs=1e-4)


def test_idle_within_spans_against_a_brute_force_count():
    import random

    rng = random.Random(5)
    for _ in range(100):
        busy = sorted((a, a + rng.randint(0, 90)) for a in (rng.randint(-50, 950)
                                                              for _ in range(6)))
        spans = [(a, a + rng.randint(0, 90)) for a in (rng.randint(0, 990) for _ in range(6))]
        rec = _record([("data.edt", a, b) for a, b in spans])
        rec.trace.events = [DeviceEvent("k", "kernel", W0 + a * MS, W0 + b * MS, None)
                            for a, b in busy]
        idle_in = sum(1 for t in range(1000)
                      if any(a <= t < b for a, b in spans)
                      and not any(a <= t < b for a, b in busy))
        got = _read("idle_data_pct.train", rec)
        if not any(b > 0 and a < 1000 for a, b in busy):
            assert got is None
        else:
            assert got == pytest.approx(idle_in / 10, abs=1e-3)  # µs floats near 2e15


def test_without_the_ports_spans_every_reader_reads_nothing(monkeypatch):
    rec = _record([("data.wait", 250, 400), ("scenes.stage", 280, 320)],
                  per={"steps": 2, "dispatches": 2})
    monkeypatch.setattr(program_spans, "program", None)
    for name in TRAIN | SCENES:
        assert _read(name, rec) is None, name
    untraced = Record(cell="x", window_s=1.0, setup_s=0.0, counters={"steps": 2}, spans={},
                      setup={}, facts={})
    monkeypatch.undo()
    for name in TRAIN | SCENES:
        assert _read(name, untraced) is None, name


def test_a_tracer_turns_the_ports_spans_on_for_its_window_only():
    from torch.autograd.profiler import record_function

    trace.enable()
    with trace.span("before"):
        pass
    trace.disable()
    tracer = Tracer(["window"])
    tracer.start()
    assert trace.ENABLED and trace.snapshot()["spans"] == []
    with record_function("window"):
        with trace.span("inside"):
            pass
    tracer.stop()
    assert not trace.ENABLED
    assert [s.name for s in trace.snapshot()["spans"]] == ["inside"]


@pytest.mark.parametrize("cell", ["train.tiny", "scenes.tiny"])
def test_a_traced_run_on_the_cpu_reads_the_host_spans(tiny_root, cell):
    args = SimpleNamespace(workload=cell, seed=2**31 + 29, seconds=1.0, trace=1)
    res = bench.run(args, root=tiny_root, device=torch.device("cpu"))
    assert res["correct"], res["checks"]
    want = (TRAIN if cell.startswith("train") else SCENES) - DEVICE  # no device events here
    assert want <= set(res["metrics"]) and not DEVICE & set(res["metrics"])
    assert all(res["metrics"][n]["value"] >= 0 for n in want)
    assert not trace.ENABLED


def test_an_untraced_run_records_no_span(tiny_root):
    args = SimpleNamespace(workload="train.tiny", seed=7, seconds=1.0, trace=0)
    res = bench.run(args, root=tiny_root, device=torch.device("cpu"))
    assert not TRAIN & set(res["metrics"]) and trace.snapshot()["spans"] == []


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["train.tiny", "scenes.tiny"])
def test_a_traced_run_on_the_card_reads_every_new_metric(tiny_root, card, cell):
    args = SimpleNamespace(workload=cell, seed=3, seconds=2.0, trace=1)
    res = bench.run(args, root=tiny_root, device=card)
    assert res["attempted"] > 0 and res["failed"] == 0
    want = TRAIN if cell.startswith("train") else SCENES
    assert want <= set(res["metrics"]), want - set(res["metrics"])
    idle = "idle_pct.train" if cell.startswith("train") else "idle_pct.scenes"
    split = sum(res["metrics"][n]["value"] for n in want & DEVICE)
    assert 0 <= split <= res["metrics"][idle]["value"] + 1e-6
