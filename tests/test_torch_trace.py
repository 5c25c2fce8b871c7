"""The port's spans and counters (``deadtrees_tpu_torch/core/trace.py``).

Off (the default), the data path, ``train_step`` and ``predict_scenes``
record nothing and touch no profiler entry point, clock or queue size. On,
the spans nest as the code does and share their batch's or step's key.
Their clock is the one of a kineto trace's host events, and a profiled
fit writes them beside its ``trace.json`` as ``spans.json``. On the CPU:
a b0 EfficientUnet++ with narrow decoder channels at 32², bs 2, over four
tiles written here.
"""

import io
import json
import queue
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from deadtrees_tpu_torch.core import trace
from deadtrees_tpu_torch.core.compile_opts import Program
from deadtrees_tpu_torch.data import pipeline
from deadtrees_tpu_torch.data.shardwriter import ShardWriter
from deadtrees_tpu_torch.infer.sliding import predict_scenes
from deadtrees_tpu_torch.train import Trainer

SIZE = 32
DATA_SPANS = ("data.wait", "data.upload", "data.augment", "data.edt")
TRAIN_SPANS = ("train.forward", "train.backward", "train.update")


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def spans_off():
    """Off and empty around each test: other files in the same process
    may have recorded spans."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _tiff(arr, mode):
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="TIFF")
    return buf.getvalue()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        with ShardWriter(str(d / split / "train-combo-%06d.tar"), maxcount=4) as w:
            for i in range(4):
                mask = np.zeros((SIZE, SIZE), np.uint8)
                mask[4:20, 6:26] = 1 + i % 2
                w.write({"__key__": f"{split}_{i:04d}",
                         "rgbn.tif": _tiff(rng.integers(0, 256, (SIZE, SIZE, 4), np.uint8),
                                           "RGBA"),
                         "mask.tif": _tiff(mask, "L"), "txt": "50.00"})
    (d / "test").mkdir()
    return d


def _config(dataset, **trainer):
    return {
        "data_dir": str(dataset), "seed": 1,
        "datamodule": {"pattern": "train-combo-*.tar", "batch_size": 2},
        "model": {
            "network": {"architecture": "efficientunet++", "encoder_name": "timm-efficientnet-b0",
                        "decoder_channels": [32, 24, 16, 12, 8],
                        "classes": ["background", "conifers", "deciduous"], "in_channels": 4,
                        "losses": ["GDICE", "FOCAL", "BOUNDARY"]},
            "training": {"learning_rate": 1e-3, "cosineannealing_tmax": 10},
        },
        "trainer": {"max_epochs": 1, "min_epochs": 1, "precision": "f32",
                    "limit_train_batches": 1, "limit_val_batches": 1, "devices": 1, **trainer},
        "callbacks": {
            "multistage": {"unfreeze_epoch": 0, "lr_reduce_epoch": None},
            "model_checkpoint": {"monitor": "val/dice", "mode": "max", "dirpath": "checkpoints/"},
            "early_stopping": {"monitor": "val/dice", "patience": 200},
        },
        "logger": {"kind": "csv", "save_dir": "metrics"},
    }


@pytest.fixture(scope="module")
def trainer(dataset, tmp_path_factory):
    t = Trainer(_config(dataset), work_dir=tmp_path_factory.mktemp("run"), device="cpu")
    t._build()
    return t


def _batches_and_steps(trainer, n=2):
    """``n`` batches of the data path, each through one ``train_step``."""
    batches = trainer.datamodule.train_batches(torch.Generator().manual_seed(0), loop=True)
    try:
        for _ in range(n):
            batch = next(batches)
            batch.pop("files")
            batch.pop("lu", None)
            trainer.state, _ = trainer.train_step(trainer.state, batch, 0, frozen=False)
    finally:
        batches.close()


def _scenes():
    model = torch.nn.Conv2d(4, 3, 1).eval()
    rng = np.random.default_rng(1)
    scenes = [rng.integers(0, 256, (64, 64, 4), np.uint8) for _ in range(3)]
    return predict_scenes(model, scenes, tile_shape=(64, 64), subtile=32, batch_size=4,
                          scenes_per_dispatch=1, device="cpu")


def test_off_records_nothing_and_enters_no_profiler(trainer, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("entered while the spans are off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(queue.Queue, "qsize", forbidden)
    no_clock = types.SimpleNamespace(time_ns=forbidden)
    monkeypatch.setattr(pipeline, "time", no_clock)
    monkeypatch.setattr(trace, "time", no_clock)
    assert not trace.ENABLED
    _batches_and_steps(trainer)
    assert len(_scenes()) == 3
    assert trace.snapshot() == {"spans": [], "counters": {}}


def test_on_spans_nest_and_share_their_batch_and_step_keys(trainer):
    step0 = trainer.state.step
    trace.enable()
    with trace.span("outer") as outer:
        _batches_and_steps(trainer, n=2)
    trace.disable()
    spans = trace.snapshot()["spans"]
    by_name = Counter(s.name for s in spans)
    # the producer may have decoded ahead before it was stopped
    assert by_name["data.decode"] >= 2
    assert all(by_name[n] == 2 for n in DATA_SPANS + TRAIN_SPANS), by_name
    training = {s.tid for s in spans if s.name in DATA_SPANS + TRAIN_SPANS}
    (decode_tid,) = {s.tid for s in spans if s.name == "data.decode"}
    assert len(training) == 1 and decode_tid not in training
    for s in spans:
        if s.name in DATA_SPANS + TRAIN_SPANS:
            assert s.parent == outer.id and outer.start <= s.start_ns <= s.end_ns
    for k in range(2):
        batch = [s for s in spans if s.key == k and s.name.startswith("data.")]
        assert sorted(s.name for s in batch if s.name != "data.decode") == sorted(DATA_SPANS)
        assert any(s.name == "data.decode" for s in batch)
        decode = next(s for s in batch if s.name == "data.decode")
        augment = next(s for s in batch if s.name == "data.augment")
        assert decode.end_ns <= augment.start_ns  # decoded before it was augmented
        step = [s.name for s in spans if s.key == step0 + k and s.name.startswith("train.")]
        assert step == list(TRAIN_SPANS)  # recorded as each ends: in order


def test_compile_span_is_a_child_and_counters_sum_and_count(monkeypatch):
    monkeypatch.setenv("DEADTREES_COMPILE_OPTS", "backend=eager")

    def twice_plus_one(x):
        return x * 2 + 1

    program = Program(twice_plus_one, "cpu")
    trace.enable()
    with trace.span("data.augment", key=7) as outer:
        program(torch.ones(3))
    program(torch.ones(3))  # compiled already: no span
    trace.add("data.queue_depth", 2)
    trace.add("data.queue_depth", 1)
    snap = trace.snapshot()
    (compile_,) = [s for s in snap["spans"] if s.name == "program.compile"]
    assert compile_.parent == outer.id and compile_.key.endswith("twice_plus_one")
    assert outer.start <= compile_.start_ns <= compile_.end_ns
    assert snap["counters"] == {"data.queue_depth": (3.0, 2)}
    assert len(program.compiles) == 1


def test_scene_spans_a_dispatch_each():
    trace.enable()
    _scenes()
    spans = trace.snapshot()["spans"]
    for name in ("scenes.stage", "scenes.unpack"):
        assert sorted(s.key for s in spans if s.name == name) == [0, 1, 2]
    stage = {s.key: s for s in spans if s.name == "scenes.stage"}
    unpack = {s.key: s for s in spans if s.name == "scenes.unpack"}
    assert all(stage[k].end_ns <= unpack[k].start_ns for k in range(3))


def test_spans_lie_on_the_clock_of_the_profilers_host_events():
    from torch.autograd.profiler import record_function

    from port_bench.harness.trace import Tracer

    tracer = Tracer(["window"])
    tracer.start()
    trace.enable()
    with record_function("warm"):
        pass
    with record_function("window"):
        with trace.span("inside") as s:
            torch.ones(64).sum()
    trace.disable()
    got = tracer.stop().window
    (span,) = [x for x in trace.snapshot()["spans"] if x.id == s.id]
    assert abs(span.start_ns / 1e3 - got[0]) < 1000 and abs(span.end_ns / 1e3 - got[1]) < 1000


def test_profiler_dir_writes_spans_beside_the_trace(dataset, tmp_path):
    work = tmp_path / "run"
    cfg = _config(dataset, profiler_dir=str(tmp_path / "profile"))
    Trainer(cfg, work_dir=work, device="cpu").fit()
    assert not trace.ENABLED and trace.snapshot()["spans"] == []
    out = Path(cfg["trainer"]["profiler_dir"])
    doc = json.loads((out / "spans.json").read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"train.forward", "data.wait", "data.decode"} <= names
    base = json.loads((out / "trace.json").read_text()).get("baseTimeNanoseconds", 0)
    assert doc["baseTimeNanoseconds"] == base
    assert doc["otherData"]["counters"]["data.queue_depth"]["count"] >= 1


def test_threads_lose_no_count_and_keep_their_own_parents():
    import sys
    import threading

    n_threads, n = 12, 400
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()
    try:
        def work(i):
            for _ in range(n):
                with trace.span("outer", key=i) as outer:
                    trace.add("c", 1)
                    with trace.span("inner", key=i) as inner:
                        assert inner.parent == outer.id

        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = trace.snapshot()
    assert snap["counters"]["c"] == (float(n_threads * n), n_threads * n)
    outers = {s.id: s for s in snap["spans"] if s.name == "outer"}
    inners = [s for s in snap["spans"] if s.name == "inner"]
    assert len(outers) == len(inners) == n_threads * n
    assert all(outers[s.parent].tid == s.tid and outers[s.parent].key == s.key for s in inners)
