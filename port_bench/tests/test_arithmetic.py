"""The yardstick's arithmetic against hand counts."""

from __future__ import annotations

import json

import pytest

import torch

from port_bench.harness import flops, peaks, record, trace
from port_bench.harness.layers import busy_s, idle_pct, launched_in
from port_bench.kinds import scenes, train
from port_bench.reference import model as ref_model
from port_bench.tests.conftest import REPO

R34 = json.loads((REPO / "port_bench" / "configs" / "unet-r34.json").read_text())


def _resolution(name: str, tile: int) -> int:
    """The output side of each convolution of the Unet on ResNet-34."""
    parts = name.split(".")
    if parts[0] == "segmentation_head":
        return tile
    if parts[0] == "decoder":
        return tile >> (4 - int(parts[2]))
    if parts[1] == "conv1":
        return tile // 2
    return tile >> (int(parts[1][len("layer"):]) + 1)


def test_flops_equal_a_hand_count_of_the_convolutions():
    tile = 64
    per_conv = {l.name: 2 * l.shape[0] * l.shape[1] * l.shape[2] * l.shape[3]
                * _resolution(l.name, tile) ** 2
                for l in ref_model.leaves(R34) if l.kind == "weight"}
    forward = sum(per_conv.values())
    traffic = {"tile": tile, "subtile": tile}
    assert scenes._flops_per_tile(R34, traffic) == forward
    # backward: the gradients of every input and weight, but not of the image
    assert train._flops_per_sample(R34, traffic) == 3 * forward - per_conv["encoder.conv1.weight"]


def test_a_depthwise_convolution_counts_its_groups():
    x = torch.empty((2, 8, 16, 16), device="meta")
    w = torch.empty((8, 1, 3, 3), device="meta")
    ops = flops.forward_flops(lambda: torch.nn.functional.conv2d(x, w, padding=1, groups=8))
    assert ops == [2 * 2 * 8 * 16 * 16 * 9]


def test_kernel4_bound_is_its_bytes_at_a_small_shape():
    n = 2 * 8 * 8 * 4
    assert peaks.augment_bound_s((2, 8, 8, 4)) == pytest.approx((n + 16 + 4 * n) / 3.35e12)


def _event(a, b, kind="kernel", label=None, name="k"):
    return trace.DeviceEvent(name, kind, a, b, label)


def test_busy_union_idle_share_and_gaps():
    events = [_event(0, 10, label="step"), _event(5, 15, "H2D"), _event(20, 30, label="batch/edt"),
              _event(35, 60, label="step")]
    tr = trace.Trace(events, [("batch", 16, 31), ("step", 31, 50)], (0, 40))
    assert trace.union_us(trace.clip(events, tr.window)) == 30
    assert trace.idle_gaps(events, tr.window) == [(15, 20), (30, 35)]
    rec = record.Record("c", 40e-6, 0.0, {"steps": 2}, {}, {}, {}, tr)
    assert idle_pct(rec) == pytest.approx(25.0)
    assert busy_s(rec, launched_in("edt")) == pytest.approx(10e-6)
    assert busy_s(rec, launched_in("step")) == pytest.approx(15e-6)
    assert tr.range_at(18) == "batch"


class _Kineto:
    def __init__(self, name, activity, start, end, corr=0, tid=1, linked=0):
        self._v = (name, activity, start, end, corr, tid, linked)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


class _Kineto211(_Kineto):
    """An event of PyTorch before 2.13: no activity type, a device type."""

    activity_type = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._dev = "DeviceType.CPU" if self._v[1] in ("user_annotation", "cuda_runtime",
                                                       "cpu_op") else "DeviceType.CUDA"

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._v[1] == "user_annotation"


del _Kineto211.activity_type


@pytest.mark.parametrize("kind", [_Kineto, _Kineto211], ids=["torch-2.13", "torch-2.11"])
def test_kernels_carry_the_range_they_were_launched_in(kind):
    _Kineto = kind  # noqa: N806
    events = [
        _Kineto("window", "user_annotation", 0, 100_000),
        _Kineto("batch", "user_annotation", 1_000, 20_000),
        _Kineto("edt", "user_annotation", 5_000, 15_000),
        _Kineto("step", "user_annotation", 20_000, 90_000),
        _Kineto("cudaLaunchKernel", "cuda_runtime", 6_000, 7_000, corr=11),
        _Kineto("cudaLaunchKernel", "cuda_runtime", 30_000, 31_000, corr=12),
        _Kineto("cudaMemcpyAsync", "cuda_runtime", 2_000, 3_000, corr=13),
        _Kineto("cudaLaunchKernel", "cuda_runtime", 40_000, 41_000, corr=14, tid=2),
        _Kineto("cudaLaunchKernel", "cuda_runtime", 95_000, 96_000, corr=15),
        _Kineto("edt_kernel", "kernel", 8_000, 9_000, linked=11),
        _Kineto("conv_kernel", "kernel", 32_000, 60_000, linked=12),
        _Kineto("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 3_000, 4_000, linked=13),
        _Kineto("backward", "kernel", 61_000, 62_000, corr=14, linked=3),
        _Kineto("unlaunched", "kernel", 63_000, 64_000, corr=15),
        _Kineto("step", "gpu_user_annotation", 20_000, 90_000),
    ]
    tr = trace.Tracer(("window", "batch", "step", "edt")).read(events)
    got = {e.name: (e.kind, e.label) for e in tr.events}
    assert got["edt_kernel"] == ("kernel", "batch/edt")
    assert got["conv_kernel"] == ("kernel", "step")
    assert got["Memcpy HtoD (Pinned -> Device)"] == ("H2D", "batch")
    assert got["backward"] == ("kernel", "step")  # launched by another thread
    assert got["unlaunched"] == ("kernel", None)  # its launch id comes after it
    assert tr.window == (0.0, 100.0) and "step" not in got
