"""The device trace of a traced window, kept in memory.

``torch.profiler``'s CUPTI tracing through the autograd profiler's own
entry points: the events come straight from the kineto results, without
the per-event Python objects that ``profile.__exit__`` builds (minutes for
a window of a million events) and without a chrome trace on disk.

Each device event (kernel, copy or memset) carries the benchmark ranges
(``torch.profiler.record_function``) that the main thread was in when
the event was launched, found through the launch's correlation id. The union of busy
intervals is the copy of ``chip_smoke._device_busy_ms``.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceEvent:
    name: str
    kind: str  # "kernel", "H2D", "D2H", "copy" or "memset"
    start_us: float
    end_us: float
    label: Optional[str]  # innermost benchmark range at launch, outermost first joined by "/"

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Trace:
    events: List[DeviceEvent]
    ranges: List[Tuple[str, float, float]]  # benchmark ranges on the main thread, by start
    window: Tuple[float, float]  # the "window" range, us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def in_window(self) -> List[DeviceEvent]:
        a, b = self.window
        return [e for e in self.events if e.end_us > a and e.start_us < b]

    def range_at(self, t_us: float) -> Optional[str]:
        """The benchmark ranges open on the main thread at ``t_us``,
        outermost first, joined by "/"."""
        i = bisect.bisect_right([a for _, a, _ in self.ranges], t_us)
        names = [n for n, a, b in self.ranges[max(0, i - 8):i] if a <= t_us <= b]
        return "/".join(names) if names else None


def _activity(e) -> str:
    """The event's kineto activity; PyTorch before 2.13 has no
    ``activity_type``, and it is then told from the device and the name
    (a range the benchmark opened shows on the device side too)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if not str(e.device_type()).endswith("CPU"):
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    if name.startswith("cuda") or name.startswith("cu"):
        return "cuda_runtime"
    annotation = getattr(e, "is_user_annotation", None)
    return "user_annotation" if annotation is None or annotation() else "cpu_op"


def _kind(activity: str, name: str) -> str:
    if activity == "kernel":
        return "kernel"
    if activity == "gpu_memset":
        return "memset"
    return "H2D" if "HtoD" in name else "D2H" if "DtoH" in name else "copy"


def union_us(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of intervals: a copy overlapping a kernel on
    another stream counts once."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def clip(events: Sequence[DeviceEvent], window: Tuple[float, float]) -> List[Tuple[float, float]]:
    a, b = window
    return [(max(e.start_us, a), min(e.end_us, b)) for e in events
            if e.end_us > a and e.start_us < b]


def idle_gaps(events: Sequence[DeviceEvent], window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The intervals of the window in which the device ran nothing."""
    gaps, t = [], window[0]
    for a, b in sorted(clip(events, window)):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if window[1] > t:
        gaps.append((t, window[1]))
    return gaps


class Tracer:
    """Start and stop the profiler around a window; :meth:`stop` returns
    the :class:`Trace`. Host ranges are those whose names the benchmark
    gave (``names``)."""

    def __init__(self, names: Sequence[str]):
        self.names = set(names)

    def start(self) -> None:
        from torch.autograd.profiler import (
            ProfilerActivity,
            ProfilerConfig,
            ProfilerState,
            _ExperimentalConfig,
            _enable_profiler,
            _prepare_profiler,
        )

        config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                _ExperimentalConfig())
        activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        _prepare_profiler(config, activities)
        _enable_profiler(config, activities)

    def stop(self) -> Trace:
        from torch.autograd.profiler import _disable_profiler

        return self.read(_disable_profiler().events())

    def read(self, kineto_events) -> Trace:
        launches: Dict[int, float] = {}
        ranges: List[Tuple[str, float, float, int]] = []
        device = []
        for e in kineto_events:
            activity = _activity(e)
            if activity in DEVICE_KINDS and e.name() not in self.names:
                device.append((e.name(), _kind(activity, e.name()), e.start_ns() / 1e3,
                               e.end_ns() / 1e3,
                               (e.correlation_id(), e.linked_correlation_id())))
            elif activity in ("cuda_runtime", "cuda_driver"):
                launches[e.correlation_id()] = e.start_ns() / 1e3
            elif activity == "user_annotation" and e.name() in self.names:
                ranges.append((e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                               e.start_thread_id()))
        window = [r for r in ranges if r[0] == "window"]
        if not window:
            raise RuntimeError("the trace holds no 'window' range")
        main = window[0][3]
        host = sorted(((n, a, b) for n, a, b, tid in ranges if tid == main and n != "window"),
                      key=lambda r: r[1])
        starts = [a for _, a, _ in host]
        events = []
        for name, kind, a, b, ids in device:
            label = None
            # the launch: the runtime call of the event's correlation id (or
            # of its linked one) made before the event ran; from any thread
            # (autograd launches the backward pass from a thread of its own),
            # labelled by the ranges the main thread was in at that time
            found = [launches[i] for i in ids if i in launches and launches[i] <= a]
            if found:
                t = found[0]
                i = bisect.bisect_right(starts, t)
                open_ = [n for n, s, e in host[max(0, i - 8):i] if s <= t <= e]
                label = "/".join(open_) if open_ else None
            events.append(DeviceEvent(name, kind, a, b, label))
        return Trace(events, host, (window[0][1], window[0][2]))
