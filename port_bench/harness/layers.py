"""Arithmetic the metric readers share: device time by launching range."""

from __future__ import annotations

from typing import Callable, Optional

from port_bench.harness.record import Record
from port_bench.harness.trace import DeviceEvent, clip, union_us


def busy_s(record: Record, keep: Callable[[DeviceEvent], bool]) -> Optional[float]:
    """Union of the window's device intervals of the events ``keep``
    selects, in seconds; None without a trace or without such events."""
    if record.trace is None:
        return None
    events = [e for e in record.trace.in_window() if keep(e)]
    if not events:
        return None
    return union_us(clip(events, record.trace.window)) / 1e6


def launched_in(name: str) -> Callable[[DeviceEvent], bool]:
    """Kernels (not copies) launched inside the benchmark range ``name``."""
    return lambda e: e.kind == "kernel" and e.label is not None and name in e.label.split("/")


def idle_pct(record: Record) -> Optional[float]:
    busy = busy_s(record, lambda e: True)
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / record.trace.window_s)
