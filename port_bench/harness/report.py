"""The result line's ``device`` and ``breakdown``."""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Dict, Optional

from port_bench.harness.trace import Trace, clip, idle_gaps, union_us

TOP = 10


def device_info(device, count: int, peak: int, trace: Optional[Trace]) -> Dict[str, Any]:
    import torch

    cuda = device.type == "cuda"
    out: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": count,
        "memory_peak_bytes": int(peak),
    }
    if trace is not None:
        out["busy_s"] = union_us(clip(trace.events, trace.window)) / 1e6
        out["window_s"] = trace.window_s
    return out


def breakdown(trace: Trace) -> Dict[str, list]:
    """The device operations that took most time in the window, by name,
    and the longest idle gaps, each by the benchmark range the host was in
    when the gap began."""
    ops: Dict[str, float] = defaultdict(float)
    for e in trace.in_window():
        ops[e.name[:160]] += e.dur_us / 1e6
    gaps = sorted(idle_gaps(trace.events, trace.window), key=lambda g: g[0] - g[1])[:TOP]
    return {
        "device_ops": [[n, s] for n, s in sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[trace.range_at(a) or "outside any range", (b - a) / 1e6]
                      for a, b in gaps],
    }


def round_trip(obj):
    """Non-finite numbers as null: the line stays JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: round_trip(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [round_trip(v) for v in obj]
    return obj
