"""The port's own spans and counters in a traced run.

The port records named stretches of host time on each thread, and
counters, in ``deadtrees_tpu_torch/core/trace.py``: off unless enabled,
on the Unix-epoch clock of the device trace's host events. The kinds do
not turn them on; the readers of the per-layer metrics that read them
load this module, and loading it makes every
:class:`~port_bench.harness.trace.Tracer` clear the port's spans and
counters and turn them on as it starts the profiler, and off as it stops
it. What the port holds afterwards is the traced window's, and an
untraced run records nothing.

A span counts when it begins inside the window (the trace's ``window``
range). Where the port has no such module (an older checkout), every
function here returns None.
"""

from __future__ import annotations

from typing import Optional, Sequence

from port_bench.harness.record import Record
from port_bench.harness.trace import Tracer, clip, union_us

try:
    from deadtrees_tpu_torch.core import trace as program
except ImportError:
    program = None

# the data path's spans on the thread that calls next() (data.decode runs
# on the producer's thread), and train_step's
DATA = ("data.wait", "data.upload", "data.augment", "data.edt")
STEP = ("train.forward", "train.backward", "train.update")
SCENES_HOST = ("scenes.stage", "scenes.unpack")


def _hook() -> None:
    if program is None or getattr(Tracer, "port_spans", False):
        return
    start, stop = Tracer.start, Tracer.stop

    def start_spans(self) -> None:
        start(self)
        program.reset()
        program.enable()

    def stop_spans(self):
        program.disable()
        return stop(self)

    Tracer.start, Tracer.stop, Tracer.port_spans = start_spans, stop_spans, True


_hook()


def spans_in(record: Record, names: Sequence[str]) -> Optional[list]:
    """The port's spans named ``names`` that began in the traced window;
    None without a trace, the port's module or such a span."""
    if program is None or record.trace is None:
        return None
    a, b = (t * 1e3 for t in record.trace.window)
    out = [s for s in program.snapshot()["spans"] if s.name in names and a <= s.start_ns < b]
    return out or None


def _ms(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6


def ms_a(record: Record, names: Sequence[str], per: str) -> Optional[float]:
    """Host ms of the spans ``names`` over the record's counter ``per``."""
    spans = spans_in(record, names)
    n = record.counters.get(per)
    return None if spans is None or not n else _ms(spans) / n


def mean_ms(record: Record, name: str) -> Optional[float]:
    spans = spans_in(record, (name,))
    return None if spans is None else _ms(spans) / len(spans)


def counter_mean(record: Record, name: str) -> Optional[float]:
    """The window's sum of the port's counter ``name`` over its count."""
    if program is None or record.trace is None:
        return None
    total, count = program.snapshot()["counters"].get(name, (0.0, 0))
    return total / count if count else None


def idle_within_pct(record: Record, names: Sequence[str]) -> Optional[float]:
    """Share of the traced window in which the device ran nothing while
    the host was inside one of the spans ``names`` (the spans less the
    device's busy intervals); None without device events in the window."""
    spans = spans_in(record, names)
    if spans is None or not record.trace.in_window():
        return None
    window = record.trace.window
    busy = clip(record.trace.events, window)
    inside = [(s.start_ns / 1e3, min(s.end_ns / 1e3, window[1])) for s in spans]
    return 100.0 * (union_us(busy + inside) - union_us(busy)) / (window[1] - window[0])
