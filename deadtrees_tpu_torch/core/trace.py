"""Spans and counters of the port's own host work, off unless asked for.

A span is a named stretch of host time on one thread: ``with
span("data.edt", key=seq):`` around the work, or :func:`record` after the
fact with a known start and end. Each holds its name, the thread's native
id (the id a ``torch.profiler`` trace gives the thread), the innermost
span open on that thread when it began (its parent), its start and end,
and a ``key`` that ties the spans of one unit of work together: a batch's
sequence number from its producer, a train step's ``state.step``, a
scene dispatch's index. :func:`add` is a counter: a sum and a count.

Off by default. Off, each call site costs one test of :data:`ENABLED`:
nothing is allocated, no clock is read and no profiler entry point is
entered (:func:`span` returns one shared no-op context). On, spans go to
a bounded in-memory buffer (the oldest drop first) and nothing is written
until a caller asks: :func:`snapshot` returns them with the counters,
:func:`write_chrome` writes them as a chrome trace. The record does not
go through ``torch.profiler.record_function``: the profiler sees no range
opened on a thread that did not start it, such as a data producer's.

Timestamps are ``time.time_ns()``, Unix-epoch nanoseconds: the clock of a
``torch.profiler`` (kineto) trace's host events, so the spans lie on the
device trace's timeline without a profiler session of their own.

The port's spans are named where they are placed: ``data.*`` in
``data/pipeline.py``, ``train.*`` in ``train/steps.py``, ``scenes.*`` in
``infer/sliding.py``, ``program.compile`` in ``core/compile_opts.py``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import re
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

ENABLED = False
CAPACITY = 1 << 20  # spans kept; the oldest drop first

_spans: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_counters: Dict[str, List[float]] = {}
_lock = threading.Lock()
_ids = itertools.count()


class _Open(threading.local):
    def __init__(self):
        self.stack: List[int] = []  # ids of the spans open on this thread


_open = _Open()
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    id: int
    name: str
    tid: int
    parent: Optional[int]  # the id of the innermost span open on the thread at the start
    start_ns: int
    end_ns: int
    key: Any


class _Timed:
    __slots__ = ("name", "key", "id", "parent", "start")

    def __init__(self, name: str, key: Any):
        self.name, self.key = name, key

    def __enter__(self) -> "_Timed":
        stack = _open.stack
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        _open.stack.pop()
        _spans.append(Span(self.id, self.name, threading.get_native_id(), self.parent,
                           self.start, end, self.key))
        return False


def span(name: str, key: Any = None):
    """A context that records the block as span ``name``; a shared no-op
    while the spans are off."""
    return _Timed(name, key) if ENABLED else _OFF


def record(name: str, start_ns: int, end_ns: int, key: Any = None) -> None:
    """Record a span whose start and end (``time.time_ns()``) are known;
    its parent is the innermost span open on this thread now. Callers test
    :data:`ENABLED` before they read a clock for it."""
    if not ENABLED:
        return
    stack = _open.stack
    _spans.append(Span(next(_ids), name, threading.get_native_id(),
                       stack[-1] if stack else None, start_ns, end_ns, key))


def add(name: str, value: float) -> None:
    """Add ``value`` to counter ``name`` (its sum, and one to its count)."""
    if not ENABLED:
        return
    with _lock:
        c = _counters.setdefault(name, [0.0, 0])
        c[0] += value
        c[1] += 1


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def reset() -> None:
    """Drop every span and counter kept so far."""
    with _lock:
        _spans.clear()
        _counters.clear()


def snapshot() -> Dict[str, Any]:
    """``{"spans": [Span, ...], "counters": {name: (sum, count)}}``."""
    with _lock:
        return {"spans": list(_spans),
                "counters": {k: (v[0], int(v[1])) for k, v in _counters.items()}}


def trace_base_ns(trace_json: Union[str, Path]) -> int:
    """``baseTimeNanoseconds`` from the head of a ``torch.profiler`` chrome
    trace (its events' ``ts`` count from it); 0 when it has none."""
    with open(trace_json, "rb") as f:
        head = f.read(1 << 16).decode("utf-8", "replace")
    m = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    return int(m.group(1)) if m else 0


def write_chrome(path: Union[str, Path], spans: List[Span],
                 counters: Optional[Dict[str, Tuple[float, int]]] = None,
                 base_ns: int = 0) -> None:
    """``spans`` as complete ("X") events of a chrome trace, ``ts`` in µs
    from ``base_ns`` (a profiler trace's :func:`trace_base_ns` puts both
    files on one clock); ``counters`` under ``otherData``."""
    pid = os.getpid()
    events = [{"ph": "X", "cat": "port", "name": s.name, "pid": pid, "tid": s.tid,
               "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"key": s.key, "id": s.id, "parent": s.parent}} for s in spans]
    doc = {"displayTimeUnit": "ms", "baseTimeNanoseconds": base_ns, "traceEvents": events,
           "otherData": {"counters": {k: {"sum": v[0], "count": v[1]}
                                      for k, v in (counters or {}).items()}}}
    Path(path).write_text(json.dumps(doc, default=str))
