"""Execution timer (reference deadtrees/utils/timer.py:5-8)."""

from __future__ import annotations

import time
from contextlib import contextmanager


@contextmanager
def record_execution_time():
    """Yields a lambda returning elapsed seconds so far (and after exit)."""
    start = time.perf_counter()
    end: list = []
    try:
        yield lambda: (end[0] if end else time.perf_counter()) - start
    finally:
        end.append(time.perf_counter())
