"""What a run hands its metric readers and its output check.

The readers (``port_bench/metrics/*.py``) see a :class:`Record`: the
window's length and counters, the host spans the benchmark took around
its calls into the program, the set-up's parts, facts of the cell (work
a step or a tile, the kernel shapes) and, in a traced run, the
:class:`~port_bench.harness.trace.Trace`.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from port_bench.harness.trace import Trace


@dataclasses.dataclass
class Record:
    cell: str
    window_s: float
    setup_s: float
    counters: Dict[str, float]
    spans: Dict[str, List[Tuple[float, float]]]
    setup: Dict[str, float]
    facts: Dict[str, Any]
    trace: Optional[Trace] = None

    def span_s(self, name: str) -> float:
        return sum(b - a for a, b in self.spans.get(name, []))


@dataclasses.dataclass
class Check:
    """One number compared with the reference, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def checks(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> List[Check]:
    """A :class:`Check` of each number whose limit is set; a limit of null
    marks a number that is read and printed but not compared (it has no
    reading that a fault or the control would give above the program's)."""
    for name, value in numbers.items():
        if limits.get(name) is None:
            print(f"not compared: {name} {value!r}", file=sys.stderr, flush=True)
    return [Check(k, v, float(limits[k])) for k, v in numbers.items()
            if limits.get(k) is not None]


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep: Optional[Sequence[str]] = None) -> List[Tuple[float, str]]:
    """Each leaf's gap between two norms, ``|got − want|``, over the larger
    of the reference's norm of that leaf and of the median leaf; worst
    first. ``keep`` names the leaves compared (all of ``want``'s)."""
    names = list(want) if keep is None else list(keep)
    if set(got) != set(want):
        raise ValueError(f"the leaves differ: {sorted(set(got) ^ set(want))[:8]}")
    median = statistics.median(want[n] for n in names)
    return sorted(((abs(got[n] - want[n]) / max(want[n], median), n) for n in names),
                  reverse=True)
