"""Launch counts of the port's CUDA kernels.

One count per kernel, raised by its wrapper where it launches the kernel
and nowhere else, so a run can show that its path went through the
kernels: set the counts to 0 with :func:`reset_launch_counts`, drive the
path, read :data:`LAUNCHES`.

A count advances where the kernel's custom op runs its implementation, in
Python or, for train-mode BatchNorm's kernels, in C++ (a counter of its
library, bound here by name when the library loads): at every eager call,
and inside a compiled program at its warm-up and at its CUDA-graph
capture, but not at a graph replay, which launches the recorded kernels
without running the implementation. A replay's launches are read by
kernel name from a profiler trace (``chip_smoke.py`` phase 15).
"""

from __future__ import annotations

import ctypes
from collections.abc import MutableMapping
from typing import Dict, Iterator


class Launches(MutableMapping):
    """The counts by kernel name: a fixed set of names, each counted here
    or, once :meth:`bind` gave it one, in a native library's counter."""

    def __init__(self, counts: Dict[str, int]):
        self._counts = dict(counts)
        self._bound: Dict[str, ctypes.c_longlong] = {}

    def bind(self, name: str, counter: ctypes.c_longlong) -> None:
        """Count ``name`` in ``counter`` from now on, starting from its
        count here."""
        counter.value = self._counts[name]
        self._bound[name] = counter

    def __getitem__(self, name: str) -> int:
        counter = self._bound.get(name)
        return self._counts[name] if counter is None else counter.value

    def __setitem__(self, name: str, value: int) -> None:
        if name not in self._counts:
            raise KeyError(name)
        counter = self._bound.get(name)
        if counter is None:
            self._counts[name] = value
        else:
            counter.value = value

    def __delitem__(self, name: str) -> None:
        raise TypeError("a kernel's count cannot be removed")

    def __iter__(self) -> Iterator[str]:
        return iter(self._counts)

    def __len__(self) -> int:
        return len(self._counts)

    def __repr__(self) -> str:
        return repr(dict(self))


LAUNCHES = Launches({
    "fused_ir_chw_pass1": 0,  # ops/fused_mbconv.py
    "fused_ir_chw_pass2": 0,  # ops/fused_mbconv.py
    "fused_ir_fat_pass1": 0,  # ops/fused_cell.py
    "fused_ir_fat_pass2": 0,  # ops/fused_cell.py
    "fused_inverted_residual_pass1": 0,  # ops/fused_mbconv.py
    "fused_inverted_residual_pass2": 0,  # ops/fused_mbconv.py
    "depthwise_conv2d": 0,  # ops/depthwise.py
    "augment_jitter_normalize": 0,  # ops/augment.py
    "edt_columns": 0,  # ops/edt.py
    "edt_rows": 0,  # ops/edt.py
    "bn_stats": 0,  # ops/csrc/batchnorm_op.cpp
    "bn_apply": 0,  # ops/csrc/batchnorm_op.cpp
    "bn_grad_reduce": 0,  # ops/csrc/batchnorm_op.cpp
    "bn_grad_apply": 0,  # ops/csrc/batchnorm_op.cpp
})


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
