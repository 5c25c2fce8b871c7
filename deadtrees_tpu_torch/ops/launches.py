"""Launch counts of the port's CUDA kernels.

One count per kernel, raised by its wrapper where it launches the kernel
and nowhere else, so a run can show that its path went through the
kernels: set the counts to 0 with :func:`reset_launch_counts`, drive the
path, read :data:`LAUNCHES`.

A count advances in Python, where the kernel's custom op runs its
implementation: at every eager call, and inside a compiled program at its
warm-up and at its CUDA-graph capture, but not at a graph replay, which
launches the recorded kernels without running any Python. A replay's
launches are read by kernel name from a profiler trace (``chip_smoke.py``
phase 15).
"""

from __future__ import annotations

LAUNCHES = {
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
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
