"""Launch counts of the port's CUDA kernels.

One count per kernel, raised by its wrapper where it launches the kernel
and nowhere else, so a run can show that its path went through the
kernels: set the counts to 0 with :func:`reset_launch_counts`, drive the
path, read :data:`LAUNCHES`.
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
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
