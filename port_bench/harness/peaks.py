"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit) and the bounds of the port's kernels at their shapes."""

from __future__ import annotations

from typing import Sequence

BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def augment_bound_s(shape: Sequence[int]) -> float:
    """Kernel 4 (jitter + normalize) at its (B, H, W, C) uint8 input: the
    batch and α, β read once, the float32 NCHW batch written once; 8 float
    operations an element and one add an element for the image mean. The
    larger of the bytes' and the operations' time (the copy of
    ``chip_smoke.augment_bound_ms``)."""
    bsz, hh, ww, c = shape
    n = bsz * hh * ww * c
    nbytes = n + 8 * bsz + 4 * n
    return max(nbytes / HBM_BYTES_PER_S, 9 * n / F32_FLOP_PER_S)
