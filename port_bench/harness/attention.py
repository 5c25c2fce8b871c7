"""The attention's work in one training step of a MiT configuration,
counted from the configuration and the traffic alone.

Each block attends N = (h·w) queries of its stage's token map to M keys,
M = (h / R)·(w / R) after the stage's spatial reduction R, over C =
heads × d channels. A block's forward is 4·N·M·C FLOPs for each sample
(QKᵀ and PV); training is three times that (the forward; dP and dV; dQ
and dK), and a backend that recomputes P in its backward pass does more
work than is counted here, so that the share reads the same work
whatever implements it. Bytes are Q, K, V and O, and dO, dQ, dK and dV,
in bf16, each moved once: 8·(N + M)·C bytes a sample. A block's bound
is the larger of its FLOPs at the card's bf16 dense peak and its bytes
at its memory bandwidth (``peaks``); a step's bound is the sum over the
configuration's blocks at the traffic's tile and batch.

The attention's device time is that of the kernels whose name, case
folded, contains one of :data:`MARKS`: the fused backends' kernels
(PyTorch's flash kernels, cuDNN's fused attention). A hand-written
attention kernel of the port carries ``attention`` in its name, so that
the metrics keep reading it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from port_bench.harness.layers import busy_s
from port_bench.harness.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from port_bench.harness.record import Record

BF16_BYTES = 2
MARKS = ("flash", "fmha", "attention", "sdpa")


def blocks(config: Dict, traffic: Dict) -> List[Tuple[int, int, int, int]]:
    """(batch, N, M, C) of every attention of one forward, in order."""
    enc = config["encoder"]
    size, out = traffic["tile"], []
    for k, s, dim, depth, r in zip(enc["patch_kernels"], enc["patch_strides"],
                                   enc["embed_dims"], enc["depths"], enc["sr_ratios"]):
        size = (size + 2 * (k // 2) - k) // s + 1
        out += [(traffic["batch_size"], size * size, (size // r) ** 2, dim)] * depth
    return out


def flops(b: int, n: int, m: int, c: int) -> float:
    """One block's training FLOPs."""
    return 3.0 * 4 * b * n * m * c


def nbytes(b: int, n: int, m: int, c: int) -> float:
    """One block's training bytes."""
    return 2.0 * 4 * BF16_BYTES * b * (n + m) * c


def step_bound_s(config: Dict, traffic: Dict) -> float:
    return sum(max(flops(*blk) / BF16_FLOP_PER_S, nbytes(*blk) / HBM_BYTES_PER_S)
               for blk in blocks(config, traffic))


def is_kernel(e) -> bool:
    """A device event of an attention kernel, by the rule of :data:`MARKS`."""
    name = e.name.casefold()
    return e.kind == "kernel" and any(m in name for m in MARKS)


def device_s_a_step(record: Record) -> Optional[float]:
    """Union of the window's attention kernels' device intervals over the
    steps, s; None without a trace or without such kernels."""
    s = busy_s(record, is_kernel)
    return None if s is None else s / record.counters["steps"]
