"""Operations of a network, counted from the shapes of its convolutions
and matrix products as a pass over meta tensors dispatches them.

``torch.utils.flop_counter`` counts the weight gradient of a grouped
convolution as if it were dense (C times too high for a depthwise one),
so the backward pass is counted here from the forward: each
convolution's input and weight gradients cost what its forward costs,
except the input gradient of the first, which reads the image."""

from __future__ import annotations

import math
from typing import List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


class Counter(TorchDispatchMode):
    """FLOPs (2 a multiply-add) of each convolution and matrix product, in
    the order they run."""

    def __init__(self):
        super().__init__()
        self.ops: List[int] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is aten.convolution.default:
            w = args[1]
            self.ops.append(2 * out.numel() * math.prod(w.shape[1:]))
        elif func in (aten.mm.default, aten.addmm.default, aten.bmm.default,
                      aten.baddbmm.default):
            a = args[-2]
            self.ops.append(2 * out.numel() * a.shape[-1])
        return out


def forward_flops(fn) -> List[int]:
    """The per-op FLOPs of ``fn()``, run over meta tensors."""
    with Counter() as counter:
        fn()
    return counter.ops


def training_flops(ops: List[int]) -> int:
    """Forward, input and weight gradients, less the first op's input
    gradient."""
    return 3 * sum(ops) - ops[0]
