"""Plain PyTorch building blocks of the reference networks.

The reference computes in float32 with TF32 off, op by op, over a flat
dict of parameters named as the model's published state dict names them
(smp's and timm's layout). It imports nothing of the measured program.

A :class:`Numerics` of mode ``"fp8"`` rounds both operands of every
convolution to float8 e4m3 with one scale a tensor (the step below the
configuration's bf16): the control that the comparison must reject.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def float32_exact():
    """Full float32 products on the card inside the block: TF32 off for
    matmuls and cuDNN, the program's own settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Numerics:
    """How the reference rounds: ``"float32"`` (the reference), ``"fp8"``
    (each convolution's operands through float8 e4m3, scaled by their
    largest magnitude) or ``"bf16"`` (each convolution's operands and
    output through bfloat16, as autocast runs them: a witness of what the
    configuration's own precision does to a number). Gradients pass
    straight through the rounding."""

    MODES = ("float32", "fp8", "bf16")

    def __init__(self, mode: str = "float32"):
        if mode not in self.MODES:
            raise ValueError(f"numerics {mode!r}; expected one of {self.MODES}")
        self.mode = mode

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "float32":
            return t
        if self.mode == "bf16":
            return _through(t, torch.bfloat16)
        scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
        return t + (q - t.detach())

    def result(self, t: torch.Tensor) -> torch.Tensor:
        return _through(t, torch.bfloat16) if self.mode == "bf16" else t


def _through(t: torch.Tensor, dtype) -> torch.Tensor:
    return t + (t.detach().to(dtype).to(t.dtype) - t.detach())


class Leaf:
    """One entry of a network's state: name, shape and kind (``weight`` of
    a convolution, ``bias``, ``bn_weight``, ``bn_bias``, ``bn_mean``,
    ``bn_var``, ``bn_count``). Parameters are the first four kinds."""

    PARAM_KINDS = ("weight", "bias", "bn_weight", "bn_bias")

    def __init__(self, name: str, shape: Tuple[int, ...], kind: str):
        self.name, self.shape, self.kind = name, tuple(shape), kind

    @property
    def is_param(self) -> bool:
        return self.kind in self.PARAM_KINDS


class Shapes:
    """Collects the leaves of a network in state-dict order."""

    def __init__(self):
        self.leaves: List[Leaf] = []

    def conv(self, name: str, cout: int, cin: int, k: int, bias: bool = False,
             groups: int = 1) -> None:
        self.leaves.append(Leaf(name + ".weight", (cout, cin // groups, k, k), "weight"))
        if bias:
            self.leaves.append(Leaf(name + ".bias", (cout,), "bias"))

    def bn(self, name: str, c: int) -> None:
        for suffix, kind, shape in (("weight", "bn_weight", (c,)), ("bias", "bn_bias", (c,)),
                                    ("running_mean", "bn_mean", (c,)),
                                    ("running_var", "bn_var", (c,)),
                                    ("num_batches_tracked", "bn_count", ())):
            self.leaves.append(Leaf(f"{name}.{suffix}", shape, kind))


class Net:
    """One forward pass over ``params``: convolutions through
    ``numerics``, BatchNorm on the batch's statistics (``train``) or the
    running ones. ``stats``, when a dict, receives each train-mode
    BatchNorm's (mean, biased variance). ``checkpoint`` recomputes each
    block in the backward pass, so that a float32 step fits the card."""

    def __init__(self, params: Dict[str, torch.Tensor], *, train: bool,
                 numerics: Optional[Numerics] = None, checkpoint: bool = False,
                 stats: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None):
        self.p = params
        self.train = train
        self.numerics = numerics or Numerics()
        self.checkpoint = checkpoint
        self.stats = stats

    def conv(self, x: torch.Tensor, name: str, stride: int = 1, groups: int = 1
             ) -> torch.Tensor:
        """k×k convolution with k // 2 padding."""
        w = self.p[name + ".weight"]
        q = self.numerics.operand
        return self.numerics.result(F.conv2d(q(x), q(w), self.p.get(name + ".bias"), stride,
                                             w.shape[-1] // 2, 1, groups))

    def bn(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        if self.train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            if self.stats is not None:
                self.stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = self.p[name + ".running_mean"], self.p[name + ".running_var"]
        scale = self.p[name + ".weight"] * torch.rsqrt(var + eps)
        shift = self.p[name + ".bias"] - mean * scale
        return x * scale[:, None, None] + shift[:, None, None]

    def block(self, fn: Callable, *args):
        """``fn(self, *args)``, recomputed in the backward pass when
        ``checkpoint`` is set and gradients are on."""
        if self.checkpoint and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                lambda *a: fn(self, *a), *args, use_reentrant=False)
        return fn(self, *args)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def fan_in(shape: Tuple[int, ...]) -> int:
    return math.prod(shape[1:]) if len(shape) > 1 else 1
