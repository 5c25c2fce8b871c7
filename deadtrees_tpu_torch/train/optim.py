"""Optimizer, LR schedule and the multistage freeze/unfreeze.

Counterpart of ``deadtrees_tpu.train.optim``, with optax's semantics:

- clip by global norm (``gradient_clip_val``, 0.5): ``g`` if ``‖g‖ < max``
  else ``g / ‖g‖ · max`` (optax's rule, not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm);
- Adam (b1 0.9, b2 0.999, eps 1e-8, bias correction);
- the learning rate of torch's ``CosineAnnealingLR`` stepped per epoch,
  counted in *applied* updates;
- ``accumulate_grad_batches = k``: the mean of k micro-step gradients is
  applied on the k-th step (``optax.MultiSteps``), clip included;
- MultiStage: the encoder frozen until ``unfreeze_epoch`` (its gradients
  zeroed before the clip and Adam, so frozen weights still take Adam's
  momentum, as in the JAX train step), then a fresh Adam at
  ``lr / lr_reduce_fraction`` from ``lr_reduce_epoch``.

Updates are applied in place with ``torch._foreach_*`` ops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    cosineannealing_tmax: int = 10  # epochs per half-cosine
    gradient_clip_val: float = 0.5
    steps_per_epoch: int = 1  # OPTIMIZER updates per epoch (micro-steps/k)
    eta_min: float = 0.0
    accumulate_grad_batches: int = 1


@dataclasses.dataclass(frozen=True)
class MultiStageConfig:
    unfreeze_epoch: int = 20
    lr_reduce_epoch: Optional[int] = 40
    lr_reduce_fraction: Optional[float] = 3.0


def cosine_annealing_schedule(config: OptimizerConfig, base_lr: float) -> Callable[[int], float]:
    """torch ``CosineAnnealingLR`` closed form, stepped per epoch:
    ``lr(e) = eta_min + (lr0 - eta_min)·(1 + cos(π e / T_max)) / 2`` with
    ``e = updates // steps_per_epoch`` (it continues past T_max)."""

    def schedule(step: int) -> float:
        epoch = step // config.steps_per_epoch
        cos = math.cos(math.pi * epoch / config.cosineannealing_tmax)
        return config.eta_min + (base_lr - config.eta_min) * (1.0 + cos) / 2.0

    return schedule


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a 0-d tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


class Optimizer:
    """clip-by-global-norm → Adam → per-epoch cosine LR over ``params``
    (``make_optimizer`` of the JAX package as a stateful object)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Sequence[torch.Tensor], config: OptimizerConfig,
                 lr_scale: float = 1.0):
        self.params: List[torch.Tensor] = list(params)
        self.config = config
        self.schedule = cosine_annealing_schedule(config, config.learning_rate * lr_scale)
        self.k = max(1, int(config.accumulate_grad_batches or 1))
        self.count = 0  # applied updates: Adam's bias correction and the LR
        self.mini_step = 0
        with torch.no_grad():
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
            self.acc = [torch.zeros_like(p) for p in self.params] if self.k > 1 else None

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one micro-step's gradients; returns True when an update was
        applied to the parameters (every k-th call)."""
        grads = list(grads)
        if self.k > 1:
            # running mean (Welford), as optax.MultiSteps accumulates
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            grads = self.acc
        norm = global_norm(grads)
        max_norm = self.config.gradient_clip_val
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        g = torch._foreach_mul(grads, scale)

        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
        lr = self.schedule(self.count)
        self.count += 1
        denom = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)
        if self.k > 1:
            self.mini_step = 0
            torch._foreach_zero_(self.acc)
        return True


def make_optimizer(
    params: Sequence[torch.Tensor], config: OptimizerConfig, *, lr_scale: float = 1.0
) -> Optimizer:
    """clip-by-global-norm → Adam with per-epoch cosine annealing; a fresh
    one (``lr_scale = 1 / lr_reduce_fraction``) is the MultiStage stage
    switch."""
    return Optimizer(params, config, lr_scale=lr_scale)


def encoder_grad_mask(model: torch.nn.Module, grads: Sequence[torch.Tensor]) -> None:
    """Zero, in place, the gradients of the ``encoder`` parameters of
    ``model`` (``grads`` in ``model.parameters()`` order)."""
    enc = {id(p) for p in model.encoder.parameters()}
    torch._foreach_zero_([g for p, g in zip(model.parameters(), grads) if id(p) in enc])
