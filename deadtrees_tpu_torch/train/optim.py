"""Optimizer, LR schedule and the multistage freeze/unfreeze.

Counterpart of ``deadtrees_tpu.train.optim``, with optax's semantics:

- clip by global norm (``gradient_clip_val``, 0.5): ``g`` if ``‖g‖ < max``
  else ``g / ‖g‖ · max`` (optax's rule, not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm);
- Adam (b1 0.9, b2 0.999, eps 1e-8, bias correction ``1 - b**count`` in
  float32, as optax computes it);
- the learning rate of torch's ``CosineAnnealingLR`` stepped per epoch,
  counted in *applied* updates;
- ``accumulate_grad_batches = k``: the mean of k micro-step gradients is
  applied on the k-th step (``optax.MultiSteps``), clip included;
- MultiStage: the encoder frozen until ``unfreeze_epoch`` (its gradients
  zeroed before the clip and Adam, so frozen weights still take Adam's
  momentum, as in the JAX train step), then a fresh Adam at
  ``lr / lr_reduce_fraction`` from ``lr_reduce_epoch``.

Updates are applied in place with ``torch._foreach_*`` ops.

The optimizer's state travels in the JAX package's own bytes: the flax
serialization of the optax state of ``make_optimizer``
(:func:`optimizer_to_bytes`, :func:`optimizer_from_bytes`), so a
checkpoint written by either package resumes in the other. Its layout
(``flax.serialization.to_state_dict``) is, for k = 1,
``{"0": {}, "1": {"count", "mu", "nu"}, "2": {"count"}}`` (the clip, Adam
and the learning-rate scale of the chain), and for k > 1 (``MultiSteps``)
``{"mini_step", "gradient_step", "inner_opt_state": <the k = 1 map>,
"acc_grads", "skip_state": {}}``. ``mu``, ``nu`` and ``acc_grads`` are
trees in the flax parameter layout (``models/convert.py``); the counts are
int32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deadtrees_tpu_torch.core.checkpoint import snapshot
from deadtrees_tpu_torch.core.msgpack_codec import packb, unpackb
from deadtrees_tpu_torch.models.convert import (
    state_dict_from_variables,
    tensor_variables_from_state_dict,
)


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
    """sqrt of the sum of squares of every element, as a float32 0-d
    tensor. The sums are taken in float64: torch's float32 ``_foreach_norm``
    on the CPU is off by about 7e-7 of the norm over the b0's 4.6M
    gradients (optax's float32 norm by about 1e-7), which moves the clip
    scale and, through Adam, the parameters by more than 1e-7 in a few
    steps."""
    norms = torch._foreach_norm(list(grads), 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it: for b2 = 0.999
    the float32 subtraction cancels (1.3e-5 off at count 1), and Adam's
    update follows the denominator it gets."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


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
        denom = torch._foreach_div(self.nu, _bias_correction(self.b2, self.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, _bias_correction(self.b1, self.count))
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


def _param_names(opt: Optimizer, model: torch.nn.Module) -> List[str]:
    named = list(model.named_parameters())
    if len(named) != len(opt.params) or any(p is not q for (_, p), q in zip(named, opt.params)):
        raise ValueError("the optimizer does not hold this model's parameters in order")
    return [n for n, _ in named]


def optimizer_state_dict(opt: Optimizer, model: torch.nn.Module) -> Dict[str, Any]:
    """``opt``'s state as flax's ``to_state_dict`` lays out the optax state
    of ``make_optimizer`` (module docstring). The moment trees hold tensors
    on the optimizer's device, some of them views of its live state: copy
    the tree before the next step if it is to be kept."""
    names = _param_names(opt, model)
    encoder_name = getattr(model, "encoder_name", None)

    def tree(tensors):
        return tensor_variables_from_state_dict(
            dict(zip(names, tensors)), encoder_name=encoder_name)["params"]

    count = np.asarray(opt.count, np.int32)
    inner = {"0": {}, "1": {"count": count, "mu": tree(opt.mu), "nu": tree(opt.nu)},
             "2": {"count": count.copy()}}
    if opt.k == 1:
        return inner
    return {"mini_step": np.asarray(opt.mini_step, np.int32), "gradient_step": count.copy(),
            "inner_opt_state": inner, "acc_grads": tree(opt.acc), "skip_state": {}}


@torch.no_grad()
def load_optimizer_state_dict(
    opt: Optimizer, model: torch.nn.Module, state: Dict[str, Any]
) -> Optimizer:
    """Set ``opt``'s moments, accumulator and counts from a state in the
    layout of :func:`optimizer_state_dict` (numpy leaves, as read from
    bytes); the learning rate and its scale stay ``opt``'s own."""
    names = _param_names(opt, model)
    encoder_name = getattr(model, "encoder_name", None)
    multi = "inner_opt_state" in state
    if multi != (opt.k > 1):
        raise ValueError(f"an optimizer state of {'k > 1' if multi else 'k = 1'} "
                         f"does not load into accumulate_grad_batches={opt.k}")
    inner = state["inner_opt_state"] if multi else state
    count = int(inner["1"]["count"])
    if int(inner["2"]["count"]) != count or (multi and int(state["gradient_step"]) != count):
        raise ValueError("the optimizer state's update counts disagree")

    def copy_into(dst: List[torch.Tensor], tree) -> None:
        sd = state_dict_from_variables({"params": tree}, encoder_name=encoder_name)
        for d, n in zip(dst, names):
            d.copy_(sd[n])

    copy_into(opt.mu, inner["1"]["mu"])
    copy_into(opt.nu, inner["1"]["nu"])
    if multi:
        copy_into(opt.acc, state["acc_grads"])
        opt.mini_step = int(state["mini_step"])
    opt.count = count
    return opt


def optimizer_to_bytes(opt: Optimizer, model: torch.nn.Module) -> bytes:
    """``opt``'s state as ``flax.serialization.to_bytes`` writes the optax
    state of ``make_optimizer``."""
    return packb(snapshot(optimizer_state_dict(opt, model)))


def optimizer_from_bytes(opt: Optimizer, model: torch.nn.Module, data: bytes) -> Optimizer:
    """Load bytes of :func:`optimizer_to_bytes` or of the JAX package's
    ``flax.serialization.to_bytes(opt_state)`` into ``opt``."""
    return load_optimizer_state_dict(opt, model, unpackb(data))
