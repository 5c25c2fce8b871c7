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

Updates are applied in place on flat buffers (:class:`Optimizer`), and
:meth:`Optimizer.step` runs no Python arithmetic on a number that changes
from step to step: the update count ``count`` and the accumulation count
``mini_step`` are 0-d int32 tensors on the parameters' device (optax's
counts are arrays too), the learning rate and Adam's bias corrections are
computed from ``count`` in float32 on the device, as optax computes them,
and whether an update applies (every k-th step, and only when the step's
loss is finite: ``finite``) is a device boolean that selects, with
``torch.where``, between the new and the old parameters and state. So the
step traces into one program (``train/steps.py``) that compiles once per
optimizer and never syncs with the host.

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


def bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay**count`` in float32 on the device from the 0-d count
    tensor, as optax computes it: for b2 = 0.999 the float32 subtraction
    cancels (1.3e-5 off at count 1), and Adam's update follows the
    denominator it gets."""
    return 1.0 - torch.pow(torch.full((), decay, dtype=torch.float32, device=count.device),
                           count.float())


def cosine_rate(config: OptimizerConfig, base_lr: float, count: torch.Tensor) -> torch.Tensor:
    """:func:`cosine_annealing_schedule` on the device, in float32 as the
    JAX package's schedule computes it: the learning rate after ``count``
    applied updates (a 0-d int tensor)."""
    epoch = torch.div(count, config.steps_per_epoch, rounding_mode="floor")
    cos = torch.cos(math.pi * epoch.float() / config.cosineannealing_tmax)
    return config.eta_min + (base_lr - config.eta_min) * (1.0 + cos) / 2.0


def global_norm(g: torch.Tensor) -> torch.Tensor:
    """sqrt of the sum of squares of the flat gradient vector ``g``, as a
    float32 0-d tensor. The sum is taken in float64: a float32 sum over the
    b0's 4.6M gradients is off by about 7e-7 of the norm (optax's by about
    1e-7), which moves the clip scale and, through Adam, the parameters by
    more than 1e-7 in a few steps."""
    return torch.linalg.vector_norm(g, dtype=torch.float64).float()


class Optimizer:
    """clip-by-global-norm → Adam → per-epoch cosine LR over ``params``
    (``make_optimizer`` of the JAX package as a stateful object).

    Its arithmetic runs on flat vectors, a few ops whatever the number of
    parameters, which keeps its program small to trace and compile: the
    gradients (``grad``, filled by :meth:`load_grads`), the moments and the accumulator for k > 1 are each
    one flat float32 buffer (``mu`` / ``nu`` / ``acc`` are lists of views of
    them in the parameters' shapes), and one foreach op adds the update to
    the parameters. The parameters stay tensors of their own, without
    gradients while a program traces them: views of one buffer would be
    inputs that alias each other, which AOTAutograd checks pair by pair.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Sequence[torch.Tensor], config: OptimizerConfig,
                 lr_scale: float = 1.0):
        self.params: List[torch.Tensor] = list(params)
        self.config = config
        self.base_lr = config.learning_rate * lr_scale
        self.schedule = cosine_annealing_schedule(config, self.base_lr)
        self.k = max(1, int(config.accumulate_grad_batches or 1))
        device = self.params[0].device if self.params else torch.device("cpu")
        if any(p.dtype != torch.float32 or p.device != device for p in self.params):
            raise ValueError("the optimizer takes float32 parameters on one device")
        self._sizes = [p.numel() for p in self.params]
        n = sum(self._sizes)
        with torch.no_grad():
            self.grad = torch.zeros(n, dtype=torch.float32, device=device)
            # applied updates: Adam's bias correction and the LR
            self.count = torch.zeros((), dtype=torch.int32, device=device)
            self.mini_step = torch.zeros((), dtype=torch.int32, device=device)
            self._mu = torch.zeros(n, dtype=torch.float32, device=device)
            self._nu = torch.zeros(n, dtype=torch.float32, device=device)
            self._acc = (torch.zeros(n, dtype=torch.float32, device=device)
                         if self.k > 1 else None)
        self.mu, self.nu = self._views(self._mu), self._views(self._nu)
        self.acc = self._views(self._acc) if self._acc is not None else None
        # the state stays where it lies: a CUDA graph updates it in place
        for t in (self.count, self.mini_step, self.grad, self._mu, self._nu, self._acc,
                  *self.params):
            if t is not None:
                torch._dynamo.mark_static_address(t)

    def state_tensors(self) -> List[torch.Tensor]:
        """The state that the ranks of a data-parallel run hold equal (the
        counts, the moments, the accumulator; ``parallel.mesh.replicate``)."""
        return [t for t in (self.count, self.mini_step, self._mu, self._nu, self._acc)
                if t is not None]

    def _views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """``flat`` cut into the parameters' shapes (views)."""
        return [v.view(p.shape) for v, p in zip(flat.split(self._sizes), self.params)]

    @torch.no_grad()
    def load_grads(self, grads: Sequence[torch.Tensor]) -> None:
        """Copy the parameters' gradients into ``grad`` (one foreach op)."""
        torch._foreach_copy_(self._views(self.grad), list(grads))

    @torch.no_grad()
    def step(self, finite: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Take one micro-step's gradients, those in ``grad`` (from
        :meth:`load_grads`); returns a 0-d device boolean, True when an update was
        applied to the parameters (every k-th call). ``finite`` (a 0-d
        device boolean, the step's loss being finite; True when omitted):
        when False, nothing changes, the accumulation included, as the JAX
        step's guard selects the old state."""
        g = self.grad
        ok = finite if finite is not None else torch.ones(
            (), dtype=torch.bool, device=self.count.device)
        if self.k > 1:
            # running mean (Welford), as optax.MultiSteps accumulates
            seen = self.mini_step + 1
            acc = self._acc + (g - self._acc) / seen.float()
            apply = ok & (seen >= self.k)
            g = acc
        else:
            apply = ok
        norm = global_norm(g)
        max_norm = self.config.gradient_clip_val
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        g = g * scale

        mu = torch.add(self._mu * self.b1, g, alpha=1.0 - self.b1)
        nu = torch.addcmul(self._nu * self.b2, g, g, value=1.0 - self.b2)
        lr = cosine_rate(self.config, self.base_lr, self.count)
        count = self.count + 1
        denom = torch.sqrt(nu / bias_correction(self.b2, count)) + self.eps
        upd = mu / bias_correction(self.b1, count) / denom * -lr
        # nothing moves unless the update applies (p + 0 == p)
        torch._foreach_add_(self.params,
                            self._views(torch.where(apply, upd, torch.zeros_like(upd))))
        self._mu.copy_(torch.where(apply, mu, self._mu))
        self._nu.copy_(torch.where(apply, nu, self._nu))
        self.count.copy_(torch.where(apply, count, self.count))
        if self.k > 1:
            self._acc.copy_(torch.where(ok, torch.where(apply, torch.zeros_like(acc), acc),
                                        self._acc))
            self.mini_step.copy_(torch.where(
                ok, torch.where(apply, torch.zeros_like(seen), seen), self.mini_step))
        return apply


def make_optimizer(
    params: Sequence[torch.Tensor], config: OptimizerConfig, *, lr_scale: float = 1.0
) -> Optimizer:
    """clip-by-global-norm → Adam with per-epoch cosine annealing; a fresh
    one (``lr_scale = 1 / lr_reduce_fraction``) is the MultiStage stage
    switch."""
    return Optimizer(params, config, lr_scale=lr_scale)


def encoder_grad_mask(model: torch.nn.Module, grads: Sequence[torch.Tensor]) -> None:
    """Zero, in place, the gradients of the ``encoder`` parameters of
    ``model`` (``grads`` in ``model.parameters()`` order). A model without
    an ``encoder`` (SegFormer) keeps every gradient, as the JAX mask keeps
    a tree without an ``encoder`` subtree."""
    encoder = getattr(model, "encoder", None)
    if encoder is None:
        return
    enc = {id(p) for p in encoder.parameters()}
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

    count = np.asarray(int(opt.count), np.int32)
    inner = {"0": {}, "1": {"count": count, "mu": tree(opt.mu), "nu": tree(opt.nu)},
             "2": {"count": count.copy()}}
    if opt.k == 1:
        return inner
    return {"mini_step": np.asarray(int(opt.mini_step), np.int32),
            "gradient_step": count.copy(),
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
        opt.mini_step.fill_(int(state["mini_step"]))
    opt.count.fill_(count)
    return opt


def optimizer_to_bytes(opt: Optimizer, model: torch.nn.Module) -> bytes:
    """``opt``'s state as ``flax.serialization.to_bytes`` writes the optax
    state of ``make_optimizer``."""
    return packb(snapshot(optimizer_state_dict(opt, model)))


def optimizer_from_bytes(opt: Optimizer, model: torch.nn.Module, data: bytes) -> Optimizer:
    """Load bytes of :func:`optimizer_to_bytes` or of the JAX package's
    ``flax.serialization.to_bytes(opt_state)`` into ``opt``."""
    return load_optimizer_state_dict(opt, model, unpackb(data))
