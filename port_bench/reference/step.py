"""The training step, plainly: the network in train mode, the compound
loss, its gradients by autograd, clip by global norm and Adam.

The loss is the recipe's GDICE + BOUNDARY + FOCAL on the softmax:

- GDICE: class weights 1 / (Σ_batch target_k)², ``1 − 2 (Σ_k w_k·Σ p·t +
  1e-9) / (Σ_k w_k·Σ (p + t) + 1e-9)`` over the whole batch;
- BOUNDARY: the mean of ``p·distmap`` over the foreground classes;
- FOCAL (γ 2): ``−Σ (1 − p)² t log(p + 1e-10) / (Σ t + 1e-10)``.

The update follows optax's chain: the gradient scaled by ``clip / ‖g‖``
when ‖g‖ ≥ clip, then Adam with bias correction, at the configuration's
learning rate for the epoch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference import model as ref_model
from port_bench.reference.core import Numerics

LOSSES = ("GDICE", "FOCAL", "BOUNDARY")


def loss(logits: torch.Tensor, mask: torch.Tensor, distmap: torch.Tensor,
         losses: Sequence[str]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if sorted(losses) != sorted(LOSSES):
        raise ValueError(f"the reference computes {LOSSES}, not {tuple(losses)}")
    k = logits.shape[1]
    p = torch.softmax(logits, 1)
    t = F.one_hot(mask, k).permute(0, 3, 1, 2).float()
    dims = (0, 2, 3)
    w = 1.0 / (t.sum(dims) ** 2 + 1e-9)
    dice = 2.0 * ((w * (p * t).sum(dims)).sum() + 1e-9) / ((w * (p + t).sum(dims)).sum() + 1e-9)
    parts = {"dice_loss": 1.0 - dice,
             "boundary_loss": (p[:, 1:] * distmap[:, 1:]).mean(),
             "focal_loss": -((1.0 - p) ** 2 * t * torch.log(p + 1e-10)).sum() / (t.sum() + 1e-10)}
    return parts["dice_loss"] + parts["boundary_loss"] + parts["focal_loss"], parts


def grads(params: Dict[str, torch.Tensor], names: List[str], image, mask, distmap,
          model: Dict, losses: Sequence[str], numerics: Numerics
          ) -> Tuple[Dict[str, float], List[torch.Tensor]]:
    """Loss parts (floats, ``total_loss`` among them) and the gradients of
    ``names``; each block recomputed in the backward pass."""
    leaves = [params[n].detach().requires_grad_(True) for n in names]
    run = dict(params)
    run.update(zip(names, leaves))
    logits = ref_model.forward(run, image, model, train=True, numerics=numerics,
                               checkpoint=True)
    total, parts = loss(logits, mask, distmap, losses)
    g = torch.autograd.grad(total, leaves)
    out = {k: float(v.detach()) for k, v in parts.items()}
    out["total_loss"] = float(total.detach())
    return out, list(g)


class Adam:
    """clip-by-global-norm → Adam(b1, b2, eps) at a fixed learning rate."""

    def __init__(self, params: List[torch.Tensor], lr: float, clip: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.clip = params, lr, clip
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Apply one update; returns the clipped gradients."""
        norm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads))
        scale = 1.0 if norm < self.clip else self.clip / norm
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        clipped = [g * scale for g in grads]
        for p, g, m, v in zip(self.params, clipped, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))
        return clipped
