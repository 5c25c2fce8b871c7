"""Compound-loss configuration and computation.

Counterpart of ``deadtrees_tpu.train.loss``, the reference's loss parser
and compound loss:

- the ``losses`` config list (GDICE | GWDICE | DICE | FOCAL | BOUNDARY |
  BOUNDARY-RAMPED);
- GDICE and DICE exclude each other, and a dice-family term is required;
- the compound sum dice + (α·)boundary + focal;
- the ramp ``α = min((epoch + 1) · initial_alpha, 0.99)`` of
  BOUNDARY-RAMPED.

Tensors are channel-first (B, K, H, W).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deadtrees_tpu_torch.losses.losses import (
    BoundaryLoss,
    DiceLoss,
    FocalLoss,
    GeneralizedDiceLoss,
    GeneralizedWassersteinDiceLoss,
)

# Default GWDL class-distance matrix
_GWDL_DIST_MAT = np.array([[0.0, 1.0, 1.0], [1.0, 0.0, 0.5], [1.0, 0.5, 0.0]])


@dataclasses.dataclass(frozen=True)
class CompoundLossConfig:
    losses: Tuple[str, ...] = ("GDICE", "FOCAL", "BOUNDARY")
    num_classes: int = 3
    initial_alpha: float = 0.01


class CompoundLoss:
    """Callable computing the compound loss and its per-term parts."""

    def __init__(self, config: CompoundLossConfig):
        self.config = config
        names = tuple(config.losses)
        if "GDICE" in names and "DICE" in names:
            raise ValueError(f"Only GDICE _OR_ DICE allowed {names}")

        classes_int = list(range(config.num_classes))
        classes_wout_bg = [c for c in classes_int if c != 0]
        self.dice_loss = None
        self.dice_is_gwdl = False
        self.focal_loss = None
        self.boundary_loss = None
        self.boundary_ramped = False
        for name in names:
            if name == "GDICE":
                self.dice_loss = GeneralizedDiceLoss()
            elif name == "GWDICE":
                n = config.num_classes
                self.dice_loss = GeneralizedWassersteinDiceLoss(
                    dist_matrix=_GWDL_DIST_MAT[:n, :n]
                )
                self.dice_is_gwdl = True
            elif name == "DICE":
                self.dice_loss = DiceLoss(idc=classes_wout_bg)
            elif name == "FOCAL":
                self.focal_loss = FocalLoss(idc=classes_int, gamma=2)
            elif name in ("BOUNDARY", "BOUNDARY-RAMPED"):
                self.boundary_loss = BoundaryLoss(idc=classes_wout_bg)
                self.boundary_ramped = name == "BOUNDARY-RAMPED"
            else:
                raise NotImplementedError(f"The loss component <{name}> is not recognized")
        if self.dice_loss is None:
            raise ValueError(f"a dice-family loss (GDICE, GWDICE or DICE) is required: {names}")

    def alpha(self, epoch: int) -> float:
        """Boundary-loss blend: ramps 0.01 → 0.99 by epoch."""
        return min((epoch + 1) * self.config.initial_alpha, 0.99)

    def __call__(
        self,
        probs: torch.Tensor,  # softmax(logits), (B, K, H, W)
        target_one_hot: torch.Tensor,  # (B, K, H, W)
        *,
        logits: Optional[torch.Tensor] = None,  # needed for GWDICE
        distmap: Optional[torch.Tensor] = None,  # (B, K, H, W) signed distance
        epoch: int = 0,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        parts: Dict[str, torch.Tensor] = {}
        if self.dice_is_gwdl:
            loss_gd = self.dice_loss(logits, target_one_hot.argmax(1))
        else:
            loss_gd = self.dice_loss(probs, target_one_hot)
        parts["dice_loss"] = loss_gd
        loss = loss_gd
        if self.boundary_loss is not None and distmap is not None:
            loss_bd = self.boundary_loss(probs, distmap)
            parts["boundary_loss"] = loss_bd
            loss = loss + (self.alpha(int(epoch)) * loss_bd if self.boundary_ramped else loss_bd)
        if self.focal_loss is not None:
            loss_fo = self.focal_loss(probs, target_one_hot)
            parts["focal_loss"] = loss_fo
            loss = loss + loss_fo
        parts["total_loss"] = loss
        return loss, parts


def build_loss(
    losses: Sequence[str], num_classes: int, initial_alpha: float = 0.01
) -> CompoundLoss:
    return CompoundLoss(
        CompoundLossConfig(
            losses=tuple(losses), num_classes=num_classes, initial_alpha=initial_alpha
        )
    )
