"""Compound-loss suite for dead-tree segmentation (channel-first).

Counterpart of ``deadtrees_tpu.losses.losses``, with the same numerics
(EPS placement, idc class filtering, reduction order): CrossEntropy,
GeneralizedDice, GeneralizedDiceLoss (the "GDICE" config), DiceLoss,
SurfaceLoss/BoundaryLoss, FocalLoss and the Generalized Wasserstein Dice
Loss. Tensors are channel-first: ``probs`` is the softmax output
(B, K, H, W) and ``target`` one-hot (B, K, H, W).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-10
_SPATIAL = (2, 3)
_ALL_BUT_CLASS = (0, 2, 3)


def _take_idc(x: torch.Tensor, idc: Tuple[int, ...]) -> torch.Tensor:
    """Filter the class axis (dim 1) with static indices (the reference's
    ``idc``); a contiguous run is a slice."""
    lo, hi = min(idc), max(idc)
    if tuple(idc) == tuple(range(lo, hi + 1)):
        return x[:, lo:hi + 1]
    return x[:, list(idc)]


class CrossEntropy:
    """Masked cross-entropy."""

    def __init__(self, *, idc: Sequence[int]):
        self.idc = tuple(idc)

    def __call__(self, probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        log_p = torch.log(_take_idc(probs, self.idc).float() + 1e-10)
        mask = _take_idc(target, self.idc).float()
        loss = -torch.sum(mask * log_p)
        return loss / (torch.sum(mask) + 1e-10)


class GeneralizedDice:
    """Boundary-loss-repo GDL variant: per-sample inverse-squared-volume
    class weights."""

    def __init__(self, *, idc: Sequence[int]):
        self.idc = tuple(idc)

    def __call__(self, probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        pc = _take_idc(probs, self.idc).float()
        tc = _take_idc(target, self.idc).float()
        w = 1.0 / (torch.sum(tc, dim=_SPATIAL) ** 2 + EPS)  # (B, K)
        intersection = w * torch.sum(pc * tc, dim=_SPATIAL)
        union = w * (torch.sum(pc, dim=_SPATIAL) + torch.sum(tc, dim=_SPATIAL))
        divided = 1.0 - 2.0 * (torch.sum(intersection, dim=1) + EPS) / (
            torch.sum(union, dim=1) + EPS
        )
        return torch.mean(divided)


class GeneralizedDiceLoss:
    """The GDL of the "GDICE" config: class weights are the inverse squared
    class volume over the whole batch; the ratio folds the batch in too."""

    def __call__(self, probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        inp = probs.float()
        targ = target.float()
        w = 1.0 / (torch.sum(targ, dim=_ALL_BUT_CLASS) ** 2 + 1e-9)  # (K,)
        numerator = torch.sum(w * torch.sum(targ * inp, dim=_ALL_BUT_CLASS))
        denominator = torch.sum(w * torch.sum(targ + inp, dim=_ALL_BUT_CLASS))
        dice = 2.0 * (numerator + 1e-9) / (denominator + 1e-9)
        return 1.0 - dice


class DiceLoss:
    """Plain per-(batch, class) dice loss."""

    def __init__(self, *, idc: Sequence[int]):
        self.idc = tuple(idc)

    def __call__(self, probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        pc = _take_idc(probs, self.idc).float()
        tc = _take_idc(target, self.idc).float()
        intersection = torch.sum(pc * tc, dim=_SPATIAL)  # (B, K)
        union = torch.sum(pc, dim=_SPATIAL) + torch.sum(tc, dim=_SPATIAL)
        divided = 1.0 - (2.0 * intersection + EPS) / (union + EPS)
        return torch.mean(divided)


class SurfaceLoss:
    """Boundary (surface) loss over the signed distance maps of
    :func:`deadtrees_tpu_torch.losses.functional.batch_one_hot2dist`."""

    def __init__(self, *, idc: Sequence[int]):
        self.idc = tuple(idc)

    def __call__(self, probs: torch.Tensor, dist_maps: torch.Tensor) -> torch.Tensor:
        pc = _take_idc(probs, self.idc).float()
        dc = _take_idc(dist_maps, self.idc).float()
        return torch.mean(pc * dc)


BoundaryLoss = SurfaceLoss


class FocalLoss:
    """Multi-class focal loss."""

    def __init__(self, *, idc: Sequence[int], gamma: float = 2.0):
        self.idc = tuple(idc)
        self.gamma = gamma

    def __call__(self, probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        masked_probs = _take_idc(probs, self.idc)
        log_p = torch.log(masked_probs + EPS)
        mask = _take_idc(target, self.idc).float()
        w = (1.0 - masked_probs) ** self.gamma
        loss = -torch.sum(w * mask * log_p)
        return loss / (torch.sum(mask) + EPS)


class GeneralizedWassersteinDiceLoss:
    """Generalized Wasserstein Dice Loss on LOGITS (B, K, H, W) and integer
    targets (B, H, W), softmax applied inside; 'default' (alpha 1 for the
    foreground, 0 for the background) or 'GDL' weighting."""

    def __init__(self, dist_matrix, weighting_mode: str = "default", reduction: str = "mean"):
        if weighting_mode not in ("default", "GDL"):
            raise ValueError(f"weighting_mode must be 'default' or 'GDL', got {weighting_mode}")
        m = np.asarray(dist_matrix, dtype=np.float32)
        if m.max() != 1.0:
            m = m / m.max()
        self.M = torch.from_numpy(m)
        self.num_classes = m.shape[0]
        self.alpha_mode = weighting_mode
        self.reduction = reduction

    def __call__(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        epsilon = float(np.spacing(1))
        b, k = logits.shape[:2]
        flat_logits = logits.reshape(b, k, -1).transpose(1, 2)  # (B, S, K)
        flat_target = target.reshape(b, -1).long()  # (B, S)
        probs = torch.softmax(flat_logits, dim=-1)

        m_rows = self.M.to(logits.device)[flat_target]  # (B, S, K)
        wass_dist_map = torch.sum(m_rows * probs, dim=-1)  # (B, S)

        if self.alpha_mode == "GDL":
            one_hot_t = F.one_hot(flat_target, self.num_classes).float()
            alpha = 1.0 / (torch.sum(one_hot_t, dim=1) + 1.0)  # (B, K)
        else:
            alpha = torch.ones((b, self.num_classes), device=logits.device)
            alpha[:, 0] = 0.0
        alpha_per_voxel = torch.gather(alpha, 1, flat_target)  # (B, S)

        true_pos = torch.sum(alpha_per_voxel * (1.0 - wass_dist_map), dim=1)  # (B,)
        if self.alpha_mode == "GDL":
            denom = torch.sum(alpha_per_voxel * (2.0 - wass_dist_map), dim=1)
        else:
            all_error = torch.sum(wass_dist_map, dim=1)
            denom = 2.0 * true_pos + all_error
        wass_dice = (2.0 * true_pos + epsilon) / (denom + epsilon)
        loss = 1.0 - wass_dice
        if self.reduction == "sum":
            return torch.sum(loss)
        if self.reduction == "none":
            return loss
        return torch.mean(loss)
