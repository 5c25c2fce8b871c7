"""Segmentation metrics (channel-first).

Counterpart of ``deadtrees_tpu.losses.metrics``:

- :func:`fscore`: smp's ``Fscore`` (global F-beta over thresholded
  probabilities, with an optional channel-exclusion list);
- :func:`dice_score`: MONAI's ``DiceMetric`` (per-item, per-class dice,
  NaN for empty ground truth, nan-mean);
- :func:`confusion_matrix` / :func:`masked_confusion_matrix`:
  torchmetrics' confusion matrix, optionally row-normalized, and the one
  restricted to the forest land-use layer.

Probabilities and one-hot tensors are (B, K, H, W).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _threshold(x: torch.Tensor, threshold: Optional[float]) -> torch.Tensor:
    if threshold is None:
        return x
    return (x > threshold).to(x.dtype)


def _take_channels(
    x: torch.Tensor, num_classes: int, ignore_channels: Optional[Sequence[int]]
) -> torch.Tensor:
    if not ignore_channels:
        return x
    keep = tuple(i for i in range(num_classes) if i not in set(ignore_channels))
    lo, hi = min(keep), max(keep)
    if keep == tuple(range(lo, hi + 1)):
        return x[:, lo:hi + 1]
    return x[:, list(keep)]


def fscore(
    probs: torch.Tensor,
    target: torch.Tensor,
    *,
    beta: float = 1.0,
    eps: float = 1e-7,
    threshold: Optional[float] = 0.5,
    ignore_channels: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Global F-beta score over (B, K, H, W) probabilities: threshold →
    drop ignored channels → one tp/fp/fn over all remaining elements."""
    k = probs.shape[1]
    pr = _take_channels(_threshold(probs.float(), threshold), k, ignore_channels)
    gt = _take_channels(target.float(), k, ignore_channels)
    tp = torch.sum(gt * pr)
    fp = torch.sum(pr) - tp
    fn = torch.sum(gt) - tp
    b2 = beta**2
    return ((1 + b2) * tp + eps) / ((1 + b2) * tp + b2 * fn + fp + eps)


def dice_score(
    pred_one_hot: torch.Tensor,
    target_one_hot: torch.Tensor,
    *,
    include_background: bool = True,
) -> torch.Tensor:
    """MONAI-style mean dice over (B, K, H, W) one-hot tensors; classes
    with empty ground truth are NaN and left out of the mean."""
    p = pred_one_hot.float()
    t = target_one_hot.float()
    if not include_background:
        p = p[:, 1:]
        t = t[:, 1:]
    inter = torch.sum(p * t, dim=(2, 3))  # (B, K)
    denom = torch.sum(p, dim=(2, 3)) + torch.sum(t, dim=(2, 3))
    nan = torch.full_like(denom, float("nan"))
    dice = torch.where(denom > 0, 2.0 * inter / denom, nan)
    gt_empty = torch.sum(t, dim=(2, 3)) == 0
    dice = torch.where(gt_empty, nan, dice)
    return torch.nanmean(dice)


def _normalize_rows(cm: torch.Tensor, normalize: Optional[str]) -> torch.Tensor:
    if normalize is None:
        return cm
    if normalize == "true":
        row = torch.sum(cm, dim=1, keepdim=True)
        return torch.where(row > 0, cm / torch.clamp(row, min=1), torch.zeros((), device=cm.device))
    raise ValueError(f"Unsupported normalize mode: {normalize}")


def confusion_matrix(
    pred: torch.Tensor,
    target: torch.Tensor,
    *,
    num_classes: int,
    normalize: Optional[str] = None,
) -> torch.Tensor:
    """Confusion matrix over integer label tensors of any (equal) shape:
    ``cm[i, j]`` counts pixels of true class i predicted as class j.
    ``normalize='true'`` row-normalizes; rows without support are zero."""
    idx = target.reshape(-1).long() * num_classes + pred.reshape(-1).long()
    cm = torch.bincount(idx, minlength=num_classes * num_classes)
    return _normalize_rows(cm.reshape(num_classes, num_classes), normalize)


def masked_confusion_matrix(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    *,
    num_classes: int,
    normalize: Optional[str] = None,
) -> torch.Tensor:
    """Confusion matrix over the pixels where ``mask == 1``: the others go
    to a scratch bin that is dropped."""
    idx = target.reshape(-1).long() * num_classes + pred.reshape(-1).long()
    scratch = num_classes * num_classes
    idx = torch.where(mask.reshape(-1) == 1, idx, torch.full_like(idx, scratch))
    cm = torch.bincount(idx, minlength=scratch + 1)[:-1]
    return _normalize_rows(cm.reshape(num_classes, num_classes), normalize)
