"""Segmentation metrics (channel-first).

Counterpart of ``deadtrees_tpu.losses.metrics``:

- :func:`fscore`: smp's ``Fscore`` (global F-beta over thresholded
  probabilities, with an optional channel-exclusion list);
- :func:`dice_score`: MONAI's ``DiceMetric`` (per-item, per-class dice,
  NaN for empty ground truth, nan-mean);
- :func:`confusion_matrix` / :func:`masked_confusion_matrix`:
  torchmetrics' confusion matrix, optionally row-normalized, and the one
  restricted to the forest land-use layer. Both count with
  :func:`bin_counts`, whose output length is fixed (JAX's ``bincount``
  with ``length``), so they trace into a compiled program, where
  ``torch.bincount``'s data-dependent length would break the graph.

Inside ``parallel.mesh.global_batch`` of several ranks :func:`fscore`'s
tp / fp / fn are the global batch's sums (all-reduced), as JAX's are over
a sharded batch.

Probabilities and one-hot tensors are (B, K, H, W).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from deadtrees_tpu_torch.parallel.mesh import batch_sum


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
    tp, s_pr, s_gt = batch_sum(torch.stack([torch.sum(gt * pr), torch.sum(pr), torch.sum(gt)]))
    fp = s_pr - tp
    fn = s_gt - tp
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


def bin_counts(idx: torch.Tensor, length: int) -> torch.Tensor:
    """``torch.bincount(idx, minlength=length)`` for ``idx`` in
    ``[0, length)``, as int64 of exactly ``length`` bins: a fixed-length
    ``scatter_add`` of ones, the same integers."""
    idx = idx.reshape(-1).long()
    return torch.zeros(length, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


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
    cm = bin_counts(idx, num_classes * num_classes)
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
    cm = bin_counts(idx, scratch + 1)[:-1]
    return _normalize_rows(cm.reshape(num_classes, num_classes), normalize)
