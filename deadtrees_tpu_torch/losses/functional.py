"""Representation conversions for segmentation targets (channel-first).

Counterpart of ``deadtrees_tpu.losses.functional``: one-hot encoding,
argmax decoding and the signed-distance maps of the boundary loss. The
port's tensors are channel-first, as the model emits them: one-hot and
probabilities are (B, K, H, W), distance maps (B, K, H, W) or (K, H, W).

The distance maps and the exact Euclidean distance transform live in
``ops/edt.py`` beside their kernels: :func:`batch_one_hot2dist` is the
custom op ``deadtrees::signed_distance_maps`` (two hand-written kernels
on a CUDA tensor, the plain two-pass EDT on a CPU tensor); :func:`edt`
and :func:`batch_one_hot2dist_reference` are the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deadtrees_tpu_torch.ops.edt import (  # noqa: F401  (re-exported)
    batch_one_hot2dist_reference,
    edt,
    signed_distance_maps,
)


def class2one_hot(seg: torch.Tensor, K: int) -> torch.Tensor:
    """Integer mask (B, H, W) → float32 one-hot (B, K, H, W)."""
    return F.one_hot(seg.long(), K).permute(0, 3, 1, 2).float()


def probs2class(probs: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W) probabilities → (B, H, W) class indices."""
    return probs.argmax(1)


def probs2one_hot(probs: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W) probabilities → hard one-hot of the argmax."""
    return class2one_hot(probs2class(probs), probs.shape[1])


def batch_one_hot2dist(seg: torch.Tensor) -> torch.Tensor:
    """Signed distance maps for the boundary loss, (..., K, H, W) →
    (..., K, H, W) float32. For each class k with pos = seg[k] > 0.5:

        res_k = edt_to_pos · neg − (edt_to_neg − 1) · pos

    positive outside the class region, negative inside, and a zero map for
    a class absent from the tile. The custom op
    ``deadtrees::signed_distance_maps``: on a CUDA tensor the EDT's two
    kernels (a float32 one-hot with 1 ≤ H, W ≤ 8,192, or it raises), on a
    CPU tensor :func:`batch_one_hot2dist_reference`."""
    return signed_distance_maps(seg)


def one_hot2dist(seg: torch.Tensor) -> torch.Tensor:
    """One tile's signed distance maps, (K, H, W) → (K, H, W)."""
    return batch_one_hot2dist(seg)
