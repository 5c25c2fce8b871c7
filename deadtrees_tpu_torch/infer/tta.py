"""Test-time augmentation: dihedral-group probability ensembling.

Counterpart of ``deadtrees_tpu.infer.tta`` on NHWC tensors.
``make_tta_fn`` wraps a logits function so that it runs every orientation
of the dihedral group (4 rotations × an optional flip = 8 views, or the
4 rotations), maps each view's probabilities back to the input frame and
averages them. Averaging over the whole group makes the predictor
equivariant: a rotated or flipped tile gives the rotated or flipped
prediction. Views run one after another, so only one view's activations
are live at a time.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

__all__ = ["DIHEDRAL", "ROTATIONS", "apply_view", "invert_view", "make_tta_fn"]

# (k, flip): rotate by k·90° counter-clockwise over (H, W), then optionally
# flip along W. The inverse undoes in reverse order.
ROTATIONS: List[Tuple[int, bool]] = [(k, False) for k in range(4)]
DIHEDRAL: List[Tuple[int, bool]] = ROTATIONS + [(k, True) for k in range(4)]


def apply_view(x: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    """Transform an NHWC (or NHW...) batch into view (k, flip)."""
    x = torch.rot90(x, k, dims=(1, 2))
    if flip:
        x = torch.flip(x, dims=(2,))
    return x


def invert_view(y: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    """Map view-(k, flip) outputs back to the input frame."""
    if flip:
        y = torch.flip(y, dims=(2,))
    return torch.rot90(y, -k, dims=(1, 2))


def make_tta_fn(
    logits_fn: Callable[[torch.Tensor], torch.Tensor], views: int = 8
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap ``logits_fn(img_nhwc) -> logits_nhwc`` with ``views``-fold TTA
    (8: the dihedral group; 4: rotations). The wrapped function returns the
    mean float32 softmax probabilities over the views, NHWC, in the input
    frame. Tiles must be square (rot90 views)."""
    if views == 8:
        group = DIHEDRAL
    elif views == 4:
        group = ROTATIONS
    else:
        raise ValueError(f"views must be 4 or 8, got {views}")

    def tta(img: torch.Tensor) -> torch.Tensor:
        if img.shape[1] != img.shape[2]:
            raise ValueError(f"TTA needs square tiles (rot90 views), got {tuple(img.shape)}")
        acc = None
        for k, f in group:
            probs = torch.softmax(logits_fn(apply_view(img, k, f)).float(), dim=-1)
            inv = invert_view(probs, k, f)
            acc = inv if acc is None else acc + inv
        return acc / len(group)

    return tta
