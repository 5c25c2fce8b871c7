"""Representation conversions for segmentation targets (channel-first).

Counterpart of ``deadtrees_tpu.losses.functional``: one-hot encoding,
argmax decoding and the signed-distance maps of the boundary loss. The
port's tensors are channel-first, as the model emits them: one-hot and
probabilities are (B, K, H, W), distance maps (B, K, H, W) or (K, H, W).

The exact Euclidean distance transform keeps the JAX package's two-pass
design, in the same float32 arithmetic: per-column distances from a
cummax scan down the columns and a cummin scan up them, then for each row
the lower envelope ``min_x' ((x - x')² + g²[y, x'])`` as a broadcast min,
in row blocks of at most 16 M floats (unchunked, a 512² mask would need
512 MB per class). This is XLA in the JAX package, not a Pallas kernel:
plain torch here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_BIG = 1e12  # "infinity" for squared pixel distances; > (2*8192)**2
_ENVELOPE_FLOATS = 16 * 2**20  # live floats of one row block


def class2one_hot(seg: torch.Tensor, K: int) -> torch.Tensor:
    """Integer mask (B, H, W) → float32 one-hot (B, K, H, W)."""
    return F.one_hot(seg.long(), K).permute(0, 3, 1, 2).float()


def probs2class(probs: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W) probabilities → (B, H, W) class indices."""
    return probs.argmax(1)


def probs2one_hot(probs: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W) probabilities → hard one-hot of the argmax."""
    return class2one_hot(probs2class(probs), probs.shape[1])


def _nearest_true_1d(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-pixel distance (in pixels) to the nearest True element along
    ``dim``; lines with no True element get a distance near _BIG."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.float32, device=mask.device).reshape(shape)
    idx = idx.expand(mask.shape)
    seed_fwd = torch.where(mask, idx, torch.full_like(idx, -_BIG))
    d_before = idx - torch.cummax(seed_fwd, dim).values
    seed_bwd = torch.where(mask, idx, torch.full_like(idx, 2 * _BIG))
    after = torch.cummin(torch.flip(seed_bwd, (dim,)), dim).values
    d_after = torch.flip(after, (dim,)) - idx
    return torch.minimum(d_before, d_after)


def _row_envelope_min(g2: torch.Tensor) -> torch.Tensor:
    """d2[..., y, x] = min_x' ((x - x')² + g2[..., y, x']), over blocks of
    rows that keep at most 16 M floats live."""
    w = g2.shape[-1]
    rows = g2.reshape(-1, w)
    x = torch.arange(w, dtype=torch.float32, device=g2.device)
    dx2 = (x[:, None] - x[None, :]) ** 2  # (W, W')
    chunk = max(1, _ENVELOPE_FLOATS // (w * w))
    out = torch.empty_like(rows)
    for start in range(0, rows.shape[0], chunk):
        block = rows[start:start + chunk]
        out[start:start + chunk] = (dx2[None] + block[:, None, :]).amin(-1)
    return out.reshape(g2.shape)


def edt(mask: torch.Tensor) -> torch.Tensor:
    """Exact Euclidean distance to the nearest True pixel of boolean masks
    (..., H, W), each 2D mask on its own; 0 on True pixels. Equivalent to
    ``scipy.ndimage.distance_transform_edt(~mask)``; every pixel of an
    all-False mask gets the large finite value sqrt(1e12) = 1e6."""
    g = _nearest_true_1d(mask, dim=mask.dim() - 2)
    g2 = torch.clamp(g * g, max=_BIG)
    return torch.sqrt(_row_envelope_min(g2))


def batch_one_hot2dist(seg: torch.Tensor) -> torch.Tensor:
    """Signed distance maps for the boundary loss, (..., K, H, W) →
    (..., K, H, W) float32. For each class k with pos = seg[k] > 0.5:

        res_k = edt_to_pos · neg − (edt_to_neg − 1) · pos

    positive outside the class region, negative inside, and a zero map for
    a class absent from the tile."""
    pos = seg > 0.5
    neg = ~pos
    d = edt(torch.stack([pos, neg]))
    d_out = d[0] * neg.float()
    d_in = (d[1] - 1.0) * pos.float()
    res = d_out - d_in
    any_pos = pos.flatten(-2).any(-1)[..., None, None]
    return torch.where(any_pos, res, torch.zeros_like(res))


def one_hot2dist(seg: torch.Tensor) -> torch.Tensor:
    """One tile's signed distance maps, (K, H, W) → (K, H, W)."""
    return batch_one_hot2dist(seg)
