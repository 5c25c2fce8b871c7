"""Fused EfficientUnet++ decoder: the whole dense grid on the fused kernels.

Counterpart of ``deadtrees_tpu.ops.fused_decoder`` (``layout="chw"``).
Inference-only fast path: every decoder InvertedResidual — all 22 of the
flagship — runs through :func:`fused_inverted_residual_chw` (the two CUDA
kernels on a CUDA tensor), the dense-grid wiring of
``models/decoders.py:_DenseGridDecoder`` is reproduced functionally in
NCHW, and only the small segmentation head runs as a plain float32 conv.
BatchNorms are folded into conv weights once, at load.

Usage:
    folded = fold_effunetpp_decoder(model)        # once
    logits = fused_forward(model, folded, img)    # (B, classes, H, W) f32
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from deadtrees_tpu_torch.models.blocks import upsample2x_nearest
from deadtrees_tpu_torch.ops.fused_mbconv import (
    FoldedBlockParams,
    fold_inverted_residual,
    fused_inverted_residual_chw,
)

Folded = Dict[str, Tuple[FoldedBlockParams, FoldedBlockParams]]


def fold_effunetpp_decoder(model) -> Folded:
    """Fold every decoder grid cell's two InvertedResiduals."""
    return {
        name: (fold_inverted_residual(cell.conv1), fold_inverted_residual(cell.conv2))
        for name, cell in model.decoder.blocks.items()
    }


def folded_block(x: torch.Tensor, fp: FoldedBlockParams) -> torch.Tensor:
    """One BN-folded InvertedResidual in plain PyTorch, computed in x's
    dtype (counterpart of ``folded_block_xla``)."""
    cm = fp.w1.shape[1]
    fp = FoldedBlockParams(*(None if t is None else t.to(x.dtype) for t in fp))
    y = F.hardswish(F.conv2d(x, fp.w1.t()[:, :, None, None], fp.b1))
    h = F.hardswish(F.conv2d(
        y, fp.dw.permute(2, 0, 1)[:, None], fp.b_dw,
        padding=fp.dw.shape[0] // 2, groups=cm,
    ))
    pooled = h.mean((2, 3))
    gate = torch.sigmoid(torch.relu(pooled @ fp.cse_w1 + fp.cse_b1) @ fp.cse_w2 + fp.cse_b2)
    s = torch.sigmoid(torch.einsum("bchw,c->bhw", h, fp.sse_w[:, 0]) + fp.sse_b[0])
    scse = h * gate[:, :, None, None] + h * s[:, None]
    out = F.conv2d(scse, fp.w2.t()[:, :, None, None], fp.b2)
    if fp.wsk is not None:
        return out + F.conv2d(x, fp.wsk.t()[:, :, None, None], fp.bsk)
    return out + x


def _cell(folded: Folded, name: str, x: torch.Tensor, skip) -> torch.Tensor:
    """One decoder grid cell: up2x → concat skip → fused block ×2."""
    x = upsample2x_nearest(x)
    if skip is not None:
        x = torch.cat([x] + list(skip), dim=1)
    fp0, fp1 = folded[name]
    x = fused_inverted_residual_chw(x, fp0)
    return fused_inverted_residual_chw(x, fp1)


def fused_decoder_chw(
    features: Sequence[torch.Tensor],
    folded: Folded,
    decoder_channels: Sequence[int],
) -> torch.Tensor:
    """Dense-grid decoder forward on the smp feature pyramid (NCHW);
    returns the full-resolution decoded map (NCHW)."""
    feats: List[torch.Tensor] = list(features[1:])[::-1]
    depth = len(decoder_channels) - 1
    dense: Dict[Tuple[int, int], torch.Tensor] = {}
    for layer in range(depth):
        for d in range(depth - layer):
            li = d + layer
            if layer == 0:
                dense[(d, d)] = _cell(folded, f"x_{d}_{d}", feats[d], [feats[d + 1]])
            else:
                cat = [dense[(idx, li)] for idx in range(d + 1, li + 1)]
                dense[(d, li)] = _cell(
                    folded, f"x_{d}_{li}", dense[(d, li - 1)], cat + [feats[li + 1]]
                )
    return _cell(folded, f"x_0_{depth}", dense[(0, depth - 1)], None)


def encode_features(model, img: torch.Tensor) -> List[torch.Tensor]:
    """Encoder forward in the model's compute type → the NCHW feature
    pyramid, every level in that type. Honours the model's encoder
    conventions (``bn_eps`` / ``pad_type``)."""
    with model.autocast(img.device.type):
        feats = model.encoder(img)
    return [f.to(model.dtype) for f in feats]


def apply_head(model, decoded: torch.Tensor) -> torch.Tensor:
    """Segmentation head (3×3 conv, float32 logits) on the decoded map."""
    head = model.segmentation_head[0]
    with torch.autocast(decoded.device.type, enabled=False):
        return F.conv2d(
            decoded.float(), head.weight.float(), head.bias.float(),
            padding=head.padding,
        )


def fused_forward(model, folded: Folded, img: torch.Tensor, *,
                  layout: str = "chw") -> torch.Tensor:
    """Full flagship forward: encoder → fused decoder → float32 head.

    ``img`` is the normalized (B, in_channels, H, W) float input; returns
    (B, classes, H, W) float32 logits, equal to ``model(img)`` up to
    rounding. Only ``layout="chw"`` is ported."""
    if layout != "chw":
        raise NotImplementedError(
            f"layout={layout!r}: the NHWC fat-cell kernels are not ported yet "
            "(ROADMAP.md, 'fused_decoder=\"nhwc\"')"
        )
    feats = encode_features(model, img)
    decoded = fused_decoder_chw(feats, folded, model.decoder_channels)
    return apply_head(model, decoded)
