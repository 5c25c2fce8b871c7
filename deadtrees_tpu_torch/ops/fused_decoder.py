"""Fused EfficientUnet++ decoder: the whole dense grid on the fused kernels.

Counterpart of ``deadtrees_tpu.ops.fused_decoder``, both layouts.
Inference-only fast path; the dense-grid wiring of
``models/decoders.py:_DenseGridDecoder`` is reproduced functionally and
only the small segmentation head runs as a plain float32 conv. BatchNorms
are folded into conv weights once, at load.

- ``layout="chw"``: every decoder InvertedResidual — all 22 of the
  flagship — runs through :func:`fused_inverted_residual_chw` (kernel 1's
  two CUDA kernels on a CUDA tensor), in NCHW.
- ``layout="nhwc"``: the grid runs in NHWC; a block whose input is float32
  or bfloat16 with C_in ≥ 64 and a tile that JAX's ``_pick_th`` accepts
  runs through :func:`fused_ir_fat` (the NHWC kernel pair), every other
  block through the plain :func:`folded_block_nhwc` (torch's library ops,
  as JAX leaves them to XLA). ``fused_decoder_nhwc``'s ``block_fn`` swaps
  the block runner (the int8-activation path of ``infer/act_quant.py``).

Usage:
    folded = fold_effunetpp_decoder(model)        # once
    logits = fused_forward(model, folded, img)    # (B, classes, H, W) f32
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deadtrees_tpu_torch.models.blocks import upsample2x_nearest
from deadtrees_tpu_torch.ops import fused_cell
from deadtrees_tpu_torch.ops.depthwise import depthwise_conv2d
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


def _cast(fp: FoldedBlockParams, dtype: torch.dtype) -> FoldedBlockParams:
    return FoldedBlockParams(*(None if t is None else t.to(dtype) for t in fp))


def folded_block_nhwc(x: torch.Tensor, fp: FoldedBlockParams) -> torch.Tensor:
    """One BN-folded InvertedResidual in plain PyTorch on NHWC tensors,
    computed in x's dtype with the parameters cast to it (counterpart of
    ``folded_block_xla_nhwc``).

    KEEP IN SYNC with ``infer/act_quant.py`` ``folded_block_int8`` /
    ``folded_block_calibrate``, which restate this math with quantization
    and record hooks (drift guard: tests/test_torch_quantize.py)."""
    fp = _cast(fp, x.dtype)
    y = F.hardswish(x @ fp.w1 + fp.b1)
    h = F.hardswish(depthwise_conv2d(y, fp.dw[:, :, None]) + fp.b_dw)
    pooled = h.mean((1, 2))
    gate = torch.sigmoid(torch.relu(pooled @ fp.cse_w1 + fp.cse_b1) @ fp.cse_w2 + fp.cse_b2)
    s = torch.sigmoid(h @ fp.sse_w + fp.sse_b)
    scse = h * gate[:, None, None, :] + h * s
    out = scse @ fp.w2 + fp.b2
    if fp.wsk is not None:
        return out + (x @ fp.wsk + fp.bsk)
    return out + x


def takes_fat_kernel(x: torch.Tensor, fp: FoldedBlockParams) -> bool:
    """The JAX routing rule of ``_one_block_nhwc`` as it runs on the CPU
    (interpret mode, so without the TPU's W ≥ 128 clause): float32 or
    bfloat16 input, C_in ≥ 64, and a tile that ``_pick_th`` accepts."""
    _, hh, ww, cin = x.shape
    return (
        x.dtype in (torch.float32, torch.bfloat16)
        and cin >= 64
        and fused_cell._pick_th(hh, ww, cin, fp.w1.shape[1], 1) is not None
    )


def _one_block_nhwc(x: torch.Tensor, fp: FoldedBlockParams) -> torch.Tensor:
    """Fat cells run the NHWC kernel pair, thin ones the plain block."""
    if takes_fat_kernel(x, fp):
        return fused_cell.fused_ir_fat(x, fp)
    return folded_block_nhwc(x, fp)


def upsample2x_nearest_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2× nearest-neighbour upsampling of an NHWC tensor."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


BlockFn = Callable[[torch.Tensor, FoldedBlockParams, str], torch.Tensor]


def _cell_nhwc(folded: Folded, name: str, x: torch.Tensor, skip, block_fn: BlockFn):
    x = upsample2x_nearest_nhwc(x)
    if skip is not None:
        x = torch.cat([x] + list(skip), dim=-1)
    fp0, fp1 = folded[name]
    x = block_fn(x, fp0, f"{name}.0")
    return block_fn(x, fp1, f"{name}.1")


def fused_decoder_nhwc(
    features_nhwc: Sequence[torch.Tensor],
    folded: Folded,
    decoder_channels: Sequence[int],
    *,
    block_fn: Optional[BlockFn] = None,
) -> torch.Tensor:
    """Dense-grid decoder on BN-folded blocks, NHWC end to end; returns the
    full-resolution decoded map (NHWC).

    ``block_fn(x, fp, site) -> y`` runs one InvertedResidual (``site`` is
    ``"x_{d}_{l}.{0|1}"``); the default routes fat cells through
    :func:`fused_ir_fat` and thin ones through :func:`folded_block_nhwc`."""
    if block_fn is None:
        block_fn = lambda x, fp, site: _one_block_nhwc(x, fp)  # noqa: E731
    feats: List[torch.Tensor] = list(features_nhwc[1:])[::-1]
    depth = len(decoder_channels) - 1
    dense: Dict[Tuple[int, int], torch.Tensor] = {}
    for layer in range(depth):
        for d in range(depth - layer):
            li = d + layer
            if layer == 0:
                dense[(d, d)] = _cell_nhwc(
                    folded, f"x_{d}_{d}", feats[d], [feats[d + 1]], block_fn
                )
            else:
                cat = [dense[(idx, li)] for idx in range(d + 1, li + 1)]
                dense[(d, li)] = _cell_nhwc(
                    folded, f"x_{d}_{li}", dense[(d, li - 1)], cat + [feats[li + 1]],
                    block_fn,
                )
    return _cell_nhwc(folded, f"x_0_{depth}", dense[(0, depth - 1)], None, block_fn)


def encode_features(model, img: torch.Tensor) -> List[torch.Tensor]:
    """Encoder forward in the model's compute type → the NCHW feature
    pyramid, every level in that type. Honours the model's encoder
    conventions (``bn_eps`` / ``pad_type``)."""
    with model.autocast(img.device.type):
        feats = model.encoder(img)
    return [f.to(model.dtype) for f in feats]


def encode_features_nhwc(model, img: torch.Tensor) -> List[torch.Tensor]:
    """:func:`encode_features` with every level copied to a contiguous
    NHWC tensor (the encoder itself runs in NCHW, as on the other routes;
    the copies are the price of the NHWC decoder's layout)."""
    return [f.permute(0, 2, 3, 1).contiguous() for f in encode_features(model, img)]


def apply_head(model, decoded: torch.Tensor) -> torch.Tensor:
    """Segmentation head (3×3 conv, float32 logits) on the decoded map
    (NCHW, or an NCHW view of an NHWC map)."""
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
    rounding. ``layout`` is ``"chw"`` (kernel 1) or ``"nhwc"`` (the fat-cell
    kernels)."""
    if layout == "nhwc":
        feats = encode_features_nhwc(model, img)
        decoded = fused_decoder_nhwc(feats, folded, model.decoder_channels)
        return apply_head(model, decoded.permute(0, 3, 1, 2))
    if layout != "chw":
        raise ValueError(f"layout={layout!r}; expected 'chw' or 'nhwc'")
    feats = encode_features(model, img)
    decoded = fused_decoder_chw(feats, folded, model.decoder_channels)
    return apply_head(model, decoded)
