"""Calibrated int8 activation storage for the BN-folded decoder (serving).

Counterpart of ``deadtrees_tpu.infer.act_quant``: the decoder's
intra-block activations (y = post-expand, h = post-depthwise, s =
post-SCSE) are rounded through int8 with per-channel scales, calibrated on
one batch (``scale = 1.1 · absmax / 127``), in the blocks that
``fused_decoder_nhwc`` runs through its ``block_fn``. As in JAX there is
no kernel here: these are plain torch ops, and the w8a8 route launches no
fat-cell kernel. ``torch.round`` rounds half to even like ``jnp.round``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from deadtrees_tpu_torch.ops.depthwise import depthwise_conv2d
from deadtrees_tpu_torch.ops.fused_decoder import _cast, fused_decoder_nhwc
from deadtrees_tpu_torch.ops.fused_mbconv import FoldedBlockParams

ALL_SITES = frozenset(("y", "h", "s"))


def _quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float32 → int8 with a per-channel scale."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _dequant(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def folded_block_int8(
    x: torch.Tensor,
    fp: FoldedBlockParams,
    scales: Dict[str, torch.Tensor],
    sites: frozenset = ALL_SITES,
) -> torch.Tensor:
    """One BN-folded InvertedResidual (NHWC) with int8 y/h/s storage.

    Compute stays in x's dtype; only the pooled-gate math runs in float32.
    KEEP IN SYNC with ``ops/fused_decoder.py`` ``folded_block_nhwc`` and
    :func:`folded_block_calibrate` (drift guard:
    tests/test_torch_quantize.py)."""
    dtype = x.dtype
    fpc = _cast(fp, dtype)

    y = F.hardswish((x @ fpc.w1 + fpc.b1).float())
    y = _dequant(_quant(y, scales["y"]), scales["y"], dtype) if "y" in sites else y.to(dtype)

    h = F.hardswish((depthwise_conv2d(y, fpc.dw[:, :, None]) + fpc.b_dw).float())
    hf = _dequant(_quant(h, scales["h"]), scales["h"], dtype) if "h" in sites else h.to(dtype)
    pooled = hf.float().mean((1, 2))
    z = torch.relu(pooled @ fp.cse_w1 + fp.cse_b1)
    gate = torch.sigmoid(z @ fp.cse_w2 + fp.cse_b2)
    s = torch.sigmoid(hf @ fpc.sse_w + fpc.sse_b)
    scse = hf * gate[:, None, None, :].to(dtype) + hf * s
    if "s" in sites:
        scse = _dequant(_quant(scse.float(), scales["s"]), scales["s"], dtype)

    out = scse @ fpc.w2 + fpc.b2
    if fp.wsk is not None:
        out = out + (x @ fpc.wsk + fpc.bsk)
    else:
        out = out + x
    return out.to(dtype)


def folded_block_calibrate(
    x: torch.Tensor, fp: FoldedBlockParams, record: Dict[str, torch.Tensor], site: str
) -> torch.Tensor:
    """The same math in x's dtype, recording the per-channel float32
    absmax of y, h and s at ``record["{site}.{y|h|s}"]``."""
    dtype = x.dtype
    fpc = _cast(fp, dtype)

    def amax(t):
        return t.float().abs().amax((0, 1, 2))

    y = F.hardswish((x @ fpc.w1 + fpc.b1).float()).to(dtype)
    record[f"{site}.y"] = amax(y)
    h = F.hardswish((depthwise_conv2d(y, fpc.dw[:, :, None]) + fpc.b_dw).float()).to(dtype)
    record[f"{site}.h"] = amax(h)

    pooled = h.float().mean((1, 2))
    z = torch.relu(pooled @ fp.cse_w1 + fp.cse_b1)
    gate = torch.sigmoid(z @ fp.cse_w2 + fp.cse_b2)
    s = torch.sigmoid(h @ fpc.sse_w + fpc.sse_b)
    scse = h * gate[:, None, None, :].to(dtype) + h * s
    record[f"{site}.s"] = amax(scse)

    out = scse @ fpc.w2 + fpc.b2
    if fp.wsk is not None:
        out = out + (x @ fpc.wsk + fpc.bsk)
    else:
        out = out + x
    return out.to(dtype)


def calibrate_decoder(
    features_nhwc: Sequence[torch.Tensor],
    folded: Dict[str, Tuple[FoldedBlockParams, FoldedBlockParams]],
    decoder_channels: Sequence[int],
) -> Dict[str, torch.Tensor]:
    """One calibration pass over the decoder: site → per-channel scale,
    with a ×1.1 margin against calibration-batch under-coverage."""
    record: Dict[str, torch.Tensor] = {}

    def block_fn(x, fp, site):
        return folded_block_calibrate(x, fp, record, site)

    fused_decoder_nhwc(features_nhwc, folded, decoder_channels, block_fn=block_fn)
    return {k: torch.clamp(v * 1.1, min=1e-6) / 127.0 for k, v in record.items()}


def make_int8_block_fn(
    scales: Dict[str, torch.Tensor], sites: frozenset = ALL_SITES
) -> Callable:
    """``block_fn`` for ``fused_decoder_nhwc`` that stores the activations
    of ``sites`` as int8 with the calibrated ``scales``."""

    def block_fn(x, fp, site):
        s = {k: scales[f"{site}.{k}"] for k in ("y", "h", "s")}
        return folded_block_int8(x, fp, s, sites=sites)

    return block_fn
