"""2-bit packed class maps — the serving wire format for ≤4-class outputs.

Counterpart of ``deadtrees_tpu.infer.packing``: a (B, H, W) uint8 class
map with 3 classes carries 6 wasted bits per pixel; packing 4 pixels per
byte cuts device→host transfer and network payloads 4×. ``pack2`` takes a
torch tensor (on any device) or a numpy array; ``unpack2`` is a host
numpy op. Pixel i of a group of four sits in bits 2i..2i+1.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

Array = Union[torch.Tensor, np.ndarray]


def pack2(classmap: Array) -> Array:
    """(..., W) uint8 class ids < 4 → (..., ceil(W/4)) uint8, 4 px/byte.
    Returns the input's kind (tensor on its device, or numpy)."""
    if isinstance(classmap, np.ndarray):
        return pack2(torch.from_numpy(np.ascontiguousarray(classmap))).numpy()
    w = classmap.shape[-1]
    pad = (-w) % 4
    x = classmap.to(torch.uint8)
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.reshape(x.shape[:-1] + (-1, 4))
    return x[..., 0] | (x[..., 1] << 2) | (x[..., 2] << 4) | (x[..., 3] << 6)


def unpack2(packed: Array, width: int) -> np.ndarray:
    """Inverse of :func:`pack2` on host: (..., W/4) uint8 → (..., width)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    p = np.asarray(packed, np.uint8)
    out = np.stack(
        [(p >> s) & 0b11 for s in (0, 2, 4, 6)], axis=-1
    ).reshape(p.shape[:-1] + (-1,))
    return out[..., :width]
