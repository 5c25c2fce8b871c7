"""Block (un)tiling math: scene ↔ subtile batches.

Counterpart of ``deadtrees_tpu.infer.blocks``:

- ``*_chw``: the reference semantics ((C, H, W) → (N, C, d, d) and
  (N, d, d) → (H, W));
- ``*_nhwc``: the layout the scene predictor uses ((H, W, C) →
  (N, d, d, C)).

All four are pure reshapes and permutations, with subtiles in rows-of-
subtiles order. They take a torch tensor (on any device) or a numpy array
and return the kind they were given.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

Array = Union[torch.Tensor, np.ndarray]


def _permute(x: Array, axes: Sequence[int]) -> Array:
    return x.permute(*axes) if isinstance(x, torch.Tensor) else x.transpose(axes)


def make_blocks_chw(x: Array, d: int) -> Array:
    """(C, H, W) → (N, C, d, d), rows-of-subtiles order."""
    p, m, n = x.shape
    return _permute(x.reshape(-1, m // d, d, n // d, d), (1, 3, 0, 2, 4)).reshape(-1, p, d, d)


def unmake_blocks_chw(x: Array, d: int, m: int, n: int) -> Array:
    """(N, d, d) → (m, n); the subtiles are concatenated along axis 0 first,
    as the reference does."""
    cat = torch.cat(list(x)) if isinstance(x, torch.Tensor) else np.concatenate(list(x))
    return _permute(cat.reshape(m // d, n // d, d, d), (0, 2, 1, 3)).reshape(m, n)


def make_blocks_nhwc(x: Array, d: int) -> Array:
    """(H, W, C) → (N, d, d, C), same subtile order as the chw variant."""
    m, n, c = x.shape
    return _permute(x.reshape(m // d, d, n // d, d, c), (0, 2, 1, 3, 4)).reshape(-1, d, d, c)


def unmake_blocks_nhwc(x: Array, m: int, n: int) -> Array:
    """(N, d, d) or (N, d, d, C) → (m, n[, C])."""
    if x.ndim == 3:
        d = x.shape[1]
        return _permute(x.reshape(m // d, n // d, d, d), (0, 2, 1, 3)).reshape(m, n)
    d, c = x.shape[1], x.shape[3]
    return _permute(x.reshape(m // d, n // d, d, d, c), (0, 2, 1, 3, 4)).reshape(m, n, c)
