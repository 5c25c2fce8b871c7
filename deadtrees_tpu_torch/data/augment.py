"""Input normalization (counterpart of ``deadtrees_tpu.data.augment``).

Only ``normalize`` is ported so far: it is the one piece of the augment
module on the serving path. The training augmentations are queued in
ROADMAP.md.
"""

from __future__ import annotations

from typing import Sequence

import torch


def normalize(
    img_f32: torch.Tensor, mean: Sequence[float], std: Sequence[float]
) -> torch.Tensor:
    """albumentations Normalize for uint8-ranged channel-last input:
    ``(x - 255 m) / (255 s)``, in float32."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=img_f32.device) * 255.0
    std = torch.as_tensor(std, dtype=torch.float32, device=img_f32.device) * 255.0
    return (img_f32 - mean) / std
