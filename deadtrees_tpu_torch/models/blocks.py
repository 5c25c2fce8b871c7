"""NN building blocks of the EfficientUnet++ decoder (PyTorch, NCHW).

Counterparts of ``deadtrees_tpu.models.blocks``, laid out with the
reference smp module structure so that ``state_dict()`` keys match the
reference checkpoints (``block.0`` expand, ``block.3`` depthwise,
``block.6.cSE``/``sSE``, ``block.7`` project, ``skip_conv``,
``segmentation_head.0``).

Only the default (single-tensor) InvertedResidual path is ported: the JAX
package's env-gated layout experiments compute the same numbers.

Every BatchNorm of the port is :class:`BatchNorm2d`, which trains with
flax's semantics (biased running variance).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax ``nn.BatchNorm`` train-mode semantics.

    In train mode it normalizes with the biased batch variance (as torch
    does) and moves ``running_var`` toward the *biased* variance too, where
    torch would take the unbiased one; ``momentum`` 0.1 is flax's 0.9.
    The statistics are taken in float32 whatever the input type, as flax
    takes them. Eval mode and the ``state_dict()`` keys are torch's own.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean * m)
            self.running_var.mul_(1.0 - m).add_(var * m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsampling for NCHW tensors
    (``F.interpolate(x, scale_factor=2, mode="nearest")``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class SEModule(nn.Sequential):
    """Channel squeeze-excitation: ``x * sigmoid(conv(relu(conv(mean x))))``.

    Indexed like the reference ``cSE`` Sequential (convs at 1 and 3)."""

    def __init__(self, channels: int, reduction: int = 16):
        hidden = max(channels // reduction, 1)
        super().__init__(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(channels, hidden, 1),
            nn.ReLU(),
            nn.Conv2d(hidden, channels, 1),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * super().forward(x)


class SSEModule(nn.Sequential):
    """Spatial squeeze-excitation: ``x * sigmoid(conv1x1(x) -> 1 channel)``."""

    def __init__(self, channels: int):
        super().__init__(nn.Conv2d(channels, 1, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * super().forward(x)


class SCSEModule(nn.Module):
    """Concurrent spatial + channel SE: ``cSE(x) + sSE(x)``."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.cSE = SEModule(channels, reduction)
        self.sSE = SSEModule(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cSE(x) + self.sSE(x)


class InvertedResidual(nn.Module):
    """Inverted bottleneck residual with embedded SCSE.

    pointwise-expand → BN → hardswish → depthwise → BN → hardswish →
    SCSE(reduction=squeeze_ratio) → pointwise-project → BN, plus a residual
    connection (1×1 conv + BN on the skip when channel counts differ).
    BatchNorm eps is 1e-5, as in the JAX block.
    """

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 3,
        expansion_ratio: int = 1,
        squeeze_ratio: int = 1,
    ):
        super().__init__()
        mid = in_channels * expansion_ratio
        self.kernel_size = kernel_size
        self.block = nn.Sequential(
            nn.Conv2d(in_channels, mid, 1),
            BatchNorm2d(mid, eps=1e-5),
            nn.Hardswish(),
            nn.Conv2d(
                mid, mid, kernel_size, padding=kernel_size // 2, groups=mid
            ),
            BatchNorm2d(mid, eps=1e-5),
            nn.Hardswish(),
            SCSEModule(mid, squeeze_ratio),
            nn.Conv2d(mid, features, 1),
            BatchNorm2d(features, eps=1e-5),
        )
        self.skip_conv = (
            nn.Sequential(
                nn.Conv2d(in_channels, features, 1),
                BatchNorm2d(features, eps=1e-5),
            )
            if in_channels != features
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = self.block(x)
        if self.skip_conv is not None:
            x = self.skip_conv(x)
        return x + residual


class SegmentationHead(nn.Sequential):
    """Final k×k conv producing per-class logits; output is float32
    whatever the compute type."""

    def __init__(self, in_channels: int, classes: int, kernel_size: int = 3):
        super().__init__(
            nn.Conv2d(in_channels, classes, kernel_size, padding=kernel_size // 2)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).float()
