"""NN building blocks of the decoder zoo (PyTorch, NCHW).

Counterparts of ``deadtrees_tpu.models.blocks``, laid out with the
reference smp module structure so that ``state_dict()`` keys match the
reference checkpoints: the inverted residual (``block.0`` expand,
``block.3`` depthwise, ``block.6.cSE``/``sSE``, ``block.7`` project,
``skip_conv``), the conv-BN-ReLU pair (``conv1.0`` / ``conv1.1``), the
attention wrapper (``attention1.attention.cSE.1``), the ResUnet++ ASPP
(``aspp_block{1..4}.0`` conv / ``.2`` BN, ``output``) and attention gate
(``decoder_conv`` / ``encoder_conv`` / ``attn_conv``, BN at 0, conv at 2),
and ``segmentation_head.0``.

Only the default (single-tensor) InvertedResidual path is ported: the JAX
package's env-gated layout experiments compute the same numbers.

Every BatchNorm of the port is :class:`BatchNorm2d`, which trains with
flax's semantics (biased running variance), over the global batch of a
data-parallel step (``parallel/mesh.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from deadtrees_tpu_torch.parallel.mesh import active_mesh


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the ranks' global batch: the per-channel
    sums of x and x² and the count are all-reduced once in the forward,
    the sums of dy and dy·x̂ once in the backward, as the normalization
    couples every sample of the global batch. The sums accumulate in
    float64 (torch's CPU BatchNorm does too): float32 sums put the deepest
    layers' gradients of a small model 30 × further from a float64
    reference than the one-process BatchNorm. Saves x in its own type."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        xf = x.float()
        count = torch.full((1,), x.numel() // c, dtype=torch.float64, device=x.device)
        stats = torch.cat([xf.sum((0, 2, 3), dtype=torch.float64),
                           (xf * xf).sum((0, 2, 3), dtype=torch.float64), count])
        dist.all_reduce(stats, group=group)
        n = stats[-1]
        mean64 = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean64 * mean64, min=0.0).float()
        mean = mean64.float()
        invstd = torch.rsqrt(var + eps)
        scale = invstd * weight.float()
        y = (xf - mean[:, None, None]) * scale[:, None, None] + bias.float()[:, None, None]
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]
        g = gy.float()
        xhat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        sums = torch.cat([g.sum((0, 2, 3), dtype=torch.float64),
                          (g * xhat).sum((0, 2, 3), dtype=torch.float64)])
        grad_bias, grad_weight = sums[:c].float(), sums[c:].float()
        dist.all_reduce(sums, group=ctx.group)
        mean_dy, mean_dy_xhat = (sums[:c] / ctx.n).float(), (sums[c:] / ctx.n).float()
        gx = (g - mean_dy[:, None, None] - xhat * mean_dy_xhat[:, None, None]) * (
            invstd * weight.float())[:, None, None]
        return (gx.to(x.dtype), grad_weight.to(weight.dtype), grad_bias.to(weight.dtype),
                None, None)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax ``nn.BatchNorm`` train-mode semantics.

    In train mode it normalizes with the biased batch variance (as torch
    does) and moves ``running_var`` toward the *biased* variance too, where
    torch would take the unbiased one; ``momentum`` 0.1 is flax's 0.9.
    The statistics are taken in float32 whatever the input type, as flax
    takes them. Eval mode and the ``state_dict()`` keys are torch's own.

    Inside ``parallel.mesh.global_batch`` of several ranks the statistics
    are those of the global batch (:class:`_GlobalBatchNorm`), as XLA
    computes them for the JAX step under a mesh; ``nn.SyncBatchNorm`` would
    move ``running_var`` toward the unbiased variance. Otherwise nothing
    changes, the numbers included.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mesh = active_mesh()
        if mesh is not None:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps,
                                                  mesh.group)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean * m)
                self.running_var.mul_(1.0 - m).add_(var * m)
                self.num_batches_tracked.add_(1)
            return y
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


class Attention(nn.Module):
    """smp's attention wrapper (the JAX package's ``make_attention``):
    ``self.attention`` is an SCSE (``"scse"``) or SE (``"se"``) module of
    reduction 16, or an identity with no parameters for ``name=None``."""

    def __init__(self, name, channels: int):
        super().__init__()
        if name is None:
            self.attention = nn.Identity()
        elif name == "scse":
            self.attention = SCSEModule(channels)
        elif name == "se":
            self.attention = SEModule(channels)
        else:
            raise ValueError(f"Attention {name} is not implemented")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention(x)


class ConvBnAct(nn.Sequential):
    """conv → BatchNorm → ReLU (the reference ``Conv2dReLU``, which also
    stands in for its identically ordered ``PreActivatedConv2dReLU``);
    the conv is bias-free, BatchNorm eps 1e-5."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3):
        super().__init__(
            nn.Conv2d(in_channels, features, kernel_size, padding=kernel_size // 2,
                      bias=False),
            BatchNorm2d(features, eps=1e-5),
            nn.ReLU(),
        )


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling bridge of ResUnet++: three dilated
    3×3 branches (rates 6/12/18) and one plain 3×3, each conv → ReLU → BN
    in that (unusual) order with biased convs, concatenated and merged by
    a biased 1×1 conv."""

    def __init__(self, in_channels: int, features: int, rates=(6, 12, 18)):
        super().__init__()
        for i, rate in enumerate(tuple(rates) + (1,), start=1):
            setattr(self, f"aspp_block{i}", nn.Sequential(
                nn.Conv2d(in_channels, features, 3, padding=rate, dilation=rate),
                nn.ReLU(),
                BatchNorm2d(features, eps=1e-5),
            ))
        self.n_branches = len(rates) + 1
        self.output = nn.Conv2d(self.n_branches * features, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [getattr(self, f"aspp_block{i}")(x) for i in range(1, self.n_branches + 1)]
        return self.output(torch.cat(outs, dim=1))


def _bn_relu_conv(in_channels: int, features: int, kernel_size: int) -> nn.Sequential:
    return nn.Sequential(
        BatchNorm2d(in_channels, eps=1e-5),
        nn.ReLU(),
        nn.Conv2d(in_channels, features, kernel_size, padding=kernel_size // 2),
    )


class RUPPAttentionBlock(nn.Module):
    """ResUnet++ decoder attention gate: BN → ReLU → 3×3 conv of the
    decoder stream, plus the same of the skip max-pooled 2×2 when there
    is one, then BN → ReLU → 1×1 conv back to the input width; the spatial
    mean of that is the per-channel gate on x."""

    def __init__(self, in_channels: int, skip_channels: int, features: int):
        super().__init__()
        if skip_channels:
            self.encoder_conv = _bn_relu_conv(skip_channels, features, 3)
        self.decoder_conv = _bn_relu_conv(in_channels, features, 3)
        self.attn_conv = _bn_relu_conv(features, in_channels, 1)

    def forward(self, x: torch.Tensor, skip=None) -> torch.Tensor:
        out = self.decoder_conv(x)
        if skip is not None:
            out = out + F.max_pool2d(self.encoder_conv(skip), 2, 2)
        out = self.attn_conv(out)
        return out.mean((2, 3), keepdim=True) * x


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
