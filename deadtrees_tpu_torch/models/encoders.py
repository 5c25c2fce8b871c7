"""ResNet-18/34/50 and EfficientNet-B0..B7 feature extractors (PyTorch, NCHW).

(The MiT encoders mit_b0 … mit_b5, which :func:`get_encoder` also builds,
are in ``models/mit.py``.)

Counterpart of ``deadtrees_tpu.models.encoders``. The ResNets keep the
torchvision key scheme smp's resnet encoders load (``conv1``, ``bn1``,
``layer{1..4}.{block}.conv{1,2[,3]} / bn{1,2[,3]} / downsample.0 / .1``);
the EfficientNets keep the timm state-dict key scheme smp's
timm-efficientnet encoders load (``conv_stem``, ``bn1``, ``blocks.{stage}.{block}.conv_pw /
bn1 / conv_dw / bn2 / se.conv_reduce / se.conv_expand / conv_pwl / bn3``;
the expand-ratio-1 stage-1 blocks are ``conv_dw / bn1 / se / conv_pw /
bn2``).

Both forward conventions of the JAX encoder stay selectable:
``bn_eps`` 1e-3 (default) or 1e-5, and ``pad_type`` "static" (torch k//2
padding) or "same" (TF-SAME: a dynamic asymmetric pad, then a VALID conv).
The ResNets have one convention (torchvision's: BatchNorm eps 1e-5,
symmetric padding) and take neither option.
"""

from __future__ import annotations

import logging
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deadtrees_tpu_torch.models.blocks import BatchNorm2d

log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# ResNet (torchvision layout: resnet18 / resnet34 basic, resnet50 bottleneck)
# ---------------------------------------------------------------------------


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1):
    conv = nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=False)
    return conv, BatchNorm2d(cout, eps=1e-5)


class BasicBlock(nn.Module):
    """torchvision ResNet basic block: two 3×3 convs (the stride on the
    first, padded (1, 1) as torch pads) + identity, 1×1 projection when the
    shape changes."""

    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(in_channels, features, 3, stride)
        self.conv2, self.bn2 = _conv_bn(features, features, 3)
        self.downsample = None
        if stride != 1 or in_channels != features:
            self.downsample = nn.Sequential(*_conv_bn(in_channels, features, 1, stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


class Bottleneck(nn.Module):
    """torchvision ResNet bottleneck: 1×1 reduce → 3×3 (the stride here) →
    1×1 expand ×4, 1×1 projection when the shape changes."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1, self.bn1 = _conv_bn(in_channels, features, 1)
        self.conv2, self.bn2 = _conv_bn(features, features, 3, stride)
        self.conv3, self.bn3 = _conv_bn(features, out, 1)
        self.downsample = None
        if stride != 1 or in_channels != out:
            self.downsample = nn.Sequential(*_conv_bn(in_channels, out, 1, stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


RESNET_WIDTHS = (64, 128, 256, 512)


class ResNetEncoder(nn.Module):
    """ResNet backbone emitting the 6-level smp feature pyramid: the input,
    the stem activation (reduction 2), then the output of each of the four
    stages (reductions 4, 8, 16, 32). The stem max-pool is 3×3 stride 2
    padded with -inf, ``F.max_pool2d(x, 3, 2, 1)``."""

    def __init__(self, stage_sizes: Sequence[int], block: str = "basic",
                 in_channels: int = 3):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(in_channels, 64, 7, 2)
        block_cls = BasicBlock if block == "basic" else Bottleneck
        cin = 64
        for stage, (n, width) in enumerate(zip(stage_sizes, RESNET_WIDTHS)):
            blocks = []
            for i in range(n):
                blocks.append(block_cls(cin, width, 2 if stage > 0 and i == 0 else 1))
                cin = width * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        h = F.relu(self.bn1(self.conv1(x)))
        features.append(h)
        h = F.max_pool2d(h, 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            h = stage(h)
            features.append(h)
        return features


# (stage sizes, block) per ResNet
RESNET_GEOMETRY = {
    "resnet18": ((2, 2, 2, 2), "basic"),
    "resnet34": ((3, 4, 6, 3), "basic"),
    "resnet50": ((3, 4, 6, 3), "bottleneck"),
}


# ---------------------------------------------------------------------------
# EfficientNet (B0..B7)
# ---------------------------------------------------------------------------

# Base (B0) stage configs: (expand_ratio, channels, num_blocks, stride, kernel)
_EFFNET_BASE = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# (width_mult, depth_mult) per variant
_EFFNET_PARAMS = {
    "efficientnet-b0": (1.0, 1.0),
    "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b2": (1.1, 1.2),
    "efficientnet-b3": (1.2, 1.4),
    "efficientnet-b4": (1.4, 1.8),
    "efficientnet-b5": (1.6, 2.2),
    "efficientnet-b6": (1.8, 2.6),
    "efficientnet-b7": (2.0, 3.1),
}

_PAD_TYPES = ("static", "same")


def _round_channels(channels: float, width_mult: float, divisor: int = 8) -> int:
    """EfficientNet channel rounding (round to nearest multiple of 8)."""
    channels *= width_mult
    new_c = max(divisor, int(channels + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * channels:
        new_c += divisor
    return int(new_c)


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def _tf_same_pads(
    shape: Sequence[int], kernel: int, stride: int
) -> List[Tuple[int, int]]:
    """TF-'SAME' asymmetric padding per spatial dim (shape is (B, C, H, W)).

    ``out = ceil(in/s)``; total pad ``(out-1)*s + k - in`` split low-first
    — e.g. k=3 s=2 on even input pads (0, 1) where torch static pads (1, 1).
    Identical to static k//2 padding whenever stride is 1 and k is odd.
    """
    pads = []
    for d in shape[2:4]:
        out = -(-d // stride)
        total = max((out - 1) * stride + kernel - d, 0)
        pads.append((total // 2, total - total // 2))
    return pads


class _ConvNoBias(nn.Conv2d):
    """Bias-free k×k conv in either padding convention."""

    def __init__(self, cin, cout, kernel, stride=1, groups=1, pad_type="static"):
        pad = 0 if pad_type == "same" else kernel // 2
        super().__init__(
            cin, cout, kernel, stride, pad, groups=groups, bias=False
        )
        self.pad_type = pad_type

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_type == "same":
            (pt, pb), (pl, pr) = _tf_same_pads(
                x.shape, self.kernel_size[0], self.stride[0]
            )
            x = F.pad(x, [pl, pr, pt, pb])
        return super().forward(x)


class _SqueezeExcite(nn.Module):
    """EfficientNet SE: SiLU between the 1×1 convs, sized from the block
    input channels."""

    def __init__(self, mid: int, se_ch: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(mid, se_ch, 1)
        self.conv_expand = nn.Conv2d(se_ch, mid, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        s = F.silu(self.conv_reduce(s))
        return x * torch.sigmoid(self.conv_expand(s))


class MBConv(nn.Module):
    """EfficientNet mobile inverted bottleneck block with SE.

    expand(1×1) → BN → SiLU → depthwise(k×k, stride) → BN → SiLU →
    SE(ratio 0.25 of block input) → project(1×1) → BN; residual when
    stride 1 and shapes match. ``expand_ratio == 1`` drops the expand
    conv (timm's depthwise-separable block and its key names).
    """

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int,
        strides: int,
        expand_ratio: int,
        se_ratio: float = 0.25,
        bn_eps: float = 1e-3,
        pad_type: str = "static",
    ):
        super().__init__()
        mid = in_channels * expand_ratio
        se_ch = max(1, int(in_channels * se_ratio))
        self.expand_ratio = expand_ratio
        self.residual = strides == 1 and in_channels == features
        dw = _ConvNoBias(
            mid, mid, kernel_size, strides, groups=mid,
            pad_type=pad_type if strides > 1 else "static",
        )
        if expand_ratio != 1:
            self.conv_pw = nn.Conv2d(in_channels, mid, 1, bias=False)
            self.bn1 = BatchNorm2d(mid, eps=bn_eps)
            self.conv_dw = dw
            self.bn2 = BatchNorm2d(mid, eps=bn_eps)
            self.se = _SqueezeExcite(mid, se_ch)
            self.conv_pwl = nn.Conv2d(mid, features, 1, bias=False)
            self.bn3 = BatchNorm2d(features, eps=bn_eps)
        else:
            self.conv_dw = dw
            self.bn1 = BatchNorm2d(mid, eps=bn_eps)
            self.se = _SqueezeExcite(mid, se_ch)
            self.conv_pw = nn.Conv2d(mid, features, 1, bias=False)
            self.bn2 = BatchNorm2d(features, eps=bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.expand_ratio != 1:
            h = F.silu(self.bn1(self.conv_pw(x)))
            h = F.silu(self.bn2(self.conv_dw(h)))
            h = self.bn3(self.conv_pwl(self.se(h)))
        else:
            h = F.silu(self.bn1(self.conv_dw(x)))
            h = self.bn2(self.conv_pw(self.se(h)))
        return x + h if self.residual else h


class EfficientNetEncoder(nn.Module):
    """EfficientNet backbone emitting the 6-level smp feature pyramid
    ``[x, f1, f2, f3, f4, f5]`` at reductions [1, 2, 4, 8, 16, 32]: the
    stem activation, then the outputs of stages 2, 3, 5 and 7."""

    _TAPS = (2, 3, 5, 7)

    def __init__(
        self,
        width_mult: float,
        depth_mult: float,
        in_channels: int = 3,
        bn_eps: float = 1e-3,
        pad_type: str = "static",
    ):
        super().__init__()
        if pad_type not in _PAD_TYPES:
            raise ValueError(f"pad_type={pad_type!r}; expected one of {_PAD_TYPES}")
        stem = _round_channels(32, width_mult)
        self.conv_stem = _ConvNoBias(in_channels, stem, 3, 2, pad_type=pad_type)
        self.bn1 = BatchNorm2d(stem, eps=bn_eps)
        stages = []
        cin = stem
        for t, c, n, s, k in _EFFNET_BASE:
            cout = _round_channels(c, width_mult)
            blocks = []
            for i in range(_round_repeats(n, depth_mult)):
                blocks.append(
                    MBConv(
                        cin, cout, k, s if i == 0 else 1, t,
                        bn_eps=bn_eps, pad_type=pad_type,
                    )
                )
                cin = cout
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        h = F.silu(self.bn1(self.conv_stem(x)))
        features.append(h)
        for stage_idx, stage in enumerate(self.blocks, start=1):
            h = stage(h)
            if stage_idx in self._TAPS:
                features.append(h)
        return features


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def _effnet_out_channels(width_mult: float) -> Tuple[int, ...]:
    r = lambda c: _round_channels(c, width_mult)  # noqa: E731
    return (3, r(32), r(24), r(40), r(112), r(320))


def _resnet_builder(stage_sizes, block):
    def build(in_channels: int, **opts) -> ResNetEncoder:
        if opts:
            raise TypeError(
                f"the ResNet encoders take no convention options (got {sorted(opts)}): "
                "bn_eps / pad_type select between EfficientNet conventions only"
            )
        return ResNetEncoder(stage_sizes, block, in_channels=in_channels)

    return build


ENCODERS = {
    name: {
        "builder": _resnet_builder(stage_sizes, block),
        "out_channels": (3, 64) + tuple(
            w * (4 if block == "bottleneck" else 1) for w in RESNET_WIDTHS
        ),
    }
    for name, (stage_sizes, block) in RESNET_GEOMETRY.items()
}
for _name, (_w, _d) in _EFFNET_PARAMS.items():
    ENCODERS[_name] = {
        "builder": (
            lambda in_channels, w=_w, d=_d, **opts: EfficientNetEncoder(
                width_mult=w, depth_mult=d, in_channels=in_channels, **opts
            )
        ),
        "out_channels": _effnet_out_channels(_w),
    }
    # smp configures these as "timm-efficientnet-bN"
    ENCODERS[f"timm-{_name}"] = ENCODERS[_name]

def get_encoder(
    name: str,
    *,
    in_channels: int = 3,
    weights: Optional[str] = None,
    **encoder_options,
) -> Tuple[nn.Module, Tuple[int, ...]]:
    """Build an encoder module + its ``out_channels`` tuple: one of
    :data:`ENCODERS` (the JAX package's), or a MiT encoder ``mit_b0`` …
    ``mit_b5`` in smp's layout (``models/mit.py``, no JAX counterpart).

    ``encoder_options`` (``bn_eps`` / ``pad_type``; None means the family
    default) select the EfficientNet forward convention documented in
    docs/encoder_audit.md; a ResNet or a MiT raises ``TypeError`` for any
    option that is not None (their conventions are fully determined).
    """
    from deadtrees_tpu_torch.models import mit

    key = name.lower().strip()
    if key not in ENCODERS and key not in mit.MIT_ENCODERS:
        raise ValueError(f"Unknown encoder '{name}'. Available: "
                         f"{sorted(ENCODERS) + sorted(mit.MIT_ENCODERS)}")
    if weights == "imagenet":
        log.warning(
            "encoder_weights='imagenet' requested but this environment has no "
            "network egress; initializing randomly. Load converted weights "
            "through a checkpoint to restore parity."
        )
    opts = {k: v for k, v in encoder_options.items() if v is not None}
    if key in mit.MIT_ENCODERS:
        return mit.build(key, in_channels, **opts)
    entry = ENCODERS[key]
    out_channels = (in_channels,) + tuple(entry["out_channels"][1:])
    return entry["builder"](in_channels, **opts), out_channels
