"""ResNet encoder with basic blocks (He et al., arXiv:1512.03385),
torchvision's layout.

7×7 stride-2 stem → BN → ReLU → 3×3 stride-2 max pool, then stages of
two 3×3 conv-BN pairs (the stride on the first conv of a stage's first
block) with the identity, or a 1×1 conv-BN projection where the shape
changes, added before the ReLU. The feature pyramid is the input, the stem
activation and the output of each stage. Widths from the configuration:
``stem``, ``stage_channels``, ``stage_repeats``, ``bn_eps``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.core import Net, Shapes


def _blocks(enc: Dict) -> Iterator[Tuple[str, int, int, int]]:
    cin = enc["stem"]
    for s, (cout, reps) in enumerate(zip(enc["stage_channels"], enc["stage_repeats"])):
        for i in range(reps):
            yield f"encoder.layer{s + 1}.{i}", cin, cout, 2 if s > 0 and i == 0 else 1
            cin = cout


def out_channels(enc: Dict, in_channels: int) -> List[int]:
    return [in_channels, enc["stem"]] + list(enc["stage_channels"])


def residual_bns(enc: Dict) -> List[str]:
    """The last BatchNorm of each block's residual branch."""
    return [f"{name}.bn2" for name, _, _, _ in _blocks(enc)]


def shapes(sh: Shapes, enc: Dict, in_channels: int) -> None:
    sh.conv("encoder.conv1", enc["stem"], in_channels, 7)
    sh.bn("encoder.bn1", enc["stem"])
    for name, cin, cout, stride in _blocks(enc):
        sh.conv(f"{name}.conv1", cout, cin, 3)
        sh.bn(f"{name}.bn1", cout)
        sh.conv(f"{name}.conv2", cout, cout, 3)
        sh.bn(f"{name}.bn2", cout)
        if stride != 1 or cin != cout:
            sh.conv(f"{name}.downsample.0", cout, cin, 1)
            sh.bn(f"{name}.downsample.1", cout)


def _basic(net: Net, x: torch.Tensor, name: str, stride: int, eps: float) -> torch.Tensor:
    h = F.relu(net.bn(net.conv(x, f"{name}.conv1", stride), f"{name}.bn1", eps))
    h = net.bn(net.conv(h, f"{name}.conv2"), f"{name}.bn2", eps)
    if f"{name}.downsample.0.weight" in net.p:
        x = net.bn(net.conv(x, f"{name}.downsample.0", stride), f"{name}.downsample.1", eps)
    return F.relu(h + x)


def forward(net: Net, x: torch.Tensor, enc: Dict) -> List[torch.Tensor]:
    eps = enc["bn_eps"]
    feats = [x]
    h = F.relu(net.bn(net.conv(x, "encoder.conv1", 2), "encoder.bn1", eps))
    feats.append(h)
    h = F.max_pool2d(h, 3, 2, 1)
    last = {}
    for name, _, _, stride in _blocks(enc):
        h = net.block(lambda n, v, nm=name, st=stride: _basic(n, v, nm, st, eps), h)
        last[name.split(".")[1]] = h
    return feats + [last[f"layer{s + 1}"] for s in range(len(enc["stage_channels"]))]
