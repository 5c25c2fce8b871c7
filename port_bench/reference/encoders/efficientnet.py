"""EfficientNet encoder (Tan and Le, arXiv:1905.11946), timm's layout.

Stem 3×3 stride 2 → BN → SiLU, then mobile inverted bottlenecks: 1×1
expand → BN → SiLU → depthwise k×k (the stride here, k // 2 padding) →
BN → SiLU → squeeze-excite (SiLU, a quarter of the block's input width) →
1×1 project → BN, with the identity added when the stride is 1 and the
width stays. A block of expansion 1 has no expand conv (timm's names then
run conv_dw / bn1 / se / conv_pw / bn2). The feature pyramid is the input,
the stem, and the outputs of stages 2, 3, 5 and 7.

Every width comes from the configuration: ``stem``, ``stage_channels``,
``stage_repeats``, ``stage_expand``, ``stage_kernels``, ``stage_strides``,
``se_ratio``, ``bn_eps``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.core import Net, Shapes

TAPS = (2, 3, 5, 7)


def _blocks(enc: Dict) -> Iterator[Tuple[str, int, int, int, int, int]]:
    """(name, cin, cout, kernel, stride, expand) of every block."""
    cin = enc["stem"]
    for s, (cout, reps, t, k, stride) in enumerate(zip(
            enc["stage_channels"], enc["stage_repeats"], enc["stage_expand"],
            enc["stage_kernels"], enc["stage_strides"])):
        for i in range(reps):
            yield f"encoder.blocks.{s}.{i}", cin, cout, k, stride if i == 0 else 1, t
            cin = cout


def out_channels(enc: Dict, in_channels: int) -> List[int]:
    ch = enc["stage_channels"]
    return [in_channels, enc["stem"]] + [ch[t - 1] for t in TAPS]


def residual_bns(enc: Dict) -> List[str]:
    """The last BatchNorm of each block that adds its input back."""
    return [f"{name}.bn3" if t != 1 else f"{name}.bn2"
            for name, cin, cout, _, stride, t in _blocks(enc) if stride == 1 and cin == cout]


def shapes(sh: Shapes, enc: Dict, in_channels: int) -> None:
    sh.conv("encoder.conv_stem", enc["stem"], in_channels, 3)
    sh.bn("encoder.bn1", enc["stem"])
    for name, cin, cout, k, _, t in _blocks(enc):
        mid = cin * t
        se = max(1, int(cin * enc["se_ratio"]))
        if t != 1:
            sh.conv(f"{name}.conv_pw", mid, cin, 1)
            sh.bn(f"{name}.bn1", mid)
            sh.conv(f"{name}.conv_dw", mid, mid, k, groups=mid)
            sh.bn(f"{name}.bn2", mid)
        else:
            sh.conv(f"{name}.conv_dw", mid, mid, k, groups=mid)
            sh.bn(f"{name}.bn1", mid)
        sh.conv(f"{name}.se.conv_reduce", se, mid, 1, bias=True)
        sh.conv(f"{name}.se.conv_expand", mid, se, 1, bias=True)
        if t != 1:
            sh.conv(f"{name}.conv_pwl", cout, mid, 1)
            sh.bn(f"{name}.bn3", cout)
        else:
            sh.conv(f"{name}.conv_pw", cout, mid, 1)
            sh.bn(f"{name}.bn2", cout)


def _mbconv(net: Net, x: torch.Tensor, name: str, stride: int, expand: int,
            eps: float) -> torch.Tensor:
    h = x
    if expand != 1:
        h = F.silu(net.bn(net.conv(h, f"{name}.conv_pw"), f"{name}.bn1", eps))
    dw_bn = f"{name}.bn2" if expand != 1 else f"{name}.bn1"
    h = F.silu(net.bn(net.conv(h, f"{name}.conv_dw", stride, groups=h.shape[1]), dw_bn, eps))
    s = h.mean((2, 3), keepdim=True)
    s = F.silu(net.conv(s, f"{name}.se.conv_reduce"))
    h = h * torch.sigmoid(net.conv(s, f"{name}.se.conv_expand"))
    if expand != 1:
        h = net.bn(net.conv(h, f"{name}.conv_pwl"), f"{name}.bn3", eps)
    else:
        h = net.bn(net.conv(h, f"{name}.conv_pw"), f"{name}.bn2", eps)
    return x + h if stride == 1 and x.shape[1] == h.shape[1] else h


def forward(net: Net, x: torch.Tensor, enc: Dict) -> List[torch.Tensor]:
    eps = enc["bn_eps"]
    feats = [x]
    h = F.silu(net.bn(net.conv(x, "encoder.conv_stem", 2), "encoder.bn1", eps))
    feats.append(h)
    stage_of = {}
    for name, _, _, _, stride, t in _blocks(enc):
        stage = int(name.split(".")[2])
        h = net.block(lambda n, v, nm=name, st=stride, tt=t: _mbconv(n, v, nm, st, tt, eps), h)
        stage_of[stage] = h
    return feats + [stage_of[t - 1] for t in TAPS]
