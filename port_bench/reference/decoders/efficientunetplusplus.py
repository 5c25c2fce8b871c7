"""EfficientUNet++ decoder (Silva et al., arXiv:2106.11447) as smp builds it.

The UNet++ nested grid (Zhou et al., arXiv:1807.10165): cell x_{d}_{l}
upsamples its left neighbour 2× (nearest) and concatenates every earlier
cell of its resolution and the encoder skip; each cell is two inverted
residual blocks with concurrent spatial and channel squeeze-excitation
(scSE): 1×1 expand (bias) → BN → hardswish → depthwise 3×3 (bias) → BN →
hardswish → scSE → 1×1 project (bias) → BN, plus the input, through a
1×1 conv (bias) → BN where the width changes. BN eps 1e-5. Widths:
``decoder_channels``, ``expansion_ratio``, ``squeeze_ratio``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from port_bench.reference.core import Net, Shapes, upsample2x

EPS = 1e-5


def cells(enc_out: Sequence[int], dec: Sequence[int]) -> Dict[str, tuple]:
    """{cell: (in, skip, out)} in the order the forward pass visits them."""
    ec = list(enc_out[1:])[::-1]
    skip_ch = ec[1:] + [0]
    depth = len(dec) - 1

    def out_ch(d: int, l: int) -> int:
        return dec[l] if d == 0 else skip_ch[l]

    out = {}
    for layer in range(depth):
        for d in range(depth - layer):
            li = d + layer
            if layer == 0:
                out[f"x_{d}_{d}"] = (ec[d], skip_ch[d], out_ch(d, d))
            else:
                cat = sum(out_ch(i, li) for i in range(d + 1, li + 1))
                out[f"x_{d}_{li}"] = (out_ch(d, li - 1), cat + skip_ch[li], out_ch(d, li))
    out[f"x_0_{depth}"] = (dec[depth - 1], 0, dec[-1])
    return out


def _ir_shapes(sh: Shapes, name: str, cin: int, cout: int, model: Dict) -> None:
    mid = cin * model["expansion_ratio"]
    hidden = max(mid // model["squeeze_ratio"], 1)
    sh.conv(f"{name}.block.0", mid, cin, 1, bias=True)
    sh.bn(f"{name}.block.1", mid)
    sh.conv(f"{name}.block.3", mid, mid, 3, bias=True, groups=mid)
    sh.bn(f"{name}.block.4", mid)
    sh.conv(f"{name}.block.6.cSE.1", hidden, mid, 1, bias=True)
    sh.conv(f"{name}.block.6.cSE.3", mid, hidden, 1, bias=True)
    sh.conv(f"{name}.block.6.sSE.0", 1, mid, 1, bias=True)
    sh.conv(f"{name}.block.7", cout, mid, 1, bias=True)
    sh.bn(f"{name}.block.8", cout)
    if cin != cout:
        sh.conv(f"{name}.skip_conv.0", cout, cin, 1, bias=True)
        sh.bn(f"{name}.skip_conv.1", cout)


def residual_bns(enc_out: Sequence[int], model: Dict) -> List[str]:
    """The last BatchNorm of every inverted residual block."""
    return [f"decoder.blocks.{cell}.{conv}.block.8"
            for cell in cells(enc_out, model["decoder_channels"]) for conv in ("conv1", "conv2")]


def shapes(sh: Shapes, enc_out: Sequence[int], model: Dict) -> None:
    for cell, (cin, skip, cout) in cells(enc_out, model["decoder_channels"]).items():
        _ir_shapes(sh, f"decoder.blocks.{cell}.conv1", cin + skip, cout, model)
        _ir_shapes(sh, f"decoder.blocks.{cell}.conv2", cout, cout, model)


def _inverted_residual(net: Net, x: torch.Tensor, name: str) -> torch.Tensor:
    h = F.hardswish(net.bn(net.conv(x, f"{name}.block.0"), f"{name}.block.1", EPS))
    h = F.hardswish(net.bn(net.conv(h, f"{name}.block.3", groups=h.shape[1]),
                           f"{name}.block.4", EPS))
    c = h.mean((2, 3), keepdim=True)
    c = torch.sigmoid(net.conv(F.relu(net.conv(c, f"{name}.block.6.cSE.1")),
                               f"{name}.block.6.cSE.3"))
    s = torch.sigmoid(net.conv(h, f"{name}.block.6.sSE.0"))
    h = h * c + h * s
    h = net.bn(net.conv(h, f"{name}.block.7"), f"{name}.block.8", EPS)
    if f"{name}.skip_conv.0.weight" in net.p:
        x = net.bn(net.conv(x, f"{name}.skip_conv.0"), f"{name}.skip_conv.1", EPS)
    return x + h


def _cell(net: Net, x: torch.Tensor, skips: List[torch.Tensor], name: str) -> torch.Tensor:
    x = upsample2x(x)
    if skips:
        x = torch.cat([x] + list(skips), 1)
    x = _inverted_residual(net, x, f"{name}.conv1")
    return _inverted_residual(net, x, f"{name}.conv2")


def forward(net: Net, feats: List[torch.Tensor], enc_out: Sequence[int], model: Dict):
    deep = feats[1:][::-1]
    depth = len(model["decoder_channels"]) - 1
    dense = {}

    def run(name, x, skips):
        return net.block(lambda n, v, *s: _cell(n, v, list(s), f"decoder.blocks.{name}"),
                         x, *skips)

    for layer in range(depth):
        for d in range(depth - layer):
            li = d + layer
            if layer == 0:
                dense[(d, d)] = run(f"x_{d}_{d}", deep[d], [deep[d + 1]])
            else:
                cat = [dense[(i, li)] for i in range(d + 1, li + 1)]
                dense[(d, li)] = run(f"x_{d}_{li}", dense[(d, li - 1)], cat + [deep[li + 1]])
    return run(f"x_0_{depth}", dense[(0, depth - 1)], [])
