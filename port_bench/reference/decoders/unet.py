"""U-Net decoder (Ronneberger et al., arXiv:1505.04597) as smp builds it.

Block i: 2× nearest upsample of the running map, concatenation with the
i-th skip (the encoder features from deep to shallow, while there is
one), then two 3×3 conv (no bias) → BN (eps 1e-5) → ReLU pairs. Widths:
``decoder_channels``; no attention.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from port_bench.reference.core import Net, Shapes, upsample2x

EPS = 1e-5


def _blocks(enc_out: Sequence[int], dec: Sequence[int]):
    ec = list(enc_out[1:])[::-1]
    skips = ec[1:]
    ins = [ec[0]] + list(dec[:-1])
    return [(f"decoder.blocks.{i}", cin, skips[i] if i < len(skips) else 0, cout)
            for i, (cin, cout) in enumerate(zip(ins, dec))]


def residual_bns(enc_out: Sequence[int], model: Dict) -> List[str]:
    return []


def shapes(sh: Shapes, enc_out: Sequence[int], model: Dict) -> None:
    for name, cin, skip, cout in _blocks(enc_out, model["decoder_channels"]):
        sh.conv(f"{name}.conv1.0", cout, cin + skip, 3)
        sh.bn(f"{name}.conv1.1", cout)
        sh.conv(f"{name}.conv2.0", cout, cout, 3)
        sh.bn(f"{name}.conv2.1", cout)


def _block(net: Net, x: torch.Tensor, skip, name: str) -> torch.Tensor:
    x = upsample2x(x)
    if skip is not None:
        x = torch.cat([x, skip], 1)
    x = F.relu(net.bn(net.conv(x, f"{name}.conv1.0"), f"{name}.conv1.1", EPS))
    return F.relu(net.bn(net.conv(x, f"{name}.conv2.0"), f"{name}.conv2.1", EPS))


def forward(net: Net, feats: List[torch.Tensor], enc_out: Sequence[int], model: Dict):
    deep = feats[1:][::-1]
    x = deep[0]
    for i, (name, _, skip, _) in enumerate(_blocks(enc_out, model["decoder_channels"])):
        s = deep[i + 1] if skip else None
        x = net.block(lambda n, v, sk, nm=name: _block(n, v, sk, nm), x, s)
    return x
