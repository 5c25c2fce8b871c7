"""UNet++ decoder (Zhou et al., arXiv:1807.10165) as smp builds it, on the
cell grid of ``efficientunetplusplus.py``.

Cell x_{d}_{l} upsamples its left neighbour 2× (nearest), concatenates
every earlier cell of its resolution and the encoder skip, then runs the
U-Net block's two 3×3 conv (no bias) → BN (eps 1e-5) → ReLU pairs (keys
``conv1.0`` / ``conv1.1``, ``conv2.0`` / ``conv2.1``). An encoder level of
0 channels (a MiT encoder's empty stride-2 level) is no skip, and a cell
of width 0 is not built and adds nothing to a concatenation. Widths:
``decoder_channels``; no attention.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from port_bench.reference.core import Net, Shapes
from port_bench.reference.decoders import efficientunetplusplus as grid
from port_bench.reference.decoders.unet import _block


def cells(enc_out: Sequence[int], dec: Sequence[int]) -> Dict[str, tuple]:
    """{cell: (in, skip, out)} of width > 0, in the order the forward pass
    visits them."""
    return {k: v for k, v in grid.cells(enc_out, dec).items() if v[2]}


def residual_bns(enc_out: Sequence[int], model: Dict) -> List[str]:
    return []


def shapes(sh: Shapes, enc_out: Sequence[int], model: Dict) -> None:
    for cell, (cin, skip, cout) in cells(enc_out, model["decoder_channels"]).items():
        name = f"decoder.blocks.{cell}"
        sh.conv(f"{name}.conv1.0", cout, cin + skip, 3)
        sh.bn(f"{name}.conv1.1", cout)
        sh.conv(f"{name}.conv2.0", cout, cout, 3)
        sh.bn(f"{name}.conv2.1", cout)


def forward(net: Net, feats, enc_out: Sequence[int], model: Dict):
    deep = [f if f.shape[1] else None for f in feats[1:][::-1]]
    built = cells(enc_out, model["decoder_channels"])
    depth = len(model["decoder_channels"]) - 1
    dense = {}

    def run(name, x, skips):
        skips = [s for s in skips if s is not None]
        return net.block(lambda n, v, *s, nm=f"decoder.blocks.{name}":
                         _block(n, v, _cat(s), nm), x, *skips)

    for layer in range(depth):
        for d in range(depth - layer):
            li = d + layer
            if f"x_{d}_{li}" not in built:
                continue
            if layer == 0:
                dense[(d, d)] = run(f"x_{d}_{d}", deep[d], [deep[d + 1]])
            else:
                cat = [dense.get((i, li)) for i in range(d + 1, li + 1)]
                dense[(d, li)] = run(f"x_{d}_{li}", dense[(d, li - 1)], cat + [deep[li + 1]])
    return run(f"x_0_{depth}", dense[(0, depth - 1)], [])


def _cat(skips):
    return torch.cat(list(skips), 1) if skips else None
