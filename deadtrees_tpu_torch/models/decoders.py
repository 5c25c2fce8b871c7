"""EfficientUnet++ decoder (PyTorch, NCHW).

Counterpart of the dense-grid half of ``deadtrees_tpu.models.decoders``:
the UNet++ nested-dense wiring (:class:`_DenseGridDecoder`) with
inverted-residual + SCSE blocks. Cells live in ``blocks`` under the
reference names ``x_{depth}_{layer}`` with sub-blocks ``conv1``/``conv2``,
so state-dict keys match the reference checkpoints. The other decoder
families are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from deadtrees_tpu_torch.models.blocks import InvertedResidual, upsample2x_nearest


class EffUnetPlusPlusDecoderBlock(nn.Module):
    """2× upsample → concat skip(s) → inverted-residual ×2."""

    def __init__(
        self,
        in_channels: int,
        skip_channels: int,
        features: int,
        squeeze_ratio: int = 1,
        expansion_ratio: int = 1,
    ):
        super().__init__()
        self.conv1 = InvertedResidual(
            in_channels + skip_channels, features,
            expansion_ratio=expansion_ratio, squeeze_ratio=squeeze_ratio,
        )
        self.conv2 = InvertedResidual(
            features, features,
            expansion_ratio=expansion_ratio, squeeze_ratio=squeeze_ratio,
        )

    def forward(self, x: torch.Tensor, skip=None) -> torch.Tensor:
        x = upsample2x_nearest(x)
        if skip is not None:
            skips = list(skip) if isinstance(skip, (list, tuple)) else [skip]
            x = torch.cat([x] + skips, dim=1)
        return self.conv2(self.conv1(x))


def _prep_features(features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Drop the full-resolution feature, reverse to deepest-first."""
    return list(features[1:])[::-1]


def dense_grid_cells(
    encoder_channels: Sequence[int], decoder_channels: Sequence[int]
) -> Dict[str, Tuple[int, int, int]]:
    """``{cell name: (in, skip, out) channels}`` of the dense grid, in the
    order the forward pass visits the cells."""
    ec = list(encoder_channels[1:])[::-1]
    skip_ch = ec[1:] + [0]
    depth = len(decoder_channels) - 1

    def out_ch(d: int, l: int) -> int:
        return decoder_channels[l] if d == 0 else skip_ch[l]

    cells = {}
    for layer in range(depth):
        for d in range(depth - layer):
            li = d + layer
            if layer == 0:
                cells[f"x_{d}_{d}"] = (ec[d], skip_ch[d], out_ch(d, d))
            else:
                cat = sum(out_ch(i, li) for i in range(d + 1, li + 1))
                cells[f"x_{d}_{li}"] = (
                    out_ch(d, li - 1), cat + skip_ch[li], out_ch(d, li)
                )
    cells[f"x_0_{depth}"] = (decoder_channels[depth - 1], 0, decoder_channels[-1])
    return cells


class _DenseGridDecoder(nn.Module):
    """Shared nested-dense (UNet++) wiring.

    Grid cell ``x_{d}_{l}`` (depth d, layer l) upsamples its left neighbour
    and concatenates all same-resolution predecessors plus the encoder skip.
    Output channels per cell: ``decoder_channels[l]`` on the d=0 row, else
    the skip width of layer l. Subclasses supply :meth:`make_block`.
    """

    def __init__(
        self, encoder_channels: Sequence[int], decoder_channels: Sequence[int]
    ):
        super().__init__()
        self.decoder_channels = tuple(decoder_channels)
        self.blocks = nn.ModuleDict(
            {
                name: self.make_block(cin, skip, cout)
                for name, (cin, skip, cout) in dense_grid_cells(
                    encoder_channels, decoder_channels
                ).items()
            }
        )

    def make_block(self, cin: int, skip: int, cout: int) -> nn.Module:
        raise NotImplementedError

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        feats = _prep_features(features)
        depth = len(self.decoder_channels) - 1
        dense = {}
        for layer in range(depth):
            for d in range(depth - layer):
                li = d + layer
                if layer == 0:
                    dense[(d, d)] = self.blocks[f"x_{d}_{d}"](feats[d], feats[d + 1])
                else:
                    cat = [dense[(idx, li)] for idx in range(d + 1, li + 1)]
                    dense[(d, li)] = self.blocks[f"x_{d}_{li}"](
                        dense[(d, li - 1)], cat + [feats[li + 1]]
                    )
        return self.blocks[f"x_0_{depth}"](dense[(0, depth - 1)])


class EfficientUnetPlusPlusDecoder(_DenseGridDecoder):
    """EfficientUnet++ decoder: the UNet++ grid with inverted-residual +
    SCSE blocks."""

    def __init__(
        self,
        encoder_channels: Sequence[int],
        decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
        squeeze_ratio: int = 1,
        expansion_ratio: int = 1,
    ):
        self.squeeze_ratio = squeeze_ratio
        self.expansion_ratio = expansion_ratio
        super().__init__(encoder_channels, decoder_channels)

    def make_block(self, cin: int, skip: int, cout: int) -> nn.Module:
        return EffUnetPlusPlusDecoderBlock(
            cin, skip, cout,
            squeeze_ratio=self.squeeze_ratio,
            expansion_ratio=self.expansion_ratio,
        )
