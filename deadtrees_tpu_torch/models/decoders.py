"""Decoder zoo: U-Net, U-Net++, ResUnet, ResUnet++, EfficientUnet++ (PyTorch, NCHW).

Counterpart of ``deadtrees_tpu.models.decoders``:

- :class:`UnetDecoder`, :class:`ResUnetDecoder`, :class:`ResUnetPlusPlusDecoder`:
  the linear decoders, blocks in ``blocks.{i}`` (smp / reference layout:
  ``conv1`` / ``conv2`` conv-BN-ReLU pairs, ``attention1`` / ``attention2``,
  the ResUnet ``identity_conv``, the ResUnet++ ``attention0`` gate and the
  ``center`` / ``final_aspp`` bridges);
- :class:`UnetPlusPlusDecoder` and :class:`EfficientUnetPlusPlusDecoder`:
  the UNet++ nested-dense wiring (:class:`_DenseGridDecoder`) with
  conv-BN-ReLU or inverted-residual + SCSE cells, under the reference
  names ``blocks.x_{depth}_{layer}``.

Every decoder takes the smp feature pyramid ``[x, f1..f5]`` and drops the
full-resolution entry. A level of 0 channels (the empty stride-2 level of
a MiT encoder, ``models/mit.py``) is no skip: the blocks that would take
it take none, and the dense grid builds no cell of width 0. The JAX
package's env-gated partwise / low-res layout experiments (off by
default) compute the same numbers and are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from deadtrees_tpu_torch.models.blocks import (
    ASPP,
    Attention,
    ConvBnAct,
    InvertedResidual,
    RUPPAttentionBlock,
    upsample2x_nearest,
)


def _cat_skip(x: torch.Tensor, skip) -> torch.Tensor:
    """2× upsample, then concatenate the skip (one tensor or a list)."""
    x = upsample2x_nearest(x)
    if skip is None:
        return x
    skips = list(skip) if isinstance(skip, (list, tuple)) else [skip]
    return torch.cat([x] + skips, dim=1)


class UnetDecoderBlock(nn.Module):
    """smp Unet decoder block: 2× upsample → concat skip → [attention1] →
    conv-BN-ReLU ×2 → attention2. ``attention1`` has parameters only when
    there is a skip (the JAX block creates it only then)."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 attention_type: Optional[str] = None):
        super().__init__()
        self._body(in_channels + skip_channels, skip_channels, features, attention_type)

    def _body(self, cat: int, skip_channels: int, features: int, attention_type) -> None:
        self.conv1 = ConvBnAct(cat, features)
        self.attention1 = Attention(attention_type if skip_channels else None, cat)
        self.conv2 = ConvBnAct(features, features)
        self.attention2 = Attention(attention_type, features)

    def _convs(self, x: torch.Tensor, skip) -> torch.Tensor:
        if skip is not None:
            x = self.attention1(x)
        return self.attention2(self.conv2(self.conv1(x)))

    def forward(self, x: torch.Tensor, skip=None) -> torch.Tensor:
        return self._convs(_cat_skip(x, skip), skip)


class ResUnetDecoderBlock(UnetDecoderBlock):
    """ResUnet decoder block: the Unet block with an additive, biased 1×1
    ``identity_conv`` of the (upsampled, concatenated) block input."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 attention_type: Optional[str] = None):
        super().__init__(in_channels, skip_channels, features, attention_type)
        self.identity_conv = nn.Conv2d(in_channels + skip_channels, features, 1)

    def forward(self, x: torch.Tensor, skip=None) -> torch.Tensor:
        x = _cat_skip(x, skip)
        return self._convs(x, skip) + self.identity_conv(x)


class ResUnetPlusPlusDecoderBlock(ResUnetDecoderBlock):
    """ResUnet++ decoder block: the attention gate ``attention0`` on the
    decoder stream BEFORE upsampling, then the ResUnet block body."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 attention_type: Optional[str] = None):
        nn.Module.__init__(self)
        self.attention0 = RUPPAttentionBlock(in_channels, skip_channels, in_channels)
        cat = in_channels + skip_channels
        self._body(cat, skip_channels, features, attention_type)
        self.identity_conv = nn.Conv2d(cat, features, 1)

    def forward(self, x: torch.Tensor, skip=None) -> torch.Tensor:
        return super().forward(self.attention0(x, skip), skip)


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


def _prep_features(features: Sequence[torch.Tensor]) -> List[Optional[torch.Tensor]]:
    """Drop the full-resolution feature, reverse to deepest-first; a level
    of 0 channels (a MiT encoder's empty stride-2 level) is None: no skip."""
    return [f if f.shape[1] else None for f in list(features[1:])[::-1]]


def linear_blocks(
    encoder_channels: Sequence[int], decoder_channels: Sequence[int]
) -> List[Tuple[int, int, int]]:
    """``(in, skip, out)`` channels of each block of a linear decoder:
    block i takes the previous block's output (the deepest feature for
    block 0) and the i-th skip, while there is one."""
    ec = list(encoder_channels[1:])[::-1]
    skips = ec[1:]
    ins = [ec[0]] + list(decoder_channels[:-1])
    return [
        (cin, skips[i] if i < len(skips) else 0, cout)
        for i, (cin, cout) in enumerate(zip(ins, decoder_channels))
    ]


class _LinearDecoder(nn.Module):
    """Shared U-shaped wiring: ``blocks.{i}`` upsample the running map and
    take the i-th skip while there is one."""

    block_cls = UnetDecoderBlock

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 attention_type: Optional[str] = None):
        super().__init__()
        self.decoder_channels = tuple(decoder_channels)
        self.blocks = self._make_blocks(encoder_channels, decoder_channels, attention_type)

    def _make_blocks(self, encoder_channels, decoder_channels, attention_type) -> nn.ModuleList:
        return nn.ModuleList([
            self.block_cls(cin, skip, cout, attention_type)
            for cin, skip, cout in linear_blocks(encoder_channels, decoder_channels)
        ])

    def run_blocks(self, x: torch.Tensor, skips: Sequence[torch.Tensor]) -> torch.Tensor:
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        feats = _prep_features(features)
        return self.run_blocks(feats[0], feats[1:])


class UnetDecoder(_LinearDecoder):
    """smp-style plain U-Net decoder."""


class ResUnetDecoder(_LinearDecoder):
    """ResUnet decoder: Unet blocks with an additive 1×1 identity path."""

    block_cls = ResUnetDecoderBlock


class ResUnetPlusPlusDecoder(_LinearDecoder):
    """ResUnet++ decoder: an ASPP ``center`` bridge to twice the deepest
    width into blocks of doubled widths, each with its attention gate, and
    a ``final_aspp`` halving the last width back."""

    block_cls = ResUnetPlusPlusDecoderBlock

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 attention_type: Optional[str] = None):
        nn.Module.__init__(self)
        self.decoder_channels = tuple(decoder_channels)
        head = encoder_channels[-1]
        doubled = [2 * c for c in decoder_channels]
        self.center = ASPP(head, 2 * head)
        self.blocks = self._make_blocks(
            tuple(encoder_channels[:-1]) + (2 * head,), doubled, attention_type
        )
        self.final_aspp = ASPP(doubled[-1], doubled[-1] // 2)

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        feats = _prep_features(features)
        return self.final_aspp(self.run_blocks(self.center(feats[0]), feats[1:]))


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
                if cout
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
                name = f"x_{d}_{li}"
                if name not in self.blocks:  # a cell of width 0
                    continue
                if layer == 0:
                    dense[(d, d)] = self.blocks[name](feats[d], feats[d + 1])
                else:
                    cat = [dense[(idx, li)] for idx in range(d + 1, li + 1)
                           if (idx, li) in dense]
                    cat += [feats[li + 1]] if feats[li + 1] is not None else []
                    dense[(d, li)] = self.blocks[name](dense[(d, li - 1)], cat or None)
        return self.blocks[f"x_0_{depth}"](dense[(0, depth - 1)])


class UnetPlusPlusDecoder(_DenseGridDecoder):
    """smp-style UNet++ decoder: the dense grid of Unet blocks."""

    def __init__(
        self,
        encoder_channels: Sequence[int],
        decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
        attention_type: Optional[str] = None,
    ):
        self.attention_type = attention_type
        super().__init__(encoder_channels, decoder_channels)

    def make_block(self, cin: int, skip: int, cout: int) -> nn.Module:
        return UnetDecoderBlock(cin, skip, cout, self.attention_type)


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
