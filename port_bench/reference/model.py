"""The reference segmentation network: encoder + decoder + 3×3 head.

A configuration file names the encoder family (``encoder.family``: a file
under ``encoders/``) and the decoder (``architecture``: a file under
``decoders/``); a new family or decoder is a new file there. The
parameters are a flat dict in the published state dict's names, which
:func:`leaves` lists with their shapes from the configuration alone.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

import torch

from port_bench.reference.core import Leaf, Net, Numerics, Shapes


def _encoder(model: Dict):
    return importlib.import_module(f"port_bench.reference.encoders.{model['encoder']['family']}")


def _decoder(model: Dict):
    return importlib.import_module(f"port_bench.reference.decoders.{model['architecture']}")


def leaves(model: Dict) -> List[Leaf]:
    """Every parameter and buffer of the network, in state-dict order."""
    sh = Shapes()
    enc = _encoder(model)
    enc.shapes(sh, model["encoder"], model["in_channels"])
    enc_out = enc.out_channels(model["encoder"], model["in_channels"])
    _decoder(model).shapes(sh, enc_out, model)
    sh.conv("segmentation_head.0", model["classes"], model["decoder_channels"][-1], 3,
            bias=True)
    return sh.leaves


def residual_bns(model: Dict) -> List[str]:
    """The BatchNorms that end a residual branch, encoder and decoder."""
    enc = _encoder(model)
    enc_out = enc.out_channels(model["encoder"], model["in_channels"])
    return enc.residual_bns(model["encoder"]) + _decoder(model).residual_bns(enc_out, model)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, model: Dict, *,
            train: bool, numerics: Optional[Numerics] = None, checkpoint: bool = False,
            stats: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
            ) -> torch.Tensor:
    """(B, C, H, W) float32 → (B, classes, H, W) float32 logits."""
    net = Net(params, train=train, numerics=numerics, checkpoint=checkpoint, stats=stats)
    enc = _encoder(model)
    feats = enc.forward(net, x, model["encoder"])
    enc_out = enc.out_channels(model["encoder"], model["in_channels"])
    h = _decoder(model).forward(net, feats, enc_out, model)
    return net.conv(h, "segmentation_head.0")


def n_params(model: Dict) -> int:
    return sum(int(torch.Size(l.shape).numel()) for l in leaves(model) if l.is_param)
