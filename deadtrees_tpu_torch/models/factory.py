"""Model assembly and architecture dispatch (PyTorch).

Counterpart of ``deadtrees_tpu.models.factory``: the six architectures of
the JAX package — Unet, Unet++, ResUnet, ResUnet++ and EfficientUnet++ on
any encoder of ``models/encoders.py`` (ResNet-18/34/50, EfficientNet-b0..b7),
and SegFormer on mit-b0..b2 (``models/segformer.py``). Beyond the JAX
package, the five U-Net-family decoders also run on the MiT encoders
mit_b0 … mit_b5 in smp's layout (``models/mit.py``; smp's
``Unet(encoder_name="mit_b5")``).

``dtype`` means "compute in this type": the forward runs under
``torch.autocast`` for it, and parameters stay float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from deadtrees_tpu_torch.models import decoders as dec
from deadtrees_tpu_torch.models.blocks import ASPP, ConvBnAct, SegmentationHead
from deadtrees_tpu_torch.models.encoders import (
    BasicBlock,
    Bottleneck,
    ResNetEncoder,
    get_encoder,
)
from deadtrees_tpu_torch.models.segformer import SegFormer

ARCHITECTURES = (
    "unet",
    "unetplusplus",
    "resunet",
    "resunetplusplus",
    "efficientunetplusplus",
    "segformer",
)

_ALIASES = {
    "unet++": "unetplusplus",
    "resunet++": "resunetplusplus",
    "efficientunet++": "efficientunetplusplus",
}


def canonical_architecture(name: str) -> str:
    key = name.lower().strip()
    key = _ALIASES.get(key, key)
    if key not in ARCHITECTURES:
        raise NotImplementedError(
            "Currently only Unet, ResUnet, Unet++, ResUnet++, "
            "EfficientUnet++, and SegFormer architectures are supported"
        )
    return key


# architecture → (decoder class, segmentation head kernel); the ResUnets
# end in a 1×1 head (the reference's resunet/model.py:92,
# resunetplusplus/model.py:94)
_DECODERS = {
    "unet": (dec.UnetDecoder, 3),
    "unetplusplus": (dec.UnetPlusPlusDecoder, 3),
    "resunet": (dec.ResUnetDecoder, 1),
    "resunetplusplus": (dec.ResUnetPlusPlusDecoder, 1),
    "efficientunetplusplus": (dec.EfficientUnetPlusPlusDecoder, 3),
}


class SegmentationModel(nn.Module):
    """Encoder + decoder + segmentation head producing per-class logits.

    ``forward`` maps a (B, in_channels, H, W) float tensor to
    (B, classes, H, W) float32 logits, computing in ``self.dtype``.
    ``architecture`` is the canonical name of the decoder family built.
    """

    def __init__(
        self,
        encoder_name: str = "timm-efficientnet-b5",
        *,
        architecture: str = "efficientunetplusplus",
        encoder_weights: Optional[str] = None,
        decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
        in_channels: int = 4,
        classes: int = 3,
        decoder_attention_type: Optional[str] = None,
        squeeze_ratio: int = 1,
        expansion_ratio: int = 1,
        encoder_bn_eps: Optional[float] = None,
        encoder_pad_type: Optional[str] = None,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.architecture = canonical_architecture(architecture)
        if self.architecture not in _DECODERS:
            raise ValueError(f"SegmentationModel does not build {architecture!r}")
        self.encoder_name = encoder_name
        self.in_channels = in_channels
        self.classes = classes
        self.decoder_channels = tuple(decoder_channels)
        self.dtype = dtype
        self.encoder, enc_channels = get_encoder(
            encoder_name,
            in_channels=in_channels,
            weights=encoder_weights,
            bn_eps=encoder_bn_eps,
            pad_type=encoder_pad_type,
        )
        decoder_cls, head_kernel = _DECODERS[self.architecture]
        if self.architecture == "efficientunetplusplus":
            self.decoder = decoder_cls(
                enc_channels, self.decoder_channels,
                squeeze_ratio=squeeze_ratio, expansion_ratio=expansion_ratio,
            )
        else:
            self.decoder = decoder_cls(
                enc_channels, self.decoder_channels, attention_type=decoder_attention_type
            )
        self.segmentation_head = SegmentationHead(
            self.decoder_channels[-1], classes, kernel_size=head_kernel
        )

    def autocast(self, device_type: str):
        """The context that realises ``self.dtype`` for a forward pass."""
        return torch.autocast(
            device_type,
            dtype=self.dtype,
            enabled=self.dtype != torch.float32,
        )

    def train(self, mode: bool = True, encoder_train: bool = True) -> "SegmentationModel":
        """``encoder_train=False`` keeps the encoder's BatchNorms on their
        running statistics while the rest trains: the multistage freeze
        stage (the JAX model's ``encoder_train`` switch, the reference's
        ``encoder.eval()``)."""
        super().train(mode)
        if mode and not encoder_train:
            self.encoder.eval()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with self.autocast(x.device.type):
            features = self.encoder(x)
            decoded = self.decoder(features)
            return self.segmentation_head(decoded)


def create_model(
    architecture: str = "efficientunetplusplus",
    encoder_name: str = "timm-efficientnet-b5",
    *,
    encoder_weights: Optional[str] = None,
    decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
    in_channels: int = 4,
    classes: int = 3,
    decoder_attention_type: Optional[str] = None,
    encoder_bn_eps: Optional[float] = None,
    encoder_pad_type: Optional[str] = None,
    encoder_options: Optional[dict] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> Union[SegmentationModel, SegFormer]:
    """Architecture-string dispatch; takes the hparams keys the JAX
    trainer writes. There is no catch-all keyword: any other key raises
    ``TypeError``, so no option can be swallowed silently.

    ``encoder_options`` is the dict form of the EfficientNet convention
    knobs (``{"bn_eps": ..., "pad_type": ...}``); explicit
    ``encoder_bn_eps`` / ``encoder_pad_type`` win over it. A ResNet
    encoder raises ``TypeError`` when either is set.

    ``encoder_name`` names a ResNet, an EfficientNet (``timm-`` or not) or
    a MiT encoder in smp's layout (``mit_b0`` … ``mit_b5``, with an
    underscore, for the U-Net-family decoders); an unknown name raises
    ``ValueError`` with the list. ``decoder_attention_type`` (None,
    ``"se"`` or ``"scse"``) applies to the four Unet-family decoders;
    efficientunet++ and segformer raise ``ValueError`` for it. SegFormer
    takes ``encoder_name`` when it names one of its own MiT variants
    (mit-b0..b2, with a hyphen), else mit-b0, as the JAX factory does; it
    has no decoder widths and no encoder options.
    """
    if encoder_options:
        unknown = set(encoder_options) - {"bn_eps", "pad_type"}
        if unknown:
            raise TypeError(f"unknown encoder_options {sorted(unknown)}")
        if encoder_bn_eps is None:
            encoder_bn_eps = encoder_options.get("bn_eps")
        if encoder_pad_type is None:
            encoder_pad_type = encoder_options.get("pad_type")
    arch = canonical_architecture(architecture)
    if decoder_attention_type is not None and arch in ("efficientunetplusplus", "segformer"):
        raise ValueError(
            f"{architecture} has no decoder attention option "
            f"(got decoder_attention_type={decoder_attention_type!r})"
        )
    if arch == "segformer":
        return SegFormer(
            encoder_name if encoder_name.lower().startswith("mit") else "mit-b0",
            in_channels=in_channels, classes=classes, dtype=dtype,
        )
    return SegmentationModel(
        encoder_name,
        architecture=arch,
        encoder_weights=encoder_weights,
        decoder_attention_type=decoder_attention_type,
        decoder_channels=decoder_channels,
        in_channels=in_channels,
        classes=classes,
        encoder_bn_eps=encoder_bn_eps,
        encoder_pad_type=encoder_pad_type,
        dtype=dtype,
    )


# modules whose convs the JAX package initializes with he_normal
_HE_MODULES = (ResNetEncoder, BasicBlock, Bottleneck, ConvBnAct, ASPP)


@torch.no_grad()
def init_model(model: nn.Module, *, generator: torch.Generator) -> nn.Module:
    """(Re-)initialize ``model`` in place from ``generator`` with the JAX
    package's initializers, module by module: the kernels of every conv in
    a ResNet encoder, a conv-BN-ReLU pair or an ASPP from a normal of
    variance 2/fan_in (he normal), every other conv and linear kernel from
    one of variance 1/fan_in (lecun normal), both without flax's
    truncation (the same variance); biases zero, BatchNorm and LayerNorm
    scale 1 and bias 0, running mean 0 and variance 1. Kernels are drawn
    in module order. Returns the model."""
    he = {
        id(c)
        for m in model.modules() if isinstance(m, _HE_MODULES)
        for c in m.modules() if isinstance(c, nn.Conv2d)
    }
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w * math.sqrt(2.0 / fan_in) if id(m) in he else w / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
    return model
