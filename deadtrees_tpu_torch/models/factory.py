"""Model assembly and architecture dispatch (PyTorch).

Counterpart of ``deadtrees_tpu.models.factory``. The port builds the
model of record, EfficientUnet++, on the EfficientNet-b0..b7 encoders;
the other architectures of the JAX package raise ``NotImplementedError``
naming their ROADMAP item.

``dtype`` means "compute in this type": the forward runs under
``torch.autocast`` for it, and parameters stay float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from deadtrees_tpu_torch.models.blocks import SegmentationHead
from deadtrees_tpu_torch.models.decoders import EfficientUnetPlusPlusDecoder
from deadtrees_tpu_torch.models.encoders import get_encoder

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


class SegmentationModel(nn.Module):
    """Encoder + decoder + segmentation head producing per-class logits.

    ``forward`` maps a (B, in_channels, H, W) float tensor to
    (B, classes, H, W) float32 logits, computing in ``self.dtype``.
    """

    def __init__(
        self,
        encoder_name: str = "timm-efficientnet-b5",
        *,
        encoder_weights: Optional[str] = None,
        decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
        in_channels: int = 4,
        classes: int = 3,
        squeeze_ratio: int = 1,
        expansion_ratio: int = 1,
        encoder_bn_eps: Optional[float] = None,
        encoder_pad_type: Optional[str] = None,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.architecture = "efficientunetplusplus"
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
        self.decoder = EfficientUnetPlusPlusDecoder(
            enc_channels, self.decoder_channels,
            squeeze_ratio=squeeze_ratio, expansion_ratio=expansion_ratio,
        )
        self.segmentation_head = SegmentationHead(
            self.decoder_channels[-1], classes, kernel_size=3
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
) -> SegmentationModel:
    """Architecture-string dispatch; takes the hparams keys the JAX
    trainer writes. There is no catch-all keyword: any other key raises
    ``TypeError``, so no option can be swallowed silently.

    ``encoder_options`` is the dict form of the convention knobs
    (``{"bn_eps": ..., "pad_type": ...}``); explicit ``encoder_bn_eps`` /
    ``encoder_pad_type`` win over it.
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
    if arch != "efficientunetplusplus":
        raise NotImplementedError(
            f"architecture {architecture!r} is not ported yet (ROADMAP.md, "
            "'The rest of the model zoo')"
        )
    if decoder_attention_type is not None:
        raise ValueError(
            "efficientunet++ has no decoder attention option "
            f"(got decoder_attention_type={decoder_attention_type!r})"
        )
    return SegmentationModel(
        encoder_name,
        encoder_weights=encoder_weights,
        decoder_channels=decoder_channels,
        in_channels=in_channels,
        classes=classes,
        encoder_bn_eps=encoder_bn_eps,
        encoder_pad_type=encoder_pad_type,
        dtype=dtype,
    )


@torch.no_grad()
def init_model(model: nn.Module, *, generator: torch.Generator) -> nn.Module:
    """(Re-)initialize ``model`` in place from ``generator`` with the JAX
    package's default initializers: conv kernels from a normal of std
    1/sqrt(fan_in) (lecun normal, without the truncation), conv biases
    zero, BatchNorm scale 1, bias 0, running mean 0 and variance 1.
    Returns the model."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model
