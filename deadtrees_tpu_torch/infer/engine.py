"""Inference engine: one checkpoint, uint8 tiles in, class maps out.

Counterpart of ``deadtrees_tpu.infer.engine.JaxInference``:
:class:`TorchInference` loads a checkpoint of the JAX package's format,
takes the channel count from the hparams (else the encoder stem conv),
drops NIR when a 3-channel model gets 4-band input, normalizes in float32
and returns argmax class maps. The public layout is the JAX package's:
NHWC uint8 ``(B, H, W, C)`` in, ``(B, H, W)`` uint8 out.

It runs on CUDA unless the caller passes ``device="cpu"``; with no device
asked for and no CUDA available it raises. The ensemble and exported
engines, TTA and quantized serving are not ported yet: asking for them
raises ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from deadtrees_tpu_torch.core.checkpoint import load_model
from deadtrees_tpu_torch.data.augment import normalize
from deadtrees_tpu_torch.data.config import DATASET_CONFIG

# Batches of at most this many images take the fused decoder under
# fused_decoder="auto"; larger ones take the plain model (the JAX
# engine's rule).
FUSED_MAX_BATCH = 32

_FUSED_CHOICES = (False, True, "", "auto", "chw", "nhwc")


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise.
    Raises when CUDA is wanted (explicitly or by default) and missing."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on a CUDA device unless "
            "device='cpu' is passed"
        )
    return device


def _sniff_in_channels(params, hparams: Optional[dict] = None) -> int:
    """Channel count: from hparams when present, else the encoder stem
    conv kernel (flax HWIO layout, ``encoder/Conv_0``)."""
    if hparams and "in_channels" in hparams:
        return int(hparams["in_channels"])
    stem = params.get("encoder", params).get("Conv_0")
    if stem is None or "kernel" not in stem:
        raise ValueError("Could not sniff input channels from params")
    return int(stem["kernel"].shape[2])


class Inference:
    """ABC surface matching the reference engines."""

    def run(self, batch: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class TorchInference(Inference):
    def __init__(
        self,
        checkpoint: Union[str, Path],
        *,
        device: Optional[Union[str, torch.device]] = None,
        mean: Sequence[float] = DATASET_CONFIG.mean,
        std: Sequence[float] = DATASET_CONFIG.std,
        fused_decoder: Union[bool, str] = False,
        quantized: Union[bool, str] = False,
        tta: Union[bool, int] = False,
    ):
        """``fused_decoder`` routes the decoder through the fused CUDA
        kernels with BatchNorms folded at load:

        - ``"auto"``: batch-size-aware — requests with ≤32 images run the
          fused decoder, larger batches the plain model (the serving API
          uses this);
        - ``"chw"`` (or ``True``): always the fused decoder;
        - ``"nhwc"``: not ported yet (raises).
        """
        if fused_decoder not in _FUSED_CHOICES:
            raise ValueError(
                f"fused_decoder={fused_decoder!r}; expected one of {_FUSED_CHOICES}"
            )
        if fused_decoder == "nhwc":
            raise NotImplementedError(
                "fused_decoder='nhwc' (the fused_ir_fat kernels) is not ported "
                "yet (ROADMAP.md, 'fused_decoder=\"nhwc\"')"
            )
        if quantized:
            raise NotImplementedError(
                f"quantized={quantized!r} is not ported yet (ROADMAP.md, "
                "'Serving extras')"
            )
        if tta:
            raise NotImplementedError(
                f"tta={tta!r} is not ported yet (ROADMAP.md, 'Serving extras')"
            )
        self.device = resolve_device(device)
        self.model, self.variables, self.hparams = load_model(
            checkpoint, device=self.device
        )
        self.in_channels = _sniff_in_channels(self.variables["params"], self.hparams)
        self.mean = tuple(mean)[: self.in_channels]
        self.std = tuple(std)[: self.in_channels]
        self.fused_decoder = "auto" if fused_decoder == "auto" else bool(fused_decoder)
        self.folded = None
        if self.fused_decoder:
            from deadtrees_tpu_torch.ops.fused_decoder import fold_effunetpp_decoder

            self.folded = fold_effunetpp_decoder(self.model)

    def _slice_channels(self, batch: np.ndarray) -> np.ndarray:
        # RGBN checkpoint trained on 3 channels: drop NIR
        if batch.shape[-1] > self.in_channels:
            batch = batch[..., : self.in_channels]
        return batch

    def uses_fused(self, batch_size: int) -> bool:
        """Whether a batch of this size runs the fused decoder."""
        if self.fused_decoder == "auto":
            return batch_size <= FUSED_MAX_BATCH
        return bool(self.fused_decoder)

    @torch.no_grad()
    def predict(self, img_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) uint8 tensor on the engine's device → (B, H, W)
        uint8 class map on the device."""
        img = normalize(img_u8.float(), self.mean, self.std)
        img = img.permute(0, 3, 1, 2).contiguous()
        if self.uses_fused(img.shape[0]):
            from deadtrees_tpu_torch.ops.fused_decoder import fused_forward

            logits = fused_forward(self.model, self.folded, img)
            return logits.argmax(1).to(torch.uint8)
        probs = torch.softmax(self.model(img), dim=1)
        return probs.argmax(1).to(torch.uint8)

    def run(self, batch: np.ndarray) -> np.ndarray:
        """(B, H, W, C) uint8 → (B, H, W) uint8 class map."""
        batch = self._slice_channels(np.asarray(batch))
        img = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.uint8))
        return self.predict(img.to(self.device)).cpu().numpy()
