"""Inference engine: one checkpoint, uint8 tiles in, class maps out.

Counterpart of ``deadtrees_tpu.infer.engine.JaxInference``:
:class:`TorchInference` loads a checkpoint of the JAX package's format,
takes the channel count from the hparams (else the encoder stem conv),
drops NIR when a 3-channel model gets 4-band input, normalizes in float32
and returns argmax class maps. The public layout is the JAX package's:
NHWC uint8 ``(B, H, W, C)`` in, ``(B, H, W)`` uint8 out.

It runs on CUDA unless the caller passes ``device="cpu"``; with no device
asked for and no CUDA available it raises. Every option of the JAX
engine is ported (the fused decoder in both layouts, w8 / w8a8
quantization, TTA) with its validation. :class:`EnsembleInference` is the
odd-N majority vote over checkpoints; :class:`ExportedInference` runs an
artifact of ``infer/export.py`` (the ONNX analogue: a ``torch.export``
program with a dynamic batch).

Each route is one compiled program per input shape
(``core.compile_opts.Program``), as the JAX engine jits each: uint8 in,
normalize, forward, argmax, uint8 out; w8a8 has a calibrate and a predict
program, the ensemble a vote program. On CUDA, w8a8, TTA and the vote run
eagerly unless ``DEADTREES_COMPILE_OPTS`` is set (``by_default=False``:
their compiled form is not yet checked on the card). ``"auto"``'s cut at
:data:`FUSED_MAX_BATCH` is a Python branch on the batch size, which is
static in a program: each batch size traces one side of it. On the card a
program replays as a CUDA graph, which overwrites its output at the next
replay: :meth:`TorchInference.predict` returns a copy, and :meth:`run`
copies it to the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from deadtrees_tpu_torch.core.checkpoint import load_model
from deadtrees_tpu_torch.core.compile_opts import Program
from deadtrees_tpu_torch.models import state_dict_from_variables
from deadtrees_tpu_torch.data.config import DATASET_CONFIG
from deadtrees_tpu_torch.ops.augment import channel_constants

# Batches of at most this many images take the fused decoder under
# fused_decoder="auto"; larger ones take the plain model (the JAX
# engine's rule).
FUSED_MAX_BATCH = 32

_FUSED_CHOICES = (False, True, "", "auto", "chw", "nhwc")
_QUANT_CHOICES = (False, True, "", "w8", "w8a8")
_TTA_CHOICES = (False, 0, True, 4, 8)


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


def normalizer(mean: Sequence[float], std: Sequence[float], device: torch.device):
    """``normalize`` of ``data/augment.py`` with its constants made once, on
    ``device``: a program then reads them as static inputs and makes no
    host-to-device copy. Returns ``f(img_f32 NHWC) -> (x - 255 m) / (255 s)``."""
    m255, s255 = channel_constants(mean, std, len(mean), device)
    for t in (m255, s255):
        torch._dynamo.mark_static_address(t)

    def normalize(img_f32: torch.Tensor) -> torch.Tensor:
        return (img_f32 - m255) / s255

    return normalize


def static_tensors(tree) -> None:
    """Mark every tensor of ``tree`` (dicts, lists, tuples) as a static
    input of the programs that read it: a CUDA graph then reads it where it
    lies instead of copying it in before each replay."""
    if isinstance(tree, torch.Tensor):
        torch._dynamo.mark_static_address(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            static_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            static_tensors(v)


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
        quant_sites: Sequence[str] = ("y",),
        tta: Union[bool, int] = False,
    ):
        """Every architecture of the zoo serves on the plain model, with
        ``quantized=True`` (w8) and ``tta``. ``fused_decoder`` and w8a8
        apply to efficientunet++ checkpoints (on any encoder) and raise
        ``ValueError`` for any other architecture. ``fused_decoder`` routes
        the decoder through the fused CUDA kernels with BatchNorms folded
        at load:

        - ``"auto"``: batch-size-aware — requests with ≤32 images run the
          CHW kernels, larger batches the plain model (the serving API
          uses this);
        - ``"chw"`` (or ``True``): always the CHW kernels (kernel 1);
        - ``"nhwc"``: always the NHWC route, the fat cells on the NHWC
          kernel pair (``ops/fused_cell.py``).

        ``quantized=True`` (or ``"w8"``) round-trips every large kernel
        through per-channel int8 once at load, rounds it to bfloat16, and
        serves the usual path on those weights. ``"w8a8"`` also stores the
        decoder's intra-block activations of ``quant_sites`` (y, h, s)
        through int8 with scales calibrated on ``batch[:32]`` of the first
        :meth:`run`; it runs the NHWC decoder with its own block function.
        ``tta`` (True = 8, or 4) averages softmax probabilities over the
        dihedral views of the plain model. The combinations the JAX engine
        refuses raise ``ValueError`` here too."""
        if fused_decoder not in _FUSED_CHOICES:
            raise ValueError(
                f"fused_decoder={fused_decoder!r}; expected one of {_FUSED_CHOICES}"
            )
        if quantized not in _QUANT_CHOICES:
            raise ValueError(
                f"quantized={quantized!r}; expected False, True ('w8'), 'w8' or 'w8a8'"
            )
        if quantized == "w8a8" and fused_decoder:
            raise ValueError(
                "quantized='w8a8' runs its own folded-decoder program; "
                "it cannot be combined with fused_decoder"
            )
        bad_sites = set(quant_sites) - {"y", "h", "s"}
        if bad_sites:
            raise ValueError(f"unknown quant_sites {sorted(bad_sites)}")
        if tta not in _TTA_CHOICES:
            raise ValueError(f"tta={tta!r}; expected False, True (8), 4 or 8")
        if tta and (fused_decoder or quantized == "w8a8"):
            raise ValueError(
                "tta composes with the standard predict path only "
                "(not fused_decoder / quantized='w8a8')"
            )
        self.tta_views = 8 if tta is True else int(tta)
        self.device = resolve_device(device)
        self.model, self.variables, self.hparams = load_model(
            checkpoint, device=self.device
        )
        if (fused_decoder or quantized == "w8a8") and (
            self.model.architecture != "efficientunetplusplus"
        ):
            raise ValueError(
                f"fused_decoder={fused_decoder!r} / quantized={quantized!r} run the folded "
                "EfficientUnet++ decoder; this checkpoint is "
                f"{self.model.architecture} on {self.model.encoder_name}"
            )
        self.in_channels = _sniff_in_channels(self.variables["params"], self.hparams)
        self.mean = tuple(mean)[: self.in_channels]
        self.std = tuple(std)[: self.in_channels]
        self.quantized = "w8" if quantized is True else (quantized or False)
        self.quant_sites = frozenset(quant_sites)
        if self.quantized:
            self._round_trip_weights()
        self.fused_decoder = "auto" if fused_decoder == "auto" else bool(fused_decoder)
        self.layout = "nhwc" if fused_decoder == "nhwc" else "chw"
        self.folded = None
        self._scales = None  # w8a8: calibrated on the first run() batch
        if self.fused_decoder or self.quantized == "w8a8":
            from deadtrees_tpu_torch.ops.fused_decoder import fold_effunetpp_decoder

            self.folded = fold_effunetpp_decoder(self.model)
            static_tensors(self.folded)
        self._normalize = normalizer(self.mean, self.std, self.device)
        # w8a8 and TTA compile on CUDA only when asked for (core/compile_opts.py)
        self._program = Program(self._predict, self.device,
                                by_default=not (self.tta_views or self.quantized == "w8a8"))
        self._calibrate = Program(self._calibrate_w8a8, self.device, by_default=False)

    def _round_trip_weights(self) -> None:
        """int8 as a storage format: quantize the kernels once, serve their
        bfloat16-rounded dequantized values (the JAX engine's w8 load)."""
        from deadtrees_tpu_torch.infer.quantize import dequantize_params, quantize_params

        params = dequantize_params(
            quantize_params(self.variables["params"]), dtype=torch.bfloat16
        )
        params = _map_leaves(params, lambda t: t.float().numpy())
        self.variables = {"params": params, "batch_stats": self.variables["batch_stats"]}
        self.model.load_state_dict(
            state_dict_from_variables(self.variables, encoder_name=self.model.encoder_name)
        )

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

    def _logits_nhwc(self, img_nhwc: torch.Tensor) -> torch.Tensor:
        """The plain model on a normalized NHWC batch; NHWC float32 logits."""
        logits = self.model(img_nhwc.permute(0, 3, 1, 2).contiguous())
        return logits.permute(0, 2, 3, 1)

    def _calibrate_w8a8(self, img_u8: torch.Tensor):
        """w8a8's calibrate program: the decoder's activation scales from
        the batch (the JAX engine's ``_calibrate``)."""
        from deadtrees_tpu_torch.infer.act_quant import calibrate_decoder
        from deadtrees_tpu_torch.ops.fused_decoder import encode_features_nhwc

        img = self._normalize(img_u8.float()).permute(0, 3, 1, 2).contiguous()
        feats = encode_features_nhwc(self.model, img)
        return calibrate_decoder(feats, self.folded, self.model.decoder_channels)

    def _predict_w8a8(self, img: torch.Tensor, scales) -> torch.Tensor:
        from deadtrees_tpu_torch.infer.act_quant import make_int8_block_fn
        from deadtrees_tpu_torch.ops.fused_decoder import (
            apply_head,
            encode_features_nhwc,
            fused_decoder_nhwc,
        )

        feats = encode_features_nhwc(self.model, img)
        decoded = fused_decoder_nhwc(
            feats, self.folded, self.model.decoder_channels,
            block_fn=make_int8_block_fn(scales, sites=self.quant_sites),
        )
        return apply_head(self.model, decoded.permute(0, 3, 1, 2)).argmax(1)

    def _predict(self, img_u8: torch.Tensor, scales=None) -> torch.Tensor:
        """The route's program: (B, H, W, C) uint8 → (B, H, W) uint8."""
        img_nhwc = self._normalize(img_u8.float())
        if self.tta_views:
            from deadtrees_tpu_torch.infer.tta import make_tta_fn

            probs = make_tta_fn(self._logits_nhwc, self.tta_views)(img_nhwc)
            return probs.argmax(-1).to(torch.uint8)
        img = img_nhwc.permute(0, 3, 1, 2).contiguous()
        if self.quantized == "w8a8":
            return self._predict_w8a8(img, scales).to(torch.uint8)
        if self.uses_fused(img.shape[0]):
            from deadtrees_tpu_torch.ops.fused_decoder import fused_forward

            logits = fused_forward(self.model, self.folded, img, layout=self.layout)
            return logits.argmax(1).to(torch.uint8)
        probs = torch.softmax(self.model(img), dim=1)
        return probs.argmax(1).to(torch.uint8)

    @torch.no_grad()
    def predict(self, img_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) uint8 tensor on the engine's device → (B, H, W)
        uint8 class map on the device, through the route's program. w8a8
        calibrates its scales on ``img_u8[:32]`` of the first call (its
        calibrate program), as the JAX engine does."""
        if self.quantized == "w8a8":
            if self._scales is None:
                # post-training calibration on a slice of the first batch
                self._scales = self._calibrate(img_u8[:32])
                static_tensors(self._scales)
            return self._program(img_u8, self._scales)
        return self._program(img_u8)

    def run(self, batch: np.ndarray) -> np.ndarray:
        """(B, H, W, C) uint8 → (B, H, W) uint8 class map."""
        batch = self._slice_channels(np.asarray(batch))
        img = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.uint8))
        return self.predict(img.to(self.device)).cpu().numpy()


class EnsembleInference(Inference):
    """Odd-N majority vote over model checkpoints.

    - Members with equal hparams (the common case) run one after another
      on the device, each giving the argmax of its logits; the votes are
      summed as one-hot int32 on the device and the result is their argmax,
      which picks the smallest class on a tie (``torch.argmax`` returns the
      first maximal index), as the reference's ``torch.mode`` does.
    - Members of mixed hparams (any architectures and encoders of the zoo,
      a Unet beside an EfficientUnet++ or a SegFormer): one plain
      :class:`TorchInference` each (argmax of the softmax), the votes
      summed on the host. Members must agree on ``classes``;
      ``in_channels`` may differ, each member slices its own, and the
      widest is kept here.

    Runs on CUDA unless ``device="cpu"``; raises without CUDA."""

    def __init__(
        self,
        checkpoints: Sequence[Union[str, Path]],
        *,
        device: Optional[Union[str, torch.device]] = None,
        mean: Sequence[float] = DATASET_CONFIG.mean,
        std: Sequence[float] = DATASET_CONFIG.std,
    ):
        if len(checkpoints) % 2 != 1:
            raise ValueError(
                f"Ensemble inference expects odd number of models, got {len(checkpoints)}"
            )
        self.device = resolve_device(device)
        members = [load_model(c, device=self.device) for c in checkpoints]
        hp0 = members[0][2]
        self.homogeneous = all(hp == hp0 for _, _, hp in members[1:])
        self.hparams = hp0
        self.num_classes = hp0.get("classes", 3)
        if any(hp.get("classes", 3) != self.num_classes for _, _, hp in members[1:]):
            raise ValueError(
                "Ensemble members must agree on `classes` "
                f"({[hp.get('classes', 3) for _, _, hp in members]})"
            )
        self.in_channels = _sniff_in_channels(members[0][1]["params"], hp0)
        if self.homogeneous:
            self.models: List[torch.nn.Module] = [m for m, _, _ in members]
            self.model = self.models[0]
            self.mean = tuple(mean)[: self.in_channels]
            self.std = tuple(std)[: self.in_channels]
            self._normalize = normalizer(self.mean, self.std, self.device)
            self._program = Program(self._vote, self.device, by_default=False)
        else:
            del members  # don't hold N models across the re-load
            self._members = [
                TorchInference(c, device=self.device, mean=mean, std=std)
                for c in checkpoints
            ]
            self.model = self._members[0].model
            self.in_channels = max(m.in_channels for m in self._members)

    def _vote(self, img_u8: torch.Tensor) -> torch.Tensor:
        """The vote's program: every member's argmax, summed one-hot."""
        img = self._normalize(img_u8.float()).permute(0, 3, 1, 2).contiguous()
        votes = None
        for model in self.models:
            one_hot = torch.nn.functional.one_hot(model(img).argmax(1), self.num_classes)
            votes = one_hot.int() if votes is None else votes + one_hot.int()
        return votes.argmax(-1).to(torch.uint8)

    def run(self, batch: np.ndarray) -> np.ndarray:
        """(B, H, W, C) uint8 → (B, H, W) uint8 majority class map."""
        batch = np.asarray(batch)
        if batch.shape[-1] > self.in_channels:
            batch = batch[..., : self.in_channels]
        if self.homogeneous:
            img = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.uint8))
            with torch.no_grad():
                return self._program(img.to(self.device)).cpu().numpy()
        votes = np.zeros(batch.shape[:3] + (self.num_classes,), np.int32)
        classes = np.arange(self.num_classes)
        for member in self._members:
            preds = member.run(batch)  # member slices its own channels
            votes += (preds[..., None] == classes).astype(np.int32)
        return np.argmax(votes, axis=-1).astype(np.uint8)


class ExportedInference(Inference):
    """Runs an exported artifact of ``infer/export.py`` (the ONNX analogue;
    the JAX engine's ``ExportedInference``). Input channels are sliced to
    the artifact's ``in_channels``; tiles must be its ``image_size``. Runs
    on CUDA unless ``device="cpu"``; raises without CUDA."""

    def __init__(self, artifact: Union[str, Path], *,
                 device: Optional[Union[str, torch.device]] = None):
        from deadtrees_tpu_torch.infer.export import load_exported

        self.device = resolve_device(device)
        self._program, self.meta = load_exported(artifact, device=self.device)
        self.in_channels = self.meta.get("in_channels", 4)

    @torch.no_grad()
    def predict(self, img_u8: torch.Tensor) -> torch.Tensor:
        """(B, S, S, C) uint8 tensor on the engine's device → (B, S, S)
        uint8 class map on the device."""
        return self._program(img_u8)

    def run(self, batch: np.ndarray) -> np.ndarray:
        """(B, S, S, C) uint8 → (B, S, S) uint8 class map."""
        batch = np.asarray(batch)
        if batch.shape[-1] > self.in_channels:
            batch = batch[..., : self.in_channels]
        img = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.uint8))
        return self.predict(img.to(self.device)).cpu().numpy()


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)
