"""Exported inference: a checkpoint as a stand-alone program with a dynamic
batch axis, the ONNX analogue.

Counterpart of ``deadtrees_tpu.infer.export``. The JAX package serializes
its jitted predictor with ``jax.export``; the port serializes the same
function with ``torch.export``: uint8 NHWC tiles ``(B, S, S, C)`` →
normalize → the plain model in the checkpoint's dtype (its own autocast)
→ argmax → uint8 ``(B, S, S)`` class map. The batch is a
``torch.export.Dim``; ``S`` is ``image_size``. The program is the model's
ATen graph with autocast made explicit casts (``run_decompositions({})``),
so its arithmetic is fixed when it is exported and does not change with
the device it runs on. The fused decoder's custom ops stay out of it, as
the JAX package keeps its Pallas kernels out of its artifact.

The file is the JAX package's envelope with the port's own magic line: a
msgpack map (``core/msgpack_codec.py``) of ``artifact`` (the bytes of
``torch.export.save``, without the example inputs it would store), ``meta``
(JSON: ``in_channels``, ``image_size``, ``classes``, ``quantized``,
``hparams``) and, for ``quantize=True``, ``weights``. A StableHLO program
and an ``ExportedProgram`` cannot stand in for each other, so each
package's loader refuses the other's file with ``ValueError``.

``quantize=True`` is the JAX design: ``weights`` holds the int8 tree of
``infer/quantize.py`` ``quantize_params`` (flax layout), the program takes
those kernels as bfloat16 inputs, and :func:`load_exported` dequantizes
them once. The exported module has no parameters under those names (they
are removed before the trace), so the program holds only the BatchNorm
statistics and the kernels too small to quantize.

:func:`load_exported` runs on CUDA unless asked for ``"cpu"`` (it raises
without CUDA, as ``resolve_device`` does) and moves a program exported on
one device to another with ``torch.export.passes.move_to_device_pass``.
The loaded program is a ``core.compile_opts.Program`` with
``by_default=False``: on CUDA it runs eagerly unless
``DEADTREES_COMPILE_OPTS`` is set.
"""

from __future__ import annotations

import io
import json
import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from deadtrees_tpu_torch.core.checkpoint import load_model
from deadtrees_tpu_torch.core.compile_opts import Program
from deadtrees_tpu_torch.core.msgpack_codec import packb, unpackb
from deadtrees_tpu_torch.data.config import DATASET_CONFIG
from deadtrees_tpu_torch.infer.engine import ExportedInference, resolve_device, static_tensors
from deadtrees_tpu_torch.ops.augment import channel_constants

__all__ = ["ExportedInference", "SUFFIX", "export_inference", "load_exported"]

log = logging.getLogger(__name__)

_MAGIC = b"DTTORCHEXP1\n"
# the default file suffix of an artifact (the JAX package's is ".dtexp")
SUFFIX = ".ptexp"


class _Predictor(nn.Module):
    """uint8 NHWC → uint8 class map: normalize, the model, argmax. With
    ``weight_names`` the model's parameters of those names come from the
    ``weights`` argument (the model must not hold them)."""

    def __init__(self, model: nn.Module, mean: Sequence[float], std: Sequence[float],
                 weight_names: Sequence[str] = ()):
        super().__init__()
        self.model = model
        m255, s255 = channel_constants(mean, std, len(mean), next(model.buffers()).device)
        self.register_buffer("m255", m255)
        self.register_buffer("s255", s255)
        self.weight_names = tuple(weight_names)

    def forward(self, img_u8: torch.Tensor,
                weights: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        img = ((img_u8.float() - self.m255) / self.s255).permute(0, 3, 1, 2).contiguous()
        if weights is None:
            logits = self.model(img)
        else:
            logits = torch.func.functional_call(
                self.model, dict(zip(self.weight_names, weights)), (img,), strict=False
            )
        return logits.argmax(1).to(torch.uint8)


def _weight_inputs(qparams: Dict, encoder_name: Optional[str]
                   ) -> Tuple[List[str], List[torch.Tensor]]:
    """The program's weight inputs for an int8 tree: the state-dict names
    of the quantized kernels and their dequantized bfloat16 values (CPU),
    in state-dict order."""
    from deadtrees_tpu_torch.infer.quantize import _is_quantized_leaf, dequantize_params
    from deadtrees_tpu_torch.models import state_dict_from_variables

    def mapped(quantized_leaf):
        def walk(node):
            if _is_quantized_leaf(node):
                return quantized_leaf(node)
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            return np.asarray(node)

        return state_dict_from_variables({"params": walk(qparams)}, encoder_name=encoder_name)

    names = [k for k, v in mapped(lambda n: np.asarray(n["q"])).items() if v.dtype == torch.int8]
    # bfloat16 has no numpy dtype: map the float32 image of the bfloat16
    # values, which holds them exactly, and round back
    values = mapped(lambda n: dequantize_params(n, dtype=torch.bfloat16).float().numpy())
    return names, [values[k].to(torch.bfloat16) for k in names]


def _drop_parameter(model: nn.Module, name: str) -> None:
    """Remove parameter ``name`` (dotted) from ``model``, leaving a plain
    ``None`` attribute for ``functional_call`` to fill."""
    owner, _, attr = name.rpartition(".")
    module = model.get_submodule(owner)
    delattr(module, attr)
    setattr(module, attr, None)


def export_inference(
    checkpoint: Union[str, Path],
    outfile: Union[str, Path],
    *,
    image_size: int = 256,
    mean: Sequence[float] = DATASET_CONFIG.mean,
    std: Sequence[float] = DATASET_CONFIG.std,
    quantize: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> None:
    """Checkpoint → exported artifact with a dynamic batch axis, traced on
    ``device`` (CUDA unless ``"cpu"``; raises without CUDA).

    ``quantize=True`` stores the kernels as int8 in the file (about 4×
    smaller for the flagship); the program takes them as bfloat16 inputs,
    dequantized once at load."""
    device = resolve_device(device)
    model, variables, hp = load_model(checkpoint, device=device)
    in_channels = hp.get("in_channels", 4)
    mean = tuple(mean)[:in_channels]
    std = tuple(std)[:in_channels]
    batch = torch.export.Dim("b", min=1)
    # batch 2: an example batch of 1 would specialize the program to it
    img = torch.zeros((2, image_size, image_size, in_channels), dtype=torch.uint8, device=device)

    weights_payload = None
    if quantize:
        from deadtrees_tpu_torch.infer.quantize import quantize_params

        qparams = quantize_params(variables["params"])
        names, weights = _weight_inputs(qparams, model.encoder_name)
        for name in names:
            _drop_parameter(model, name)
        weights = [w.to(device) for w in weights]
        predictor = _Predictor(model, mean, std, names)
        args, dynamic = (img, weights), ({0: batch}, [None] * len(weights))
        weights_payload = packb(qparams)
    else:
        predictor = _Predictor(model, mean, std)
        args, dynamic = (img,), ({0: batch},)

    with torch.no_grad():
        program = torch.export.export(predictor.eval(), args, dynamic_shapes=dynamic)
        program = program.run_decompositions({})
    program.example_inputs = None  # torch.export.save would store them
    buf = io.BytesIO()
    torch.export.save(program, buf)

    payload = {
        "artifact": buf.getvalue(),
        "meta": json.dumps({
            "in_channels": in_channels,
            "image_size": image_size,
            "classes": hp.get("classes", 3),
            "quantized": bool(quantize),
            "hparams": hp,
        }).encode(),
    }
    if weights_payload is not None:
        payload["weights"] = weights_payload
    outfile = Path(outfile)
    outfile.parent.mkdir(parents=True, exist_ok=True)
    with open(outfile, "wb") as f:
        f.write(_MAGIC)
        f.write(packb(payload))
    log.info(f"Exported inference artifact to {outfile}")


def load_exported(
    path: Union[str, Path], device: Optional[Union[str, torch.device]] = None
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], Dict]:
    """``(program, meta)`` of an artifact: ``program(img_u8)`` takes a
    ``(B, S, S, C)`` uint8 tensor on ``device`` (CUDA unless ``"cpu"``) and
    returns the ``(B, S, S)`` uint8 class map there."""
    from torch.export.passes import move_to_device_pass

    device = resolve_device(device)
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"Not an exported artifact of deadtrees_tpu_torch: {path}")
        payload = unpackb(f.read())
    meta = json.loads(payload["meta"])
    exported = torch.export.load(io.BytesIO(payload["artifact"]))
    module = move_to_device_pass(exported, device).module().requires_grad_(False)

    if "weights" in payload:  # quantized artifact: int8 weights in the payload
        _, weights = _weight_inputs(unpackb(payload["weights"]), meta["hparams"].get("encoder_name"))
        weights = [w.to(device) for w in weights]  # dequantized once, at load
        static_tensors(weights)

        def predict(img_u8: torch.Tensor) -> torch.Tensor:
            return module(img_u8, weights)

    else:

        def predict(img_u8: torch.Tensor) -> torch.Tensor:
            return module(img_u8)

    # compiled on CUDA only when asked for (core/compile_opts.py)
    return Program(predict, device, by_default=False), meta
