"""Int8 weight-only quantization for serving.

Counterpart of ``deadtrees_tpu.infer.quantize``, on the port's flax-layout
variable trees (numpy leaves, as ``core.checkpoint`` reads them):

- conv/dense kernels (ndim >= 2, >= ``min_size`` elements) → int8 ``q`` +
  float32 ``scale`` per output channel (the last axis), ``w ≈ q * scale``;
- biases and BatchNorm parameters/statistics stay float32.

Int8 is a storage format: the engine round-trips the weights through it
once at load and serves the dequantized values (``TorchInference(
quantized="w8")``). :func:`quantize_params` is the JAX function's numpy
code, so ``q`` and ``scale`` are bit-equal to it. :func:`argmax_agreement`
measures the accuracy delta.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def _quantize_leaf(w: np.ndarray) -> Dict[str, Any]:
    """Per-output-channel (last axis) symmetric int8 quantization."""
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale.reshape(-1)}


def _is_quantized_leaf(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def quantize_params(params: Dict, min_size: int = 1024) -> Dict:
    """Quantize every float kernel leaf with >= ``min_size`` elements
    (small tensors — biases, BN — aren't worth the rounding error)."""

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        arr = np.asarray(node)
        if np.issubdtype(arr.dtype, np.floating) and arr.ndim >= 2 and arr.size >= min_size:
            return _quantize_leaf(arr)
        return arr

    return walk(params)


def dequantize_params(qparams: Dict, dtype: torch.dtype = torch.float32) -> Dict:
    """Inverse of :func:`quantize_params`: a tree of CPU tensors, each
    quantized leaf as ``(q · scale)`` in float32 rounded to ``dtype``, the
    other leaves as they are."""

    def walk(node):
        if _is_quantized_leaf(node):
            q = torch.from_numpy(np.asarray(node["q"])).float()
            scale = torch.from_numpy(np.asarray(node["scale"], np.float32))
            return (q * scale.reshape((1,) * (q.dim() - 1) + (-1,))).to(dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node))

    return walk(qparams)


def quantized_nbytes(qparams: Dict) -> Tuple[int, int]:
    """(quantized bytes, original float32 bytes) for reporting."""
    qb = fb = 0

    def walk(node):
        nonlocal qb, fb
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
            return
        arr = np.asarray(node)
        qb += arr.nbytes
        fb += arr.size * (4 if arr.dtype == np.int8 else arr.itemsize)

    walk(qparams)
    return qb, fb


def argmax_agreement(pred_a, pred_b) -> float:
    """Fraction of pixels with identical argmax — the measured accuracy
    delta of quantization."""
    a, b = np.asarray(pred_a), np.asarray(pred_b)
    return float((a == b).mean())
