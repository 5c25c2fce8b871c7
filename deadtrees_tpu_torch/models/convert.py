"""Weights carried between the JAX package and the port.

The JAX package keeps a flax ``{"params", "batch_stats"}`` tree (NHWC
kernels); the port keeps a ``state_dict`` in the reference smp key layout
(NCHW kernels). This module maps one onto the other for the model of
record, EfficientUnet++ on an EfficientNet encoder, in both directions:

- :func:`state_dict_from_variables` — the inverse of the JAX package's
  ``convert_efficientnet_encoder`` / ``convert_inverted_residual`` /
  ``convert_effunetpp_checkpoint``: flax HWIO kernels → torch OIHW
  (depthwise (kH, kW, 1, C) → (C, 1, kH, kW)), BN scale/bias → weight/bias
  and mean/var → running_mean/running_var;
- :func:`variables_from_state_dict` — the same table read the other way,
  so the port writes checkpoints the JAX package loads.

Both walk one explicit key table, so a missing or misshaped tensor fails
loudly instead of scrambling weights.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deadtrees_tpu_torch.models.encoders import (
    _EFFNET_BASE,
    _EFFNET_PARAMS,
    _round_repeats,
)

# (flax path, torch prefix, kind) with kind "conv" | "bn"
_Entry = Tuple[Tuple[str, ...], str, str]

_GRID = "_DenseGridDecoder_0"


def _inverted_residual_table(
    fpath: Tuple[str, ...], tprefix: str, has_skip: bool
) -> List[_Entry]:
    se = fpath + ("SCSEModule_0",)
    table = [
        (fpath + ("Conv_0",), f"{tprefix}.block.0", "conv"),
        (fpath + ("BatchNorm_0",), f"{tprefix}.block.1", "bn"),
        (fpath + ("Conv_1",), f"{tprefix}.block.3", "conv"),
        (fpath + ("BatchNorm_1",), f"{tprefix}.block.4", "bn"),
        (se + ("SEModule_0", "Conv_0"), f"{tprefix}.block.6.cSE.1", "conv"),
        (se + ("SEModule_0", "Conv_1"), f"{tprefix}.block.6.cSE.3", "conv"),
        (se + ("SSEModule_0", "Conv_0"), f"{tprefix}.block.6.sSE.0", "conv"),
        (fpath + ("Conv_2",), f"{tprefix}.block.7", "conv"),
        (fpath + ("BatchNorm_2",), f"{tprefix}.block.8", "bn"),
    ]
    if has_skip:
        table += [
            (fpath + ("Conv_3",), f"{tprefix}.skip_conv.0", "conv"),
            (fpath + ("BatchNorm_3",), f"{tprefix}.skip_conv.1", "bn"),
        ]
    return table


def _encoder_table(repeats: Sequence[int]) -> List[_Entry]:
    table = [
        (("encoder", "Conv_0"), "encoder.conv_stem", "conv"),
        (("encoder", "BatchNorm_0"), "encoder.bn1", "bn"),
    ]
    mb = 0
    for stage, ((t, *_), n) in enumerate(zip(_EFFNET_BASE, repeats)):
        for b in range(n):
            f = ("encoder", f"MBConv_{mb}")
            tp = f"encoder.blocks.{stage}.{b}"
            if t != 1:
                names = [("conv_pw", "bn1"), ("conv_dw", "bn2"),
                         ("se.conv_reduce", None), ("se.conv_expand", None),
                         ("conv_pwl", "bn3")]
            else:
                names = [("conv_dw", "bn1"), ("se.conv_reduce", None),
                         ("se.conv_expand", None), ("conv_pw", "bn2")]
            bn_i = 0
            for conv_i, (conv, bn) in enumerate(names):
                table.append((f + (f"Conv_{conv_i}",), f"{tp}.{conv}", "conv"))
                if bn is not None:
                    table.append((f + (f"BatchNorm_{bn_i}",), f"{tp}.{bn}", "bn"))
                    bn_i += 1
            mb += 1
    return table


def _model_table(
    repeats: Sequence[int], cells: Sequence[Tuple[str, bool, bool]]
) -> List[_Entry]:
    """``cells``: (name, conv1 has skip, conv2 has skip) per grid cell."""
    table = _encoder_table(repeats)
    for cell, skip1, skip2 in cells:
        for i, (conv, has_skip) in enumerate((("conv1", skip1), ("conv2", skip2))):
            table += _inverted_residual_table(
                ("decoder", _GRID, cell, f"InvertedResidual_{i}"),
                f"decoder.blocks.{cell}.{conv}",
                has_skip,
            )
    table.append((("segmentation_head", "Conv_0"), "segmentation_head.0", "conv"))
    return table


def _repeats_for(n_blocks: int, encoder_name: Optional[str]) -> List[int]:
    if encoder_name is not None:
        key = encoder_name.lower().strip().replace("timm-", "")
        if key not in _EFFNET_PARAMS:
            raise ValueError(f"not an EfficientNet encoder: {encoder_name!r}")
        depth = _EFFNET_PARAMS[key][1]
        return [_round_repeats(n, depth) for (_, _, n, _, _) in _EFFNET_BASE]
    for _, depth in _EFFNET_PARAMS.values():
        repeats = [_round_repeats(n, depth) for (_, _, n, _, _) in _EFFNET_BASE]
        if sum(repeats) == n_blocks:
            return repeats
    raise ValueError(f"no EfficientNet variant has {n_blocks} MBConv blocks")


def _get(tree: Dict, path: Sequence[str]) -> Dict:
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: Dict, path: Sequence[str], value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _hwio_to_oihw(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _state_dict_from_table(table, params: Dict, stats: Dict) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def t(a) -> torch.Tensor:  # a writable copy: checkpoint arrays are read-only views
        return torch.from_numpy(np.array(a, copy=True, order="C"))

    for fpath, tkey, kind in table:
        p = _get(params, fpath)
        if kind == "conv":
            sd[f"{tkey}.weight"] = t(_hwio_to_oihw(np.asarray(p["kernel"])))
            if "bias" in p:
                sd[f"{tkey}.bias"] = t(p["bias"])
        else:
            sd[f"{tkey}.weight"] = t(p["scale"])
            sd[f"{tkey}.bias"] = t(p["bias"])
            if stats is not None:
                s = _get(stats, fpath)
                sd[f"{tkey}.running_mean"] = t(s["mean"])
                sd[f"{tkey}.running_var"] = t(s["var"])
                sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def state_dict_from_variables(
    variables: Dict[str, Dict], *, encoder_name: Optional[str] = None
) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree (numpy leaves) → the port's
    ``state_dict`` (CPU tensors, the leaves' dtype). Without
    ``"batch_stats"`` only the parameters are mapped (a tree of Adam
    moments has the parameters' layout).

    ``encoder_name`` fixes the encoder depth; without it the depth is
    read from the number of MBConv blocks in the tree."""
    params, stats = variables["params"], variables.get("batch_stats")
    n_blocks = sum(1 for k in params["encoder"] if k.startswith("MBConv_"))
    grid = params["decoder"][_GRID]
    cells = [
        (c, "Conv_3" in grid[c]["InvertedResidual_0"],
         "Conv_3" in grid[c]["InvertedResidual_1"])
        for c in sorted(grid)
    ]
    table = _model_table(_repeats_for(n_blocks, encoder_name), cells)
    return _state_dict_from_table(table, params, stats)


def state_dict_from_inverted_residual(
    params: Dict, batch_stats: Dict
) -> Dict[str, torch.Tensor]:
    """One flax ``InvertedResidual``'s variables → the ``state_dict`` of
    the port's :class:`~deadtrees_tpu_torch.models.blocks.InvertedResidual`
    (the inverse of the JAX ``convert_inverted_residual``)."""
    table = _inverted_residual_table(("ir",), "", "Conv_3" in params)
    sd = _state_dict_from_table(table, {"ir": params}, {"ir": batch_stats})
    return {k[1:]: v for k, v in sd.items()}  # drop the empty prefix's "."


def _flax_variables(sd: Dict[str, Any], encoder_name, to_hwio, f32) -> Dict[str, Dict]:
    n_blocks = len({
        ".".join(k.split(".")[:4]) for k in sd if k.startswith("encoder.blocks.")
    })
    cells = sorted({k.split(".")[2] for k in sd if k.startswith("decoder.blocks.")})
    cells = [
        (c, f"decoder.blocks.{c}.conv1.skip_conv.0.weight" in sd,
         f"decoder.blocks.{c}.conv2.skip_conv.0.weight" in sd)
        for c in cells
    ]
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for fpath, tkey, kind in _model_table(_repeats_for(n_blocks, encoder_name), cells):
        if kind == "conv":
            leaf = {"kernel": to_hwio(sd[f"{tkey}.weight"])}
            if f"{tkey}.bias" in sd:
                leaf["bias"] = f32(sd[f"{tkey}.bias"])
            _put(params, fpath, leaf)
        else:
            _put(params, fpath, {
                "scale": f32(sd[f"{tkey}.weight"]), "bias": f32(sd[f"{tkey}.bias"]),
            })
            if f"{tkey}.running_mean" in sd:
                _put(stats, fpath, {
                    "mean": f32(sd[f"{tkey}.running_mean"]),
                    "var": f32(sd[f"{tkey}.running_var"]),
                })
    return {"params": params, "batch_stats": stats}


def variables_from_state_dict(
    state_dict: Dict[str, Any], *, encoder_name: Optional[str] = None
) -> Dict[str, Dict]:
    """The port's ``state_dict`` → the JAX ``{"params", "batch_stats"}``
    tree with float32 numpy leaves (what the JAX checkpoint format holds).
    A dict of parameters alone gives empty ``"batch_stats"``."""
    sd = {
        k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in state_dict.items()
    }

    def f32(a) -> np.ndarray:
        return np.ascontiguousarray(a, dtype=np.float32)

    return _flax_variables(sd, encoder_name, lambda w: f32(_oihw_to_hwio(w)), f32)


def tensor_variables_from_state_dict(
    state_dict: Dict[str, torch.Tensor], *, encoder_name: Optional[str] = None
) -> Dict[str, Dict]:
    """:func:`variables_from_state_dict` with float32 tensor leaves on the
    tensors' own device: conv kernels are permuted to HWIO and made
    contiguous, every other leaf is the float32 tensor. A leaf may share
    the module's storage (a float32 bias, a kernel whose permutation is
    already contiguous): whoever keeps the tree past the next step must
    copy it (``core.checkpoint`` snapshots do)."""

    def to_hwio(w: torch.Tensor) -> torch.Tensor:
        return w.detach().permute(2, 3, 1, 0).float().contiguous()

    return _flax_variables(state_dict, encoder_name, to_hwio, lambda t: t.detach().float())
