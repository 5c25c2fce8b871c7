"""Weights carried between the JAX package and the port.

The JAX package keeps a flax ``{"params", "batch_stats"}`` tree (NHWC
kernels); the port keeps a ``state_dict`` in the reference smp key layout
(NCHW kernels). This module maps one onto the other for every model of the
zoo, in both directions:

- :func:`state_dict_from_variables` — the inverse of the JAX package's
  ``convert_resnet_encoder`` / ``convert_efficientnet_encoder`` and of its
  ``convert_{unet,resunet,unetpp,resunetpp,effunetpp}_checkpoint``, plus
  the SCSE / SE decoder attention (which those converters do not map) and
  SegFormer: flax HWIO kernels → torch OIHW (depthwise (kH, kW, 1, C) →
  (C, 1, kH, kW)), ``Dense`` (in, out) → ``nn.Linear`` (out, in), BN
  scale/bias → weight/bias and mean/var → running_mean/running_var,
  ``LayerNorm`` scale/bias → weight/bias;
- :func:`variables_from_state_dict` — the same table read the other way,
  so the port writes checkpoints the JAX package loads.

The MiT encoders in smp's layout (``models/mit.py``) have no JAX
counterpart; their tree is the port's own (``encoder/patch_embed{s}/proj``,
``encoder/block{s}_{i}/attn/kv``, ... : the torch names, kernels in flax's
layout), so that the port's checkpoints of a U-Net-family decoder on them
round-trip.

Both walk one explicit key table, built from the model's structure
(:func:`_spec_from_params` reads it off a flax tree, :func:`_spec_from_state_dict`
off a state dict), so a missing or misshaped tensor fails loudly instead
of scrambling weights. Flax names submodules by class and call order
(``ConvBnAct_0``, ``SCSEModule_1``, ``BasicBlock_7``), and the tables
follow those counters.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deadtrees_tpu_torch.models.encoders import (
    _EFFNET_BASE,
    _EFFNET_PARAMS,
    RESNET_GEOMETRY,
    RESNET_WIDTHS,
    _round_repeats,
)
from deadtrees_tpu_torch.models.segformer import MIT_CONFIGS, SR_RATIOS

# (flax path, torch prefix, kind) with kind "conv" | "bn" | "dense" | "ln"
_Entry = Tuple[Tuple[str, ...], str, str]
Spec = Dict[str, Any]

_GRID = "_DenseGridDecoder_0"
# every encoder emits 6 features: the deepest feeds the decoder, 4 are skips
_N_SKIPS = 4


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


def _effnet_encoder_table(repeats: Sequence[int]) -> List[_Entry]:
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


def _resnet_encoder_table(stage_sizes: Sequence[int], block: str) -> List[_Entry]:
    """torchvision ``layer{s}.{b}`` ↔ flax ``BasicBlock_{i}`` /
    ``Bottleneck_{i}`` (numbered across stages); a block's projection is
    its last ``Conv`` / ``BatchNorm`` pair."""
    table = [
        (("encoder", "Conv_0"), "encoder.conv1", "conv"),
        (("encoder", "BatchNorm_0"), "encoder.bn1", "bn"),
    ]
    n_convs, expansion = (2, 1) if block == "basic" else (3, 4)
    flax_block = "BasicBlock" if block == "basic" else "Bottleneck"
    cin, index = 64, 0
    for stage, (n, width) in enumerate(zip(stage_sizes, RESNET_WIDTHS)):
        for b in range(n):
            f = ("encoder", f"{flax_block}_{index}")
            tp = f"encoder.layer{stage + 1}.{b}"
            for c in range(n_convs):
                table.append((f + (f"Conv_{c}",), f"{tp}.conv{c + 1}", "conv"))
                table.append((f + (f"BatchNorm_{c}",), f"{tp}.bn{c + 1}", "bn"))
            if (stage > 0 and b == 0) or cin != width * expansion:
                table.append((f + (f"Conv_{n_convs}",), f"{tp}.downsample.0", "conv"))
                table.append((f + (f"BatchNorm_{n_convs}",), f"{tp}.downsample.1", "bn"))
            cin = width * expansion
            index += 1
    return table


def _attention_table(
    fpath: Tuple[str, ...], tprefix: str, attention: Optional[str], index: int
) -> List[_Entry]:
    """smp's ``Attention`` wrapper (``{tprefix}.attention``) ↔ the flax
    ``SCSEModule_{index}`` / ``SEModule_{index}`` of the block."""
    if attention is None:
        return []
    t = f"{tprefix}.attention"
    if attention == "scse":
        f = fpath + (f"SCSEModule_{index}",)
        return [
            (f + ("SEModule_0", "Conv_0"), f"{t}.cSE.1", "conv"),
            (f + ("SEModule_0", "Conv_1"), f"{t}.cSE.3", "conv"),
            (f + ("SSEModule_0", "Conv_0"), f"{t}.sSE.0", "conv"),
        ]
    f = fpath + (f"SEModule_{index}",)
    return [(f + ("Conv_0",), f"{t}.1", "conv"), (f + ("Conv_1",), f"{t}.3", "conv")]


def _unet_block_table(
    fpath: Tuple[str, ...], tprefix: str, has_skip: bool, attention: Optional[str]
) -> List[_Entry]:
    """``conv{1,2}.0`` / ``.1`` ↔ ``ConvBnAct_{0,1}``; the attention around
    them (flax numbers ``attention1`` 0 and ``attention2`` 1 when there is
    a skip, ``attention2`` 0 when there is none)."""
    table = []
    for j, conv in enumerate(("conv1", "conv2")):
        f = fpath + (f"ConvBnAct_{j}",)
        table.append((f + ("Conv_0",), f"{tprefix}.{conv}.0", "conv"))
        table.append((f + ("BatchNorm_0",), f"{tprefix}.{conv}.1", "bn"))
    if has_skip:
        table += _attention_table(fpath, f"{tprefix}.attention1", attention, 0)
    table += _attention_table(fpath, f"{tprefix}.attention2", attention, int(has_skip))
    return table


def _aspp_table(fpath: Tuple[str, ...], tprefix: str) -> List[_Entry]:
    """Branch k: ``aspp_block{k+1}.0`` conv / ``.2`` BN ↔ ``Conv_k`` /
    ``BatchNorm_k``; the merge ``output`` ↔ ``Conv_4``."""
    table = []
    for k in range(4):
        table.append((fpath + (f"Conv_{k}",), f"{tprefix}.aspp_block{k + 1}.0", "conv"))
        table.append((fpath + (f"BatchNorm_{k}",), f"{tprefix}.aspp_block{k + 1}.2", "bn"))
    table.append((fpath + ("Conv_4",), f"{tprefix}.output", "conv"))
    return table


def _rupp_attention_table(
    fpath: Tuple[str, ...], tprefix: str, has_skip: bool
) -> List[_Entry]:
    """The gate's ``Sequential(BN, ReLU, conv)`` stacks (BN at 0, conv at
    2) ↔ ``BatchNorm_i`` / ``Conv_i`` in call order: decoder_conv,
    encoder_conv (with a skip only), attn_conv."""
    stacks = ["decoder_conv"] + (["encoder_conv"] if has_skip else []) + ["attn_conv"]
    table = []
    for i, stack in enumerate(stacks):
        table.append((fpath + (f"BatchNorm_{i}",), f"{tprefix}.{stack}.0", "bn"))
        table.append((fpath + (f"Conv_{i}",), f"{tprefix}.{stack}.2", "conv"))
    return table


def _mit_encoder_table(depths: Sequence[int]) -> List[_Entry]:
    """smp's MiT keys (``models/mit.py``) ↔ a tree of the same names."""
    table: List[_Entry] = []
    for s, depth in enumerate(depths, start=1):
        f, tp = ("encoder", f"patch_embed{s}"), f"encoder.patch_embed{s}"
        table += [(f + ("proj",), f"{tp}.proj", "conv"), (f + ("norm",), f"{tp}.norm", "ln")]
        for i in range(depth):
            f, tp = ("encoder", f"block{s}_{i}"), f"encoder.block{s}.{i}"
            table += [(f + ("norm1",), f"{tp}.norm1", "ln")]
            table += [(f + ("attn", n), f"{tp}.attn.{n}", "dense") for n in ("q", "kv", "proj")]
            if SR_RATIOS[s - 1] > 1:
                table += [(f + ("attn", "sr"), f"{tp}.attn.sr", "conv"),
                          (f + ("attn", "norm"), f"{tp}.attn.norm", "ln")]
            table += [
                (f + ("norm2",), f"{tp}.norm2", "ln"),
                (f + ("mlp", "fc1"), f"{tp}.mlp.fc1", "dense"),
                (f + ("mlp", "dwconv"), f"{tp}.mlp.dwconv.dwconv", "conv"),
                (f + ("mlp", "fc2"), f"{tp}.mlp.fc2", "dense"),
            ]
        table.append((("encoder", f"norm{s}"), f"encoder.norm{s}", "ln"))
    return table


def _decoder_table(spec: Spec) -> List[_Entry]:
    arch, attention = spec["architecture"], spec.get("attention")
    table: List[_Entry] = []
    if arch in ("unetplusplus", "efficientunetplusplus"):
        for cell, flags in spec["cells"]:
            fpath, tp = ("decoder", _GRID, cell), f"decoder.blocks.{cell}"
            if arch == "unetplusplus":
                table += _unet_block_table(fpath, tp, flags, attention)
                continue
            for i, (conv, has_skip) in enumerate(zip(("conv1", "conv2"), flags)):
                table += _inverted_residual_table(
                    fpath + (f"InvertedResidual_{i}",), f"{tp}.{conv}", has_skip
                )
        return table
    if arch == "resunetplusplus":
        table += _aspp_table(("decoder", "center"), "decoder.center")
    for i in range(spec["n_blocks"]):
        fpath, tp = ("decoder", f"block_{i}"), f"decoder.blocks.{i}"
        has_skip = i < spec.get("skips", _N_SKIPS)
        if arch == "resunetplusplus":
            table += _rupp_attention_table(
                fpath + ("RUPPAttentionBlock_0",), f"{tp}.attention0", has_skip
            )
        table += _unet_block_table(fpath, tp, has_skip, attention)
        if arch != "unet":
            table.append((fpath + ("Conv_0",), f"{tp}.identity_conv", "conv"))
    if arch == "resunetplusplus":
        table += _aspp_table(("decoder", "final_aspp"), "decoder.final_aspp")
    return table


def _segformer_table(depths: Sequence[int]) -> List[_Entry]:
    """The port's SegFormer keys (``models/segformer.py``) ↔ the flax tree,
    whose root modules are numbered across stages (``Conv_0..3`` patch
    embeddings, ``LayerNorm_{2s}`` / ``_{2s+1}`` a stage's input / output
    norm, ``MiTBlock_{i}``, ``Dense_0..3`` the decoder projections,
    ``Conv_4`` fuse, ``BatchNorm_0``, ``Conv_5`` classifier)."""
    table: List[_Entry] = []
    index = 0
    for s, depth in enumerate(depths):
        table.append(((f"Conv_{s}",), f"patch_embed.{s}", "conv"))
        table.append(((f"LayerNorm_{2 * s}",), f"patch_norm.{s}", "ln"))
        for b in range(depth):
            f, tp = (f"MiTBlock_{index}",), f"blocks.{s}.{b}"
            att, ffn = f + ("EfficientAttention_0",), f + ("MixFFN_0",)
            table += [
                (f + ("LayerNorm_0",), f"{tp}.norm1", "ln"),
                (att + ("Dense_0",), f"{tp}.attn.q", "dense"),
            ]
            if SR_RATIOS[s] > 1:
                table += [
                    (att + ("Conv_0",), f"{tp}.attn.sr", "conv"),
                    (att + ("LayerNorm_0",), f"{tp}.attn.sr_norm", "ln"),
                ]
            table += [
                (att + ("Dense_1",), f"{tp}.attn.k", "dense"),
                (att + ("Dense_2",), f"{tp}.attn.v", "dense"),
                (att + ("Dense_3",), f"{tp}.attn.proj", "dense"),
                (f + ("LayerNorm_1",), f"{tp}.norm2", "ln"),
                (ffn + ("Dense_0",), f"{tp}.ffn.fc1", "dense"),
                (ffn + ("Conv_0",), f"{tp}.ffn.dw", "conv"),
                (ffn + ("Dense_1",), f"{tp}.ffn.fc2", "dense"),
            ]
            index += 1
        table.append(((f"LayerNorm_{2 * s + 1}",), f"stage_norm.{s}", "ln"))
    n = len(depths)
    table += [((f"Dense_{s}",), f"decode_proj.{s}", "dense") for s in range(n)]
    table += [
        ((f"Conv_{n}",), "decode_fuse", "conv"),
        (("BatchNorm_0",), "decode_bn", "bn"),
        ((f"Conv_{n + 1}",), "classifier", "conv"),
    ]
    return table


def _model_table(spec: Spec) -> List[_Entry]:
    if spec["architecture"] == "segformer":
        return _segformer_table(spec["depths"])
    if spec["encoder"] == "resnet":
        table = _resnet_encoder_table(spec["stage_sizes"], spec["block"])
    elif spec["encoder"] == "mit":
        table = _mit_encoder_table(spec["depths"])
    else:
        table = _effnet_encoder_table(spec["repeats"])
    table += _decoder_table(spec)
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


def _resnet_stage_sizes(block: str, n_blocks: int, encoder_name: Optional[str]) -> Tuple[int, ...]:
    key = (encoder_name or "").lower().strip()
    if key in RESNET_GEOMETRY:
        return RESNET_GEOMETRY[key][0]
    for stage_sizes, b in RESNET_GEOMETRY.values():
        if b == block and sum(stage_sizes) == n_blocks:
            return stage_sizes
    raise ValueError(f"no ResNet has {n_blocks} {block} blocks")


def _mit_depths(n_blocks: int, encoder_name: Optional[str]) -> Tuple[int, ...]:
    key = (encoder_name or "").lower().strip()
    if key in MIT_CONFIGS:
        return MIT_CONFIGS[key][1]
    for _, depths, _, _ in MIT_CONFIGS.values():
        if sum(depths) == n_blocks:
            return depths
    raise ValueError(f"no MiT variant has {n_blocks} blocks")


def _mit_spec(blocks: Sequence[str]) -> Spec:
    """A MiT encoder's depths from its blocks' names (``block{s}.{i}``);
    its pyramid's stride-2 level is empty, so a linear decoder takes 3
    skips."""
    stages = [b.split(".")[0] for b in set(blocks)]
    return {"encoder": "mit", "skips": _N_SKIPS - 1,
            "depths": tuple(stages.count(f"block{s}") for s in range(1, 5))}


def _unetpp_cells(cells: Sequence[str], depth: int, spec: Spec):
    """(cell, has a skip) of a UNet++ grid: every cell but the last has
    one, and on a MiT encoder neither has the cell above the empty level,
    whose grid predecessors are all of width 0."""
    bare = {f"x_0_{depth}"} | ({f"x_0_{depth - 1}"} if spec.get("encoder") == "mit" else set())
    return [(c, c not in bare) for c in cells]


def _attention_in(names) -> Optional[str]:
    for name in names:
        if name.startswith("SCSEModule_") or ".attention.cSE." in name:
            return "scse"
    for name in names:
        if name.startswith("SEModule_") or ".attention.1." in name:
            return "se"
    return None


def _spec_from_params(params: Dict, encoder_name: Optional[str]) -> Spec:
    """The model's structure read off a flax params tree."""
    if "decoder" not in params:
        n = sum(1 for k in params if k.startswith("MiTBlock_"))
        if not n:
            raise ValueError(f"neither a decoder nor MiT blocks in the tree: {sorted(params)}")
        return {"architecture": "segformer", "depths": _mit_depths(n, encoder_name)}
    spec: Spec = {}
    enc = params["encoder"]
    for block, flax_block in (("basic", "BasicBlock_"), ("bottleneck", "Bottleneck_")):
        n = sum(1 for k in enc if k.startswith(flax_block))
        if n:
            spec.update(encoder="resnet", block=block,
                        stage_sizes=_resnet_stage_sizes(block, n, encoder_name))
    if "patch_embed1" in enc:
        spec.update(_mit_spec([f"block{k[5:].replace('_', '.')}" for k in enc
                               if k.startswith("block")]))
    if "encoder" not in spec:
        n = sum(1 for k in enc if k.startswith("MBConv_"))
        spec.update(encoder="effnet", repeats=_repeats_for(n, encoder_name))
    decoder = params["decoder"]
    if _GRID in decoder:
        grid = decoder[_GRID]
        depth = max(int(c.rsplit("_", 1)[1]) for c in grid)
        if "InvertedResidual_0" in grid[sorted(grid)[0]]:
            spec["architecture"] = "efficientunetplusplus"
            spec["cells"] = [
                (c, ("Conv_3" in grid[c]["InvertedResidual_0"],
                     "Conv_3" in grid[c]["InvertedResidual_1"]))
                for c in sorted(grid)
            ]
        else:
            spec["architecture"] = "unetplusplus"
            spec["cells"] = _unetpp_cells(sorted(grid), depth, spec)
        blocks = list(grid.values())
    else:
        blocks = [v for k, v in decoder.items() if k.startswith("block_")]
        spec["n_blocks"] = len(blocks)
        if "center" in decoder:
            spec["architecture"] = "resunetplusplus"
        elif "Conv_0" in decoder["block_0"]:
            spec["architecture"] = "resunet"
        else:
            spec["architecture"] = "unet"
    spec["attention"] = _attention_in([k for b in blocks for k in b])
    return spec


def _spec_from_state_dict(sd: Dict[str, Any], encoder_name: Optional[str]) -> Spec:
    """The model's structure read off a port state dict (or a dict of its
    parameters alone)."""
    if "patch_embed.0.weight" in sd:
        n = len({".".join(k.split(".")[:3]) for k in sd if k.startswith("blocks.")})
        return {"architecture": "segformer", "depths": _mit_depths(n, encoder_name)}
    spec: Spec = {}
    if "encoder.conv1.weight" in sd:
        block = "bottleneck" if "encoder.layer1.0.conv3.weight" in sd else "basic"
        n = len({".".join(k.split(".")[:3]) for k in sd if k.startswith("encoder.layer")})
        spec.update(encoder="resnet", block=block,
                    stage_sizes=_resnet_stage_sizes(block, n, encoder_name))
    elif "encoder.patch_embed1.proj.weight" in sd:
        spec.update(_mit_spec([".".join(k.split(".")[1:3]) for k in sd
                               if k.startswith("encoder.block")]))
    else:
        n = len({".".join(k.split(".")[:4]) for k in sd if k.startswith("encoder.blocks.")})
        spec.update(encoder="effnet", repeats=_repeats_for(n, encoder_name))
    dec_keys = [k for k in sd if k.startswith("decoder.")]
    cells = sorted({k.split(".")[2] for k in dec_keys if k.startswith("decoder.blocks.x_")})
    if cells:
        depth = max(int(c.rsplit("_", 1)[1]) for c in cells)
        if f"decoder.blocks.{cells[0]}.conv1.block.0.weight" in sd:
            spec["architecture"] = "efficientunetplusplus"
            spec["cells"] = [
                (c, (f"decoder.blocks.{c}.conv1.skip_conv.0.weight" in sd,
                     f"decoder.blocks.{c}.conv2.skip_conv.0.weight" in sd))
                for c in cells
            ]
        else:
            spec["architecture"] = "unetplusplus"
            spec["cells"] = _unetpp_cells(cells, depth, spec)
    else:
        spec["n_blocks"] = len({k.split(".")[2] for k in dec_keys
                                if k.startswith("decoder.blocks.")})
        if "decoder.center.output.weight" in sd:
            spec["architecture"] = "resunetplusplus"
        elif "decoder.blocks.0.identity_conv.weight" in sd:
            spec["architecture"] = "resunet"
        else:
            spec["architecture"] = "unet"
    spec["attention"] = _attention_in(dec_keys)
    return spec


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
        if kind in ("conv", "dense"):
            k = np.asarray(p["kernel"])
            sd[f"{tkey}.weight"] = t(_hwio_to_oihw(k) if kind == "conv" else k.T)
            if "bias" in p:
                sd[f"{tkey}.bias"] = t(p["bias"])
            continue
        sd[f"{tkey}.weight"] = t(p["scale"])
        sd[f"{tkey}.bias"] = t(p["bias"])
        if kind == "bn" and stats is not None:
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

    The architecture, encoder and attention are read off the tree;
    ``encoder_name`` fixes the encoder's depth where the tree alone does
    not (without it the depth is read from the number of blocks)."""
    params, stats = variables["params"], variables.get("batch_stats")
    table = _model_table(_spec_from_params(params, encoder_name))
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


def _flax_variables(sd: Dict[str, Any], encoder_name, kernel, f32) -> Dict[str, Dict]:
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for fpath, tkey, kind in _model_table(_spec_from_state_dict(sd, encoder_name)):
        if kind in ("conv", "dense"):
            leaf = {"kernel": kernel(kind, sd[f"{tkey}.weight"])}
            if f"{tkey}.bias" in sd:
                leaf["bias"] = f32(sd[f"{tkey}.bias"])
            _put(params, fpath, leaf)
            continue
        _put(params, fpath, {
            "scale": f32(sd[f"{tkey}.weight"]), "bias": f32(sd[f"{tkey}.bias"]),
        })
        if kind == "bn" and f"{tkey}.running_mean" in sd:
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

    def kernel(kind: str, w) -> np.ndarray:
        return f32(_oihw_to_hwio(w) if kind == "conv" else np.transpose(w))

    return _flax_variables(sd, encoder_name, kernel, f32)


def tensor_variables_from_state_dict(
    state_dict: Dict[str, torch.Tensor], *, encoder_name: Optional[str] = None
) -> Dict[str, Dict]:
    """:func:`variables_from_state_dict` with float32 tensor leaves on the
    tensors' own device: conv kernels are permuted to HWIO and linear
    weights transposed, both made contiguous; every other leaf is the
    float32 tensor. A leaf may share the module's storage (a float32 bias,
    a kernel whose permutation is already contiguous): whoever keeps the
    tree past the next step must copy it (``core.checkpoint`` snapshots
    do)."""

    def kernel(kind: str, w: torch.Tensor) -> torch.Tensor:
        w = w.detach().permute(2, 3, 1, 0) if kind == "conv" else w.detach().t()
        return w.float().contiguous()

    return _flax_variables(state_dict, encoder_name, kernel, lambda t: t.detach().float())
