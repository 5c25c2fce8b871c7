"""First-party ONNX reader/writer for the reference's second model artifact.

The port's own copy of ``deadtrees_tpu.models.onnx_io`` (numpy only; the
port imports nothing of the JAX package). The port's models use the
reference's state-dict layout, so the state dict recovered here loads into
``create_model(**hparams)`` with ``load_state_dict`` and no converter.

The reference ships TWO trained-model artifacts: the Lightning ``.ckpt``
and ``bestmodel.onnx``, exported by ``scripts/create_onnx.py:31-45``
(``opset_version=11, do_constant_folding=True, export_params=True``) and
consumed by ``deadtrees/deployment/inference.py:128-143`` through
onnxruntime. Neither ``onnx`` nor ``onnxruntime`` is installed here, so
this module implements the protobuf wire format directly:

- :func:`read_onnx` — parse a serialized ``ModelProto`` into initializers
  (named numpy arrays), nodes (op_type/inputs/outputs/attributes), and
  the opset, with no dependency beyond numpy;
- :func:`state_dict_from_onnx` — recover a reference-layout torch-style
  state dict from the graph, **including de-fusing Conv+BatchNorm pairs**:
  torch's TorchScript exporter runs ``_jit_pass_onnx_eval_peephole`` when
  ``do_constant_folding=True`` and the model is in eval mode (exactly the
  reference's flags), which folds every BatchNorm into the preceding conv.
  De-fusion keeps the fused kernel on the conv and synthesizes an
  identity BatchNorm (scale=1, mean=0, var=1-eps) whose bias carries the
  fused conv bias — numerically equivalent at inference and loadable by
  the port's model as it is (``models/factory.py`` ``create_model``);
- :func:`scan_conventions` — extract the attributes that settle the two
  encoder-convention ambiguities of ``docs/encoder_audit.md`` rows 14-15
  *structurally*: ``BatchNormalization.epsilon`` and ``Conv.pads`` /
  ``auto_pad`` (symmetric static padding vs TF-SAME asymmetric padding on
  stride-2 convs). On a fused graph both questions dissolve: the fused
  weights embed epsilon numerically and pads stay explicit per node;
- :func:`write_onnx` / :func:`onnx_from_torch_modules` — a minimal writer
  used to build test fixtures that emulate the reference's export (both
  fused and unfused flavors), since ``torch.onnx.export`` refuses to run
  without the ``onnx`` package.

Wire-format facts used (onnx/onnx.proto, stable since IR v3):
ModelProto{1:ir_version, 7:graph, 8:opset_import{1:domain, 2:version}};
GraphProto{1:node, 2:name, 5:initializer, 11:input, 12:output};
NodeProto{1:input, 2:output, 3:name, 4:op_type, 5:attribute};
AttributeProto{1:name, 2:f, 3:i, 4:s, 7:floats, 8:ints, 20:type};
TensorProto{1:dims, 2:data_type, 4:float_data, 7:int64_data, 8:name,
9:raw_data}.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# TensorProto.DataType -> numpy dtype (subset that appears in exports)
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# protobuf wire format (generic)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _parse_fields(buf: bytes) -> Dict[int, List[Tuple[int, Union[int, bytes]]]]:
    """One protobuf message → {field_number: [(wire_type, value), ...]}.

    Length-delimited values stay as bytes (nested messages / strings /
    packed arrays are interpreted by the caller, which knows the schema).
    """
    fields: Dict[int, List[Tuple[int, Union[int, bytes]]]] = {}
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fnum, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val = buf[i:i + 8]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            if len(val) != ln:
                raise ValueError("truncated length-delimited field")
            i += ln
        elif wire == 5:
            val = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(fnum, []).append((wire, val))
    return fields


def _one(fields, num, default=None):
    vals = fields.get(num)
    return vals[-1][1] if vals else default


def _str(fields, num, default=""):
    v = _one(fields, num)
    return v.decode("utf-8") if isinstance(v, bytes) else default


def _packed_varints(entries) -> List[int]:
    """Repeated int64 field: either packed (wire 2) or one-per-entry."""
    out: List[int] = []
    for wire, val in entries:
        if wire == 0:
            out.append(val)
        else:
            i = 0
            while i < len(val):
                v, i = _read_varint(val, i)
                out.append(v)
    # ONNX ints are signed (two's complement varints) — e.g. PackBits-free
    # here, but pads of -1 would arrive as 2^64-1
    return [v - (1 << 64) if v >= (1 << 63) else v for v in out]


def _packed_floats(entries) -> List[float]:
    out: List[float] = []
    for wire, val in entries:
        if wire == 5:
            out.append(struct.unpack("<f", val)[0])
        else:
            out.extend(np.frombuffer(val, "<f4").tolist())
    return out


# ---------------------------------------------------------------------------
# model objects
# ---------------------------------------------------------------------------

@dataclass
class OnnxNode:
    op_type: str
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class OnnxModel:
    ir_version: int = 0
    opset: int = 0
    graph_name: str = ""
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    nodes: List[OnnxNode] = field(default_factory=list)
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    f = _parse_fields(buf)
    dims = _packed_varints(f.get(1, []))
    dtype_code = _one(f, 2, 1)
    name = _str(f, 8)
    dtype = _DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f"initializer {name!r}: unsupported data_type "
                         f"{dtype_code}")
    raw = _one(f, 9)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif dtype_code == 1 and 4 in f:
        arr = np.asarray(_packed_floats(f[4]), np.float32)
    elif dtype_code == 7 and 7 in f:
        arr = np.asarray(_packed_varints(f[7]), np.int64)
    elif dtype_code in (2, 3, 5, 6, 9) and 5 in f:
        arr = np.asarray(_packed_varints(f[5]),
                         np.int32).astype(dtype)
    elif dtype_code == 11 and 10 in f:
        arr = np.frombuffer(b"".join(v for _w, v in f[10]), "<f8")
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr


def _parse_attr(buf: bytes) -> Tuple[str, object]:
    f = _parse_fields(buf)
    name = _str(f, 1)
    atype = _one(f, 20, 0)
    if atype == 1 or (atype == 0 and 2 in f):       # FLOAT
        return name, struct.unpack("<f", _one(f, 2))[0]
    if atype == 2 or (atype == 0 and 3 in f):       # INT
        return name, _packed_varints(f[3])[-1]
    if atype == 3 or (atype == 0 and 4 in f):       # STRING
        return name, _one(f, 4, b"").decode("utf-8")
    if atype == 4 or (atype == 0 and 5 in f):       # TENSOR
        return name, _parse_tensor(_one(f, 5))[1]
    if atype == 6 or (atype == 0 and 7 in f):       # FLOATS
        return name, _packed_floats(f.get(7, []))
    if atype == 7 or (atype == 0 and 8 in f):       # INTS
        return name, _packed_varints(f.get(8, []))
    if atype == 8 or (atype == 0 and 9 in f):       # STRINGS
        return name, [v.decode("utf-8") for _w, v in f.get(9, [])]
    return name, None  # GRAPH etc. — not needed for weight extraction


def _parse_node(buf: bytes) -> OnnxNode:
    f = _parse_fields(buf)
    return OnnxNode(
        op_type=_str(f, 4),
        name=_str(f, 3),
        inputs=[v.decode("utf-8") for _w, v in f.get(1, [])],
        outputs=[v.decode("utf-8") for _w, v in f.get(2, [])],
        attrs=dict(_parse_attr(v) for _w, v in f.get(5, [])),
    )


def _value_info_name(buf: bytes) -> str:
    return _str(_parse_fields(buf), 1)


def read_onnx(src: Union[str, Path, bytes]) -> OnnxModel:
    """Parse a serialized ONNX ``ModelProto`` (path or bytes)."""
    data = Path(src).read_bytes() if not isinstance(src, bytes) else src
    top = _parse_fields(data)
    model = OnnxModel(ir_version=_one(top, 1, 0) or 0)
    for _w, op in top.get(8, []):
        f = _parse_fields(op)
        if _str(f, 1) in ("", "ai.onnx"):
            model.opset = _one(f, 2, 0) or 0
    graph = _one(top, 7)
    if graph is None:
        raise ValueError("not an ONNX model: no GraphProto (field 7)")
    g = _parse_fields(graph)
    model.graph_name = _str(g, 2)
    for _w, t in g.get(5, []):
        name, arr = _parse_tensor(t)
        model.initializers[name] = arr
    model.nodes = [_parse_node(v) for _w, v in g.get(1, [])]
    model.inputs = [_value_info_name(v) for _w, v in g.get(11, [])]
    model.outputs = [_value_info_name(v) for _w, v in g.get(12, [])]
    # torch's constant folding can move weights OUT of graph.initializer
    # into Constant nodes whose output keeps the (often semantic) tensor
    # name — observed on real exports for BatchNorm params on branches the
    # Conv+BN peephole can't fold (resunet++ attention gates,
    # tests/test_onnx_torch_export_oracle.py). Harvest them as
    # initializers so weight recovery sees one uniform namespace.
    for node in model.nodes:
        if node.op_type == "Constant" and node.outputs:
            val = node.attrs.get("value")
            if isinstance(val, np.ndarray) and \
                    node.outputs[0] not in model.initializers:
                model.initializers[node.outputs[0]] = val
    return model


# ---------------------------------------------------------------------------
# conventions scan (docs/encoder_audit.md rows 14-15)
# ---------------------------------------------------------------------------

def scan_conventions(model: OnnxModel) -> dict:
    """Extract the graph facts that settle the open encoder conventions.

    Returns ``bn_eps`` (set of epsilons over BatchNormalization nodes,
    keyed by scale-initializer name), ``conv`` (per weight-initializer:
    pads/strides/auto_pad/group/dilations/has_bias), ``stride2_pads``
    (the pads of every stride-2 conv — ``[1,1,1,1]`` ⇒ static symmetric,
    ``[0,0,1,1]`` ⇒ TF-SAME asymmetric), and ``fused`` (True when the
    graph has conv-with-bias patterns but no BatchNormalization nodes —
    torch's eval-peephole output, where both conventions are embedded in
    the weights and need no guess at all).
    """
    bn_eps: Dict[str, float] = {}
    conv: Dict[str, dict] = {}
    for node in model.nodes:
        if node.op_type == "BatchNormalization" and len(node.inputs) >= 2:
            bn_eps[node.inputs[1]] = float(node.attrs.get("epsilon", 1e-5))
        elif node.op_type == "Conv" and len(node.inputs) >= 2:
            conv[node.inputs[1]] = {
                "pads": [int(p) for p in node.attrs.get("pads", [])],
                "strides": [int(s) for s in node.attrs.get("strides", [1, 1])],
                "auto_pad": node.attrs.get("auto_pad", "NOTSET"),
                "group": int(node.attrs.get("group", 1)),
                "dilations": [int(d) for d in
                              node.attrs.get("dilations", [1, 1])],
                "kernel_shape": [int(k) for k in
                                 node.attrs.get("kernel_shape", [1, 1])],
                "has_bias": len(node.inputs) > 2 and bool(node.inputs[2]),
            }
    stride2 = {
        w: c["pads"] for w, c in conv.items()
        if any(s > 1 for s in c["strides"])
    }
    asym = [w for w, p in stride2.items()
            if len(p) == 4 and (p[0] != p[2] or p[1] != p[3])]
    same_upper = [w for w, c in conv.items()
                  if c["auto_pad"] in ("SAME_UPPER", "SAME_LOWER")]
    # timm's Conv2dSame (TF-SAME) exports as a dynamic Pad subgraph
    # feeding a Conv with pads=[0,0,0,0] — a k>1 stride-2 conv with zero
    # pads plus Pad ops in the graph IS the same-padding signature, not
    # "static" (verified against a real torch export of the pattern,
    # tests/test_onnx_io.py::test_scan_conventions_dynamic_pad_same).
    has_pad_ops = any(n.op_type == "Pad" for n in model.nodes)
    zero_pad_wide = [
        w for w, c in conv.items()
        if any(s > 1 for s in c["strides"])
        and c["pads"] and all(p == 0 for p in c["pads"])
        and any(k > 1 for k in c["kernel_shape"])
    ]
    has_bn = any(n.op_type == "BatchNormalization" for n in model.nodes)
    return {
        "bn_eps": bn_eps,
        "bn_eps_values": sorted({round(v, 10) for v in bn_eps.values()}),
        "conv": conv,
        "stride2_pads": stride2,
        "suggest_pad_type": (
            "same" if (asym or same_upper or (zero_pad_wide and has_pad_ops))
            else ("static" if stride2 else None)
        ),
        "fused": not has_bn and any(c["has_bias"] for c in conv.values()),
    }


# ---------------------------------------------------------------------------
# conv → batchnorm pairing (reference module layouts)
# ---------------------------------------------------------------------------

def paired_bn_name(conv: str, conv_names: frozenset) -> Optional[str]:
    """The BatchNorm module that follows conv ``conv`` in the reference
    architectures, or None for convs that legitimately carry a bias.

    Naming per the reference's smp/timm stack, which the port's modules
    keep (``models/encoders.py``, ``models/decoders.py``):
    timm efficientnet encoder (``conv_stem``→``bn1``; InvertedResidual
    ``conv_pw``→``bn1``, ``conv_dw``→``bn2``, ``conv_pwl``→``bn3``;
    DepthwiseSeparable — no ``conv_pwl`` — ``conv_dw``→``bn1``,
    ``conv_pw``→``bn2``), torchvision resnet (``convN``→``bnN``,
    ``downsample.0``→``downsample.1``), and the vendored decoders'
    ``Sequential(conv, bn, relu)`` cells (index i → i+1). SE convs, the
    resunet ``identity_conv``, and the segmentation head keep real biases.
    """
    import re

    if re.search(r"\bse\.conv_(reduce|expand)$", conv):
        return None
    if ".cSE." in conv or ".sSE." in conv or ".attention" in conv:
        return None  # SCSE gates: real-bias convs followed by ReLU/Sigmoid
    if conv.endswith("identity_conv") or "segmentation_head" in conv:
        return None
    if conv == "encoder.conv_stem":
        return "encoder.bn1"
    if conv == "encoder.conv1":  # resnet stem
        return "encoder.bn1"
    if conv == "encoder.conv_head":
        return "encoder.bn2"
    m = re.match(r"^(encoder\.blocks\.\d+\.\d+)\.conv_(pw|dw|pwl)$", conv)
    if m:
        block, kind = m.group(1), m.group(2)
        has_pwl = f"{block}.conv_pwl" in conv_names
        if kind == "pwl":
            return f"{block}.bn3"
        if kind == "pw":
            return f"{block}.bn1" if has_pwl else f"{block}.bn2"
        return f"{block}.bn2" if has_pwl else f"{block}.bn1"
    m = re.match(r"^(encoder\.layer\d+\.\d+)\.conv(\d)$", conv)
    if m:
        return f"{m.group(1)}.bn{m.group(2)}"
    m = re.match(r"^(encoder\.layer\d+\.\d+\.downsample)\.0$", conv)
    if m:
        return f"{m.group(1)}.1"
    # decoder inverted-residual cells: ONLY Sequential indices 0/3/7 are
    # the cell's bias-free convs (1/4/8 their BNs; 6 is the SCSE gate)
    m = re.match(r"^(decoder\..*\.block)\.([037])$", conv)
    if m:
        return f"{m.group(1)}.{int(m.group(2)) + 1}"
    m = re.match(r"^(decoder\..*\.skip_conv)\.0$", conv)
    if m:
        return f"{m.group(1)}.1"
    # Conv2dReLU pairs (unet/unet++/resunet cells): convK.0 → convK.1
    m = re.match(r"^(decoder\..*\.conv\d)\.0$", conv)
    if m:
        return f"{m.group(1)}.1"
    return None


def ref_conv_has_bias(conv: str) -> bool:
    """Whether the reference defines this (BN-paired) conv WITH a bias.

    The vendored IR cells build their convs from ``PointWiseConv2d`` /
    ``DepthWiseConv2d`` — plain ``nn.Conv2d`` with the default
    ``bias=True`` (extra/modules.py:95-113) — while ``Conv2dReLU`` and
    the timm/torchvision encoders pass ``bias=False`` under BN. De-fusion
    must keep the fused bias on the conv where the port's module has a
    bias, and move it into BN beta where it doesn't.
    """
    import re

    return bool(
        re.match(r"^decoder\..*\.block\.[037]$", conv)
        or re.match(r"^decoder\..*\.skip_conv\.0$", conv)
    )


def _eps_for_site(bn_name: str, encoder_bn_eps: float) -> float:
    """The epsilon the PORT's BatchNorm applies at this site: the
    efficientnet encoder's ``bn_eps`` (``models/encoders.py``, 1e-3 unless
    the hparams say otherwise) and torch's default 1e-5 in every decoder
    block (``models/blocks.py``). A resnet encoder runs at 1e-5
    (:func:`state_dict_from_onnx` sets that when the graph has no
    ``encoder.conv_stem``). The synthesized ``var = 1 - eps`` is an identity only at the eps
    the loading model uses."""
    if bn_name.startswith("encoder.bn") or (
        bn_name.startswith("encoder.blocks.")
    ):
        return encoder_bn_eps
    return 1e-5


# ---------------------------------------------------------------------------
# state-dict recovery (fused and unfused graphs)
# ---------------------------------------------------------------------------

_PARAM_SUFFIX = (".weight", ".bias", ".running_mean", ".running_var")


def state_dict_from_onnx(
    model: OnnxModel, *, encoder_bn_eps: float = 1e-3
) -> Tuple[Dict[str, np.ndarray], dict]:
    """Recover a reference-layout state dict from the ONNX graph.

    Unfused graphs (BatchNormalization nodes present): initializers carry
    the state-dict names verbatim (torch keeps parameter names on exported
    initializers) — pass them through, and record each BN's epsilon.

    Fused graphs (torch eval-peephole, the reference's actual export
    flags): every conv that the reference defines bias-free but that
    carries a bias input in the graph had its following BN folded in.
    Keep the fused kernel, synthesize the BN as identity with the fused
    bias in beta::

        bn.weight = 1, bn.running_mean = 0, bn.bias = conv_bias,
        bn.running_var = 1 - eps_site   # so scale/sqrt(var+eps) == 1

    which makes the port's model compute conv_fused(x) + beta — the fused
    graph's semantics. ``eps_site`` must match the epsilon the port's
    model will be built with (``encoder_bn_eps`` for the efficientnet
    encoder; 1e-5 elsewhere, :func:`_eps_for_site`).

    Returns ``(state_dict, report)``; the report lists defused pairs,
    passed-through keys, and ignored initializers.
    """
    # Lightning wraps the smp net as SemSegment.model, so exported
    # initializer names carry a ``model.`` prefix (network/segmodel.py) —
    # normalize to the bare scheme the converters and pairing rules use.
    strip = any(n.startswith("model.encoder.") for n in model.initializers)

    def _norm(n: str) -> str:
        return n[len("model."):] if strip and n.startswith("model.") else n

    init = {_norm(n): a for n, a in model.initializers.items()}
    sd: Dict[str, np.ndarray] = {}
    ignored: List[str] = []
    for name, arr in init.items():
        if name.endswith(_PARAM_SUFFIX) and arr.dtype in (
            np.float32, np.float64, np.float16
        ):
            sd[name] = np.asarray(arr, np.float32)
        else:
            ignored.append(name)

    def _module_from_node_name(node_name: str) -> str:
        """TorchScript-exporter node scope → module path.

        Real fused exports rename BOTH conv initializers to generated
        ``onnx::Conv_<n>`` names; the module path survives only in the
        node name, e.g. ``/encoder/conv_stem/Conv`` or (ModuleList
        nesting) ``/encoder/blocks.0/blocks.0.0/bn1/BatchNormalization``
        where each segment may EXTEND the previous one — merge those,
        drop the trailing op-instance segment, join with dots.
        (Verified against torch 2.13 legacy-exporter output,
        tests/test_onnx_torch_export_oracle.py.)
        """
        segs = [s for s in node_name.split("/") if s]
        if len(segs) < 2:
            return ""
        acc: List[str] = []
        for seg in segs[:-1]:  # last segment is the op instance (Conv...)
            if acc and seg.startswith(acc[-1] + "."):
                acc[-1] = seg
            else:
                acc.append(seg)
        return ".".join(acc)

    # graph-side view of each conv: (module name, weight init, bias init).
    # Weight initializers keep state-dict names in unfused graphs; in
    # fused graphs they are generated names and the node scope names the
    # module instead.
    conv_entries: List[Tuple[str, str, Optional[str]]] = []
    for node in model.nodes:
        if node.op_type == "Conv" and len(node.inputs) >= 2:
            w = _norm(node.inputs[1])
            b = _norm(node.inputs[2]) if len(node.inputs) > 2 \
                and node.inputs[2] else None
            if w.endswith(".weight"):
                conv = w[: -len(".weight")]
            else:
                conv = _norm(_module_from_node_name(node.name))
                # Never-CALLED containers are absent from node scopes
                # (children are invoked directly): an nn.ModuleDict's
                # attribute name drops (/decoder/x_0_0/... for state-dict
                # decoder.blocks.x_0_0, smp Unet++/EfficientUnet++), and a
                # bare holder module drops its whole level (/blocks.0/...
                # for decoder.blocks.0). Re-root using the reference
                # layouts' only valid roots — verified against real
                # torch-2.13 exporter output
                # (tests/test_onnx_torch_export_oracle.py).
                if conv and not conv.startswith(
                        ("encoder.", "decoder.", "segmentation_head.")):
                    if re.match(r"^x_\d+_\d+\.", conv):
                        conv = "decoder.blocks." + conv
                    else:
                        conv = "decoder." + conv
                conv = re.sub(r"^decoder\.(x_\d+_\d+)\.",
                              r"decoder.blocks.\1.", conv)
            conv_entries.append((conv, w, b))

    conv_names = frozenset(c for c, _w, _b in conv_entries if c)
    # resnet encoders run at fixed eps 1e-5; only the efficientnet
    # encoder's eps is configurable
    if not any(n == "encoder.conv_stem" for n in conv_names) and any(
        n.startswith("encoder.") for n in conv_names
    ):
        encoder_bn_eps = 1e-5
    defused: List[Tuple[str, str]] = []
    for conv, wname, bname in conv_entries:
        if not conv:
            continue  # no semantic weight name AND no usable node scope
        kernel = init.get(wname)
        if kernel is not None and not wname.endswith(".weight") \
                and f"{conv}.weight" not in sd:
            # fused graph with generated initializer names: materialize
            # the (BN-folded) kernel under the module's state-dict name
            sd[f"{conv}.weight"] = np.asarray(kernel, np.float32)
        bn = paired_bn_name(conv, conv_names)
        if bn is None:
            # real-bias conv: make sure the bias lands under its own name
            if bname and f"{conv}.bias" not in sd and bname in init:
                sd[f"{conv}.bias"] = np.asarray(init[bname], np.float32)
            continue
        if f"{bn}.running_mean" in sd:
            continue  # unfused graph: the BN's own stats exist
        if kernel is None:
            continue
        cout = kernel.shape[0]
        bias = (np.asarray(init[bname], np.float32)
                if bname and bname in init else np.zeros(cout, np.float32))
        eps = _eps_for_site(bn, encoder_bn_eps)
        sd[f"{bn}.weight"] = np.ones(cout, np.float32)
        sd[f"{bn}.running_mean"] = np.zeros(cout, np.float32)
        sd[f"{bn}.running_var"] = np.full(cout, 1.0 - eps, np.float32)
        if ref_conv_has_bias(conv):
            # IR-cell convs own a bias: keep the fused bias there, BN
            # beta stays zero
            sd[f"{conv}.bias"] = bias
            sd[f"{bn}.bias"] = np.zeros(cout, np.float32)
        else:
            sd[f"{bn}.bias"] = bias
            sd.pop(f"{conv}.bias", None)  # fused bias lives in beta now
        defused.append((conv, bn))

    # Cross-Sequential fold (real-exporter behavior): in the resunet++
    # attention gate the chain is decoder_conv.2 (Conv, real bias) →
    # attn_conv.0 (BN) → relu; on the LAST decoder block there is no skip
    # Add in between, so the eval peephole folds attn_conv.0 INTO
    # decoder_conv.2 (observed: generated initializer names on that conv
    # and no BN node, tests/test_onnx_torch_export_oracle.py). The fused
    # kernel+bias already carry the BN's effect — synthesize the missing
    # BN as identity so the attention gate computes the same thing.
    for conv, wname, _b in conv_entries:
        m = re.match(r"^(.+\.attention\d+)\.decoder_conv\.2$", conv or "")
        if not m or wname.endswith(".weight"):
            continue
        gate = m.group(1)
        bn = f"{gate}.attn_conv.0"
        kernel = init.get(wname)
        if kernel is None or f"{bn}.running_mean" in sd:
            continue
        cout = kernel.shape[0]
        eps = _eps_for_site(bn, encoder_bn_eps)
        sd[f"{bn}.weight"] = np.ones(cout, np.float32)
        sd[f"{bn}.bias"] = np.zeros(cout, np.float32)
        sd[f"{bn}.running_mean"] = np.zeros(cout, np.float32)
        sd[f"{bn}.running_var"] = np.full(cout, 1.0 - eps, np.float32)
        defused.append((conv, bn))

    consumed = {w for _c, w, _b in conv_entries} | {
        b for _c, _w, b in conv_entries if b
    }
    report = {
        "fused_graph": bool(defused),
        "defused_pairs": sorted(defused),
        "n_passthrough": len(sd) - 4 * len(defused),
        "ignored_initializers": sorted(
            n for n in ignored if n not in consumed)[:20],
        "encoder_bn_eps_used": encoder_bn_eps,
    }
    return sd, report


# ---------------------------------------------------------------------------
# writer (fixtures; emulates torch.onnx.export's graph shape)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wire: int) -> bytes:
    return _varint(fnum << 3 | wire)


def _ld(fnum: int, payload: bytes) -> bytes:
    return _tag(fnum, 2) + _varint(len(payload)) + payload


def _enc_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {arr.dtype} for {name!r}")
    out = b""
    for d in arr.shape:
        out += _tag(1, 0) + _varint(d)
    out += _tag(2, 0) + _varint(code)
    out += _ld(8, name.encode())
    out += _ld(9, arr.tobytes())
    return out


def _enc_attr(name: str, value) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(value, float):
        out += _tag(20, 0) + _varint(1) + _tag(2, 5) + struct.pack("<f", value)
    elif isinstance(value, bool):
        out += _tag(20, 0) + _varint(2) + _tag(3, 0) + _varint(int(value))
    elif isinstance(value, int):
        out += _tag(20, 0) + _varint(2) + _tag(3, 0) + _varint(
            value if value >= 0 else value + (1 << 64))
    elif isinstance(value, str):
        out += _tag(20, 0) + _varint(3) + _ld(4, value.encode())
    elif isinstance(value, (list, tuple)) and all(
        isinstance(v, int) for v in value
    ):
        out += _tag(20, 0) + _varint(7)
        for v in value:
            out += _tag(8, 0) + _varint(v if v >= 0 else v + (1 << 64))
    elif isinstance(value, (list, tuple)):
        out += _tag(20, 0) + _varint(6)
        for v in value:
            out += _tag(7, 5) + struct.pack("<f", float(v))
    else:
        raise ValueError(f"unsupported attribute value for {name!r}")
    return out


def _enc_node(node: OnnxNode) -> bytes:
    out = b""
    for i in node.inputs:
        out += _ld(1, i.encode())
    for o in node.outputs:
        out += _ld(2, o.encode())
    if node.name:
        out += _ld(3, node.name.encode())
    out += _ld(4, node.op_type.encode())
    for k, v in node.attrs.items():
        out += _ld(5, _enc_attr(k, v))
    return out


def write_onnx(
    initializers: Dict[str, np.ndarray],
    nodes: Sequence[OnnxNode],
    path: Optional[Union[str, Path]] = None,
    *,
    opset: int = 11,
    graph_name: str = "deadtrees",
    inputs: Sequence[str] = ("input",),
    outputs: Sequence[str] = ("output",),
) -> bytes:
    """Serialize a ModelProto. Round-trips through :func:`read_onnx`."""
    # one join: growing a bytes object tensor by tensor copies the graph
    # once per initializer
    g = b"".join(
        [_ld(1, _enc_node(node)) for node in nodes]
        + [_ld(2, graph_name.encode())]
        + [_ld(5, _enc_tensor(name, arr)) for name, arr in initializers.items()]
        + [_ld(11, _ld(1, name.encode())) for name in inputs]
        + [_ld(12, _ld(1, name.encode())) for name in outputs]
    )
    m = _tag(1, 0) + _varint(8)  # ir_version 8
    m += _ld(2, b"deadtrees_tpu")  # producer_name
    m += _ld(7, g)
    m += _ld(8, _ld(1, b"") + _tag(2, 0) + _varint(opset))
    data = m
    if path is not None:
        Path(path).write_bytes(data)
    return data


def onnx_from_torch_modules(model, *, fuse_bn: bool, opset: int = 11) -> bytes:
    """Emulate ``torch.onnx.export`` on a torch module for test fixtures.

    Walks ``named_modules()`` emitting Conv/BatchNormalization/Relu nodes
    with the real attribute values (pads/strides/group/epsilon) and
    initializers under state-dict names — the layout torch's TorchScript
    exporter produces. With ``fuse_bn=True`` it reproduces the
    eval-peephole pass (create_onnx.py's ``do_constant_folding=True`` +
    eval): each Conv followed (module order) by its own BatchNorm — the
    pair :func:`paired_bn_name` names — gets the BN folded into its
    weight/bias and the BN node dropped; the fused bias initializer gets a
    NON-semantic name (``onnx::Conv_<n>``) to mirror the exporter's
    generated names. A BatchNorm that is no conv's pair (the ResUnet++
    ASPP's conv → ReLU → BN, the attention gate's BN → ReLU → conv) stays
    a node, as the exporter leaves it.

    The node chain is sequential (single path) — faithful enough for
    weight/attribute extraction, which never executes the graph.
    """
    import torch

    model = model.eval()
    inits: Dict[str, np.ndarray] = {}
    nodes: List[OnnxNode] = []
    prev_out = "input"
    fresh = iter(range(10_000))

    def emit(op, inputs, attrs=None, name=""):
        nonlocal prev_out
        out = f"t{next(fresh)}"
        nodes.append(OnnxNode(op_type=op, name=name,
                              inputs=inputs, outputs=[out],
                              attrs=attrs or {}))
        prev_out = out

    mods = [(n, m) for n, m in model.named_modules() if n]
    conv_names = frozenset(n for n, m in mods if isinstance(m, torch.nn.Conv2d))
    pending: Optional[Tuple[str, object]] = None  # bias-free conv awaiting BN

    def flush(fold=None):
        """Emit the pending conv (optionally with BN folded in)."""
        nonlocal pending
        if pending is None:
            return
        pname, pconv = pending
        pending = None
        w = pconv.weight.detach().numpy()
        attrs = {
            "dilations": list(pconv.dilation),
            "group": int(pconv.groups),
            "kernel_shape": list(pconv.kernel_size),
            "pads": [pconv.padding[0], pconv.padding[1],
                     pconv.padding[0], pconv.padding[1]],
            "strides": list(pconv.stride),
        }
        if fold is not None:
            bn = fold
            gamma = bn.weight.detach().numpy()
            beta = bn.bias.detach().numpy()
            mean = bn.running_mean.numpy()
            var = bn.running_var.numpy()
            scale = gamma / np.sqrt(var + bn.eps)
            w = w * scale[:, None, None, None]
            b0 = (pconv.bias.detach().numpy()
                  if pconv.bias is not None else 0.0)
            b = (b0 - mean) * scale + beta
            # the real exporter renames BOTH fused initializers to
            # generated names and keeps the module path only in the node
            # scope (verified: tests/test_onnx_torch_export_oracle.py)
            w_name = f"onnx::Conv_{next(fresh)}"
            bias_name = f"onnx::Conv_{next(fresh)}"
            inits[w_name] = w.astype(np.float32)
            inits[bias_name] = np.asarray(b, np.float32)
            ins = [prev_out, w_name, bias_name]
            emit("Conv", ins, attrs,
                 name="/" + pname.replace(".", "/") + "/Conv")
            return
        ins = [prev_out, f"{pname}.weight"]
        if pconv.bias is not None:
            inits[f"{pname}.bias"] = (
                pconv.bias.detach().numpy().astype(np.float32))
            ins.append(f"{pname}.bias")
        inits[f"{pname}.weight"] = w.astype(np.float32)
        emit("Conv", ins, attrs, name=pname)

    for name, mod in mods:
        if isinstance(mod, torch.nn.Conv2d):
            flush()  # emit any earlier pending conv un-fused
            if fuse_bn:
                # torch's eval peephole fuses Conv+BN regardless of an
                # existing conv bias (it merges into the fused bias)
                pending = (name, mod)
            else:
                inits[f"{name}.weight"] = (
                    mod.weight.detach().numpy().astype(np.float32))
                ins = [prev_out, f"{name}.weight"]
                if mod.bias is not None:
                    inits[f"{name}.bias"] = (
                        mod.bias.detach().numpy().astype(np.float32))
                    ins.append(f"{name}.bias")
                emit("Conv", ins, {
                    "dilations": list(mod.dilation),
                    "group": int(mod.groups),
                    "kernel_shape": list(mod.kernel_size),
                    "pads": [mod.padding[0], mod.padding[1],
                             mod.padding[0], mod.padding[1]],
                    "strides": list(mod.stride),
                }, name=name)
        elif isinstance(mod, torch.nn.BatchNorm2d):
            if (pending is not None
                    and pending[1].out_channels == mod.num_features
                    and paired_bn_name(pending[0], conv_names) == name):
                flush(fold=mod)
            else:
                flush()
                for suffix, val in (
                    ("weight", mod.weight.detach()),
                    ("bias", mod.bias.detach()),
                    ("running_mean", mod.running_mean),
                    ("running_var", mod.running_var),
                ):
                    inits[f"{name}.{suffix}"] = (
                        val.numpy().astype(np.float32))
                emit("BatchNormalization",
                     [prev_out, f"{name}.weight", f"{name}.bias",
                      f"{name}.running_mean", f"{name}.running_var"],
                     {"epsilon": float(mod.eps),
                      "momentum": float(mod.momentum or 0.1)},
                     name=name)
        elif isinstance(mod, torch.nn.ReLU):
            emit("Relu", [prev_out])
        elif isinstance(mod, torch.nn.Linear):
            flush()
            inits[f"{name}.weight"] = (
                mod.weight.detach().numpy().astype(np.float32))
            ins = [prev_out, f"{name}.weight"]
            if mod.bias is not None:
                inits[f"{name}.bias"] = (
                    mod.bias.detach().numpy().astype(np.float32))
                ins.append(f"{name}.bias")
            emit("Gemm", ins, {"transB": 1}, name=name)
    flush()
    # unfused BatchNorm emission above also covers fuse_bn=True graphs
    # whose BN doesn't follow a bias-free conv (e.g. resunet++ ASPP after
    # pooling) — exactly the eval-peephole behavior.
    nodes.append(OnnxNode(op_type="Identity", inputs=[prev_out],
                          outputs=["output"]))
    return write_onnx(inits, nodes, opset=opset)
