"""MiT (Mix Transformer) encoder, SegFormer's (Xie et al., arXiv:2105.15203),
in smp's layout (``segmentation_models_pytorch`` ``mit_b*``, NVlabs'
``mix_transformer.py``).

Four stages. Each starts with an overlapped patch embedding: a k×k
stride-s conv with k // 2 padding (k7 s4, then k3 s2), then LayerNorm
(``embed_norm_eps``) over the tokens. Then pre-norm blocks (LayerNorm
``layer_norm_eps``):

- efficient self-attention: q from the tokens; K and V from one ``kv``
  linear of the tokens, or, where the stage's ratio R > 1, of the k = s = R
  conv of the token map after a LayerNorm (``embed_norm_eps``); heads of
  ``embed_dim / num_heads`` channels, ``softmax(q kᵀ · d^-0.5) v`` as two
  explicit ``torch.matmul`` around a softmax, then ``proj``; q and kv with
  bias;
- Mix-FFN: ``fc1`` (× ``mlp_ratio``) → 3×3 depthwise conv (bias) → exact
  (erf) GELU → ``fc2``;

each added to the token stream, and a stage LayerNorm (``layer_norm_eps``)
whose output, as a (B, C, h, w) map, is the stage's feature and the next
stage's input. The pyramid is smp's: the input, an empty (B, 0, H/2, W/2)
level, the four stage features. Every linear, convolution and attention
product takes both operands through ``net.numerics.operand`` and its result
through ``net.numerics.result``; each block is one ``net.block``.

Departures from NVlabs' ``mix_transformer.py`` and smp's ``mit_b5``: drop
path 0 (published 0.1) and dropout 0, as a deterministic step needs; 4
input bands (smp's MiT takes 3); no classification head (smp's encoder
has none either). Widths from the configuration: ``embed_dims``,
``depths``, ``num_heads``, ``sr_ratios``, ``mlp_ratio``, ``patch_kernels``,
``patch_strides``, ``layer_norm_eps``, ``embed_norm_eps``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from port_bench.reference.core import Leaf, Net, Shapes


def _stages(enc: Dict, in_channels: int):
    cins = [in_channels] + list(enc["embed_dims"][:-1])
    return list(zip(range(1, 5), cins, enc["embed_dims"], enc["depths"], enc["num_heads"],
                    enc["sr_ratios"], enc["patch_kernels"], enc["patch_strides"]))


def out_channels(enc: Dict, in_channels: int) -> List[int]:
    return [in_channels, 0] + list(enc["embed_dims"])


def residual_bns(enc: Dict) -> List[str]:
    """No BatchNorm: the encoder normalizes with LayerNorm."""
    return []


def _linear(sh: Shapes, name: str, cout: int, cin: int) -> None:
    sh.leaves += [Leaf(name + ".weight", (cout, cin), "weight"),
                  Leaf(name + ".bias", (cout,), "bias")]


def _ln(sh: Shapes, name: str, c: int) -> None:
    sh.leaves += [Leaf(name + ".weight", (c,), "bn_weight"),
                  Leaf(name + ".bias", (c,), "bn_bias")]


def shapes(sh: Shapes, enc: Dict, in_channels: int) -> None:
    hidden = enc["mlp_ratio"]
    for s, cin, dim, depth, _, sr, k, _ in _stages(enc, in_channels):
        sh.conv(f"encoder.patch_embed{s}.proj", dim, cin, k, bias=True)
        _ln(sh, f"encoder.patch_embed{s}.norm", dim)
        for i in range(depth):
            b = f"encoder.block{s}.{i}"
            _ln(sh, f"{b}.norm1", dim)
            _linear(sh, f"{b}.attn.q", dim, dim)
            _linear(sh, f"{b}.attn.kv", 2 * dim, dim)
            _linear(sh, f"{b}.attn.proj", dim, dim)
            if sr > 1:
                sh.conv(f"{b}.attn.sr", dim, dim, sr, bias=True)
                _ln(sh, f"{b}.attn.norm", dim)
            _ln(sh, f"{b}.norm2", dim)
            _linear(sh, f"{b}.mlp.fc1", hidden * dim, dim)
            sh.conv(f"{b}.mlp.dwconv.dwconv", hidden * dim, hidden * dim, 3, bias=True,
                    groups=hidden * dim)
            _linear(sh, f"{b}.mlp.fc2", dim, hidden * dim)
        _ln(sh, f"encoder.norm{s}", dim)


def _linear_fw(net: Net, x: torch.Tensor, name: str) -> torch.Tensor:
    q = net.numerics.operand
    return net.numerics.result(F.linear(q(x), q(net.p[name + ".weight"]), net.p[name + ".bias"]))


def _ln_fw(net: Net, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), net.p[name + ".weight"], net.p[name + ".bias"], eps)


def _to_map(seq: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return seq.transpose(1, 2).reshape(seq.shape[0], seq.shape[2], h, w)


def _to_seq(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


def _attention(net: Net, x: torch.Tensor, name: str, hw, heads: int, sr: int,
               eps: float) -> torch.Tensor:
    b, n, dim = x.shape
    d = dim // heads
    rnd, out = net.numerics.operand, net.numerics.result
    q = _linear_fw(net, x, f"{name}.q").reshape(b, n, heads, d).transpose(1, 2)
    kv_in = x
    if sr > 1:
        w = net.p[f"{name}.sr.weight"]
        red = out(F.conv2d(rnd(_to_map(x, *hw)), rnd(w), net.p[f"{name}.sr.bias"], sr))
        kv_in = _ln_fw(net, _to_seq(red), f"{name}.norm", eps)
    kv = _linear_fw(net, kv_in, f"{name}.kv").reshape(b, -1, 2, heads, d).permute(2, 0, 3, 1, 4)
    logits = out(torch.matmul(rnd(q), rnd(kv[0].transpose(-2, -1)))) * d ** -0.5
    p = torch.softmax(logits, dim=-1)
    att = out(torch.matmul(rnd(p), rnd(kv[1])))
    return _linear_fw(net, att.transpose(1, 2).reshape(b, n, dim), f"{name}.proj")


def _mix_ffn(net: Net, x: torch.Tensor, name: str, hw) -> torch.Tensor:
    h = _to_map(_linear_fw(net, x, f"{name}.fc1"), *hw)
    h = _to_seq(net.conv(h, f"{name}.dwconv.dwconv", groups=h.shape[1]))
    return _linear_fw(net, F.gelu(h), f"{name}.fc2")


def _block(net: Net, x: torch.Tensor, name: str, hw, heads: int, sr: int, enc: Dict):
    eps = enc["layer_norm_eps"]
    x = x + _attention(net, _ln_fw(net, x, f"{name}.norm1", eps), f"{name}.attn", hw, heads, sr,
                       enc["embed_norm_eps"])
    return x + _mix_ffn(net, _ln_fw(net, x, f"{name}.norm2", eps), f"{name}.mlp", hw)


def forward(net: Net, x: torch.Tensor, enc: Dict) -> List[torch.Tensor]:
    b, _, hh, ww = x.shape
    feats = [x, x.new_empty((b, 0, hh // 2, ww // 2))]
    h = x
    for s, _, _, depth, heads, sr, _, stride in _stages(enc, x.shape[1]):
        h = net.conv(h, f"encoder.patch_embed{s}.proj", stride)
        hw = (h.shape[2], h.shape[3])
        seq = _ln_fw(net, _to_seq(h), f"encoder.patch_embed{s}.norm", enc["embed_norm_eps"])
        for i in range(depth):
            seq = net.block(lambda n, v, nm=f"encoder.block{s}.{i}", sz=hw, nh=heads, r=sr:
                            _block(n, v, nm, sz, nh, r, enc), seq)
        h = _to_map(_ln_fw(net, seq, f"encoder.norm{s}", enc["layer_norm_eps"]), *hw)
        feats.append(h)
    return feats
