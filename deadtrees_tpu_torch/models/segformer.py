"""SegFormer: a transformer segmenter on the same tile pipeline (PyTorch).

Counterpart of ``deadtrees_tpu.models.segformer`` (the SegFormer paper,
Xie et al., 2021, arXiv:2105.15203):

- MiT encoder: 4 stages of overlapped patch embedding (k7 s4, then k3 s2),
  blocks of self-attention with spatially reduced keys and values
  (``sr_ratio`` 8/4/2/1) and a Mix-FFN (MLP around a 3×3 depthwise conv),
  LayerNorm throughout;
- all-MLP decoder: per-stage linear projection to 256 channels, bilinear
  upsampling to 1/4 resolution, concatenation (deepest first), 1×1 fuse
  conv → BN → ReLU, 1×1 classifier, bilinear upsampling ×4 in float32.

The arithmetic is the JAX module's: LayerNorm eps 1e-6 (flax's), the tanh
GELU (``jax.nn.gelu``'s default), attention logits and softmax in float32
cast to the compute type after the softmax, the spatial-reduction conv
padded as flax's ``"SAME"``, and half-pixel bilinear resizes
(``F.interpolate(align_corners=False)``, which clamps at the borders as
``jax.image.resize`` renormalizes there). Attention on the CPU is plain
``torch.matmul`` + softmax, as the JAX package computes it with ``einsum``;
on CUDA it is one fused kernel (:func:`attention`).

There is no reference checkpoint of this model, so its state-dict keys
are the port's own (``patch_embed.{s}``, ``patch_norm.{s}``,
``blocks.{s}.{b}.norm1 / attn.q / attn.sr / attn.sr_norm / attn.k /
attn.v / attn.proj / norm2 / ffn.fc1 / ffn.dw / ffn.fc2``,
``stage_norm.{s}``, ``decode_proj.{s}``, ``decode_fuse``, ``decode_bn``,
``classifier``); ``models/convert.py`` maps them onto the flax tree.

The attention and the Mix-FFN are shared with the MiT encoder in smp's
layout (``models/mit.py``), which subclasses them under smp's names and
with the published arithmetic (exact GELU, LayerNorm eps 1e-5 after the
spatial reduction).
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from deadtrees_tpu_torch.core import trace
from deadtrees_tpu_torch.models.blocks import BatchNorm2d
from deadtrees_tpu_torch.models.encoders import _tf_same_pads

# MiT variants: (embed_dims, depths, heads, mlp_ratio)
MIT_CONFIGS = {
    "mit-b0": ((32, 64, 160, 256), (2, 2, 2, 2), (1, 2, 5, 8), 4),
    "mit-b1": ((64, 128, 320, 512), (2, 2, 2, 2), (1, 2, 5, 8), 4),
    "mit-b2": ((64, 128, 320, 512), (3, 4, 6, 3), (1, 2, 5, 8), 4),
}
SR_RATIOS = (8, 4, 2, 1)
DECODER_DIM = 256


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: eps 1e-6, statistics in float32 (as torch's
    autocast runs it), the output in the input's type (flax's compute
    type), so a bfloat16 residual stream stays bfloat16."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).to(x.dtype)


def _to_map(seq: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H·W, C) token sequence → (B, C, H, W) map."""
    return seq.transpose(1, 2).reshape(seq.shape[0], seq.shape[2], h, w)


def _to_seq(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) map → (B, H·W, C) token sequence, row-major."""
    return x.flatten(2).transpose(1, 2)


# the fused backend of :func:`attention` on CUDA, pinned: a call it cannot
# take raises (no other backend is tried). cuDNN's: a forward and backward
# of the MiT-B5 U-Net's attention at bs 8, 1024², took 29.1 ms against
# flash's 46.1 ms on an H100 (tools/time_attention.py)
FUSED_BACKEND = SDPBackend.CUDNN_ATTENTION


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q kᵀ / √d) v`` by the pinned fused backend alone
    (``F.scaled_dot_product_attention`` under ``sdpa_kernel``): bf16 or
    fp16 operands, products summed in float32, the softmax in float32 and
    P rounded to the operands' type for the PV product, as the plain path
    computes it. Raises ``RuntimeError`` where that backend cannot take
    the input (float32 operands, a head size it has no kernel for)."""
    with sdpa_kernel(FUSED_BACKEND):
        return F.scaled_dot_product_attention(q, k, v)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q kᵀ / √d) v`` op by op: the logits from the operands
    taken to float32, the softmax in float32, P cast back to q's type for
    the PV product (the JAX module's arithmetic)."""
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
        attn = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(attn, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention over (B, heads, N, d) queries and
    (B, heads, M, d) keys and values. bf16 / fp16 operands on CUDA take
    :func:`fused_attention`, which saves no N × M matrix for the backward
    pass; CPU tensors and float32 operands (a float32 model, which neither
    fused backend takes) :func:`plain_attention`. The counter
    ``model.attention_fused`` (``core/trace.py``) adds 1 a fused call and
    0 a plain one."""
    fused = q.is_cuda and q.dtype in (torch.bfloat16, torch.float16)
    if trace.ENABLED:
        trace.add("model.attention_fused", float(fused))
    return fused_attention(q, k, v) if fused else plain_attention(q, k, v)


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, heads·d) → (B, heads, N, d)."""
    b, n, dim = t.shape
    return t.reshape(b, n, heads, dim // heads).transpose(1, 2)


class EfficientAttention(nn.Module):
    """Self-attention with spatially reduced keys and values (SegFormer
    eq. 2): a k = s = ``sr_ratio`` conv and a LayerNorm before K and V.
    Subclasses change how the reduction is padded and normed
    (:meth:`reduce`) and how K and V are projected (:meth:`keys_values`)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_norm = LayerNorm(dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def reduce(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """The K / V input: the spatially reduced, normed token sequence."""
        sp = _to_map(x, h, w)
        (pt, pb), (pl, pr) = _tf_same_pads(sp.shape, self.sr_ratio, self.sr_ratio)
        return self.sr_norm(_to_seq(self.sr(F.pad(sp, [pl, pr, pt, pb]))))

    def keys_values(self, t: torch.Tensor):
        return self.k(t), self.v(t)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, dim = x.shape
        k, v = self.keys_values(self.reduce(x, h, w) if self.sr_ratio > 1 else x)
        out = attention(*(split_heads(t, self.num_heads) for t in (self.q(x), k, v)))
        return self.proj(out.transpose(1, 2).reshape(b, n, dim))


class MixFFN(nn.Module):
    """MLP around a 3×3 depthwise conv (SegFormer eq. 3), tanh GELU."""

    gelu = "tanh"  # F.gelu's ``approximate``

    def __init__(self, dim: int, mlp_ratio: int):
        super().__init__()
        hidden = dim * mlp_ratio
        self.fc1 = nn.Linear(dim, hidden)
        self.dw = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def depthwise(self, x: torch.Tensor) -> torch.Tensor:
        return self.dw(x)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = _to_seq(self.depthwise(_to_map(self.fc1(x), h, w)))
        return self.fc2(F.gelu(x, approximate=self.gelu))


class MiTBlock(nn.Module):
    """Pre-norm transformer block: attention and Mix-FFN residuals."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim)
        self.ffn = MixFFN(dim, mlp_ratio)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.ffn(self.norm2(x), h, w)


class SegFormer(nn.Module):
    """MiT encoder + all-MLP decoder with the interface of
    :class:`~deadtrees_tpu_torch.models.factory.SegmentationModel`:
    (B, in_channels, H, W) float in, (B, classes, H, W) float32 logits out,
    computed in ``self.dtype``. Like the JAX module it has no encoder
    subtree, so the multistage freeze leaves it as it is."""

    architecture = "segformer"

    def __init__(self, encoder_name: str = "mit-b0", *, in_channels: int = 4,
                 classes: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        key = encoder_name.lower()
        if key not in MIT_CONFIGS:
            raise ValueError(f"Unknown SegFormer encoder {encoder_name!r}: {sorted(MIT_CONFIGS)}")
        dims, depths, heads, mlp_ratio = MIT_CONFIGS[key]
        self.encoder_name = key
        self.in_channels = in_channels
        self.classes = classes
        self.dtype = dtype
        self.patch_embed = nn.ModuleList(
            nn.Conv2d(cin, dim, k, stride=s, padding=p)
            for cin, dim, (k, s, p) in zip(
                (in_channels,) + dims[:-1], dims, [(7, 4, 3)] + [(3, 2, 1)] * 3
            )
        )
        self.patch_norm = nn.ModuleList(LayerNorm(d) for d in dims)
        self.blocks = nn.ModuleList(
            nn.ModuleList(MiTBlock(dim, nh, sr, mlp_ratio) for _ in range(depth))
            for dim, depth, nh, sr in zip(dims, depths, heads, SR_RATIOS)
        )
        self.stage_norm = nn.ModuleList(LayerNorm(d) for d in dims)
        self.decode_proj = nn.ModuleList(nn.Linear(d, DECODER_DIM) for d in dims)
        self.decode_fuse = nn.Conv2d(len(dims) * DECODER_DIM, DECODER_DIM, 1, bias=False)
        self.decode_bn = BatchNorm2d(DECODER_DIM, eps=1e-5)
        self.classifier = nn.Conv2d(DECODER_DIM, classes, 1)

    def autocast(self, device_type: str):
        """The context that realises ``self.dtype`` for a forward pass."""
        return torch.autocast(device_type, dtype=self.dtype,
                              enabled=self.dtype != torch.float32)

    def train(self, mode: bool = True, encoder_train: bool = True) -> "SegFormer":
        """``encoder_train`` is accepted and ignored, as the JAX module
        ignores it."""
        return super().train(mode)

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The four MiT stage outputs as (B, h, w, C) maps."""
        feats = []
        h = x
        for embed, norm, blocks, out_norm in zip(
            self.patch_embed, self.patch_norm, self.blocks, self.stage_norm
        ):
            h = embed(h)
            hh, ww = h.shape[2], h.shape[3]
            seq = norm(_to_seq(h))
            for block in blocks:
                seq = block(seq, hh, ww)
            seq = out_norm(seq)
            feats.append(seq.reshape(seq.shape[0], hh, ww, -1))
            h = _to_map(seq, hh, ww)
        return feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with self.autocast(x.device.type):
            feats = self.encode(x)
            target = feats[0].shape[1:3]
            proj = []
            for f, linear in zip(feats, self.decode_proj):
                p = linear(f).permute(0, 3, 1, 2)
                if p.shape[2:] != target:
                    p = F.interpolate(p, size=target, mode="bilinear", align_corners=False)
                proj.append(p)
            fused = F.relu(self.decode_bn(self.decode_fuse(torch.cat(proj[::-1], dim=1))))
            logits = self.classifier(fused)
        return F.interpolate(logits.float(), size=x.shape[2:], mode="bilinear",
                             align_corners=False)
