"""MiT (Mix Transformer) encoders mit_b0 … mit_b5 in smp's layout (PyTorch).

SegFormer's encoder (Xie et al., 2021, arXiv:2105.15203) as smp's
``mit_b*`` encoders build it (``segmentation_models_pytorch.encoders.
mix_transformer``, NVlabs' ``mix_transformer.py``), so that every U-Net
family decoder of ``models/decoders.py`` runs on it:

- 4 stages, each an overlapped patch embedding (k7 s4, then k3 s2; conv →
  LayerNorm eps 1e-5), pre-norm blocks (LayerNorm eps 1e-6) of efficient
  self-attention (K and V from a k = s = R conv + LayerNorm eps 1e-5; q
  and kv with bias; scale head_dim^-0.5) and a Mix-FFN (fc1 → 3×3
  depthwise → exact (erf) GELU → fc2), then a stage LayerNorm (eps 1e-6);
- the feature pyramid is smp's: the input, an empty (B, 0, H/2, W/2)
  level (MiT has no stride-2 stage), then the four stage outputs as
  (B, C, h, w) maps;
- state-dict keys are smp's: ``patch_embed{1-4}.proj|norm``,
  ``block{s}.{i}.norm1|attn.q|attn.kv|attn.sr|attn.norm|attn.proj|norm2|
  mlp.fc1|mlp.dwconv.dwconv|mlp.fc2``, ``norm{1-4}``.

The attention and the Mix-FFN are ``models/segformer.py``'s (the fused
kernel on CUDA, :func:`~deadtrees_tpu_torch.models.segformer.attention`)
under smp's names. The LayerNorms are torch's own: under autocast they
return float32, so the residual stream is float32 as smp's is under
autocast. Drop path and dropout are 0 (training and inference alike).

With gradients on, on CUDA under a bf16 / fp16 autocast, the four stages
run as two CUDA graphs, one of the forward pass and one of the backward
(``torch.cuda.make_graphed_callables``), captured at the first such call
and replayed at that input shape: eagerly, a step of mit_b5 launches
about 6,900 kernels and its host time exceeds its device time. The
graphs replay the kernels of the eager pass (the same arithmetic); any
other shape, gradients off, float32, the CPU or a compiled program run
the stages eagerly. The parameters are updated in place, so the graphs
stay valid; a parameter moved to other memory (``.to()``) makes a new
capture.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from deadtrees_tpu_torch.core import trace
from deadtrees_tpu_torch.models.segformer import (
    SR_RATIOS,
    EfficientAttention,
    MixFFN,
    _to_map,
    _to_seq,
)

HEADS = (1, 2, 5, 8)
MLP_RATIO = 4
_WIDE = (64, 128, 320, 512)

# name → (embed dims, depths), smp's / NVlabs' mit_b0 … mit_b5
MIT_ENCODERS: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
    "mit_b0": ((32, 64, 160, 256), (2, 2, 2, 2)),
    "mit_b1": (_WIDE, (2, 2, 2, 2)),
    "mit_b2": (_WIDE, (3, 4, 6, 3)),
    "mit_b3": (_WIDE, (3, 4, 18, 3)),
    "mit_b4": (_WIDE, (3, 8, 27, 3)),
    "mit_b5": (_WIDE, (3, 6, 40, 3)),
}


class Attention(EfficientAttention):
    """smp's ``Attention``: ``q``, ``kv`` (K then V in one linear), the
    unpadded ``sr`` conv and its ``norm`` (eps 1e-5), ``proj``."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        nn.Module.__init__(self)
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim)

    def reduce(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return self.norm(_to_seq(self.sr(_to_map(x, h, w))))

    def keys_values(self, t: torch.Tensor):
        return self.kv(t).chunk(2, dim=-1)


class DWConv(nn.Module):
    """smp's ``DWConv``: the biased 3×3 depthwise conv as ``dwconv``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dwconv(x)


class Mlp(MixFFN):
    """smp's ``Mlp``: ``fc1`` → ``dwconv`` → exact GELU → ``fc2``."""

    gelu = "none"

    def __init__(self, dim: int, mlp_ratio: int):
        nn.Module.__init__(self)
        hidden = dim * mlp_ratio
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def depthwise(self, x: torch.Tensor) -> torch.Tensor:
        return self.dwconv(x)


class Block(nn.Module):
    """Pre-norm transformer block: attention and Mix-FFN residuals."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, MLP_RATIO)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.mlp(self.norm2(x), h, w)


class OverlapPatchEmbed(nn.Module):
    """k×k stride-s conv (k // 2 padding) → LayerNorm (eps 1e-5) over the
    tokens."""

    def __init__(self, in_channels: int, dim: int, kernel: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, kernel, stride, padding=kernel // 2)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        return self.norm(_to_seq(x)), x.shape[2], x.shape[3]


class _Stages(nn.Module):
    """The encoder's stages as the callable that ``make_graphed_callables``
    takes: its parameters are the encoder's, and it is no child of the
    encoder (no second name in the state dict)."""

    def __init__(self, encoder: "MiTEncoder"):
        super().__init__()
        object.__setattr__(self, "encoder", encoder)

    def parameters(self, recurse: bool = True):
        return self.encoder.parameters(recurse)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.encoder.stages(x)


class MiTEncoder(nn.Module):
    """The MiT backbone emitting smp's 6-level pyramid (module docstring)."""

    def __init__(self, embed_dims: Sequence[int], depths: Sequence[int], in_channels: int = 3):
        super().__init__()
        cins = (in_channels,) + tuple(embed_dims[:-1])
        for s, (cin, dim, depth, heads, sr) in enumerate(
                zip(cins, embed_dims, depths, HEADS, SR_RATIOS), start=1):
            kernel, stride = (7, 4) if s == 1 else (3, 2)
            setattr(self, f"patch_embed{s}", OverlapPatchEmbed(cin, dim, kernel, stride))
            setattr(self, f"block{s}", nn.ModuleList(Block(dim, heads, sr) for _ in range(depth)))
            setattr(self, f"norm{s}", nn.LayerNorm(dim, eps=1e-6))
        self.n_stages = len(embed_dims)
        self.n_blocks = sum(depths)
        self._graphed = None  # (key, graphed stages) of the one captured shape

    def stages(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The four stage outputs as (B, C, h, w) maps, eagerly."""
        out, h = [], x
        for s in range(1, self.n_stages + 1):
            seq, sh, sw = getattr(self, f"patch_embed{s}")(h)
            for block in getattr(self, f"block{s}"):
                seq = block(seq, sh, sw)
            h = _to_map(getattr(self, f"norm{s}")(seq), sh, sw)
            out.append(h)
        return tuple(out)

    def _graph(self, x: torch.Tensor):
        """The graphed stages for ``x``, captured at the first call that may
        take them; None where the stages run eagerly (module docstring)."""
        if not (x.is_cuda and torch.is_grad_enabled() and torch.is_autocast_enabled("cuda")
                and torch.get_autocast_dtype("cuda") in (torch.bfloat16, torch.float16)
                and not x.requires_grad and not torch.compiler.is_compiling()):
            return None
        params = list(self.parameters())
        if not all(p.requires_grad for p in params):
            return None
        key = (tuple(x.shape), x.dtype, torch.get_autocast_dtype("cuda"),
               tuple(p.data_ptr() for p in params))
        if self._graphed is not None and self._graphed[0][:3] != key[:3]:
            return None
        if self._graphed is None or self._graphed[0] != key:
            self._graphed = None
            counting = trace.ENABLED  # the capture's own passes are not the caller's calls
            trace.disable()
            try:
                with torch.autocast("cuda", dtype=key[2], cache_enabled=False):
                    graphed = torch.cuda.make_graphed_callables(_Stages(self),
                                                                (x.detach().clone(),))
            finally:
                if counting:
                    trace.enable()
            self._graphed = (key, graphed)
        return self._graphed[1]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        b, _, hh, ww = x.shape
        graphed = self._graph(x)
        if graphed is None:
            feats = self.stages(x)
        else:
            with torch.autocast("cuda", dtype=torch.get_autocast_dtype("cuda"),
                                cache_enabled=False):
                feats = graphed(x)
            if trace.ENABLED:  # the graph's attention calls, each fused
                for _ in range(self.n_blocks):
                    trace.add("model.attention_fused", 1.0)
        return [x, x.new_empty((b, 0, hh // 2, ww // 2))] + list(feats)


def build(name: str, in_channels: int, **opts) -> Tuple[MiTEncoder, Tuple[int, ...]]:
    """The encoder ``name`` (a key of :data:`MIT_ENCODERS`) and its
    ``out_channels``: the input's width, 0 for the empty level, the four
    embed dims."""
    if opts:
        raise TypeError(f"the MiT encoders take no convention options (got {sorted(opts)}): "
                        "bn_eps / pad_type select between EfficientNet conventions only")
    dims, depths = MIT_ENCODERS[name]
    return MiTEncoder(dims, depths, in_channels), (in_channels, 0) + tuple(dims)
