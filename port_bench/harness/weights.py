"""Weights made from the seed on the device, in a few large calls.

The parameter list and shapes are the reference's, from the configuration
file (``reference.model.leaves``); the program's model takes them through
``load_state_dict(strict=True)``, so a model whose names or shapes depart
from the configuration fails to load. Kernels are normal of variance
1/fan_in, biases normal of deviation 0.05, BatchNorm scales 1 + 0.1·N and
shifts 0.1·N, running statistics (0, 1) until :func:`calibrate` sets them.
The scale of the last BatchNorm of each residual branch is multiplied by
the configuration's ``init.residual_bn_scale`` (Goyal et al.,
arXiv:1706.02677, start such scales at 0): a network at initialization
with BatchNorm is chaotic (Yang et al., arXiv:1902.08129), and at scale 1
the reference itself in bf16 moves 7 % of the b5's scene argmax and its
smallest leaves' gradients by half, where 0.1 leaves under 1 % and 3 %,
so that the output check can tell bf16 from fp8.
"""

from __future__ import annotations

from typing import Dict

import torch

from port_bench.reference import model as ref_model
from port_bench.reference.core import fan_in

_STD = {"bias": 0.05, "bn_weight": 0.1, "bn_bias": 0.1}


def make(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    leaves = ref_model.leaves(model)
    params = [l for l in leaves if l.is_param]
    sizes = [int(torch.Size(l.shape).numel()) for l in params]
    last = {n + ".weight" for n in ref_model.residual_bns(model)}
    gain = {n: model.get("init", {}).get("residual_bn_scale", 1.0) for n in last}
    std = [(fan_in(l.shape) ** -0.5) if l.kind == "weight" else _STD[l.kind] * gain.get(l.name, 1.0)
           for l in params]
    offset = [gain.get(l.name, 1.0) if l.kind == "bn_weight" else 0.0 for l in params]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    counts = torch.tensor(sizes, device=device)
    flat = flat * torch.repeat_interleave(torch.tensor(std, device=device), counts)
    flat = flat + torch.repeat_interleave(torch.tensor(offset, device=device), counts)
    out: Dict[str, torch.Tensor] = {}
    for l, v in zip(params, flat.split(sizes)):
        out[l.name] = v.view(l.shape)
    for l in leaves:
        if l.kind == "bn_mean":
            out[l.name] = torch.zeros(l.shape, device=device)
        elif l.kind == "bn_var":
            out[l.name] = torch.ones(l.shape, device=device)
        elif l.kind == "bn_count":
            out[l.name] = torch.zeros((), dtype=torch.int64, device=device)
    return {l.name: out[l.name] for l in leaves}


@torch.no_grad()
def calibrate(weights: Dict[str, torch.Tensor], model: Dict, image: torch.Tensor) -> None:
    """Running statistics of every BatchNorm set to those of one
    train-mode forward of the reference over ``image`` (normalized, NCHW
    float32): a trained model's statistics sit near its data's, and at
    (0, 1) the eval-mode logits grow into the hundreds."""
    stats: Dict = {}
    ref_model.forward(weights, image, model, train=True, stats=stats)
    for name, (mean, var) in stats.items():
        weights[f"{name}.running_mean"] = mean.clone()
        weights[f"{name}.running_var"] = var.clone()
