"""Batched augmentation: dihedral flips/rotations + colour jitter + normalize.

Counterpart of ``deadtrees_tpu.data.augment`` (the reference's
albumentations pipeline, run on the whole batch on the device):

    train: OneOf(HFlip, VFlip) p=0.5 → RandomRotate90 p=0.5 →
           RandomBrightnessContrast(p=0.5, brightness_limit=0.2,
           contrast_limit=0.15, brightness_by_max=False) → Normalize
    val:   Normalize only

Parameters come from an explicit ``torch.Generator`` (the random streams
differ from JAX's; the probabilities and ranges are the same). On a CUDA
batch the jitter + normalize runs as the hand-written kernel
(``ops/augment.py``); on a CPU batch as its plain version. The image comes
out float32 NCHW, the layout the model reads; masks keep (B, H, W).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from deadtrees_tpu_torch.data.config import DATASET_CONFIG
from deadtrees_tpu_torch.ops.augment import augment_jitter_normalize, color_jitter_u8


def sample_augment_params(
    generator: torch.Generator, batch: int
) -> Dict[str, torch.Tensor]:
    """Draw per-sample augmentation parameters (albumentations semantics)
    on the generator's device."""

    def uniform(lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(batch, generator=generator, device=generator.device)
        return lo + u * (hi - lo)

    def bernoulli() -> torch.Tensor:
        return torch.rand(batch, generator=generator, device=generator.device) < 0.5

    flip_on = bernoulli()
    flip_v = bernoulli()  # True → VFlip, False → HFlip
    rot_on = bernoulli()
    rot_k = torch.randint(0, 4, (batch,), generator=generator, device=generator.device)
    bc_on = bernoulli()
    alpha = 1.0 + uniform(-0.15, 0.15)
    beta = uniform(-0.2, 0.2)
    return {
        "flip_h": flip_on & ~flip_v,
        "flip_v": flip_on & flip_v,
        "rot_k": torch.where(rot_on, rot_k, torch.zeros_like(rot_k)),
        "alpha": torch.where(bc_on, alpha, torch.ones_like(alpha)),
        "beta": torch.where(bc_on, beta, torch.zeros_like(beta)),
    }


def _apply_dihedral(x: torch.Tensor, flip_h, flip_v, rot_k) -> torch.Tensor:
    """Per-sample flips + rot90 on a batched (B, H, W, ...) tensor with
    H == W: all four rotations are computed and each sample picks one, as
    in the JAX package (no data-dependent control flow)."""
    dev = x.device
    expand = (slice(None),) + (None,) * (x.dim() - 1)
    flip_h, flip_v = flip_h.to(dev)[expand], flip_v.to(dev)[expand]
    k = rot_k.to(dev)[expand]
    x = torch.where(flip_h, torch.flip(x, (2,)), x)
    x = torch.where(flip_v, torch.flip(x, (1,)), x)
    # np.rot90 counter-clockwise in the (H, W) plane, batched
    r1 = torch.flip(x.transpose(1, 2), (1,))
    r2 = torch.flip(x, (1, 2))
    r3 = torch.flip(x.transpose(1, 2), (2,))
    return torch.where(k == 1, r1, torch.where(k == 2, r2, torch.where(k == 3, r3, x)))


# the JAX package's name for the plain version of the kernel's first half
_color_jitter_u8 = color_jitter_u8


def normalize(
    img_f32: torch.Tensor, mean: Sequence[float], std: Sequence[float]
) -> torch.Tensor:
    """albumentations Normalize for uint8-ranged channel-last input:
    ``(x - 255 m) / (255 s)``, in float32."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=img_f32.device) * 255.0
    std = torch.as_tensor(std, dtype=torch.float32, device=img_f32.device) * 255.0
    return (img_f32 - mean) / std


def augment_batch(
    generator: Optional[torch.Generator],
    image_u8: torch.Tensor,  # (B, H, W, C) uint8
    mask: Optional[torch.Tensor] = None,  # (B, H, W) integer
    lu: Optional[torch.Tensor] = None,  # (B, H, W) integer
    *,
    train: bool = True,
    mean: Sequence[float] = DATASET_CONFIG.mean,
    std: Sequence[float] = DATASET_CONFIG.std,
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The train/val transform on the batch's device. Returns 'image'
    float32 (B, C, H, W), normalized, and the geometrically matched
    'mask'/'lu' as int64 (B, H, W).

    ``params`` (the dict :func:`sample_augment_params` returns) fixes the
    augmentation instead of drawing it from ``generator``."""
    c = image_u8.shape[-1]
    mean = tuple(mean)[:c]
    std = tuple(std)[:c]
    out: Dict[str, torch.Tensor] = {}
    if not train:
        out["image"] = normalize(image_u8.float(), mean, std).permute(0, 3, 1, 2).contiguous()
    else:
        if params is None:
            params = sample_augment_params(generator, image_u8.shape[0])
        geo = (params["flip_h"], params["flip_v"], params["rot_k"])
        img = _apply_dihedral(image_u8, *geo)
        out["image"] = augment_jitter_normalize(
            img, params["alpha"].to(img.device), params["beta"].to(img.device), mean, std
        )
    for name, t in (("mask", mask), ("lu", lu)):
        if t is not None:
            out[name] = (_apply_dihedral(t, *geo) if train else t).long()
    return out
