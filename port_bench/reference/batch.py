"""The training batch, worked out again from the raw tiles.

- the augmentation's draw from the benchmark's CPU generator, in the
  order the recipe's transform takes it (albumentations: OneOf(HFlip,
  VFlip) p 0.5, RandomRotate90 p 0.5, RandomBrightnessContrast p 0.5 with
  brightness 0.2 and contrast 0.15, brightness not by max);
- flips, rot90, then ``floor(clip(v·α + β·mean(img), 0, 255))`` with the
  image's exact mean, then Normalize ``(x − 255 m) / (255 s)``, NCHW;
- the boundary loss's signed distance maps by scipy's exact EDT:
  ``edt_to_class · outside − (edt_to_rest − 1) · inside`` per class, a
  zero map for a class absent from the tile.

``dtype=torch.bfloat16`` rounds the image and the maps to bfloat16 (the
step below the configuration's float32 there): the control.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def draw(state: torch.Tensor, batch: int) -> Dict[str, torch.Tensor]:
    """The parameters drawn from a CPU generator in ``state``."""
    g = torch.Generator()
    g.set_state(state)
    return draw_from(g, batch)


def draw_from(g: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
    def uniform(lo: float, hi: float) -> torch.Tensor:
        return lo + torch.rand(batch, generator=g) * (hi - lo)

    def coin() -> torch.Tensor:
        return torch.rand(batch, generator=g) < 0.5

    flip_on, flip_v, rot_on = coin(), coin(), coin()
    rot_k = torch.randint(0, 4, (batch,), generator=g)
    bc_on = coin()
    alpha, beta = 1.0 + uniform(-0.15, 0.15), uniform(-0.2, 0.2)
    return {"flip_h": flip_on & ~flip_v, "flip_v": flip_on & flip_v,
            "rot_k": torch.where(rot_on, rot_k, 0),
            "alpha": torch.where(bc_on, alpha, 1.0), "beta": torch.where(bc_on, beta, 0.0)}


def _dihedral(x: torch.Tensor, p: Dict[str, torch.Tensor], b: int) -> torch.Tensor:
    """One (H, W, ...) sample: flips, then rot90 counter-clockwise."""
    if p["flip_h"][b]:
        x = x.flip(1)
    if p["flip_v"][b]:
        x = x.flip(0)
    return torch.rot90(x, int(p["rot_k"][b]), (0, 1))


def augment(image: torch.Tensor, mask: torch.Tensor, p: Dict[str, torch.Tensor],
            mean: Sequence[float], std: Sequence[float], dtype=torch.float32):
    """(B, H, W, C) uint8 and (B, H, W) masks → (B, C, H, W) float32 image,
    (B, H, W) int64 mask."""
    c = image.shape[-1]
    m255 = torch.tensor(mean[:c], dtype=torch.float32) * 255.0
    s255 = torch.tensor(std[:c], dtype=torch.float32) * 255.0
    out, masks = [], []
    for b in range(image.shape[0]):
        x = _dihedral(image[b], p, b)
        img_mean = (x.sum(dtype=torch.int64).double() / x.numel()).float()
        v = x.float() * p["alpha"][b].float()
        v = v + p["beta"][b].float() * img_mean
        v = torch.floor(torch.clamp(v, 0.0, 255.0))
        out.append(((v - m255.to(v.device)) / s255.to(v.device)).permute(2, 0, 1))
        masks.append(_dihedral(mask[b], p, b).long())
    img = torch.stack(out)
    return img.to(dtype).float(), torch.stack(masks)


def distmaps(mask: np.ndarray, classes: int, dtype=torch.float32) -> torch.Tensor:
    """(B, H, W) integer masks → (B, K, H, W) float32 signed distances."""
    from scipy.ndimage import distance_transform_edt as edt

    out = np.zeros((mask.shape[0], classes) + mask.shape[1:], np.float64)
    for b in range(mask.shape[0]):
        for k in range(classes):
            pos = mask[b] == k
            if not pos.any():
                continue
            neg = ~pos
            out[b, k] = edt(neg) * neg - (edt(pos) - 1.0) * pos
    return torch.from_numpy(out.astype(np.float32)).to(dtype).float()
