"""Fused colour jitter + normalize of a uint8 training batch.

Counterpart of ``deadtrees_tpu.ops.augment_pallas.augment_pallas``: for
every element v of image b (already flipped and rotated),

    x   = floor(clip(v·α_b + β_b·mean_b, 0, 255))     albumentations' uint8
                                                     brightness/contrast
    out = (x − 255·m_c) / (255·s_c)                  Normalize

with ``mean_b`` the image's mean over pixels and bands. The input is NHWC
uint8 (B, H, W, C) as the host sends it; the output is float32 **NCHW**
(B, C, H, W), the layout the port's model reads.

A CUDA tensor launches the hand-written kernel (``csrc/augment.cu``, built
at first CUDA use by ``ops/_build.py``) or raises; a CPU tensor takes the
plain PyTorch version (:func:`augment_jitter_normalize_reference`). Both
round the same way (each product and the sum rounded to float32, an IEEE
division), so on the same inputs they agree bit for bit. The wrapper
keeps a launch count in ``ops.LAUNCHES["augment_jitter_normalize"]``.

The kernel is the ``torch.library`` custom op
``deadtrees::augment_jitter_normalize`` (the kernel on CUDA, the plain
version on the CPU), opaque to the compiler. Its channel constants come
as a tensor (:func:`channel_table`, built once per statistics and device),
so that a compiled program makes no host-to-device copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from deadtrees_tpu_torch.ops.launches import LAUNCHES

KERNEL = "augment_jitter_normalize"


def image_mean(img_u8: torch.Tensor) -> torch.Tensor:
    """(B,) float32 mean of each uint8 image over pixels and bands, from
    an exact integer sum (a float32 sum is no longer exact above 2^24,
    which any 512² RGBN tile passes), rounded once to float32."""
    n = img_u8[0].numel()
    total = img_u8.reshape(img_u8.shape[0], -1).sum(1, dtype=torch.int64)
    return (total.double() / n).float()


def channel_constants(
    mean: Sequence[float], std: Sequence[float], channels: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(255·m_c, 255·s_c) as float32 tensors, sliced to ``channels`` (an
    RGB model reads the first three of the RGBN statistics)."""
    m = torch.as_tensor(tuple(mean)[:channels], dtype=torch.float32, device=device)
    s = torch.as_tensor(tuple(std)[:channels], dtype=torch.float32, device=device)
    return m * 255.0, s * 255.0


@functools.lru_cache(maxsize=16)
def _channel_table(mean: Tuple[float, ...], std: Tuple[float, ...], channels: int,
                   device: torch.device) -> torch.Tensor:
    return torch.cat(channel_constants(mean, std, channels, device)).contiguous()


def channel_table(mean: Sequence[float], std: Sequence[float], channels: int,
                  device) -> torch.Tensor:
    """(2·C,) float32: 255·m_c then 255·s_c (:func:`channel_constants`), the
    kernel's ``chan`` operand, built once per statistics, channel count and
    device and shared by every later call."""
    return _channel_table(tuple(mean)[:channels], tuple(std)[:channels], channels,
                          torch.device(device))


def color_jitter_u8(
    img_u8: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, img_mean=None
) -> torch.Tensor:
    """albumentations' uint8 brightness/contrast, ``brightness_by_max=False``:
    ``floor(clip(v·α + β·mean(img), 0, 255))`` as float32, NHWC in and out."""
    if img_mean is None:
        img_mean = image_mean(img_u8)
    shape = (-1,) + (1,) * (img_u8.dim() - 1)
    x = img_u8.float() * alpha.float().reshape(shape)
    x = x + (beta.float() * img_mean).reshape(shape)
    return torch.floor(torch.clamp(x, 0.0, 255.0))


def augment_jitter_normalize_reference(
    img_u8: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    mean: Sequence[float],
    std: Sequence[float],
    img_mean=None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: jitter, normalize, then the
    permute to NCHW."""
    x = color_jitter_u8(img_u8, alpha, beta, img_mean)
    m255, s255 = channel_constants(mean, std, img_u8.shape[-1], img_u8.device)
    return ((x - m255) / s255).permute(0, 3, 1, 2).contiguous()


_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from deadtrees_tpu_torch.ops import _build

        lib = _build.load("augment")
        lib.augment_jitter_normalize.argtypes = [_P] * 6 + [_I] * 3 + [_P]
        lib.augment_jitter_normalize.restype = _I
        _lib = lib
    return _lib


def augment_jitter_normalize(
    img_u8: torch.Tensor,  # (B, H, W, C) uint8, already flipped/rotated
    alpha: torch.Tensor,  # (B,)
    beta: torch.Tensor,  # (B,)
    mean: Sequence[float],
    std: Sequence[float],
    chan: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused per-sample jitter + normalize; returns (B, C, H, W) float32.

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor
    it runs the plain version; both through the custom op. ``chan`` is
    :func:`channel_table` of ``mean`` and ``std`` on the batch's device,
    built here when the caller does not pass it (a compiled caller passes
    it, so that the program makes no host-to-device copy). The image mean
    is computed ahead of the op (:func:`image_mean`)."""
    if img_u8.dim() != 4 or img_u8.dtype != torch.uint8:
        raise ValueError(
            f"expected a (B, H, W, C) uint8 batch, got {tuple(img_u8.shape)} {img_u8.dtype}"
        )
    bsz, hh, ww, c = img_u8.shape
    if alpha.shape != (bsz,) or beta.shape != (bsz,):
        raise ValueError(f"alpha and beta must have shape ({bsz},)")
    if chan is None and (len(mean) < c or len(std) < c):
        raise ValueError(f"mean/std give fewer than {c} channels")
    if img_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {img_u8.device}")
    if bsz > 65535 or hh * ww >= 2**31 // max(c, 1):
        raise ValueError(f"batch {tuple(img_u8.shape)} exceeds the kernel's grid")
    dev = img_u8.device
    if chan is None:
        chan = channel_table(mean, std, c, dev)
    if tuple(chan.shape) != (2 * c,):
        raise ValueError(f"chan has shape {tuple(chan.shape)}, expected ({2 * c},)")
    a = alpha.to(dev, torch.float32)
    b = beta.to(dev, torch.float32)
    return torch.ops.deadtrees.augment_jitter_normalize(img_u8, a, b, image_mean(img_u8), chan)


@torch.library.custom_op("deadtrees::augment_jitter_normalize", mutates_args=())
def _augment_op(img: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                img_mean: torch.Tensor, chan: torch.Tensor) -> torch.Tensor:
    """Kernel 4 (the kernel on CUDA, the plain version on the CPU)."""
    if img.device.type == "cpu":
        c = img.shape[-1]
        x = color_jitter_u8(img, alpha, beta, img_mean)
        return ((x - chan[:c]) / chan[c:]).permute(0, 3, 1, 2).contiguous()
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    img = img.contiguous()
    if img.data_ptr() % 16:  # the vector path loads 16 bytes at a time
        img = img.clone()
    return launch(img, alpha.contiguous(), beta.contiguous(), img_mean.contiguous(),
                  chan.contiguous())


@_augment_op.register_fake
def _(img, alpha, beta, img_mean, chan):
    bsz, hh, ww, c = img.shape
    return img.new_empty((bsz, c, hh, ww), dtype=torch.float32)


def launch(img, alpha, beta, img_mean, chan) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors: ``img`` (B, H, W, C)
    uint8, contiguous and 16-byte aligned; ``alpha``, ``beta``,
    ``img_mean`` (B,) and ``chan`` (2·C,) contiguous float32 on the same
    device. Returns the (B, C, H, W) float32 output."""
    bsz, hh, ww, c = img.shape
    out = torch.empty((bsz, c, hh, ww), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        status = _kernel().augment_jitter_normalize(
            img.data_ptr(), alpha.data_ptr(), beta.data_ptr(), img_mean.data_ptr(),
            chan.data_ptr(), out.data_ptr(), bsz, hh * ww, c,
            torch.cuda.current_stream().cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {status}")
    LAUNCHES[KERNEL] += 1
    return out
