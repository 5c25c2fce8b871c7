"""Depthwise k×k convolution on NHWC tensors.

Counterpart of ``deadtrees_tpu.ops.depthwise.depthwise_conv2d``: SAME
(k // 2) zero padding, stride 1 or 2, float32 accumulation, output in x's
dtype, the JAX package's NHWC layout and (k, k, 1, C) kernel.

Routes, as in JAX:

- ``force=None`` or ``"torch"``: the library depthwise convolution
  (``F.conv2d(groups=C)``), the JAX default ``force="xla"``;
- ``force="cuda"``: the hand-written kernel (``csrc/depthwise.cu``) on a
  CUDA tensor; it raises on any other device. It takes any odd k, stride 1
  and 2 and any H and W itself, so nothing falls back.

The plain PyTorch version of the kernel is :func:`depthwise_conv2d_reference`
(the k² shifted multiply-adds in float32, the JAX kernel's own
arithmetic).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from deadtrees_tpu_torch.ops.launches import LAUNCHES

FORCES = (None, "torch", "cuda")

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def _check(x: torch.Tensor, kernel: torch.Tensor, strides: int) -> int:
    """Validate the call; returns k."""
    if x.dim() != 4:
        raise ValueError(f"expected x of shape (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype}; expected float32 or bfloat16")
    k = kernel.shape[0]
    if tuple(kernel.shape) != (k, k, 1, x.shape[-1]) or k % 2 == 0:
        raise ValueError(
            f"kernel shape {tuple(kernel.shape)}; expected (k, k, 1, {x.shape[-1]}), k odd"
        )
    if strides not in (1, 2):
        raise ValueError(f"strides={strides}; expected 1 or 2")
    return k


def depthwise_conv2d_reference(x: torch.Tensor, kernel: torch.Tensor, *,
                               strides: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: k² shifted multiply-adds of
    the zero-padded float32 input, taps in row-major order; output in x's
    dtype."""
    k = _check(x, kernel, strides)
    p = k // 2
    _, hh, ww, _ = x.shape
    ho, wo = (hh - 1) // strides + 1, (ww - 1) // strides + 1
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    w = kernel.float()
    acc = None
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, dy: dy + strides * (ho - 1) + 1: strides,
                     dx: dx + strides * (wo - 1) + 1: strides] * w[dy, dx, 0]
            acc = tap if acc is None else acc + tap
    return acc.to(x.dtype)


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from deadtrees_tpu_torch.ops import _build

        lib = _build.load("depthwise")
        lib.depthwise_nhwc.argtypes = [_P] * 3 + [_I] * 7 + [_P]
        lib.depthwise_nhwc.restype = _I
        _lib = lib
    return _lib


def _launch(x: torch.Tensor, kernel: torch.Tensor, k: int, strides: int) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"force='cuda': no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    if kernel.device != x.device:
        raise ValueError(f"kernel must be on {x.device}")
    bsz, hh, ww, c = x.shape
    w = kernel.reshape(k, k, c).float().contiguous()
    out = torch.empty((bsz, (hh - 1) // strides + 1, (ww - 1) // strides + 1, c),
                      dtype=x.dtype, device=x.device)
    lib = _kernels()
    with torch.cuda.device(x.device):
        status = lib.depthwise_nhwc(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), bsz, hh, ww, c, k, strides,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"depthwise_nhwc launch failed: CUDA error {status}")
    LAUNCHES["depthwise_conv2d"] += 1
    return out


def depthwise_conv2d(
    x: torch.Tensor,  # (B, H, W, C)
    kernel: torch.Tensor,  # (k, k, 1, C) flax/HWIO depthwise kernel
    *,
    strides: int = 1,
    force: Optional[str] = None,  # None / "torch" (library conv) | "cuda"
) -> torch.Tensor:
    """Depthwise conv with k // 2 zero padding; (B, Ho, Wo, C) in x's
    dtype, Ho = (H - 1) // strides + 1 (likewise Wo)."""
    if force not in FORCES:
        raise ValueError(f"force={force!r}; expected one of {FORCES}")
    k = _check(x, kernel, strides)
    if force == "cuda":
        return _launch(x, kernel, k, strides)
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)  # (C, 1, k, k)
    out = F.conv2d(x.permute(0, 3, 1, 2), w, stride=strides, padding=k // 2,
                   groups=x.shape[-1])
    return out.permute(0, 2, 3, 1)
