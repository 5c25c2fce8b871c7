"""Signed distance maps of the boundary loss.

Counterpart of ``deadtrees_tpu.losses.functional.batch_one_hot2dist``: for
each (H, W) plane of a one-hot (..., K, H, W) tensor, with pos = seg > 0.5,
``edt_to_pos · neg − (edt_to_neg − 1) · pos``, a zero map where the plane
has no pos pixel. The JAX package computes it in XLA; no Pallas kernel is
replaced.

The plain version (:func:`edt`, :func:`batch_one_hot2dist_reference`)
keeps the JAX package's two-pass design, in the same float32 arithmetic:
per-column distances from a cummax scan down the columns and a cummin scan
up them, then for each row the lower envelope
``min_x' ((x - x')² + g²[y, x'])`` as a broadcast min, in row blocks of at
most 16 M floats (unchunked, a 512² mask would need 512 MB per class).

A CUDA tensor launches two hand-written kernels (``csrc/edt.cu``, built at
first CUDA use by ``ops/_build.py``) or raises: the column distances, then
each row's lower envelope with the square roots and the signed combine.
A CPU tensor takes the plain version. Both round each float32 operation
the same way, so on the same input the kernels agree bit for bit with the
plain version on the card (torch's float32 sqrt on the CPU is not
correctly rounded and can land one ulp away). The op keeps launch counts
in ``ops.LAUNCHES["edt_columns"]`` and ``ops.LAUNCHES["edt_rows"]``.

The kernels are the ``torch.library`` custom op
``deadtrees::signed_distance_maps`` (the kernels on CUDA, the plain version
on the CPU), opaque to the compiler.
"""

from __future__ import annotations

import ctypes

import torch

from deadtrees_tpu_torch.ops.launches import LAUNCHES

KERNELS = ("edt_columns", "edt_rows")
MAX_SIDE = 8192  # (2 * 8192)² stays below the plain version's 1e12 "infinity"

_BIG = 1e12  # "infinity" for squared pixel distances; > (2*8192)**2
_ENVELOPE_FLOATS = 16 * 2**20  # live floats of one row block


def _nearest_true_1d(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-pixel distance (in pixels) to the nearest True element along
    ``dim``; lines with no True element get a distance near _BIG."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.float32, device=mask.device).reshape(shape)
    idx = idx.expand(mask.shape)
    seed_fwd = torch.where(mask, idx, torch.full_like(idx, -_BIG))
    d_before = idx - torch.cummax(seed_fwd, dim).values
    seed_bwd = torch.where(mask, idx, torch.full_like(idx, 2 * _BIG))
    after = torch.cummin(torch.flip(seed_bwd, (dim,)), dim).values
    d_after = torch.flip(after, (dim,)) - idx
    return torch.minimum(d_before, d_after)


def _row_envelope_min(g2: torch.Tensor) -> torch.Tensor:
    """d2[..., y, x] = min_x' ((x - x')² + g2[..., y, x']), over blocks of
    rows that keep at most 16 M floats live."""
    w = g2.shape[-1]
    rows = g2.reshape(-1, w)
    x = torch.arange(w, dtype=torch.float32, device=g2.device)
    dx2 = (x[:, None] - x[None, :]) ** 2  # (W, W')
    chunk = max(1, _ENVELOPE_FLOATS // (w * w))
    out = torch.empty_like(rows)
    for start in range(0, rows.shape[0], chunk):
        block = rows[start:start + chunk]
        out[start:start + chunk] = (dx2[None] + block[:, None, :]).amin(-1)
    return out.reshape(g2.shape)


def edt(mask: torch.Tensor) -> torch.Tensor:
    """Exact Euclidean distance to the nearest True pixel of boolean masks
    (..., H, W), each 2D mask on its own; 0 on True pixels. Equivalent to
    ``scipy.ndimage.distance_transform_edt(~mask)``; every pixel of an
    all-False mask gets the large finite value sqrt(1e12) = 1e6."""
    g = _nearest_true_1d(mask, dim=mask.dim() - 2)
    g2 = torch.clamp(g * g, max=_BIG)
    return torch.sqrt(_row_envelope_min(g2))


def batch_one_hot2dist_reference(seg: torch.Tensor) -> torch.Tensor:
    """The signed distance maps in plain PyTorch, on any device: the exact
    EDT of the class and of its complement, then the signed combine."""
    pos = seg > 0.5
    neg = ~pos
    d = edt(torch.stack([pos, neg]))
    d_out = d[0] * neg.float()
    d_in = (d[1] - 1.0) * pos.float()
    res = d_out - d_in
    any_pos = pos.flatten(-2).any(-1)[..., None, None]
    return torch.where(any_pos, res, torch.zeros_like(res))


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from deadtrees_tpu_torch.ops import _build

        lib = _build.load("edt")
        for name in KERNELS:
            fn = getattr(lib, name)
            fn.argtypes = [_P, _P, _L, _I, _I, _P]
            fn.restype = _I
        _lib = lib
    return _lib


@torch.library.custom_op("deadtrees::signed_distance_maps", mutates_args=())
def signed_distance_maps(seg: torch.Tensor) -> torch.Tensor:
    """(..., H, W) one-hot → (..., H, W) float32 signed distance maps: the
    two kernels on a CUDA tensor, the plain version on a CPU tensor. On
    CUDA it raises on anything but a float32 tensor of at least two dims
    with 1 ≤ H, W ≤ 8,192 and at least one plane."""
    if seg.device.type == "cpu":
        return batch_one_hot2dist_reference(seg).contiguous()
    if seg.device.type != "cuda":
        raise ValueError(f"no kernel for device {seg.device}")
    if seg.dtype != torch.float32 or seg.dim() < 2:
        raise ValueError(f"expected a float32 (..., H, W) one-hot, got "
                         f"{tuple(seg.shape)} {seg.dtype}")
    hh, ww = seg.shape[-2:]
    if not (1 <= hh <= MAX_SIDE and 1 <= ww <= MAX_SIDE):
        raise ValueError(f"H and W must lie in 1..{MAX_SIDE}, got {hh} x {ww}")
    planes = seg.numel() // (hh * ww)
    if planes == 0 or planes * max(hh, ww) >= 2**31:
        raise ValueError(f"{planes} planes of {hh} x {ww} do not fit the kernels' grids")
    seg = seg.contiguous()
    g2 = torch.empty((2, planes, hh, ww), dtype=torch.float32, device=seg.device)
    out = torch.empty_like(seg)
    lib = _kernel()
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream().cuda_stream
        for name, src, dst in (("edt_columns", seg, g2), ("edt_rows", g2, out)):
            status = getattr(lib, name)(src.data_ptr(), dst.data_ptr(), planes, hh, ww, stream)
            if status != 0:
                raise RuntimeError(f"{name} launch failed: CUDA error {status}")
            LAUNCHES[name] += 1
    return out


@signed_distance_maps.register_fake
def _(seg):
    return seg.new_empty(seg.shape, dtype=torch.float32)
