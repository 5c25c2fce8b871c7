"""Train-mode BatchNorm: statistics, normalisation, running update and
backward as one op.

The port's :class:`~deadtrees_tpu_torch.models.blocks.BatchNorm2d` trains
with flax's semantics: it normalizes with the batch's biased statistics,
taken in float32 whatever x's type, and moves ``running_var`` toward the
biased variance. The JAX package leaves this to XLA; no Pallas kernel is
replaced.

:func:`batch_norm_train` is the op. Its forward is
``deadtrees::batch_norm_train(x, weight, bias, running_mean, running_var,
num_batches_tracked, momentum, eps) -> (y, mean, invstd)``, which declares
the running buffers and the counter as mutated, so that a compiled program
(``DEADTREES_COMPILE_OPTS``) and ``torch.utils.checkpoint`` see the
update; its backward is ``deadtrees::batch_norm_train_backward(dy, x,
weight, mean, invstd) -> (dx, dweight, dbias)``; mean and invstd are
float32 (float64 for a float64 x, which only the CPU takes). Both have fake
implementations. The schemas are defined here with
``torch.library.Library``; the autograd formula and the CUDA
implementations are C++ (``csrc/batchnorm_op.cpp``, built at first use by
``ops/_build.py`` and loaded by :func:`load`), so that no Python runs in a
layer's backward, which autograd runs on a thread of its own beside the
data path's Python threads, and little in its forward.

- A CPU tensor takes the plain version (:func:`batch_norm_train_reference`,
  :func:`batch_norm_train_backward_reference`): the arithmetic the port's
  BatchNorm had before the op, ``var_mean`` of a float32 copy for the
  running buffers and PyTorch's native batch norm for y and the gradients.
- A CUDA tensor launches the four kernels of ``csrc/batchnorm.cu`` or
  raises: statistics and normalisation forward, two reductions and the
  input gradient backward, 2 + 2 launches a layer, counted in
  ``ops.LAUNCHES["bn_stats"]``, ``["bn_apply"]``, ``["bn_grad_reduce"]``
  and ``["bn_grad_apply"]``. They take x (N, C, H, W) in bfloat16 or
  float32, NCHW- or channels-last-contiguous, with float32 weight, bias
  and running buffers.

The kernels spread each channel over chunks of its N·H·W values, as many
as :func:`bn_plan` finds for the shape and the card's SM count.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from deadtrees_tpu_torch.ops.depthwise import H100_SMS
from deadtrees_tpu_torch.ops.launches import LAUNCHES

KERNELS = ("bn_stats", "bn_apply", "bn_grad_reduce", "bn_grad_apply")
BN_THREADS = 256  # threads a block (kThreads in csrc/batchnorm.cu)
BN_BLOCKS = 16  # blocks the plan asks for per SM: two waves of 8 resident 256-thread blocks
BN_MIN_PER_THREAD = 4  # vectors (NCHW) or pixels (NHWC) a thread reads at least
# chunks a channel at most: every block of a channel merges all of its
# chunks' partial results (a lane every 32nd), so their number is kept at
# 8 a lane
BN_MAX_CHUNKS = 256
BN_MAX_CHUNK = 2**22  # elements a chunk at most: its float32 count stays exact


class BnPlan(NamedTuple):
    """How the four kernels split one call over blocks of
    :data:`BN_THREADS` threads: a block reads ``chunk`` units of one
    channel (NCHW) or of one channel vector (NHWC); ``chunks`` blocks a
    channel."""

    v: int  # elements a vector (16 bytes), or 1
    units: int  # NCHW: vectors of one channel; NHWC: pixels
    chunk: int  # units a block
    chunks: int


def bn_plan(n: int, c: int, hw: int, nhwc: bool, itemsize: int, aligned: bool,
            sms: int = H100_SMS) -> BnPlan:
    """The split of x (n, c, H, W) with ``hw`` = H·W that the CUDA ops
    launch (``csrc/batchnorm_op.cpp`` ``plan``).

    A vector is 16 bytes where the tensors are ``aligned`` to 16 bytes and
    a vector stays inside one (n, c) plane (NCHW: 16 bytes divide a plane)
    or inside one pixel (NHWC: they divide a pixel's channels); else an
    element. The blocks of a channel (NCHW) or channel vector (NHWC) are
    as many as give :data:`BN_BLOCKS` blocks per SM over all of them, but
    no chunk shorter than :data:`BN_MIN_PER_THREAD` units a thread or
    longer than :data:`BN_MAX_CHUNK` elements, and at most
    :data:`BN_MAX_CHUNKS`."""
    out = (ctypes.c_longlong * 4)()
    load().bn_op_plan(n, c, hw, int(nhwc), itemsize, int(aligned), sms, out)
    return BnPlan(*out)


def batch_norm_train_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
    running_var: torch.Tensor, num_batches_tracked: torch.Tensor, momentum: float, eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's forward in plain PyTorch, on any device: the running
    buffers from ``var_mean`` of a float32 copy of x (biased), y and the
    saved mean and invstd from PyTorch's native batch norm (float32;
    float64 for a float64 x)."""
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        running_mean.mul_(1.0 - momentum).add_(mean * momentum)
        running_var.mul_(1.0 - momentum).add_(var * momentum)
        num_batches_tracked.add_(1)
        y, save_mean, save_invstd = torch.native_batch_norm(x, weight, bias, None, None, True,
                                                            0.0, eps)
    return y, save_mean, save_invstd


def batch_norm_train_backward_reference(
    dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
    invstd: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's backward in plain PyTorch: PyTorch's native batch norm
    backward from the saved mean and invstd (eps is not read in training)."""
    return torch.ops.aten.native_batch_norm_backward(
        dy, x, weight, None, None, mean, invstd, True, 0.0, [True, True, True])


_lib_def = torch.library.Library("deadtrees", "FRAGMENT")
_lib_def.define(
    "batch_norm_train(Tensor x, Tensor weight, Tensor bias, Tensor(a!) running_mean, "
    "Tensor(b!) running_var, Tensor(c!) num_batches_tracked, float momentum, float eps) "
    "-> (Tensor, Tensor, Tensor)")
_lib_def.define(
    "batch_norm_train_backward(Tensor dy, Tensor x, Tensor weight, Tensor mean, "
    "Tensor invstd) -> (Tensor, Tensor, Tensor)")
_lib_def.impl("batch_norm_train", batch_norm_train_reference, "CPU")
_lib_def.impl("batch_norm_train_backward", batch_norm_train_backward_reference, "CPU")


@torch.library.register_fake("deadtrees::batch_norm_train")
def _(x, weight, bias, running_mean, running_var, num_batches_tracked, momentum, eps):
    c = x.shape[1]
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    return (torch.empty_like(x), x.new_empty((c,), dtype=dtype), x.new_empty((c,), dtype=dtype))


@torch.library.register_fake("deadtrees::batch_norm_train_backward")
def _(dy, x, weight, mean, invstd):
    return torch.empty_like(x), torch.empty_like(weight), torch.empty_like(weight)


_op_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


@torch.compiler.disable
def load() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/batchnorm_op.cpp``, which
    registers the ops' autograd formula and CUDA implementations, give it
    the plan's constants, and, where CUDA is available, ``csrc/batchnorm.cu``'s
    kernels; bind ``LAUNCHES``' BatchNorm counts to its counters. Returns
    the library."""
    global _op_lib
    with _load_lock:
        if _op_lib is None:
            from deadtrees_tpu_torch.ops import _build

            lib = _build.load("batchnorm_op")
            lib.bn_op_configure.argtypes = [ctypes.c_longlong] * 5
            lib.bn_op_configure(BN_THREADS, BN_BLOCKS, BN_MIN_PER_THREAD, BN_MAX_CHUNKS,
                                BN_MAX_CHUNK)
            lib.bn_op_plan.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4 + [
                ctypes.POINTER(ctypes.c_longlong)]
            if torch.cuda.is_available():
                kernels = _build.load("batchnorm")
                lib.bn_op_set_kernels.argtypes = [ctypes.c_void_p] * 3
                lib.bn_op_set_kernels(*(ctypes.cast(f, ctypes.c_void_p) for f in (
                    kernels.bn_forward, kernels.bn_backward, kernels.bn_sm_count)))
            counts = (ctypes.c_longlong * len(KERNELS)).in_dll(lib, "bn_op_launches")
            for i, name in enumerate(KERNELS):
                LAUNCHES.bind(name, ctypes.c_longlong.from_buffer(counts, i * 8))
            _op_lib = lib
    return _op_lib


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     num_batches_tracked: torch.Tensor, momentum: float,
                     eps: float) -> torch.Tensor:
    """Train-mode BatchNorm of x (N, C, H, W) with flax's semantics: y in
    x's type, normalized by the batch's biased float32 statistics; the
    running buffers move by ``momentum`` toward the batch mean and biased
    variance and ``num_batches_tracked`` ticks, in place. Differentiable in
    x, weight and bias. Raises, as ``F.batch_norm`` does, where a channel
    has a single value."""
    n, _, h, w = x.shape
    if n * h * w == 1:
        raise ValueError(f"Expected more than 1 value per channel when training, got input "
                         f"size {tuple(x.shape)}")
    if _op_lib is None:
        load()
    return torch.ops.deadtrees.batch_norm_train.default(
        x, weight, bias, running_mean, running_var, num_batches_tracked, momentum, eps)[0]
