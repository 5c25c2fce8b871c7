"""Data parallelism over ``torch.distributed``: one process (a rank) a device.

Counterpart of ``deadtrees_tpu.parallel.mesh``. The JAX package trains on a
1-D ``data`` mesh: batches split over the devices on axis 0, parameters
replicated, and XLA inserts the collectives that make the step the step of
the GLOBAL batch. The port runs one process a device and makes those
collectives itself, with two only: ``all_reduce`` and ``broadcast`` (gloo
on CUDA tensors offers no all-gather).

- :func:`distributed_init` starts the process group from explicit
  arguments, or from the environment that ``python -m
  torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` / ``MASTER_PORT``); one process does nothing, as JAX's
  does. NCCL on CUDA, gloo on the CPU, or the ``backend`` asked for (gloo
  on CUDA tensors puts two ranks on one card, which NCCL refuses). No
  backend stands in for another: a failed initialization raises.
- :func:`create_mesh` is this rank's :class:`Mesh`: its device, rank,
  the world size and the group.
- :func:`batch_sharding` / :func:`replicate_sharding` describe the split
  (axis 0 over the ranks, or none) as a :class:`Sharding`, which
  :func:`shard_batch`, :func:`replicate` and the scene predictor read.
- :func:`shard_batch` is this rank's contiguous slice of a global batch's
  axis 0, on its device. In training the data module already yields the
  local slice (JAX's ``make_array_from_process_local_data``), so the
  trainer's batches need no slicing.
- :func:`replicate` broadcasts rank 0's tensors (parameters, BatchNorm
  buffers, optimizer state) into every rank's, in one broadcast a dtype.

What XLA derives from the sharding, the port states: inside
:func:`global_batch`, :func:`batch_sum`, :func:`batch_mean` and
:func:`batch_all` reduce over the ranks (with autograd where the input
needs a gradient). The
train-mode BatchNorm (``models/blocks.py``), the loss terms
(``losses/losses.py``), ``fscore`` (``losses/metrics.py``) and the eval
step's confusion matrices read them, so a step computes the global
batch's statistics, loss and metrics, the same numbers on every rank.
Outside :func:`global_batch`, or with one rank, they return their input.
:func:`all_reduce_mean_` averages the flat gradient buffer.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
BACKENDS = ("nccl", "gloo")

# the mesh whose ranks batch_sum & co. reduce over: set by global_batch() only
_ACTIVE: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the 1-D data-parallel mesh."""

    device: torch.device
    rank: int = 0
    size: int = 1
    group: Any = None  # the process group; None without one
    # host-side decisions (stop, barrier) on CPU tensors: the group itself
    # under gloo, a gloo group beside NCCL, so that no decision syncs the card
    control: Any = None

    @property
    def distributed(self) -> bool:
        return self.size > 1


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on ``mesh``: axis ``axis`` split over the ranks in
    contiguous equal parts, or replicated (``axis=None``)."""

    mesh: Mesh
    axis: Optional[int] = None

    def local_range(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of an axis of length ``n``; raises when
        the world size does not divide ``n``."""
        if self.axis is None:
            return 0, n
        size, rank = self.mesh.size, self.mesh.rank
        if n % size:
            raise ValueError(f"an axis of {n} does not split over {size} ranks")
        part = n // size
        return rank * part, (rank + 1) * part


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def env_world_size() -> int:
    """The world size that the launcher's environment names (1 without one)."""
    return _env_int("WORLD_SIZE") or 1


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group; True when this call (or an earlier one)
    made a group of several processes, False for one process.

    ``coordinator_address`` (``host:port`` or a ``tcp://`` URL; default
    ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` (default
    ``WORLD_SIZE``) and ``process_id`` (default ``RANK``). ``backend``:
    ``"nccl"`` or ``"gloo"``; default NCCL where CUDA is available, else
    gloo. With CUDA, the process's device is ``LOCAL_RANK`` (default: the
    rank) modulo the card count. A collective on the new group checks it
    before this returns."""
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if num_processes is None or num_processes <= 1:
        return False
    if process_id is None:
        process_id = _env_int("RANK")
        if process_id is None:
            raise ValueError("distributed_init: no process_id and no RANK in the environment")
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError("distributed_init: no coordinator_address and no "
                             "MASTER_ADDR / MASTER_PORT in the environment")
        coordinator_address = f"{addr}:{port}"
    backend = backend or default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if dist.is_initialized():
        have = (dist.get_world_size(), dist.get_rank(), dist.get_backend())
        if have != (num_processes, process_id, backend):
            raise RuntimeError(f"a process group (world, rank, backend) = {have} already "
                               f"exists; asked for {(num_processes, process_id, backend)}")
        return True
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs CUDA")
    if torch.cuda.is_available():
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device((process_id if local is None else local)
                              % torch.cuda.device_count())
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    probe = torch.ones(1, device=_default_device() if backend == "nccl" else "cpu")
    dist.all_reduce(probe)
    if int(probe.item()) != num_processes:
        raise RuntimeError(f"the {backend} group's first all_reduce gave {probe.item()}")
    return True


def _default_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def create_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[Any]] = None,
    *,
    device: Union[str, torch.device, None] = None,
) -> Mesh:
    """This rank's mesh over every rank of the process group (one rank
    without a group). ``n_devices``, when given, must be the world size.
    The rank's device: ``devices[rank]`` (one device a rank), else
    ``device``, else the current CUDA device, else the CPU."""
    if dist.is_available() and dist.is_initialized():
        size, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
        control = group if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    else:
        size, rank, group, control = 1, 0, None, None
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"a mesh of {n_devices} device(s) needs as many ranks; the "
                         f"process group has {size}")
    if devices is not None:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        here = torch.device(devices[rank])
    else:
        here = torch.device(device) if device is not None else _default_device()
    return Mesh(device=here, rank=rank, size=size, group=group, control=control)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Batched tensors: axis 0 split over the ranks."""
    return Sharding(mesh, 0)


def replicate_sharding(mesh: Mesh) -> Sharding:
    """Parameters and optimizer state: whole on every rank."""
    return Sharding(mesh, None)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's contiguous slice of axis 0 of every tensor or array in
    ``batch`` (a global batch, the same on every rank), on the rank's
    device; other leaves pass unchanged."""
    sharding = batch_sharding(mesh)

    def local(x):
        lo, hi = sharding.local_range(x.shape[0])
        return torch.as_tensor(x[lo:hi]).to(mesh.device)

    return _map(batch, local)


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of ``tree``: a module's parameters and buffers, an
    object's ``state_tensors()``, the leaves of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if hasattr(tree, "state_tensors"):
        return list(tree.state_tensors())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@torch.no_grad()
def replicate(tree: Any, mesh: Mesh) -> Any:
    """Make ``tree``'s tensors rank 0's on every rank (in place; one
    broadcast a dtype and device) and return ``tree``. A no-op on one
    rank."""
    if not mesh.distributed:
        return tree
    seen, groups = set(), {}
    for t in _tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))
    return tree


# -- the global batch --------------------------------------------------------

class global_batch:
    """Context manager: inside, :func:`batch_sum` & co. reduce over
    ``mesh``'s ranks (nothing changes for ``None`` or one rank). Nesting
    restores the outer mesh on exit."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh if mesh is not None and mesh.distributed else None

    def __enter__(self):
        global _ACTIVE
        self._outer, _ACTIVE = _ACTIVE, self.mesh
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._outer
        return False


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing :class:`global_batch`, or None."""
    return _ACTIVE


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of every rank's copy of the sum
    flows back summed over the ranks (each rank differentiates the same
    loss, so each input gets the world size times its share, which the
    step's mean over the ranks of the parameter gradients divides out)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (a new tensor; autograd passes through
    when ``x`` needs a gradient); ``x`` itself outside a global batch."""
    mesh = _ACTIVE
    if mesh is None:
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x, mesh.group)
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of a per-rank mean over equal local
    batches: the global batch's mean. ``x`` outside a global batch."""
    mesh = _ACTIVE
    if mesh is None:
        return x
    return batch_sum(x) / mesh.size


def batch_all(flag: torch.Tensor) -> torch.Tensor:
    """A boolean tensor true where it is true on every rank (one decision
    for all); ``flag`` outside a global batch."""
    mesh = _ACTIVE
    if mesh is None:
        return flag
    out = flag.to(torch.int32)
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=mesh.group)
    return out.bool()


@torch.no_grad()
def all_reduce_mean_(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``t`` replaced by its mean over ``mesh``'s ranks (one all_reduce);
    unchanged without a mesh of several ranks."""
    if mesh is not None and mesh.distributed:
        dist.all_reduce(t, group=mesh.group)
        t.div_(mesh.size)
    return t


@torch.no_grad()
def all_reduce_sum_(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``t`` replaced by its sum over ``mesh``'s ranks (one all_reduce);
    unchanged without a mesh of several ranks."""
    if mesh is not None and mesh.distributed:
        dist.all_reduce(t, group=mesh.group)
    return t


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
    """True when ``flag`` is true on any rank: one all_reduce of a CPU
    tensor over the control group, so it waits for no device work. Every
    rank must ask at the same point (the trainer's stop at a step
    boundary)."""
    if mesh is None or not mesh.distributed:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.control)
    return bool(t.item())


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait until every rank gets here (an all_reduce over the control
    group): rank 0's files on disk before another rank reads them."""
    any_rank(False, mesh)


def rank0_value(value: float) -> float:
    """Rank 0's ``value`` on every rank of the process group (a broadcast
    over a gloo group or of a CUDA tensor under NCCL); ``value`` without a
    group."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return value
    device = "cpu" if dist.get_backend() == "gloo" else _default_device()
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.broadcast(t, src=0)
    return float(t.item())
