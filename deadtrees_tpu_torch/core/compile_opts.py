"""Compiler options and the compiled programs of the port.

Counterpart of ``deadtrees_tpu.core.tpu_opts`` and of the JAX package's
``jax.jit`` boundaries. The JAX package never runs a step op by op: each
step is one ``jax.jit`` program per input shape. The port's counterpart is
:class:`Program`: a function compiled with ``torch.compile`` (TorchDynamo
traces it whole, ``fullgraph=True``; one program per input shape,
``dynamic=False``), which on the card is TorchInductor's code (the ops
around the port's kernels fused, as XLA fuses them) replayed as a CUDA
graph (one launch per program, as a jitted program is one dispatch). The
hand-written kernels stay opaque custom ops inside it (``ops/*.py``).

Where programs compile:

- on CUDA, with inductor and :data:`CUDA_DEFAULTS` (CUDA-graph replay);
  ``DEADTREES_COMPILE_OPTS`` replaces those options (an empty value means
  no options: inductor without CUDA graphs). A program made with
  ``by_default=False`` runs eagerly on CUDA unless that variable is set:
  those are the programs whose compiled form ``chip_smoke.py`` does not
  yet hold against the eager one on the card (the train, eval and predict
  steps, SWA's BatchNorm pass, w8a8, TTA and the ensemble vote; a cold
  compile of the b5's train step outlasts the script's time limit);
- on the CPU, which only the tests use, programs run eagerly unless
  ``DEADTREES_COMPILE_OPTS`` names a ``backend`` (the tests name
  ``aot_eager``, and ``inductor`` once);
- under :func:`disable_compile` (the counterpart of ``jax.disable_jit``),
  every program runs eagerly, in this process and in the processes it
  starts meanwhile (it sets ``DEADTREES_DISABLE_COMPILE=1``, which they
  inherit, as ``JAX_DISABLE_JIT`` is inherited).

A compile error raises: nothing falls back to eager. The variable is a
comma-separated ``key=value`` list: ``backend`` picks the backend (only
``inductor`` on CUDA), every other key is an inductor option (e.g.
``triton.cudagraphs=false``, ``compile_threads=1``). The TPU's
``xla_tpu_scoped_vmem_limit_kib`` has no meaning on the card and is not
carried over. Inductor's and Triton's caches go under ``build/`` of the
checkout (``build/torch_compile``) unless the caller set their
directories.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from deadtrees_tpu_torch.core import trace

ENV = "DEADTREES_COMPILE_OPTS"
EAGER_ENV = "DEADTREES_DISABLE_COMPILE"
# each program replays as one CUDA graph (one launch a call; PERF.md §5)
CUDA_DEFAULTS = {"triton.cudagraphs": True}
CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_compile"
# compiled entries of one traced function: one per input shape and per
# engine, stage or static flag (a server compiles at most 6 batch sizes per
# image size, and every engine in a process adds its own)
RECOMPILE_LIMIT = 256

_lock = threading.Lock()
_configured = False


def _parse(raw: str) -> dict:
    out = {}
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        key, _, val = item.partition("=")
        if val.lower() in ("true", "false"):
            out[key] = val.lower() == "true"
        else:
            try:
                out[key] = int(val)
            except ValueError:
                try:
                    out[key] = float(val)
                except ValueError:
                    out[key] = val
    return out


def compile_options(device: Union[str, torch.device], by_default: bool = True) -> Optional[dict]:
    """The options a program on ``device`` compiles with, ``backend``
    included; ``None`` when it runs eagerly (under :func:`disable_compile`,
    on the CPU unless ``DEADTREES_COMPILE_OPTS`` names a backend, and on
    CUDA for a program not ``by_default`` unless the variable is set)."""
    if os.environ.get(EAGER_ENV) == "1":
        return None
    device = torch.device(device)
    raw = os.environ.get(ENV)
    opts = _parse(raw) if raw is not None else None
    if device.type == "cuda":
        if opts is None and not by_default:
            return None
        opts = dict(CUDA_DEFAULTS) if opts is None else opts
        backend = opts.setdefault("backend", "inductor")
        if backend != "inductor":
            raise ValueError(f"{ENV}: programs on CUDA compile with inductor, not {backend!r}")
        return opts
    if not opts or "backend" not in opts:
        return None
    return opts


@contextlib.contextmanager
def disable_compile():
    """Run every program of the port eagerly inside the block, in every
    thread and in every process started inside it (the counterpart of
    ``jax.disable_jit()``)."""
    with _lock:
        old = os.environ.get(EAGER_ENV)
        os.environ[EAGER_ENV] = "1"
    try:
        yield
    finally:
        with _lock:
            if old is None:
                del os.environ[EAGER_ENV]
            else:
                os.environ[EAGER_ENV] = old


def _configure() -> None:
    """Once a process, before the first compile: the cache directories
    under ``build/`` (unless the caller chose others; inductor may already
    have filled in its default, under the temporary directory) and the
    recompile limit."""
    global _configured
    if _configured:
        return
    from torch._inductor.runtime.cache_dir_utils import default_cache_dir

    if os.environ.get("TORCHINDUCTOR_CACHE_DIR") in (None, os.path.abspath(default_cache_dir())):
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE_DIR)
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE_DIR / "triton"))
    cfg = torch._dynamo.config
    for name in ("recompile_limit", "cache_size_limit"):
        if hasattr(cfg, name):
            setattr(cfg, name, max(getattr(cfg, name), RECOMPILE_LIMIT))
    cfg.accumulated_cache_size_limit = max(cfg.accumulated_cache_size_limit,
                                           4 * RECOMPILE_LIMIT)
    _configured = True


def _cudagraph_thread_state() -> None:
    """Set up the CUDA-graph trees' thread-local state in this thread when
    it has none: PyTorch sets it up in the thread that imports them and in
    autograd's threads, and (before 2.13) fails in any other, such as a
    server's batching thread. Each such thread gets a tree of its own, as
    PyTorch 2.13 gives it."""
    from torch._inductor import cudagraph_trees

    local = cudagraph_trees.local
    if hasattr(local, "tree_manager_containers") or torch._C._is_key_in_tls(
            "tree_manager_containers"):
        return
    local.tree_manager_containers = {}
    local.tree_manager_locks = collections.defaultdict(threading.Lock)
    torch._C._stash_obj_in_tls("tree_manager_containers", local.tree_manager_containers)
    torch._C._stash_obj_in_tls("tree_manager_locks", local.tree_manager_locks)


def graphs_compiled() -> int:
    """Graphs TorchDynamo has compiled in this process (a recompile adds
    one): ``torch._dynamo``'s ``unique_graphs`` counter."""
    from torch._dynamo.utils import counters

    return int(counters["stats"]["unique_graphs"])


def _own(out: Any) -> Any:
    """Copies of the tensors in ``out``: a CUDA graph's outputs live in its
    memory pool and are overwritten by its next replay."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_own(o) for o in out)
    if isinstance(out, dict):
        return {k: _own(v) for k, v in out.items()}
    return out


def _device_of(args) -> Optional[torch.device]:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


class Program:
    """``fn`` as one compiled program per input shape on ``device`` (None:
    the device of the first tensor argument; module docstring), or ``fn``
    itself where :func:`compile_options` (with ``by_default``) says eager.
    ``compiles`` holds
    ``(seconds, graphs)`` of every call that compiled: its wall time, a
    trace and compile included, and the graphs it added. With CUDA-graph
    replay the outputs are copied out of the graph's pool before they are
    returned."""

    def __init__(self, fn: Callable, device: Union[str, torch.device, None],
                 by_default: bool = True):
        self.fn = fn
        self.device = None if device is None else torch.device(device)
        self.by_default = by_default
        self.compiles: List[Tuple[float, int]] = []
        self._compiled: Dict[Tuple, Callable] = {}

    def options(self, device: Optional[torch.device] = None) -> Optional[dict]:
        """:func:`compile_options` of this program on ``device`` (None: its
        own); ``None`` when it runs eagerly there."""
        return compile_options(device or self.device or torch.device("cpu"), self.by_default)

    def __call__(self, *args, **kwargs):
        device = self.device or _device_of(args) or torch.device("cpu")
        opts = self.options(device)
        if opts is None:
            return self.fn(*args, **kwargs)
        key = tuple(sorted(opts.items()))
        compiled = self._compiled.get(key)
        if compiled is None:
            _configure()
            opts = dict(opts)
            backend = opts.pop("backend")
            kw = {"options": opts} if backend == "inductor" and opts else {}
            compiled = torch.compile(self.fn, backend=backend, fullgraph=True,
                                     dynamic=False, **kw)
            self._compiled[key] = compiled
        graphs = opts.get("triton.cudagraphs", False) and device.type == "cuda"
        if graphs:
            _cudagraph_thread_state()
            torch.compiler.cudagraph_mark_step_begin()
        before = graphs_compiled()
        t0 = time.perf_counter()
        out = compiled(*args, **kwargs)
        added = graphs_compiled() - before
        if added:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            self.compiles.append((seconds, added))
            if trace.ENABLED:  # the same call on the timeline, inside the caller's span
                end = time.time_ns()
                trace.record("program.compile", end - int(seconds * 1e9), end,
                             key=getattr(self.fn, "__qualname__", repr(self.fn)))
        return _own(out) if graphs else out
