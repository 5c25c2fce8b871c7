"""The run's environment: caches inside the checkout, the card, and the
modules that may not be loaded."""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import List

# whole top-level module names: the port's own name begins with the last
FORBIDDEN = ("jax", "jaxlib", "flax", "deadtrees_tpu")


class NoDevice(RuntimeError):
    """Fewer CUDA cards than the cell asks for."""


def configure(root: Path) -> None:
    """Fixed cache directories in the checkout, set before torch loads:
    the compiled programs' (inductor, Triton) beside the kernels' libraries
    that the port builds into ``build/`` itself."""
    cache = root / "build" / "torch_compile"
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache)
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def require_cuda(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: this benchmark measures the "
                       "port on NVIDIA cards and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} card(s); "
                       f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def forbidden_loaded() -> List[str]:
    """Loaded top-level modules among :data:`FORBIDDEN`, compared whole."""
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))
