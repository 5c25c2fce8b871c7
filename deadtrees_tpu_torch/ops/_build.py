"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled on first CUDA use by ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so

The library name carries a hash of the source and of the ``csrc/*.cuh``
headers, so an edited kernel is
rebuilt and an unchanged one is reused. ``build_all`` starts one ``nvcc``
per source, all at once. A variant of a source built with preprocessor
macros (``defines``, e.g. an instrumented build for a probe) is a library
of its own beside the plain one. Nothing here runs at import time:
importing the package needs no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("fused_ir_chw", "fused_ir_nhwc", "depthwise", "augment")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source at first use"
    )


def _stem(name: str, defines: Sequence[str] = ()) -> str:
    """The library's name: the source's, and its macros for a variant."""
    return "-".join((name, *(d.lower() for d in defines)))


def _flags(defines: Sequence[str] = ()) -> tuple:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def _target(name: str, defines: Sequence[str] = ()) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include a header
        digest.update(header.read_bytes())
    digest.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"{_stem(name, defines)}-{digest.hexdigest()[:12]}.so"


def _start(name: str, defines: Sequence[str] = ()):
    """Start nvcc for one source; returns (process, tmp path, target)."""
    target = _target(name, defines)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def build_all(names: List[str] = SOURCES, defines: Sequence[str] = ()) -> Dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel (each source with the
    macros ``defines``) and load all of them. Raises with nvcc's output
    when a build fails."""
    defines = tuple(defines)
    with _lock:
        pending = {}
        t0 = time.perf_counter()
        for name in names:
            if _stem(name, defines) not in _libs and not _target(name, defines).exists():
                pending[name] = _start(name, defines)
        for name, (proc, tmp, target) in pending.items():
            log, _ = proc.communicate()
            (BUILD_DIR / f"{_stem(name, defines)}.log").write_text(log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, target)
            build_seconds[_stem(name, defines)] = time.perf_counter() - t0
        for name in names:
            stem = _stem(name, defines)
            if stem not in _libs:
                _libs[stem] = ctypes.CDLL(str(_target(name, defines)))
        return {name: _libs[_stem(name, defines)] for name in names}


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with the macros
    ``defines``), built on first use."""
    lib = _libs.get(_stem(name, defines))
    return lib if lib is not None else build_all([name], defines)[name]


def ptxas_log(name: str) -> str:
    """nvcc's register/shared-memory report from the last build, if any."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""
