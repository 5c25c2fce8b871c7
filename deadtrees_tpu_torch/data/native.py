"""The native shard reader: ctypes bindings of ``data/csrc/deadtrees_io.cpp``.

Counterpart of ``deadtrees_tpu.data.native``: tar header indexing,
baseline-TIFF decoding (none / LZW / PackBits / deflate, predictor 2,
strips or tiles) and a thread-pool batched decode into one contiguous
(N, H, W, C) uint8 array.

The library is the port's own copy of the C++ source, compiled with
``g++`` at first use (nothing runs at import) with the flags of the JAX
package's ``native/Makefile``:

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared -pthread
        -o build/torch_native/libdeadtrees_io-<hash>.so deadtrees_io.cpp -lz

``-march=native`` makes the library specific to the host's CPU, and a
working tree travels between machines, so ``<hash>`` covers the source,
the flags, the compiler's version and the host's CPU (its model and
feature flags from ``/proc/cpuinfo``). Each process compiles into a
temporary of its own and publishes it with ``os.replace``, so processes
that build at once all load a whole library. A failed build or load
raises with the compiler's output; nothing falls back to PIL here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "deadtrees_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")
LIBS = ("-lz",)
# /proc/cpuinfo keys that decide what -march=native emits
_CPU_KEYS = ("vendor_id", "cpu family", "model", "model name", "flags")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _TarEntry(ctypes.Structure):
    _fields_ = [
        ("offset", ctypes.c_int64),
        ("size", ctypes.c_int64),
        ("name", ctypes.c_char * 200),
    ]


def cpu_fingerprint(cpuinfo: Optional[str] = None) -> str:
    """The host CPU as ``-march=native`` sees it: the first processor's
    model and feature flags from ``/proc/cpuinfo`` (``cpuinfo`` overrides
    the file's text), else the platform's processor string."""
    if cpuinfo is None:
        try:
            cpuinfo = Path("/proc/cpuinfo").read_text()
        except OSError:
            cpuinfo = ""
    fields = {}
    for line in cpuinfo.split("\n\n", 1)[0].splitlines():
        key, _, value = line.partition(":")
        if key.strip() in _CPU_KEYS:
            fields[key.strip()] = value.strip()
    if not fields:
        return f"{platform.machine()} {platform.processor()}"
    return "\n".join(f"{k}: {fields.get(k, '')}" for k in _CPU_KEYS)


def _compiler() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(
            f"{CXX} not found on PATH: the port's native shard reader is built from "
            f"{SOURCE} at first use (DataConfig(use_native=False) reads with PIL)"
        )
    return found


def _compiler_version(cxx: str) -> str:
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True, check=False)
    return out.stdout.splitlines()[0] if out.stdout else ""


def library_path(build_dir: Optional[Path] = None, cpu: Optional[str] = None) -> Path:
    """Where the library for this source, these flags, this compiler and
    this CPU (``cpu``: a fingerprint, by default this host's) lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join((*CXX_FLAGS, *LIBS)).encode())
    digest.update(_compiler_version(_compiler()).encode())
    digest.update((cpu if cpu is not None else cpu_fingerprint()).encode())
    return Path(build_dir or BUILD_DIR) / f"libdeadtrees_io-{digest.hexdigest()[:16]}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile the library unless it is there already; returns its path.
    Raises with the compiler's output when the build fails."""
    target = library_path(build_dir)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if out.returncode != 0:
            raise RuntimeError(
                f"building the native shard reader failed (exit {out.returncode}):\n"
                f"{' '.join(cmd)}\n{out.stdout}{out.stderr}"
            )
        os.replace(tmp, target)  # atomic publish: a reader sees no torn file
    finally:
        tmp.unlink(missing_ok=True)
    return target


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tar_index.restype = ctypes.c_int64
    lib.tar_index.argtypes = [ctypes.c_char_p, ctypes.POINTER(_TarEntry), ctypes.c_int64]
    lib.tiff_decode.restype = ctypes.c_int
    lib.tiff_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.decode_batch.restype = ctypes.c_int
    lib.decode_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
    ]
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except OSError as e:
                raise RuntimeError(f"loading the native shard reader {path} failed: {e}") from e
        return _lib


def available() -> bool:
    """True when the library is loaded or can be built here (g++ on PATH)."""
    return _lib is not None or shutil.which(CXX) is not None


def tar_index(path: str, max_entries: Optional[int] = None) -> List[Tuple[str, int, int]]:
    """[(member name, payload offset, size)] from the tar headers only.

    ``max_entries`` defaults to the exact upper bound ``filesize // 512 +
    2`` (every member costs at least one 512-byte header block): a fixed
    1M cap zero-allocated a ~112 MB ctypes buffer a call, 102 ms a shard
    in the JAX package's measurement, more than the decode itself."""
    lib = load()
    if max_entries is None:
        max_entries = max(os.path.getsize(path) // 512 + 2, 16)
    buf = (_TarEntry * max_entries)()
    n = lib.tar_index(str(path).encode(), buf, max_entries)
    if n < 0:
        raise OSError(f"tar_index failed for {path}")
    return [(buf[i].name.decode(errors="replace"), buf[i].offset, buf[i].size) for i in range(n)]


def tiff_decode(data: bytes) -> np.ndarray:
    """Decode one TIFF byte string to (H, W[, C]) uint8. Raises
    ``ValueError`` on a layout the decoder refuses (planar files, a strip
    table that does not cover the image, 16-bit samples, ...)."""
    lib = load()
    h, w, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.tiff_decode(data, len(data), None, h, w, c)
    if rc != 0:
        raise ValueError(f"tiff_decode header parse failed rc={rc}")
    out = np.empty((h.value, w.value, c.value), np.uint8)
    rc = lib.tiff_decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p), h, w, c)
    if rc != 0:
        raise ValueError(f"tiff_decode failed rc={rc}")
    return out[..., 0] if c.value == 1 else out


def effective_threads(n_threads: int) -> int:
    """Clamp the decode pool to the host's core count. Oversubscription
    costs more than it wastes: on a 1-core host the JAX package measured
    313 samples/s at 2 threads against 1,138 at 1."""
    return max(1, min(int(n_threads), os.cpu_count() or 1))


def decode_batch(
    tar_path: str,
    entries: List[Tuple[int, int]],
    shape: Tuple[int, int, int],
    n_threads: int = 4,
) -> np.ndarray:
    """Decode N same-shape TIFF members of one tar file, given their
    (offset, size), on a pool of ``effective_threads(n_threads)`` threads
    → (N, H, W, C) uint8. A member of other dims raises ``ValueError``."""
    lib = load()
    n = len(entries)
    h, w, c = shape
    out = np.empty((n, h, w, c), np.uint8)
    offs = (ctypes.c_int64 * n)(*[e[0] for e in entries])
    sizes = (ctypes.c_int64 * n)(*[e[1] for e in entries])
    rc = lib.decode_batch(
        str(tar_path).encode(), offs, sizes, n, out.ctypes.data_as(ctypes.c_void_p),
        h, w, c, effective_threads(n_threads),
    )
    if rc != 0:
        raise ValueError(f"decode_batch failed rc={rc} for {tar_path}")
    return out


def index_shard_samples(path: str) -> Dict[str, Dict[str, Tuple[int, int]]]:
    """A shard's members grouped by sample key, in tar order:
    {key: {suffix: (offset, size)}}, from the headers only (the grouping of
    ``tar.iter_tar_samples``: key = the name up to its first dot)."""
    samples: Dict[str, Dict[str, Tuple[int, int]]] = {}
    for name, off, size in tar_index(path):
        if name.startswith("./"):
            name = name[2:]
        if "." not in name:
            continue
        key, suffix = name.split(".", 1)
        samples.setdefault(key, {})[suffix] = (off, size)
    return samples
