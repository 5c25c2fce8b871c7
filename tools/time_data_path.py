#!/usr/bin/env python3
"""Time the native shard reader on a card's host: its decode, A/B between
C++ sources, and the recipe's fit by decode-thread count.

    python3 tools/time_data_path.py [--source FILE ...] [--fits]

Writes 2 shards of 64 tiles of 512² (RGBN, mask, lu) twice, uncompressed
by PIL and as deflate + predictor 2 (``chip_smoke.py``'s decode set), under
``build/time_data_path/``. Each ``--source`` (default: the port's
``deadtrees_tpu_torch/data/csrc/deadtrees_io.cpp``; the JAX package's
``native/deadtrees_io.cpp`` has the same C interface) is built with the
port's g++ flags, and ``decode_batch`` of one shard's 64 RGBN tiles is timed
on 1, 4 and every thread, host clock, median of 5, the sources in turns
(A, B, B, A). With ``--fits`` (needs CUDA): ``Trainer.fit()`` of the b5
recipe as ``chip_smoke.py`` phase 14 runs it (bs 16, one epoch of 8
unfrozen steps) over 8 such shards, natively on 1, 2 and 4 decode threads
and through PIL, in turns after one warm-up fit, the steps/s of its
metrics file. The last line is one JSON object of the numbers. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "time_data_path"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(source: Path, index: int) -> ctypes.CDLL:
    from deadtrees_tpu_torch.data import native

    target = OUT / f"lib{index}-{source.stem}.so"
    cmd = ["g++", *native.CXX_FLAGS, "-o", str(target), str(source), *native.LIBS]
    out = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if out.returncode != 0:
        raise RuntimeError(f"building {source} failed:\n{out.stdout}{out.stderr}")
    return native._bind(ctypes.CDLL(str(target)))


def _decode_ms(lib, shard: str, extents, threads: int, img: int) -> float:
    """Median of 5 host-clock times of one ``decode_batch`` call."""
    import numpy as np

    n = len(extents)
    offs = (ctypes.c_int64 * n)(*[e[0] for e in extents])
    sizes = (ctypes.c_int64 * n)(*[e[1] for e in extents])
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = np.empty((n, img, img, 4), np.uint8)
        rc = lib.decode_batch(shard.encode(), offs, sizes, n,
                              out.ctypes.data_as(ctypes.c_void_p), img, img, 4, threads)
        times.append(time.perf_counter() - t0)
        if rc != 0:
            raise RuntimeError(f"decode_batch failed rc={rc}")
    return statistics.median(times) * 1e3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, action="append",
                        help="a C++ source of the reader (repeatable)")
    parser.add_argument("--fits", action="store_true", help="also the fits by thread count")
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    cs = _chip_smoke()
    from deadtrees_tpu_torch.data import native

    sources = [s.resolve() for s in (args.source or [native.SOURCE])]

    if OUT.exists():
        shutil.rmtree(OUT)
    cores = os.cpu_count()
    result = {"cores": cores, "sources": [str(s.relative_to(REPO)) for s in sources]}
    cs.DECODE_SHARDS = 8 if args.fits else 2
    t0 = time.perf_counter()
    cs.write_decode_shards(OUT)
    print(f"decode set: {cs.DECODE_SHARDS} x {cs.DECODE_SAMPLES} tiles of {cs.IMG}², "
          f"uncompressed and deflate + predictor 2, in {time.perf_counter() - t0:.1f} s; "
          f"{cores} cores")

    libs = [_build(s, i) for i, s in enumerate(sources)]
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    for kind in ("plain", "deflate"):
        shard = str(OUT / kind / "train" / "train-combo-000000.tar")
        extents = [g["rgbn.tif"] for g in native.index_shard_samples(shard).values()]
        for threads in sorted({1, 4, cores}):
            times = {i: [] for i in range(len(libs))}
            for i in order:
                times[i].append(_decode_ms(libs[i], shard, extents, threads, cs.IMG))
            for i, source in enumerate(result["sources"]):
                result[f"{kind}/{threads}/{source}"] = times[i]
            print(f"decode_batch of {len(extents)} RGBN tiles ({kind}) on {threads} threads, "
                  "ms in turns: " + "; ".join(
                      f"{s}: {', '.join(f'{t:.2f}' for t in times[i])}"
                      for i, s in enumerate(result["sources"])))

    if args.fits:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--fits runs the recipe on a CUDA card")
        print(f"card: {cs.card_line()}")
        runs = [("warm-up", True, 4)]
        turns = [("native 1", True, 1), ("native 2", True, 2), ("native 4", True, 4),
                 ("PIL", False, 1)]
        runs += turns + list(reversed(turns))
        fits = {}
        for i, (name, use_native, threads) in enumerate(runs):
            cs.DECODE_THREADS = threads
            rate = cs._short_fit(OUT / "plain", OUT / f"fit_{i}", use_native)["steps_per_s"]
            fits.setdefault(name, []).append(rate)
            print(f"fit of {cs.DATA_FIT_STEPS} steps, {name}: {rate:.3f} steps/s")
        result["fits"] = fits
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
