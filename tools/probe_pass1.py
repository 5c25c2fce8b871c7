#!/usr/bin/env python3
"""Where the bf16 pass 1 of kernel 1 spends its cycles, on a CUDA card.

    python3 tools/probe_pass1.py

Builds ``deadtrees_tpu_torch/ops/csrc/fused_ir_chw.cu`` a second time with
``-DDT_PASS1_PROBE``: thread 0 of every block of ``pass1_bf16_kernel``
reads ``clock64()`` after each phase (x staged and the 1x1 expand; y
written to shared memory; the depthwise conv and the cSE partial sums; h
stored) and counts the cycles it waited on the chunks' copies. The script
runs the 22 decoder-block shapes of the EfficientUNet++/b5 flagship at
512², bs 4 (random weights from seed 0) through the probe build, sums each
phase's cycles over the blocks and prints each phase's share, per shape
and over the forward. Beside them: the kernel's time per launch from the
plain build and from the probe build (CUDA events, as ``chip_smoke.py``
times it), and how many pixels the expand covers for a tile's 256 outputs
(the staged halo, padded to whole product tiles) against the
(8 + 2P) x (32 + 2P) that the depthwise conv reads. The last line is one
JSON object of the totals. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PHASES = ("stage + expand", "y write", "depthwise + psum", "h store")
PROBE = ("DT_PASS1_PROBE",)
BATCH = 4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_pass1: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import ctypes

    from deadtrees_tpu_torch.models import create_model, init_model
    from deadtrees_tpu_torch.ops import _build
    from deadtrees_tpu_torch.ops import fused_mbconv as fm

    cs = _chip_smoke()
    print(cs.card_line(), flush=True)
    plain_lib = fm._kernels()
    probe_lib = fm.bind_kernels(_build.load("fused_ir_chw", PROBE))
    probe_lib.fused_ir_chw_probe.argtypes = [ctypes.c_void_p]
    probe_lib.fused_ir_chw_probe.restype = ctypes.c_int
    probe_lib.fused_ir_chw_probe_geometry.argtypes = [ctypes.c_int, ctypes.c_int]
    probe_lib.fused_ir_chw_probe_geometry.restype = ctypes.c_int

    hp = dict(architecture="efficientunet++", encoder_name="timm-efficientnet-b5",
              in_channels=4, classes=3, decoder_channels=[256, 128, 64, 32, 16])
    gen = torch.Generator().manual_seed(cs.SEED)
    model = init_model(create_model(**hp), generator=gen).cuda().eval()
    th = plain_lib.fused_ir_chw_tile_size(3, 1, 0)
    tw = plain_lib.fused_ir_chw_tile_size(3, 1, 1)
    total = dict.fromkeys(PHASES + ("x waits",), 0)
    ms_sum = probe_ms_sum = 0.0
    print(f"bf16 pass 1 by phase, {th} x {tw} output tiles, bs {BATCH}, 512²; "
          "cycles summed over the blocks (thread 0's clock64)")
    for name, i, shape, fp in cs.flagship_block_shapes(model, BATCH):
        _, cin, hh, ww = shape
        k = fp.dw.shape[0]
        cm = fp.w1.shape[1]
        x = torch.randn(shape, generator=gen).cuda().to(torch.bfloat16)
        fm._lib = plain_lib
        ms = cs.cuda_time_ms(lambda: fm.chw_pass1(x, fp, ksize=k))
        blocks = -(-hh // th) * -(-ww // tw) * -(-cm // 64) * BATCH
        buf = torch.zeros((blocks, 5), dtype=torch.int64, device="cuda")
        fm._lib = probe_lib  # the wrappers call the probe build from here on
        try:
            probe_ms = cs.cuda_time_ms(lambda: fm.chw_pass1(x, fp, ksize=k))
            if probe_lib.fused_ir_chw_probe(buf.data_ptr()) != 0:
                raise RuntimeError("fused_ir_chw_probe failed")
            fm.chw_pass1(x, fp, ksize=k)
            torch.cuda.synchronize()
            probe_lib.fused_ir_chw_probe(None)
        finally:
            fm._lib = plain_lib
        cyc = buf.sum(0).tolist()
        if bool((buf[:, :4].sum(1) <= 0).any()):
            raise RuntimeError(f"{name}: a block of the probe build recorded nothing")
        for key, val in zip(PHASES + ("x waits",), cyc):
            total[key] += val
        ms_sum += ms
        probe_ms_sum += probe_ms
        covered = probe_lib.fused_ir_chw_probe_geometry(k, 0)
        needed = (th + 2 * (k // 2)) * (tw + 2 * (k // 2))
        busy = sum(cyc[:4])
        print(f"  {name}.conv{i + 1} ({cin}, {hh}, {ww}) k{k}: {ms:.4f} ms (probe build "
              f"{probe_ms:.4f}); " + ", ".join(
                  f"{p} {c / busy:.1%}" for p, c in zip(PHASES, cyc)) +
              f"; x waits {cyc[4] / busy:.1%}; expand covers {covered} pixels a tile for "
              f"{th * tw} outputs ({covered / (th * tw):.2f}x), the conv reads {needed}",
              flush=True)
    busy = sum(total[p] for p in PHASES)
    shares = {p: total[p] / busy for p in PHASES + ("x waits",)}
    print(f"over the 22 launches: {ms_sum:.4f} ms (probe build {probe_ms_sum:.4f}); " +
          ", ".join(f"{p} {s:.1%}" for p, s in shares.items()))
    print(json.dumps({"ms": ms_sum, "probe_ms": probe_ms_sum, "cycles": total,
                      "shares": shares}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
