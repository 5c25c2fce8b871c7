#!/usr/bin/env python3
"""Time kernel 1's pass 2 and the NHWC pass 1 (kernels 2 and 3) of one
checkout of the repo, on a CUDA card.

    python3 tools/time_passes.py [--root DIR]

``--root`` (default: this checkout) is the root of the checkout whose
``deadtrees_tpu_torch`` is imported, so that two commits can be timed in
one session with the same method: unpack the other commit with
``git archive`` into a directory that ``.gitignore`` lists, and run this
script once for each root, in turns (A, B, B, A). The shapes are those of
the EfficientUNet++/b5 flagship at 512², bs 4, bf16, random weights from
seed 0 (that checkout's model and fold): ``chw_pass2`` at the 22 decoder
blocks, ``nhwc_pass1`` at the 14 fat blocks with h in bf16 (kernel 2) and
in float32 (kernel 3). Each launch is timed as ``chip_smoke.py`` (of this
checkout) times it: CUDA events, median of 21, a spin before each call;
each kernel's largest error against its plain version is printed beside
its time. The last line is one JSON object of the sums. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BATCH = 4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=REPO)
    args = parser.parse_args()
    root = args.root.resolve()

    import torch

    if not torch.cuda.is_available():
        print("time_passes: needs a CUDA card", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    sys.path.insert(0, str(root))
    from deadtrees_tpu_torch.models import create_model, init_model
    from deadtrees_tpu_torch.ops import fused_cell as fc
    from deadtrees_tpu_torch.ops import fused_mbconv as fm
    from deadtrees_tpu_torch.ops.fused_decoder import takes_fat_kernel

    if not Path(fm.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {fm.__file__}, not the checkout at {root}")
    label = root.name
    print(f"{label}: {fm.__file__} on {cs.card_line()}", flush=True)
    hp = dict(architecture="efficientunet++", encoder_name="timm-efficientnet-b5",
              in_channels=4, classes=3, decoder_channels=[256, 128, 64, 32, 16])
    model = init_model(create_model(**hp), generator=torch.Generator().manual_seed(cs.SEED))
    model = model.cuda().eval()
    gen = torch.Generator().manual_seed(cs.SEED + 4)
    tot = dict.fromkeys(("chw_pass2_ms", "fat_pass1_ms", "k3_pass1_ms"), 0.0)
    err = dict.fromkeys(("chw_pass2", "fat_pass1", "k3_pass1"), 0.0)
    fat = 0
    for name, i, shape, fp in cs.flagship_block_shapes(model, BATCH):
        x = torch.randn(shape, generator=gen).cuda().to(torch.bfloat16)
        skip = "conv" if fp.wsk is not None else "identity"
        h, psum = fm.chw_pass1(x, fp)
        gate = fm.cse_gate(psum.sum(1), fp, shape[2] * shape[3])
        ms = cs.cuda_time_ms(lambda: fm.chw_pass2(h, x, gate, fp, skip=skip))
        ref = fm.chw_pass2_reference(h, x, gate, fp, skip=skip)
        err["chw_pass2"] = max(err["chw_pass2"],
                               cs.max_err(fm.chw_pass2(h, x, gate, fp, skip=skip), ref))
        tot["chw_pass2_ms"] += ms
        line = f"  {name}.conv{i + 1} {tuple(shape[1:])}: chw pass 2 {ms:.4f}"
        xn = x.permute(0, 2, 3, 1).contiguous()
        if takes_fat_kernel(xn, fp):
            fat += 1
            for key, h_dtype in (("fat_pass1", torch.bfloat16), ("k3_pass1", torch.float32)):
                ms = cs.cuda_time_ms(lambda: fc.nhwc_pass1(xn, fp, h_dtype=h_dtype))
                got, _ = fc.nhwc_pass1(xn, fp, h_dtype=h_dtype)
                ref, _ = fc.nhwc_pass1_reference(xn, fp, h_dtype=h_dtype)
                err[key] = max(err[key], cs.max_err(got, ref))
                tot[f"{key}_ms"] += ms
                line += f", {key.replace('_', ' ')} {ms:.4f}"
        print(line, flush=True)
    if fat != cs.FAT_BLOCKS:
        raise RuntimeError(f"{fat} fat blocks, expected {cs.FAT_BLOCKS}")
    print(f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()) +
          "; max err " + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))
    print(json.dumps({"label": label, **tot, "max_abs_err": err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
