#!/usr/bin/env python3
"""Time kernel 1's pass 2 and both NHWC passes (kernels 2 and 3) of one
checkout of the repo, on a CUDA card.

    python3 tools/time_passes.py [--root DIR] [--k3-act-precise]

``--root`` (default: this checkout) is the root of the checkout whose
``deadtrees_tpu_torch`` is imported, so that two commits can be timed in
one session with the same method: unpack the other commit with
``git archive`` into a directory that ``.gitignore`` lists, and run this
script once for each root, in turns (A, B, B, A). The shapes are those of
the EfficientUNet++/b5 flagship at 512², bs 4, bf16, random weights from
seed 0 (that checkout's model and fold): ``chw_pass2`` at the 22 decoder
blocks, ``nhwc_pass1`` and ``nhwc_pass2`` at the 14 fat blocks with h in
bf16 (kernel 2) and in float32 (kernel 3; pass 2 reads the h that pass 1
wrote). Each launch is timed as ``chip_smoke.py`` (of this checkout) times
it: CUDA events, median of 21, a spin before each call; each kernel's
largest error against its plain version is printed beside its time, and
for kernel 3's float32 h also relative to max(1, max|h|) of each launch
(the measure of the card test's ``K3_H_BAR``).

``--k3-act-precise`` adds kernel 3's pass 1 from a second build of that
checkout's ``fused_ir_nhwc.cu`` with ``-DDT_NHWC_F32H_ACT_PRECISE`` (the
precise activations for float32 h; a checkout that does not know the
macro builds its plain kernel), and for both builds of kernel 3's pass 1
the largest error against the plain version run with W1 replaced by its
two-term bf16 hi + lo split: what is left there is not that split's. The
last line is one JSON object of the sums. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BATCH = 4
ACT_PRECISE = "DT_NHWC_F32H_ACT_PRECISE"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=REPO)
    parser.add_argument("--k3-act-precise", action="store_true",
                        help="also kernel 3's pass 1 built with -DDT_NHWC_F32H_ACT_PRECISE")
    args = parser.parse_args()
    root = args.root.resolve()

    import torch

    if not torch.cuda.is_available():
        print("time_passes: needs a CUDA card", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    sys.path.insert(0, str(root))
    from deadtrees_tpu_torch.models import create_model, init_model
    from deadtrees_tpu_torch.ops import _build
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
    keys = ["chw_pass2", "fat_pass1", "fat_pass2", "k3_pass1", "k3_pass2"]
    nhwc_lib = fc._kernels()
    k3_libs = {"k3_pass1": nhwc_lib}  # kernel 3's pass 1 by build
    if args.k3_act_precise:
        key = f"k3_pass1 -D{ACT_PRECISE}"
        keys.append(key)
        k3_libs[key] = fc.bind_kernels(_build.load("fused_ir_nhwc", (ACT_PRECISE,)))
    tot = {f"{k}_ms": 0.0 for k in keys}
    err = dict.fromkeys(keys, 0.0)
    rel = dict.fromkeys(k3_libs, 0.0)  # kernel 3's h: error / max(1, max|h|)
    err_split = {k: 0.0 for k in k3_libs} if args.k3_act_precise else {}
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
            for k, h_dtype in (("fat", torch.bfloat16), ("k3", torch.float32)):
                ref, _ = fc.nhwc_pass1_reference(xn, fp, h_dtype=h_dtype)
                for key, lib in ({"fat_pass1": nhwc_lib} if k == "fat" else k3_libs).items():
                    fc._lib = lib
                    ms = cs.cuda_time_ms(lambda: fc.nhwc_pass1(xn, fp, h_dtype=h_dtype))
                    got, _ = fc.nhwc_pass1(xn, fp, h_dtype=h_dtype)
                    err[key] = max(err[key], cs.max_err(got, ref))
                    if key in rel:
                        rel[key] = max(rel[key], cs.max_err(got, ref) /
                                       max(1.0, float(ref.abs().max())))
                    if key in err_split:
                        hi, lo = fm.split_w1(fp.w1)
                        ref_split, _ = fc.nhwc_pass1_reference(
                            xn, fp._replace(w1=hi.float() + lo.float()), h_dtype=h_dtype)
                        err_split[key] = max(err_split[key], cs.max_err(got, ref_split))
                    tot[f"{key}_ms"] += ms
                    line += f", {key.replace('_', ' ', 1)} {ms:.4f}"
                fc._lib = nhwc_lib
                h, psum = fc.nhwc_pass1(xn, fp, h_dtype=h_dtype)
                gate = fm.cse_gate(psum.sum(1), fp, shape[2] * shape[3])
                key = f"{k}_pass2"
                ms = cs.cuda_time_ms(lambda: fc.nhwc_pass2(h, xn, gate, fp, skip=skip))
                ref = fc.nhwc_pass2_reference(h, xn, gate, fp, skip=skip)
                err[key] = max(err[key], cs.max_err(fc.nhwc_pass2(h, xn, gate, fp, skip=skip),
                                                    ref))
                tot[f"{key}_ms"] += ms
                line += f", {key.replace('_', ' ', 1)} {ms:.4f}"
        print(line, flush=True)
    if fat != cs.FAT_BLOCKS:
        raise RuntimeError(f"{fat} fat blocks, expected {cs.FAT_BLOCKS}")
    print(f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()) +
          "; max err " + ", ".join(f"{k} {v:.3e}" for k, v in err.items()) +
          "; relative " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) +
          "".join(f"; {k} against the hi + lo W1 {v:.3e}" for k, v in err_split.items()))
    print(json.dumps({"label": label, **tot, "max_abs_err": err, "max_rel_err": rel,
                      "max_abs_err_vs_split_w1": err_split}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
