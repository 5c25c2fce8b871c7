#!/usr/bin/env python3
"""Time kernel 5 (``depthwise_conv2d(force="cuda")``) of one checkout of
the repo against ``F.conv2d(groups=C)``, on a CUDA card.

    python3 tools/time_depthwise.py [--root DIR]

``--root`` (default: this checkout) is the root of the checkout whose
``deadtrees_tpu_torch`` is imported, so that two commits can be timed in
one session with the same method: unpack the other commit with
``git archive`` into a directory that ``.gitignore`` lists, and run this
script once for each root, in turns (A, B, B, A). The shapes are the b5
encoder's 35 stride-1 depthwise convs at bs 16, 512², bf16 (traced on the
meta device with that checkout's model). Each is timed as
``chip_smoke.py`` (of this checkout) times it: CUDA events, median of 21,
a spin before each call; also with the L2 cache emptied before each
repetition; and the host time of one call (the wrapper's Python and the
launch, the card kept busy). The last line is one JSON object of the sums.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def encoder_dw_shapes(batch: int = 16, img: int = 512):
    """{(B, H, W, C, k): count} of the b5 encoder's stride-1 depthwise convs."""
    import torch

    from deadtrees_tpu_torch.models import create_model

    with torch.device("meta"):
        model = create_model(architecture="efficientunet++",
                             encoder_name="timm-efficientnet-b5", in_channels=4, classes=3,
                             decoder_channels=[256, 128, 64, 32, 16])
    seen = []
    for blk in model.encoder.modules():
        if hasattr(blk, "conv_dw") and blk.conv_dw.stride[0] == 1:
            blk.conv_dw.register_forward_hook(lambda mod, inp, out: seen.append(
                (batch, *inp[0].shape[2:], inp[0].shape[1], mod.kernel_size[0])))
    with torch.no_grad():
        model.encoder(torch.zeros((1, 4, img, img), device="meta"))
    shapes = {}
    for key in seen:
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=REPO)
    args = parser.parse_args()
    root = args.root.resolve()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_depthwise: needs a CUDA card", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    sys.path.insert(0, str(root))
    from deadtrees_tpu_torch.ops import depthwise as dwm

    if not Path(dwm.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {dwm.__file__}, not the checkout at {root}")
    label = root.name
    print(f"{label}: {dwm.__file__} on {cs.card_line()}", flush=True)
    gen = torch.Generator().manual_seed(cs.SEED)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    tot = dict.fromkeys(("ms", "cold_ms", "host_ms", "library_ms", "library_cold_ms",
                         "library_host_ms"), 0.0)
    shapes = encoder_dw_shapes()
    for (bsz, hh, ww, c, k), n in sorted(shapes.items(), key=lambda kv: -kv[0][1]):
        x = torch.randn((bsz, hh, ww, c), generator=gen).cuda().to(torch.bfloat16)
        kern = (torch.randn((k, k, 1, c), generator=gen) * 0.2).cuda()
        w_lib = kern.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
        x_lib = x.permute(0, 3, 1, 2)
        got = dwm.depthwise_conv2d(x, kern, force="cuda")
        ref = F.conv2d(x_lib, w_lib, padding=k // 2, groups=c).permute(0, 2, 3, 1)
        err = float((got.float() - ref.float()).abs().max())
        if not err <= 3e-2 * max(1.0, float(ref.float().abs().max())):
            raise RuntimeError(f"({bsz}, {hh}, {ww}, {c}) k{k}: kernel and library differ "
                               f"by {err}")
        kernel = lambda: dwm.depthwise_conv2d(x, kern, force="cuda")  # noqa: E731
        library = lambda: F.conv2d(x_lib, w_lib, padding=k // 2, groups=c)  # noqa: E731
        row = {"ms": cs.cuda_time_ms(kernel), "cold_ms": cs.cuda_time_ms(kernel, flush=flush),
               "host_ms": cs.host_ms_per_call(kernel), "library_ms": cs.cuda_time_ms(library),
               "library_cold_ms": cs.cuda_time_ms(library, flush=flush),
               "library_host_ms": cs.host_ms_per_call(library)}
        for key, val in row.items():
            tot[key] += val * n
        print(f"  ({bsz}, {hh}, {ww}, {c}) k{k} x{n}: " +
              ", ".join(f"{key} {val:.4f}" for key, val in row.items()), flush=True)
    print(f"{label}, the {sum(shapes.values())} convs: " +
          ", ".join(f"{key} {val:.4f}" for key, val in tot.items()))
    print(json.dumps({"label": label, "convs": sum(shapes.values()), **tot}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
