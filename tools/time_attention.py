#!/usr/bin/env python3
"""Time the fused attention backends at the MiT-B5 U-Net's shapes, on a
CUDA card.

    python3 tools/time_attention.py [--batch 8] [--tile 1024]

At each of the four stages' attention shapes (queries of the stage's token
map against its spatially reduced keys, head size 64, bf16), one forward
and backward of ``F.scaled_dot_product_attention`` pinned to each fused
backend (``flash``, ``cudnn``) and of the port's plain path
(``models/segformer.py`` ``plain_attention``, skipped where its logits
would not fit), timed as ``chip_smoke.py`` times a kernel: CUDA events,
median of 21, a spin before each call. Also each backend's largest error
against the plain path, forward and gradients, relative to max(1, max|plain|),
and the step's attention bound (``port_bench/harness/attention.py``). The
last line is one JSON object. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stage_shapes(config, traffic):
    """(B, heads, N, M, d) of each stage of the configuration."""
    from port_bench.harness import attention

    enc = config["encoder"]
    seen, out = set(), []
    for (b, n, m, c), heads in zip(attention.blocks(config, traffic),
                                   [h for h, depth in zip(enc["num_heads"], enc["depths"])
                                    for _ in range(depth)]):
        if (n, m, c) not in seen:
            seen.add((n, m, c))
            out.append((b, heads, n, m, c // heads))
    return out


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from deadtrees_tpu_torch.models.segformer import plain_attention
    from port_bench.harness import attention

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--tile", type=int, default=1024)
    args = p.parse_args(argv)
    cs = _chip_smoke()
    config = json.loads((REPO / "port_bench/configs/unet-mit-b5.json").read_text())
    traffic = {"tile": args.tile, "batch_size": args.batch}
    backends = {"flash": SDPBackend.FLASH_ATTENTION, "cudnn": SDPBackend.CUDNN_ATTENTION}
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": cs.card_line(), "torch": torch.__version__, "cuda": torch.version.cuda,
              "cudnn": torch.backends.cudnn.version(), "stages": []}
    for b, h, n, m, d in stage_shapes(config, traffic):
        q = torch.randn(b, h, n, d, device="cuda", generator=g).bfloat16().requires_grad_()
        k = torch.randn(b, h, m, d, device="cuda", generator=g).bfloat16().requires_grad_()
        v = torch.randn(b, h, m, d, device="cuda", generator=g).bfloat16().requires_grad_()
        do = torch.randn(b, h, n, d, device="cuda", generator=g).bfloat16()

        def fwd_bwd(fn):
            def call():
                out = fn(q, k, v)
                return (out,) + torch.autograd.grad(out, (q, k, v), do)
            return call

        def pinned(backend):
            def fn(a, bb, c):
                with sdpa_kernel(backend):
                    return F.scaled_dot_product_attention(a, bb, c)
            return fn

        row = {"shape": [b, h, n, m, d], "bound_ms": 1e3 * max(
            attention.flops(b, n, m, h * d) / 989e12, attention.nbytes(b, n, m, h * d) / 3.35e12)}
        plain = None
        if b * h * n * m * 4 * 3 < 24e9:
            plain = [t.float() for t in fwd_bwd(plain_attention)()]
            row["plain_ms"] = cs.cuda_time_ms(fwd_bwd(plain_attention))
        for name, backend in backends.items():
            try:
                row[f"{name}_ms"] = cs.cuda_time_ms(fwd_bwd(pinned(backend)))
            except RuntimeError as e:
                row[f"{name}_error"] = str(e).splitlines()[0][:200]
                continue
            if plain is not None:
                got = fwd_bwd(pinned(backend))()
                row[f"{name}_err"] = [float((a.float() - r).abs().max() / max(1.0, float(r.abs().max())))
                                      for a, r in zip(got, plain)]
        result["stages"].append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, do, plain
        torch.cuda.empty_cache()
    depths = config["encoder"]["depths"]
    for name in list(backends) + ["plain"]:
        per = [r.get(f"{name}_ms") for r in result["stages"]]
        if all(t is not None for t in per):
            result[f"{name}_step_ms"] = sum(t * dd for t, dd in zip(per, depths))
    result["step_bound_ms"] = 1e3 * attention.step_bound_s(config, traffic)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
