#!/usr/bin/env python3
"""Time the train loop's side of a checkpoint save on a CUDA card.

    python3 tools/time_snapshot.py [--reps N]

The EfficientUNet++/b5 flagship (random weights from seed 0) and its
Adam state after one step, as ``Trainer`` saves them: the flax-layout
trees of the parameters, BatchNorm statistics and optimizer state on the
card (``tensor_variables_from_state_dict``, ``optimizer_state_dict``),
then ``core.snapshot``, the host copy that the asynchronous writer takes
on the loop's thread. Beside it, two ways to move the same bytes in one
copy: one concatenation on the card and ``.cpu()`` into pageable memory,
and the concatenation copied into a pinned buffer (allocated per
repetition; PyTorch caches freed pinned blocks). Host clock, each part
after a ``torch.cuda.synchronize()``; the first repetition includes the
host allocator's first touch. The last line is one JSON object of the
medians. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_snapshot: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from deadtrees_tpu_torch.core import snapshot
    from deadtrees_tpu_torch.models import (
        create_model,
        init_model,
        tensor_variables_from_state_dict,
    )
    from deadtrees_tpu_torch.train.optim import Optimizer, OptimizerConfig, optimizer_state_dict

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    hp = dict(architecture="efficientunet++", encoder_name="timm-efficientnet-b5",
              decoder_channels=[256, 128, 64, 32, 16], in_channels=4, classes=3)
    model = init_model(create_model(**hp, dtype=torch.bfloat16),
                       generator=torch.Generator().manual_seed(0)).cuda()
    opt = Optimizer(list(model.parameters()), OptimizerConfig())
    opt.load_grads([torch.randn_like(p) * 1e-3 for p in model.parameters()])
    opt.step()
    torch.cuda.synchronize()

    def leaves(tree, out):
        for v in tree.values():
            leaves(v, out) if isinstance(v, dict) else out.append(v)
        return out

    times = {"trees": [], "snapshot": [], "cat_cpu": [], "cat_pinned": []}
    for rep in range(args.reps):
        t0 = time.perf_counter()
        trees = (tensor_variables_from_state_dict(model.state_dict(),
                                                  encoder_name=hp["encoder_name"]),
                 optimizer_state_dict(opt, model))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        snap = [snapshot(t) for t in trees]
        t2 = time.perf_counter()
        tensors = [x for t in trees for x in leaves(t, []) if isinstance(x, torch.Tensor)]
        flat = torch.cat([x.reshape(-1) for x in tensors]).cpu()
        t3 = time.perf_counter()
        pinned = torch.empty(flat.numel(), dtype=flat.dtype, pin_memory=True)
        pinned.copy_(torch.cat([x.reshape(-1) for x in tensors]))
        t4 = time.perf_counter()
        for key, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            times[key].append(dt)
        print(f"rep {rep}: trees on the card {t1 - t0:.4f} s, snapshot of {len(tensors)} "
              f"leaves {t2 - t1:.4f} s, one cat + .cpu() {t3 - t2:.4f} s, one cat into "
              f"pinned memory {t4 - t3:.4f} s ({flat.numel() * flat.element_size()} bytes)",
              flush=True)
        del trees, snap, flat, pinned
    print(card)
    print(json.dumps({"card": card, "leaves": len(tensors),
                      **{f"{k}_s": statistics.median(v) for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
