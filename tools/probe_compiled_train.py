#!/usr/bin/env python3
"""Cold and warm compiles of the b5 flagship's programs, and the compiled
train step beside the eager one, on a CUDA card.

    python3 tools/probe_compiled_train.py

1. The ``"chw"`` engine at bs 4, compiled cold with the inductor options
   ``triton.cudagraphs=true,triton.autotune_pointwise=false``: the first
   call's seconds, the replay's host-clock time (median of 20), and the
   same engine built anew after ``torch._dynamo.reset()`` (a warm compile
   from inductor's cache), its class maps against the first.
2. The train step (``train/steps.py``) of the flagship at bs 16, 512²,
   bf16, GDICE + FOCAL + BOUNDARY, with the default options asked for
   (``DEADTREES_COMPILE_OPTS=triton.cudagraphs=true``: on CUDA the train
   step compiles only when the variable is set): 5 compiled
   steps (the first compiles the forward with its backward and the
   update program; seconds of each), 3 eager steps
   (``disable_compile()``), the peak memory, and a fresh model's first
   step after ``torch._dynamo.reset()`` (warm compiles).

The inductor cache is the checkout's ``build/torch_compile``: cold when
that directory is fresh, as on a chip call. Every line carries the
seconds since the start. Imports nothing of JAX.
"""

import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deadtrees_tpu_torch.core import compile_opts  # noqa: E402
from deadtrees_tpu_torch.core.compile_opts import disable_compile, graphs_compiled  # noqa: E402
from deadtrees_tpu_torch.infer import TorchInference  # noqa: E402
from deadtrees_tpu_torch.ops import _build  # noqa: E402

T0 = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - T0:7.1f}]", *a, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_compiled_train: this script runs on a CUDA card", file=sys.stderr)
        return 1
    log("card", cs.card_line())
    _build.build_all()
    ck = REPO / "build" / "probe" / "flag.ckpt"
    ck.parent.mkdir(parents=True, exist_ok=True)
    hp, model = cs.build_flagship(ck)
    del model
    rng = np.random.default_rng(0)
    x4 = rng.integers(0, 256, (4, 512, 512, 4), dtype=np.uint8)
    os.environ[compile_opts.ENV] = "triton.cudagraphs=true,triton.autotune_pointwise=false"
    e = TorchInference(ck, fused_decoder="chw")
    t = time.perf_counter()
    a = e.run(x4)
    log("chw bs4 cold (autotune_pointwise off)", time.perf_counter() - t)
    img = torch.from_numpy(x4).cuda()
    for _ in range(3):
        e.predict(img)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        e.predict(img)
    torch.cuda.synchronize()
    log("replay ms", (time.perf_counter() - t) / 20 * 1e3)
    torch._dynamo.reset()
    e2 = TorchInference(ck, fused_decoder="chw")
    t = time.perf_counter()
    b = e2.run(x4)
    log("chw bs4 warm (new engine, dynamo reset)", time.perf_counter() - t, (a == b).mean())
    from torch._dynamo.utils import counters

    log("inductor counters", {k: v for k, v in counters["inductor"].items() if "cache" in k})
    del e, e2
    torch.compiler.reset()
    torch.cuda.empty_cache()
    # the train step's programs compile on CUDA only when asked for
    os.environ[compile_opts.ENV] = "triton.cudagraphs=true"
    from deadtrees_tpu_torch.losses import batch_one_hot2dist, class2one_hot
    from deadtrees_tpu_torch.models import create_model, init_model
    from deadtrees_tpu_torch.train import (
        Optimizer,
        OptimizerConfig,
        TrainState,
        build_loss,
        make_train_step,
    )

    def build():
        m = init_model(create_model(**hp), generator=torch.Generator().manual_seed(0)).cuda()
        opt = Optimizer(m.parameters(), OptimizerConfig())
        step = make_train_step(m, build_loss(["GDICE", "FOCAL", "BOUNDARY"], 3), num_classes=3)
        return m, opt, step

    m, opt, step = build()
    st = TrainState(m, opt)
    mask = torch.from_numpy(rng.integers(0, 3, (16, 512, 512))).cuda()
    batch = {"image": torch.randn(16, 4, 512, 512, device="cuda"), "mask": mask,
             "distmap": batch_one_hot2dist(class2one_hot(mask, 3))}
    for i in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, met = step(st, batch, 0, frozen=False)
        torch.cuda.synchronize()
        log("step", i, f"{time.perf_counter() - t:.3f}s", float(met["total_loss"]),
            [p.compiles for p in step.programs])
    log("peak GiB", torch.cuda.max_memory_allocated() / 2**30)
    with disable_compile():
        for i in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, met = step(st, batch, 0, frozen=False)
            torch.cuda.synchronize()
            log("eager step", i, f"{time.perf_counter() - t:.3f}s", float(met["total_loss"]))
    del m, opt, step, st
    torch._dynamo.reset()
    torch.cuda.empty_cache()
    m, opt, step = build()
    st = TrainState(m, opt)
    torch.cuda.synchronize()
    t = time.perf_counter()
    st, met = step(st, batch, 0, frozen=False)
    torch.cuda.synchronize()
    log("train warm first step", time.perf_counter() - t, [p.compiles for p in step.programs])
    log("inductor counters", {k: v for k, v in counters["inductor"].items() if "cache" in k})
    log("graphs", graphs_compiled())
    return 0


if __name__ == "__main__":
    sys.exit(main())
