#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. Device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit; builds the kernels from ``deadtrees_tpu_torch/ops/csrc``.
2. Kernel vs plain: ``fused_inverted_residual_chw`` and its two passes on
   the card against their plain PyTorch versions on the same CUDA tensors,
   at all 22 decoder-block shapes of the flagship at 512² (bs 4, float32
   and bfloat16) and at 256² and 1024² (bs 1, bfloat16), a ragged shape
   and the generalized modes. The EDT's two kernels (``ops/edt.py``) at
   the training batch's distance maps (16 × 3 × 512²) bit-equal to their
   plain version, one launch each, with their time, their host time a
   call, the plain version's time and their bounds.
3. The slice at full width: the EfficientUnet++/b5 flagship from a seeded
   generator, saved with the port's ``save_checkpoint`` and served through
   ``TorchInference(fused_decoder="auto")`` at bs 1, 4, 32 (fused) and 64
   (plain), against the plain model.
4. The server (the main path whose kernel launches are counted): 8
   concurrent PNG requests to ``serve_stdlib`` with batching on.
5. Timings: fused vs plain latency, and each kernel's time per launch at
   the flagship shapes beside its plain version, its float32 bound and its
   tensor-core bound (the 1x1 products at the bf16 tensor rate), with the
   share of each bound. Both bf16 passes run their products on the tensor
   cores, so their bound is the tensor-core one.
6. Profile: device time by kernel group and the device's idle share for
   both engines at bs 4 and 32 (torch.profiler).
7. The augment kernel (fused colour jitter + normalize) against its plain
   version at the flagship training batch (16, 512², RGBN), at bs 1 on
   256² and 1024², a ragged 40×72 tile and RGB; its time beside its bound;
   the exact EDT on the card against scipy on 512² masks.
8. Training (the second main path, whose augment launches are counted):
   ``Trainer.fit()`` of the b5 flagship at bs 16, 512², bf16 over tar
   shards written with the port's ``ShardWriter``, 2 epochs with the
   MultiStage freeze in the first; the best checkpoint served by
   ``TorchInference``; 8 steps on one repeated batch lower the loss; a NaN
   batch leaves the state alone; step time, memory, EDT time and a
   torch.profiler breakdown of one train step.
9. NHWC kernels vs plain (run after phase 6): the NHWC pair as
   ``fused_ir_fat`` at the 14 fat decoder blocks of the flagship at 512²
   (bs 4, float32 and bfloat16), at the fat blocks of 256² and 1024²
   (bs 1, bfloat16), on a ragged 40×72 tile, with C_in % 8 != 0 (the
   plain-load staging of the bf16 pass 1) and in silu / k5 / identity /
   none modes; as ``fused_inverted_residual`` (h in float32) at the 14
   shapes. For bf16 x the tensor-core pass 2 runs alone in both stagings
   (TMA, and plain loads from a copy of h one element into its storage:
   the same bits) within one bf16 ulp of its plain version, and kernel
   3's float32 h within ``K3_H_BAR``; ``depthwise_conv2d(force="cuda")``
   at k 3 and 5, float32 and
   bfloat16, stride 1 and 2, ragged, at the b5 encoder's channel classes
   and on a misaligned view (the plain-load staging).
10. The rest of single-model serving (the third main path, whose NHWC
   launches are counted): ``TorchInference(fused_decoder="nhwc")`` at bs
   1, 4, 32 and 128 against the plain engine, 14 launches of each NHWC
   pass a forward; float32 ``fused_forward(layout="nhwc")`` against the
   model's logits; the w8 and w8a8 engines at bs 4 and 32 against the
   unquantized engine (no fat-cell launch under w8a8); ``tta=8`` at bs 4
   equivariant under rot90 and flips.
11. NHWC timings: latency of the nhwc, chw and plain routes at bs 1, 4,
   32 and 128; the NHWC pair and kernel 3 per launch at the 14 fat shapes
   (bf16, bs 4; both passes against their tensor-core bound) and the
   depthwise kernel at the b5 encoder's stride-1
   depthwise shapes (bs 16, 512², bf16) beside their bounds, plain
   versions and, for the depthwise kernel, ``F.conv2d(groups=C)``, both
   also with the L2 cache emptied before each repetition, each shape's
   share of its bound and the host time of one call of each; device time
   by group and idle share of the nhwc route at bs 32 and 128.
12. Scenes (the fourth main path, run after phase 11; no kernel of the
   port lies on it): ``predict_scene`` on a ragged 1500×2030 scene in a
   2048² tile (bs 128) equal to the plain model's argmax over the same
   128-subtile chunk, its padding subtiles zero, and agreeing with
   ``TorchInference.run`` at bs 16; ``predict_scenes`` on 17 scenes of
   2048² (groups of 8, 8 and a padded 1) equal to per-scene calls; its
   throughput on 16 scenes beside the plain bs-128 rate of phase 11, the
   device's idle share (torch.profiler) and the time split of one
   dispatch; ``EnsembleInference`` (3 × the flagship equal to one member,
   a heterogeneous trio equal to the flagship, an even N raises); the
   scene CLI end to end in a process of its own (retile a 4096²
   GeoTIFF, an empty tile skipped, outputs equal to ``predict_scenes``
   with their tags, the mosaic's bounds; one 3-checkpoint run of the
   CLI's ``main`` in this process). A
   ``scenes`` line with these numbers and the card comes before the
   kernels line.
13. The recipe (the fifth main path, run after phase 8, whose augment
   launches are counted in run B): ``configs/`` composed with
   ``experiment=flagship_b5_multistage``, cut to 4 epochs of 4 train and
   2 val batches over 64 + 32 + 32 tiles of 512² (MultiStage unfreeze at
   1, lr/3 at 2, SWA from 2). Run A, ``python -m deadtrees_tpu_torch
   train`` in a process of its own, gets SIGTERM once epoch 0's
   ``last.ckpt`` exists and must stop with ``preempted``, exit 0 and leave
   ``last.ckpt`` at epoch 0 with its Adam state. Run B resumes from it in
   this process (parameters, BN statistics, ``mu``, ``nu`` and ``count``
   bit-equal to the file on load), runs epochs 1-3, SWA with its BN
   recalibration, and the test after training on the best checkpoint;
   kernel 4 launches once a train step and once a recalibration batch, the
   EDT's two kernels once each a batch that gets distance maps (train,
   val, recalibration and test batches, counted at the data module);
   ``swa.ckpt`` and the best checkpoint serve through ``TorchInference``.
   Run C, ``python -m deadtrees_tpu_torch eval`` on the best checkpoint
   with ``tta=8`` and without, prints the whole ``test/*`` set over the
   same pixel count. A ``recipe`` line with the epochs' times, the
   checkpoint save as the loop sees it (asynchronous and synchronous),
   the file size, SIGTERM to exit, the resume load, the recalibration,
   ``test()``'s tiles/s with and without ``tta=8`` and the phase's wall
   time comes before the kernels line.
14. The training data path (run after phase 13; phases 8 and 13 read
   their shards through the native reader too). Decode alone on the
   card's host: 8 shards of 64 tiles of 512² (RGBN, mask, lu),
   uncompressed by PIL and re-encoded as deflate with predictor 2, read by
   ``make_sample_stream`` through PIL (over 4 of the shards) and natively
   on 4 threads (the recipe's ``num_workers``) and on every core,
   ``decode_batch`` of one shard's 64 RGBN tiles, the native stream equal
   to the PIL stream. The train loop's data rate: ``train_batches`` of
   the recipe's datamodule (bs 16: decode, pinned upload, kernel 4, EDT)
   with the reader on and off in turns, and a fit of 8 steps with each,
   beside phase 8's step alone; which part sets the epoch's pace. The multi-dataset config
   (``train datamodule=deadtrees_multi_datasets``, b5 at 512², bs 32 =
   15 + 2 + 15, cut to bs 16 = 7 + 1 + 7 only if bs 32 runs out of
   memory) for 3 steps and a val batch: every batch's parts in order,
   kernel 4 once a train batch, the peak memory. ``pipe:cat`` shards with
   ``cache_dir`` for 2 epochs equal to the local shards' batches, one
   shard over http from a localhost server. No shard falls back to PIL
   in phases 8, 13 and 14. A ``data`` line with these numbers comes
   before the kernels line.

15. The compiled programs (run last). On CUDA the serving programs and
   the augment compile by default (``core/compile_opts.py``):
   TorchInductor, replayed as a CUDA graph, the kernels as opaque custom
   ops. The programs whose compiled form this phase does not hold against
   the eager one run eagerly on CUDA unless ``DEADTREES_COMPILE_OPTS`` is
   set (``by_default=False``): the train step's two programs, the eval
   and predict steps, SWA's BatchNorm pass, w8a8, TTA and the ensemble
   vote (a cold compile of the b5's train step outlasts this script's
   limit; w8a8, TTA and the vote are checked compiled on the CPU only,
   ``tests/test_torch_compiled_*.py``). A cold compile of the b5 takes
   minutes a program on the card (``PERF.md`` §6), so phases 2-14 run
   under ``disable_compile()`` (every check as before, on the eager path,
   which the kernel timings and the exact launch counts need). For phases
   8 and 13 that changes one program only: their train, eval and SWA
   programs run eagerly by default, and the augment, the one program on
   their path that compiles by default, is held bit-equal to the eager
   call here (eager, kernel 4's launches stay one a batch: a replay runs
   no wrapper). Two ``--warm`` processes, started right after the build,
   compile phase 15's programs cold while phases 2-13 run (lane a: the
   ``"chw"`` engine at bs 4, the augment program and the scene chunk;
   lane b: ``"nhwc"`` and plain at bs 4); the main process joins them
   before phase 14 and compiles the same graphs warm in phase 15. Phase
   15 drives the default entry points at bs 4 (cut from 1, 4, 32 and 128:
   each batch size is a cold compile): ``TorchInference`` ``"chw"``,
   ``"auto"``, ``"nhwc"``, plain and w8 (the last two share a graph, as
   ``"auto"`` and ``"chw"`` do at bs ≤ 32): each route's first call and
   compile seconds, class maps against the same route run eagerly
   (≥ 0.99), latency and tiles/s in turns (compiled, eager, eager,
   compiled), device time by group and the idle share (torch.profiler, 3
   runs), peak memory, and one replayed forward's trace: 22 + 22 kernel-1
   passes on chw, 14 + 14 NHWC passes on nhwc, no host-to-device copy, no
   custom op's Python (where the plain versions run), a CUDA-graph
   launch; 8 concurrent requests through ``serve_stdlib`` in groups of 4,
   answered by compiled programs; 16 scenes of 2048² through
   ``predict_scenes`` with chunks of 16 (cut from 128): equal to the same
   program run one scene at a time through ``predict_scene``, and against
   the eager predictor per 512² subtile (each ≥ 0.95, the mean ≥ 0.99);
   ``augment_batch`` at the training batch bit-equal to the eager call,
   kernel 4 once a replay (run first; the server last: it runs its
   programs in a thread of its own). A ``compiled`` line with the
   warmers' cold and phase 15's warm compile seconds, the numbers above,
   the phase's and the script's wall time and the card comes before the
   kernels line.
16. The serving artifacts (eager; no kernel on the path: the exported
   program is the plain model, as the JAX package's artifact is). Its
   exports run after phase 13, while phase 15's warmers finish, and its
   timings after phase 15. The flagship checkpoint exported with
   ``infer/export.py`` ``export_inference`` at 512² on the card, float
   and int8 (bytes and export seconds), and once on the CPU. Each is
   loaded with ``ExportedInference`` and serves bs 1 and bs 4 from the
   one artifact (the batch is dynamic): the float artifact against
   ``TorchInference`` on the plain route, the int8 one against
   ``TorchInference(quantized=True)``, the CPU-exported one, moved to the
   card, against the card's float artifact (class-map agreement ≥ 0.99
   each, and no kernel launched; int8 bytes < 0.6 × float bytes).
   ``run()`` at bs 4 of the float and int8 artifacts beside the plain
   engine, in turns, median of ``EXPORT_REPS``, and each one's profile
   (device busy, idle share, groups, kernel launches a run;
   torch.profiler, 3 runs). ``SegmentationService(None, exported=...)``
   answers 4 requests with the artifact's maps. An ``exported`` line with
   these numbers, the phase's wall time and the card comes before the
   kernels line.
17. The model zoo (eager, run after phase 16's exports while phase 15's
   warmers finish): at the repo's full width (decoder 256/128/64/32/16, 4
   bands, 3 classes, 512²) from ``init_model`` (seed 0), unet/resnet18
   (configs/model/unet.yaml), unet, unet++, resunet, resunet++ and
   efficientunet++ on resnet34 (the architecture grid's ResNet row),
   resunet++/timm-efficientnet-b5 (the grid's widest cross), unet/resnet50
   and segformer/mit-b0 (configs/model/segformer.yaml). Each takes 6 eager
   train steps at bs 16 on one repeated batch through the port's train
   step, the augment kernel once a step (the loss must fall, peak memory
   under 80 GB), has its BatchNorm statistics set to the batch's (one
   forward at momentum 1), is written as a JAX-format checkpoint, loaded by
   ``TorchInference`` on the service's route (``"auto"`` for
   efficientunet++, plain for the rest) and ``run()`` is timed at bs 4 and
   32 (host clock, median of 5); the class maps equal the loaded model's
   own argmax on the plain route (the fused route's agreement is reported).
   efficientunet++/resnet34: kernels 1 and 2 against their plain versions
   at every shape this model gives them, the float32 fused forward on both
   layouts against the plain model (phase 3's bar, ≥ 0.99 agreement), the
   bf16 routes' maps against the float32 model's (no further than the
   plain bf16 model's, less 0.005), and the launches a forward of each. unet/resnet34: the REST
   service answers 3 requests. resunet++/resnet34: exported, its
   artifact's maps against the plain engine's. One ``zoo`` JSON line a
   configuration comes before the kernels line.

18. Data parallelism (eager, in child processes: this process joins no
   group; run after phase 17, while phase 15's warmers finish, as phase
   17 does: its children peak at 2 × 19.25 GiB, beside the warmers'
   memory and before phase 14's 74 GiB batch). The flagship at full width. NCCL with one rank (a
   child): 8 bf16 train steps of phase 8's first batch (bs 16) under a
   one-rank NCCL group bit-equal to the same steps without a group, cuDNN
   deterministic (with one rank the port calls no collective: the steps
   are the same code); one NCCL all_reduce of the flat gradient buffer
   timed; the one-process float32 step on that batch's first 4 samples
   saved. Two gloo ranks on the card (``torch.distributed.run
   --standalone --nproc-per-node 2``): the float32 step of the two ranks
   (2 samples each) against the one-process step (loss and grad norm
   within 1e-4 relative; the clipped gradient no further than 2 × the
   one-process step's from a float64 step of the same model and batch; at
   most 0.1 % of the parameters an update of the other sign apart; the
   ranks equal); one gloo all_reduce
   of the flat gradient buffer timed; 16 noise scenes of 2048² through
   ``predict_scenes`` with a 2-rank ``make_scene_predictor(mesh=)`` at bs
   128 (64 a rank), agreeing ≥ 0.99 with phase 12's maps of the same
   scenes, and their tiles/s. The recipe's trainer through ``python -m
   torch.distributed.run ... -m deadtrees_tpu_torch train --backend gloo
   trainer.devices=2`` (global bs 16, 8 a rank, 8 shards of 32 noise
   tiles in phase 8's format: 4 a rank, 2 epochs of 4 steps, SWA from
   epoch 1): the
   ranks' parameters equal after every epoch (the trainer's own check),
   the loss falls, kernel 4 once a batch on each rank (8 steps + 10
   recalibration batches), one metrics file and the checkpoints (rank 0
   writes them), the val metrics equal on both ranks, each rank's peak
   memory. A ``parallel`` line with these numbers, the phase's seconds
   and the card comes before the kernels line. Two ranks share one card:
   the numbers measure the path, not a speed-up.

The last line is the device record; the line before it the card's name
and power limit, and before that one JSON object describing the kernels
(the contract's keys, plus ``tc_bound_ms`` and ``f32_bound_ms`` for every
row, and for the depthwise kernel the cold-L2 times ``cold_ms`` /
``library_cold_ms`` and the host time of a call ``host_ms`` /
``library_host_ms``). ``bound_ms`` takes the rates of the kernel's own
arithmetic: the tensor-core bound for both bf16 passes of kernel 1 and
for both bf16 NHWC passes (kernels 2 and 3), the float32 bound for the
others.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import http.server
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
IMG = 512
SEED = 0
# bars: error relative to max(1, max|ref|)
BAR = {"float32": 1e-3, "bfloat16": 2e-2}
FORWARD_F32_BAR = 5e-3
AGREE_BF16 = 0.99
# a compiled scene's 512² subtile against the eager one's: bf16 rounding flips
# near-ties over the whole map (their mean is held at AGREE_BF16), so no
# subtile may stand far below it (the overlap's own witness is an equality)
AGREE_TILE = 0.95
# card rates for the bound (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 FLOP/s on the CUDA cores (the kernels' arithmetic type)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TC_FLOP_PER_S = 989e12  # bf16 dense on the tensor cores: the bound of the 1x1 products
L2_FLUSH_BYTES = 256 * 2**20  # written between repetitions to empty the 50 MB L2
SOURCE = "deadtrees_tpu_torch/ops/csrc/fused_ir_chw.cu"
REPLACES = {
    "fused_ir_chw_pass1": "deadtrees_tpu/ops/fused_mbconv.py:156",
    "fused_ir_chw_pass2": "deadtrees_tpu/ops/fused_mbconv.py:217",
}
AUGMENT = "augment_jitter_normalize"
AUGMENT_SOURCE = "deadtrees_tpu_torch/ops/csrc/augment.cu"
AUGMENT_REPLACES = "deadtrees_tpu/ops/augment_pallas.py:32"
AUGMENT_BAR = 1e-6  # and no element off by a grey step: bit-equality expected
# the tensor-core NHWC pass 2 (bf16 x) rounds float32-level sums to bf16 once,
# as its plain version does: one bf16 ulp at max(1, max|ref|)
NHWC_P2_ULP_BAR = 2.0 ** -7
# kernel 3's float32 h from the tensor-core pass 1, relative to max(1, max|ref|)
# (tests/test_torch_kernels_cuda.py K3_H_BAR): its largest in phase 9 is
# 1.5e-6; a pass 1 with W1 in two bf16 terms, summed over C_in in the mma's own
# accumulator, reads 2.3e-6 to 5.1e-6 here
K3_H_BAR = 2.5e-6
NHWC_SOURCE = "deadtrees_tpu_torch/ops/csrc/fused_ir_nhwc.cu"
NHWC_REPLACES = {
    "fused_ir_fat_pass1": "deadtrees_tpu/ops/fused_cell.py:67",
    "fused_ir_fat_pass2": "deadtrees_tpu/ops/fused_cell.py:119",
    "fused_inverted_residual_pass1": "deadtrees_tpu/ops/fused_mbconv.py:368",
    "fused_inverted_residual_pass2": "deadtrees_tpu/ops/fused_mbconv.py:426",
}
FAT = ("fused_ir_fat_pass1", "fused_ir_fat_pass2")
K3 = ("fused_inverted_residual_pass1", "fused_inverted_residual_pass2")
DW = "depthwise_conv2d"
DW_SOURCE = "deadtrees_tpu_torch/ops/csrc/depthwise.cu"
DW_REPLACES = "deadtrees_tpu/ops/depthwise.py:34"
FAT_BLOCKS = 14  # decoder blocks the NHWC route sends to the fat-cell kernels at 512²
AGREE_QUANT = 0.95  # tests/test_quantize.py:87, tests/test_act_quant.py:95
TTA_MISMATCH = 1e-2  # near-ties of the bf16 logits between two orientations
EDT_BAR = 1e-4
EDT_KERNELS = ("edt_columns", "edt_rows")
TRAIN_BS = 16
# phase 17: the model zoo at the repo's full width, the configurations of
# configs/model/unet.yaml, the architecture grid's ResNet row
# (configs/hparams_search/architecture_grid.yaml), its widest cross, the
# bottleneck ResNet and configs/model/segformer.yaml
ZOO = (
    ("unet", "resnet18"),
    ("unet", "resnet34"), ("unet++", "resnet34"), ("resunet", "resnet34"),
    ("resunet++", "resnet34"), ("efficientunet++", "resnet34"),
    ("resunet++", "timm-efficientnet-b5"),
    ("unet", "resnet50"),
    ("segformer", "mit-b0"),
)
ZOO_DECODER = (256, 128, 64, 32, 16)
ZOO_FUSED = ("efficientunet++", "resnet34")  # kernels 1 and 2 at ResNet skips
ZOO_SERVED = ("unet", "resnet34")  # the REST service on the plain route
ZOO_EXPORTED = ("resunet++", "resnet34")
ZOO_TRAIN_STEPS = 6
# a bf16 fused route's maps against the float32 model may trail the plain
# bf16 model's by this much: the two round to bf16 in other places, and
# six steps from initialization leave logit margins near bf16's spacing
BF16_ROUTE_SLACK = 0.005
ZOO_RUN_BS = (4, 32)
ZOO_REPS = 5
ZOO_REQUESTS = 3
TRAIN_STEPS = 4  # limit_train_batches per epoch
VAL_STEPS = 2
SCENE = 2048  # the production orthophoto tile
SCENE_BS = 128
SCENE_RAGGED = (1500, 2030)  # 3 x 4 of the 4 x 4 subtiles hold data
SCENE_PX = 0.2
SCENE_X0, SCENE_Y0 = 500000.0, 5400000.0
RECIPE_EPOCHS = 4
RECIPE_TEST = 32  # test tiles


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


SPIN_CYCLES = 1_000_000  # about 0.5 ms of GPU clock: covers a wrapper's host time


def cuda_time_ms(fn, reps: int = 21, warmup: int = 3, flush=None) -> float:
    """Median device time of one ``fn()`` over ``reps`` calls, each between
    its own pair of CUDA events. Before each call the card is kept busy
    outside the events by a spin of ``SPIN_CYCLES`` (with ``flush``, a large
    CUDA byte tensor, after an overwrite of it that leaves the L2 cache
    cold), so that the host's time in a short kernel's wrapper does not
    open a gap between the events: 0.1 ms of spin left gaps of up to 0.04
    ms in this script's process."""
    import torch

    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        if flush is not None:
            flush.fill_(1)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def host_ms_per_call(fn, calls: int = 200) -> float:
    """Host time of one ``fn()`` (the wrapper's Python and the launch), ms:
    ``calls`` calls while a spin keeps the card busy, so none waits on it."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES * 40)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_bar(ref, dtype_name: str) -> float:
    return BAR[dtype_name] * max(1.0, float(ref.float().abs().max()))


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def set_precision() -> None:
    """float32 convolutions and products in full float32 (the float32
    comparisons need it). Part of inductor's cache key: the warmers set it
    too, so that phase 15 finds their programs."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def phase_device():
    import torch

    set_precision()
    log("precision: cudnn.allow_tf32=False, matmul.allow_tf32=False, "
        "float32 matmul precision 'highest' (for the float32 comparisons)")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    log(f"card: {card_line()}")
    from deadtrees_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {list(_build.SOURCES)} "
        f"(nvcc {_build.build_seconds})")
    for name in _build.SOURCES:
        entry, spills = "?", ""
        for line in _build.ptxas_log(name).splitlines():
            m = re.search(
                r"(pass\d_(?:bf16_)?kernel|nhwc_p\d_(?:bf16_)?kernel|dw_tile_kernel"
                r"|augment_[a-z]+_kernel|edt_[a-z]+_kernel)"
                r"(I\w*?E)?E", line)
            if m:
                entry = f"{m.group(1)}<{(m.group(2) or '')[1:-1]}>"
            elif "spill" in line:
                spills = line.strip()
            elif "Used" in line:
                log(f"  ptxas {name} {entry}: {line.split(':', 1)[1].strip()}; {spills}")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def flagship_block_shapes(model, bsz: int, img: int = IMG):
    """(cell, index, (B, C_in, H, W), folded params) for the 22 decoder
    blocks of ``model`` at ``img``² input, in forward order."""
    from deadtrees_tpu_torch.ops import fold_effunetpp_decoder

    folded = fold_effunetpp_decoder(model)
    depth = len(model.decoder_channels) - 1
    cells = []
    for name, cell in model.decoder.blocks.items():
        layer = int(name.rsplit("_", 1)[1])
        size = img // 2 ** (depth - layer)
        cin0 = cell.conv1.block[0].in_channels
        cout = cell.conv1.block[7].out_channels
        cells.append((name, 0, (bsz, cin0, size, size), folded[name][0]))
        cells.append((name, 1, (bsz, cout, size, size), folded[name][1]))
    assert len(cells) == 22, len(cells)
    return cells


def random_folded(cin, cmid, cout, ksize, conv_skip, gen):
    import torch

    from deadtrees_tpu_torch.ops import FoldedBlockParams

    def n(*shape, s=0.2):
        return (torch.randn(shape, generator=gen) * s).cuda().contiguous()

    return FoldedBlockParams(
        w1=n(cin, cmid, s=cin ** -0.5), b1=n(cmid, s=0.1),
        dw=n(ksize, ksize, cmid), b_dw=n(cmid, s=0.1),
        cse_w1=n(cmid, 8), cse_b1=n(8, s=0.1), cse_w2=n(8, cmid),
        cse_b2=n(cmid, s=0.1), sse_w=n(cmid, 1, s=cmid ** -0.5),
        sse_b=n(1, s=0.1), w2=n(cmid, cout, s=cmid ** -0.5), b2=n(cout, s=0.1),
        wsk=n(cin, cout, s=cin ** -0.5) if conv_skip else None,
        bsk=n(cout, s=0.1) if conv_skip else None,
    )


def check_case(label, x, fp, errs, *, activation="hswish", ksize=3, skip="auto"):
    """Kernel vs plain for pass 1, pass 2 and the whole block on one input."""
    import torch

    from deadtrees_tpu_torch.ops import fused_mbconv as fm

    dt = "bfloat16" if x.dtype == torch.bfloat16 else "float32"
    hw = x.shape[2] * x.shape[3]
    h_ref, s_ref = fm.chw_pass1_reference(x, fp, activation=activation, ksize=ksize)
    h_k, psum = fm.chw_pass1(x, fp, activation=activation, ksize=ksize)
    torch.cuda.synchronize()
    e_h = max_err(h_k, h_ref)
    e_s = max_err(psum.sum(1), s_ref.sum(1)) / hw  # as a mean: what the gate reads
    gate = fm.cse_gate(s_ref.sum(1), fp, hw)
    o_ref = fm.chw_pass2_reference(h_ref, x, gate, fp, skip=skip)
    o_k = fm.chw_pass2(h_ref, x, gate, fp, skip=skip)
    blk_ref = fm.fused_inverted_residual_chw_reference(
        x, fp, activation=activation, ksize=ksize, skip=skip)
    blk = fm.fused_inverted_residual_chw(
        x, fp, activation=activation, ksize=ksize, skip=skip)
    torch.cuda.synchronize()
    e_o = max_err(o_k, o_ref)
    e_b = max_err(blk, blk_ref)
    bars = (rel_bar(h_ref, dt), rel_bar(s_ref / hw, dt), rel_bar(o_ref, dt),
            rel_bar(blk_ref, dt))
    ok = all(e <= b for e, b in zip((e_h, e_s, e_o, e_b), bars))
    log(f"  {label:<34} {dt:<8} pass1 h {e_h:.2e}/{bars[0]:.1e} "
        f"mean {e_s:.2e}/{bars[1]:.1e}  pass2 {e_o:.2e}/{bars[2]:.1e}  "
        f"block {e_b:.2e}/{bars[3]:.1e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {label} {dt}")
    errs["fused_ir_chw_pass1"] = max(errs["fused_ir_chw_pass1"], e_h)
    errs["fused_ir_chw_pass2"] = max(errs["fused_ir_chw_pass2"], e_o)


def phase_kernels(model, errs):
    import torch

    gen = torch.Generator().manual_seed(SEED + 1)
    log(f"kernel vs plain at the 22 flagship decoder blocks ({IMG}² input, bs 4); "
        f"bars: float32 {BAR['float32']:g}, bfloat16 {BAR['bfloat16']:g}, "
        "times max(1, max|ref|)")
    for name, i, shape, fp in flagship_block_shapes(model, 4):
        x32 = torch.randn(shape, generator=gen).cuda()
        for x in (x32, x32.to(torch.bfloat16)):
            check_case(f"{name}.conv{i + 1} {tuple(shape[1:])}", x, fp, errs)
    for img in (256, 1024):
        log(f"kernel vs plain at the 22 flagship decoder blocks ({img}² input, bs 1, bf16)")
        for name, i, shape, fp in flagship_block_shapes(model, 1, img):
            x = torch.randn(shape, generator=gen).cuda().to(torch.bfloat16)
            check_case(f"{name}.conv{i + 1} {tuple(shape[1:])}", x, fp, errs)
    log("ragged and generalized modes")
    cases = [
        # (label, cin, cout, H, W, ksize, activation, skip)
        ("ragged 40x72 conv skip", 48, 32, 40, 72, 3, "hswish", "auto"),
        ("ragged 40x72 identity", 48, 48, 40, 72, 3, "hswish", "auto"),
        ("k5 silu none", 88, 40, 45, 70, 5, "silu", "none"),  # 32-channel blocks
        ("k3 silu identity", 64, 64, 45, 70, 3, "silu", "identity"),
        ("k5 hswish conv", 128, 96, 45, 70, 5, "hswish", "conv"),  # 64-channel blocks
    ]
    for label, cin, cout, hh, ww, k, act, skip in cases:
        conv = skip == "conv" or (skip == "auto" and cin != cout)
        fp = random_folded(cin, cin, cout, k, conv, gen)
        x32 = torch.randn((3, cin, hh, ww), generator=gen).cuda()
        for x in (x32, x32.to(torch.bfloat16)):
            check_case(label, x, fp, errs, activation=act, ksize=k, skip=skip)


def phase_edt_kernels(card: str) -> None:
    """Phase 2's EDT: the two kernels against the plain version on the card
    at the training batch's one-hot (16 × 3 × 512², 32-pixel class regions,
    one tile of class 0 alone), bit for bit, one launch each; their time
    beside the plain version's and their bounds."""
    import torch

    from deadtrees_tpu_torch.losses.functional import (
        batch_one_hot2dist,
        batch_one_hot2dist_reference,
        class2one_hot,
    )
    from deadtrees_tpu_torch.ops import LAUNCHES, reset_launch_counts

    rng = np.random.default_rng(SEED + 9)
    seg = torch.from_numpy(rng.integers(0, 3, (TRAIN_BS, 16, 16)))
    seg = seg.repeat_interleave(IMG // 16, 1).repeat_interleave(IMG // 16, 2)
    seg[1] = 0  # classes 1 and 2 absent: zero maps
    one_hot = class2one_hot(seg.cuda(), 3)
    reset_launch_counts()
    got = batch_one_hot2dist(one_hot)
    torch.cuda.synchronize()
    counts = {k: LAUNCHES[k] for k in EDT_KERNELS}
    want = batch_one_hot2dist_reference(one_hot)
    if counts != dict.fromkeys(EDT_KERNELS, 1):
        raise AssertionError(f"EDT launches {counts}, expected one of each")
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"the EDT kernels differ from the plain version by up to "
                             f"{max_err(got, want)}")
    ms = cuda_time_ms(lambda: batch_one_hot2dist(one_hot))
    host = host_ms_per_call(lambda: batch_one_hot2dist(one_hot), calls=50)
    plain_ms = cuda_time_ms(lambda: batch_one_hot2dist_reference(one_hot), reps=3, warmup=1)
    pixels = one_hot.numel()
    bytes_ms = 8 * pixels / HBM_BYTES_PER_S * 1e3  # the one-hot read, the maps written
    design_ms = 32 * pixels / HBM_BYTES_PER_S * 1e3  # columns 20 B a pixel, rows 12 B
    pairs = 2 * pixels * IMG  # (x, x') pairs of both halves
    ops_ms = 3 * pairs / F32_FLOP_PER_S * 1e3  # an FMA and a min a pair
    log(f"EDT kernels at {tuple(one_hot.shape)} on {card}: bit-equal to the plain version, "
        f"launches {counts}; {ms:.4f} ms (CUDA events, median of 21), host {host:.4f} ms a "
        f"call; plain {plain_ms:.3f} ms (median of 3); bounds: bytes {bytes_ms:.4f} ms (read "
        f"and written once; the design's 32 B a pixel {design_ms:.4f} ms), operations "
        f"{ops_ms:.4f} ms ({pairs / 1e9:.2f} G (sum, min) pairs, 3 FLOPs each)")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def build_flagship(path: Path):
    """The b5 flagship from a seeded generator with randomized BN stats,
    written with the port's save_checkpoint. Returns (hparams, model)."""
    import torch

    from deadtrees_tpu_torch.core import save_checkpoint
    from deadtrees_tpu_torch.models import (
        create_model,
        init_model,
        variables_from_state_dict,
    )

    hp = dict(architecture="efficientunet++", encoder_name="timm-efficientnet-b5",
              in_channels=4, classes=3, decoder_channels=[256, 128, 64, 32, 16])
    gen = torch.Generator().manual_seed(SEED)
    model = init_model(create_model(**hp), generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=gen) * 0.4 + 0.8)
                m.bias.copy_(torch.rand(c, generator=gen) * 0.2 - 0.1)
                m.running_mean.copy_(torch.rand(c, generator=gen) * 0.6 - 0.3)
                m.running_var.copy_(torch.rand(c, generator=gen) * 0.6 + 0.7)
    n_mb = sum(len(stage) for stage in model.encoder.blocks)
    assert n_mb == 39, n_mb
    t0 = time.perf_counter()
    save_checkpoint(path, **variables_from_state_dict(model.state_dict()), hparams=hp)
    log(f"flagship b5: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
        f"params, {n_mb} MBConv blocks, 22 decoder blocks; checkpoint "
        f"{path.stat().st_size / 2**20:.1f} MiB written in "
        f"{time.perf_counter() - t0:.2f} s")
    return hp, model


def phase_slice(path: Path, hp):
    import torch

    from deadtrees_tpu_torch.infer import TorchInference
    from deadtrees_tpu_torch.models import create_model
    from deadtrees_tpu_torch.ops import (
        LAUNCHES,
        fold_effunetpp_decoder,
        fused_forward,
        reset_launch_counts,
    )

    t0 = time.perf_counter()
    fused = TorchInference(path, fused_decoder="auto")
    plain = TorchInference(path)
    log(f"TorchInference x2 loaded in {time.perf_counter() - t0:.2f} s on "
        f"{fused.device}")
    rng = np.random.default_rng(SEED)
    for bs in (1, 4, 32):
        img = rng.integers(0, 256, (bs, IMG, IMG, 4), dtype=np.uint8)
        reset_launch_counts()
        a = fused.run(img)
        counts = dict(LAUNCHES)
        b = plain.run(img)
        assert a.shape == (bs, IMG, IMG) and a.dtype == np.uint8, a.shape
        agree = float((a == b).mean())
        log(f"  bf16 bs {bs:>2}: fused vs plain class-map agreement {agree:.5f} "
            f"(bar {AGREE_BF16}); launches {counts}; classes "
            f"{np.bincount(a.ravel(), minlength=3).tolist()}")
        assert all(counts[k] == 22 for k in REPLACES), counts
        assert agree >= AGREE_BF16, agree
    big = rng.integers(0, 256, (64, IMG, IMG, 4), dtype=np.uint8)
    reset_launch_counts()
    out = fused.run(big)
    assert out.shape == (64, IMG, IMG)
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES
    agree = float((out == plain.run(big)).mean())
    log(f"  bf16 bs 64: plain route (launches {dict(LAUNCHES)}), agreement "
        f"with the plain engine {agree:.5f}")
    assert agree >= AGREE_BF16
    del big, out

    model32 = create_model(**hp, dtype=torch.float32)
    model32.load_state_dict(fused.model.state_dict())
    model32 = model32.cuda().eval()
    folded32 = fold_effunetpp_decoder(model32)
    with torch.no_grad():
        for bs in (1, 4, 32):
            img = torch.from_numpy(rng.integers(0, 256, (bs, IMG, IMG, 4), dtype=np.uint8))
            x = fused_input(fused, img.cuda())
            reset_launch_counts()
            got = fused_forward(model32, folded32, x)
            counts = dict(LAUNCHES)
            ref = model32(x)
            err = max_err(got, ref)
            bar = FORWARD_F32_BAR * max(1.0, float(ref.abs().max()))
            log(f"  f32 bs {bs:>2}: fused_forward vs model logits max err "
                f"{err:.3e} (bar {bar:.3e}, max|ref| {float(ref.abs().max()):.3f}); "
                f"launches {counts}")
            assert all(counts[k] == 22 for k in REPLACES), counts
            assert err <= bar, err
            del x, got, ref
    del model32, folded32
    torch.cuda.empty_cache()
    return fused, plain


def fused_input(engine, img_u8):
    from deadtrees_tpu_torch.data import normalize

    return normalize(img_u8.float(), engine.mean, engine.std).permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def phase_server(path: Path):
    """8 concurrent 512² PNGs through serve_stdlib with batching on; returns
    the kernels' launch counts over the run and the dispatch count."""
    from PIL import Image

    from deadtrees_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from deadtrees_tpu_torch.serve import SegmentationService, serve_stdlib

    service = SegmentationService(path, batch_wait_ms=2, max_batch=32)
    server = serve_stdlib(service, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(SEED + 2)
    uploads = []
    for _ in range(8):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 4), dtype=np.uint8), "RGBA").save(
            buf, "PNG")
        uploads.append(buf.getvalue())
    results = [None] * 8

    def post(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/segmentation", data=uploads[i],
            headers={"Content-Type": "image/png"}, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            results[i] = (resp.status, resp.read(), dict(resp.headers))

    try:
        # warm the engine once outside the counted window (allocator, cuDNN)
        service.engines["torch"].run(np.zeros((1, IMG, IMG, 4), np.uint8))
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        batcher = service.batchers["torch"]
        for i, r in enumerate(results):
            assert r is not None, f"request {i} got no answer"
            status, body, headers = r
            mask = np.asarray(Image.open(io.BytesIO(body)))
            assert status == 200 and mask.shape == (IMG, IMG), (status, mask.shape)
        log(f"server: 8 concurrent {IMG}² requests -> 200 with {IMG}x{IMG} masks in "
            f"{wall:.3f} s; {batcher.dispatches} dispatches; launches {counts}")
        assert counts["fused_ir_chw_pass1"] == 22 * batcher.dispatches > 0, counts
        assert counts["fused_ir_chw_pass2"] == 22 * batcher.dispatches, counts
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["models"] == ["torch"], health
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        assert 'deadtrees_requests_total{model_type="torch"} 8' in metrics, metrics
        log(f"server: /healthz {health}; /metrics counts 8 requests")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    return counts


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------


def pass1_tiles(hh: int, ww: int, k: int, bf16: bool) -> int:
    """psum rows of kernel 1's pass 1: its output tiles at this shape."""
    from deadtrees_tpu_torch.ops import fused_mbconv as fm

    lib = fm._kernels()
    return (-(-hh // lib.fused_ir_chw_tile_size(k, int(bf16), 0))
            * -(-ww // lib.fused_ir_chw_tile_size(k, int(bf16), 1)))


def bounds(shape, fp, skip: str, itemsize: int):
    """(bytes, flops, 1x1-product flops) each pass must move / do at this
    shape; the product flops are part of flops."""
    bsz, cin, hh, ww = shape
    hw = hh * ww
    cm = fp.w1.shape[1]
    cout = fp.w2.shape[1]
    k = fp.dw.shape[0]
    n_tiles = pass1_tiles(hh, ww, k, itemsize == 2)
    w1_bytes = 4 * (fp.w1.numel() + fp.b1.numel() + fp.dw.numel() + fp.b_dw.numel())
    p1_bytes = bsz * hw * (cin + cm) * itemsize + bsz * n_tiles * cm * 4 + w1_bytes
    p1_mm = 2 * bsz * hw * cin * cm
    p1_flops = p1_mm + 2 * bsz * hw * k * k * cm
    x_read = cin if skip != "none" else 0
    w2_bytes = 4 * (fp.w2.numel() + fp.b2.numel() + fp.sse_w.numel() + bsz * cm
                    + (fp.wsk.numel() + fp.bsk.numel() if skip == "conv" else 0))
    p2_bytes = bsz * hw * (cm + x_read + cout) * itemsize + w2_bytes
    p2_mm = 2 * bsz * hw * (cm * cout + (cin * cout if skip == "conv" else 0))
    p2_flops = p2_mm + 5 * bsz * hw * cm
    return (p1_bytes, p1_flops, p1_mm), (p2_bytes, p2_flops, p2_mm)


def phase_timings(model, fused, plain, card: str):
    import torch

    from deadtrees_tpu_torch.ops import fused_mbconv as fm

    rng = np.random.default_rng(SEED + 3)
    log(f"latency, fused vs plain engine (median of 7, host clock around run(), "
        f"H2D and D2H included) on {card}")
    for bs in (1, 4, 32):
        img = rng.integers(0, 256, (bs, IMG, IMG, 4), dtype=np.uint8)
        t_f, t_p = [], []
        for engine in (fused, plain):
            engine.run(img)
        for _ in range(7):
            for engine, acc in ((plain, t_p), (fused, t_f), (fused, t_f), (plain, t_p)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.run(img)
                acc.append(time.perf_counter() - t0)
        mf, mp = statistics.median(t_f) * 1e3, statistics.median(t_p) * 1e3
        log(f"  bs {bs:>2}: fused {mf:.3f} ms, plain {mp:.3f} ms "
            f"({bs * 1e3 / mf:.2f} vs {bs * 1e3 / mp:.2f} img/s)")

    log(f"kernel time per launch at the flagship shapes (bf16, bs 4, CUDA events, "
        f"median of 21) on {card}; f32 bound = max(bytes / {HBM_BYTES_PER_S:.3g} B/s, "
        f"f32 FLOPs / {F32_FLOP_PER_S:.3g} FLOP/s); tc bound = max(bytes / "
        f"{HBM_BYTES_PER_S:.3g} B/s, 1x1 FLOPs / {TC_FLOP_PER_S:.3g} + the rest / "
        f"{F32_FLOP_PER_S:.3g} FLOP/s); bound = the tc bound (both passes run their bf16 "
        "products on the tensor cores); share = bound / time")
    gen = torch.Generator().manual_seed(SEED + 4)
    tot = {n: {} for n in REPLACES}
    for name, i, shape, fp in flagship_block_shapes(model, 4):
        x = torch.randn(shape, generator=gen).cuda().to(torch.bfloat16)
        skip = "conv" if fp.wsk is not None else "identity"
        h, psum = fm.chw_pass1(x, fp)
        gate = fm.cse_gate(psum.sum(1), fp, shape[2] * shape[3])
        rows = {
            "fused_ir_chw_pass1": (lambda: fm.chw_pass1(x, fp),
                                   lambda: fm.chw_pass1_reference(x, fp)),
            "fused_ir_chw_pass2": (lambda: fm.chw_pass2(h, x, gate, fp, skip=skip),
                                   lambda: fm.chw_pass2_reference(h, x, gate, fp, skip=skip)),
        }
        b1, b2 = bounds(shape, fp, skip, 2)
        parts = []
        for kname, (kern, ref), (nbytes, flops, mm) in zip(rows, rows.values(), (b1, b2)):
            ms = cuda_time_ms(kern)
            pms = cuda_time_ms(ref)
            bound, by = _add_time(tot[kname], ms, pms, nbytes, flops, mm_flops=mm,
                                  tensor_cores=True)
            f32 = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
            parts.append(f"{kname[-5:]} {ms:.4f} ms (plain {pms:.4f}, bound {bound:.4f} "
                         f"{by}, share {bound / ms:.1%}; f32 bound {f32:.4f}, share "
                         f"{f32 / ms:.1%})")
        log(f"  {name}.conv{i + 1} {tuple(shape[1:])}: " + "; ".join(parts))
    for kname, t in tot.items():
        log(f"  {kname}: one forward's 22 launches {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"(bytes {t['bytes_ms']:.4f}, ops {t['ops_ms']:.4f}), share "
            f"{t['bound_ms'] / t['ms']:.1%}; f32 bound {t['f32_bound_ms']:.4f} ms, tc bound "
            f"{t['tc_bound_ms']:.4f} ms")
    return tot


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------


# the port's kernels by name prefix (csrc/*.cu), so that a variant or a
# renamed kernel of the same family stays in its group
PORT_KERNELS = (("pass1_", "fused pass 1"), ("pass2_", "fused pass 2"),
                ("nhwc_p1_", "NHWC pass 1"), ("nhwc_p2_", "NHWC pass 2"),
                ("dw_", "depthwise kernel"), ("augment_", "augment kernel"))


def port_kernel_group(name: str):
    """The group of a port kernel from its (demangled) profiler name, or
    None for a kernel of another library."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""), maxsplit=1)[0]
    base = head.split("::")[-1].split()[-1:]
    for prefix, group in PORT_KERNELS:
        if base and base[0].startswith(prefix):
            return group
    return None


def _kernel_group(event) -> str:
    name = event.get("name", "")
    if event.get("cat") != "kernel":
        return "copies"
    group = port_kernel_group(name)
    if group is not None:
        return group
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "xmma", "gemm", "cutlass", "winograd")):
        return "conv/GEMM library"
    return "elementwise, reductions"


def phase_profile(fused, plain, card: str) -> None:
    """Device time by kernel group and the device's idle share for the
    engines at bs 4 and 32 (torch.profiler, three runs after a warm-up;
    the traces stay in build/chip_smoke/)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 5)
    trace_dir = REPO / "build" / "chip_smoke"
    log(f"profile: torch.profiler over 3 runs of run() (H2D and D2H included), "
        f"per run, on {card}")
    for bs in (4, 32):
        img = rng.integers(0, 256, (bs, IMG, IMG, 4), dtype=np.uint8)
        for label, engine in (("fused", fused), ("plain", plain)):
            engine.run(img)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    engine.run(img)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / 3
            path = trace_dir / f"trace_{label}_bs{bs}.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
            groups = {}
            for e in events:
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                    g = _kernel_group(e)
                    groups[g] = groups.get(g, 0.0) + e["dur"] / 3e3  # ms per run
            if not groups:
                raise RuntimeError("torch.profiler recorded no device activity")
            busy = sum(groups.values())
            parts = "; ".join(f"{g} {ms:.3f}" for g, ms in
                              sorted(groups.items(), key=lambda kv: -kv[1]))
            log(f"  {label} bs {bs:>2}: wall {wall * 1e3:.3f} ms, device busy "
                f"{busy:.3f} ms, idle {1 - busy / (wall * 1e3):.1%}; ms by group: {parts}")

# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------


def fat_block_shapes(model, bsz: int, img: int = IMG):
    """(cell, index, (B, H, W, C_in), folded params) of the decoder blocks
    that the NHWC route sends to the fat-cell kernels at ``img``² input
    (the JAX routing rule, ``fused_decoder.takes_fat_kernel``)."""
    import torch

    from deadtrees_tpu_torch.ops.fused_decoder import takes_fat_kernel

    out = []
    for name, i, (b, c, hh, ww), fp in flagship_block_shapes(model, bsz, img):
        if takes_fat_kernel(torch.empty((b, hh, ww, c), dtype=torch.bfloat16,
                                        device="meta"), fp):
            out.append((name, i, (b, hh, ww, c), fp))
    return out


def check_nhwc_case(label, x, fp, errs, *, activation="hswish", ksize=3, skip="auto",
                    kernel3=False):
    """The NHWC pair vs plain for pass 1, pass 2 and the whole block, as
    kernel 2 (h in x's dtype) or, with ``kernel3``, as kernel 3 (h in
    float32). For bf16 x pass 2 runs in both stagings: on the TMA staging
    (aligned h; the plain loads where C % 8 != 0) and on a copy of h one
    element into its storage (the plain loads), which must give the same
    bits."""
    import torch

    from deadtrees_tpu_torch.ops import fused_cell as fc
    from deadtrees_tpu_torch.ops import fused_mbconv as fm

    dt = "bfloat16" if x.dtype == torch.bfloat16 else "float32"
    names = K3 if kernel3 else FAT
    h_dtype = torch.float32 if kernel3 else x.dtype
    hw = x.shape[1] * x.shape[2]
    skip = fm._resolve_skip(fp, skip)
    h_ref, s_ref = fc.nhwc_pass1_reference(x, fp, activation=activation, ksize=ksize,
                                           h_dtype=h_dtype)
    h_k, psum = fc.nhwc_pass1(x, fp, activation=activation, ksize=ksize, h_dtype=h_dtype,
                              count=names[0])
    torch.cuda.synchronize()
    e_h = max_err(h_k, h_ref)
    e_s = max_err(psum.sum(1), s_ref.sum(1)) / hw
    gate = fm.cse_gate(s_ref.sum(1), fp, hw)
    o_ref = fc.nhwc_pass2_reference(h_ref, x, gate, fp, skip=skip)
    o_k = fc.nhwc_pass2(h_ref, x, gate, fp, skip=skip, count=names[1])
    stages = fc.nhwc_pass2_staging(h_ref, x, skip) or "float32 kernel"
    same = True
    if dt == "bfloat16":
        buf = torch.empty((h_ref.numel() + 1,), dtype=h_dtype, device=h_ref.device)
        buf[1:].copy_(h_ref.flatten())
        h_plain = buf[1:].view(h_ref.shape)
        stages += "/" + fc.nhwc_pass2_staging(h_plain, x, skip)
        o_plain = fc.nhwc_pass2(h_plain, x, gate, fp, skip=skip, count=names[1])
        same = bool(torch.equal(o_k, o_plain))
    if kernel3:
        blk_ref = fm.fused_inverted_residual_reference(x, fp)
        blk = fm.fused_inverted_residual(x, fp)
    else:
        blk_ref = fc.fused_ir_fat_reference(x, fp, activation=activation, ksize=ksize,
                                            skip=skip)
        blk = fc.fused_ir_fat(x, fp, activation=activation, ksize=ksize, skip=skip)
    torch.cuda.synchronize()
    e_o = max_err(o_k, o_ref)
    e_b = max_err(blk, blk_ref)
    scale = max(1.0, float(h_ref.float().abs().max()))
    bars = (K3_H_BAR * scale if kernel3 and dt == "bfloat16" else rel_bar(h_ref, dt),
            rel_bar(s_ref / hw, dt),
            (NHWC_P2_ULP_BAR * max(1.0, float(o_ref.float().abs().max()))
             if dt == "bfloat16" else rel_bar(o_ref, dt)),
            rel_bar(blk_ref, dt))
    ok = same and all(e <= b for e, b in zip((e_h, e_s, e_o, e_b), bars))
    rel_h = f" (rel {e_h / scale:.2e})" if kernel3 and dt == "bfloat16" else ""
    log(f"  {label:<34} {dt:<8} {'k3' if kernel3 else 'k2'} pass1 h {e_h:.2e}/{bars[0]:.1e}{rel_h} "
        f"mean {e_s:.2e}/{bars[1]:.1e}  pass2 ({stages}{', bit-equal' if '/' in stages else ''}) "
        f"{e_o:.2e}/{bars[2]:.1e}  block {e_b:.2e}/{bars[3]:.1e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"NHWC kernel disagrees with its plain version: {label} {dt}")
    errs[names[0]] = max(errs[names[0]], e_h)
    errs[names[1]] = max(errs[names[1]], e_o)


def check_dw_case(label, x, kernel, strides, errs):
    import torch

    from deadtrees_tpu_torch.ops import depthwise as dwm

    dt = "bfloat16" if x.dtype == torch.bfloat16 else "float32"
    ref = dwm.depthwise_conv2d_reference(x, kernel, strides=strides)
    got = dwm.depthwise_conv2d(x, kernel, strides=strides, force="cuda")
    torch.cuda.synchronize()
    err, bar = max_err(got, ref), rel_bar(ref, dt)
    ok = got.shape == ref.shape and got.dtype == x.dtype and err <= bar
    log(f"  {label:<40} {dt:<8} {tuple(got.shape)} max err {err:.2e}/{bar:.1e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"depthwise kernel disagrees with its plain version: {label} {dt}")
    errs[DW] = max(errs[DW], err)


def phase_nhwc_kernels(model, errs):
    import torch

    gen = torch.Generator().manual_seed(SEED + 12)
    fat = fat_block_shapes(model, 4)
    log(f"NHWC kernels vs plain at the {len(fat)} fat decoder blocks ({IMG}² input, bs 4): "
        + ", ".join(f"{n}.conv{i + 1}" for n, i, _, _ in fat))
    if len(fat) != FAT_BLOCKS:
        raise AssertionError(f"{len(fat)} fat blocks at {IMG}², expected {FAT_BLOCKS}")
    for name, i, shape, fp in fat:
        x32 = torch.randn(shape, generator=gen).cuda()
        for x in (x32, x32.to(torch.bfloat16)):
            check_nhwc_case(f"{name}.conv{i + 1} {tuple(shape[1:])}", x, fp, errs)
            check_nhwc_case(f"{name}.conv{i + 1} {tuple(shape[1:])}", x, fp, errs,
                            kernel3=True)
    for img in (256, 1024):
        fat = fat_block_shapes(model, 1, img)
        log(f"NHWC kernels vs plain at the {len(fat)} fat decoder blocks ({img}² input, "
            "bs 1, bf16)")
        for name, i, shape, fp in fat:
            x = torch.randn(shape, generator=gen).cuda().to(torch.bfloat16)
            check_nhwc_case(f"{name}.conv{i + 1} {tuple(shape[1:])}", x, fp, errs)
    log("NHWC ragged and generalized modes")
    cases = [
        # (label, cin, cout, H, W, ksize, activation, skip)
        ("ragged 40x72 conv skip", 64, 32, 40, 72, 3, "hswish", "auto"),
        ("ragged 40x72 identity", 96, 96, 40, 72, 3, "hswish", "auto"),
        ("C_in % 8 != 0 conv skip", 100, 48, 40, 72, 3, "hswish", "auto"),  # plain loads
        ("k5 silu none", 88, 40, 45, 70, 5, "silu", "none"),  # 32-channel blocks
        ("k3 silu identity", 64, 64, 45, 70, 3, "silu", "identity"),
        ("k5 hswish conv", 128, 96, 45, 70, 5, "hswish", "conv"),  # 64-channel blocks
    ]
    for label, cin, cout, hh, ww, k, act, skip in cases:
        conv = skip == "conv" or (skip == "auto" and cin != cout)
        fp = random_folded(cin, cin, cout, k, conv, gen)
        x32 = torch.randn((3, hh, ww, cin), generator=gen).cuda()
        for x in (x32, x32.to(torch.bfloat16)):
            check_nhwc_case(label, x, fp, errs, activation=act, ksize=k, skip=skip)
            if (k, act, skip) == (3, "hswish", "auto"):
                check_nhwc_case(label, x, fp, errs, kernel3=True)
    log("depthwise kernel vs plain")
    for shape, k, strides in (((2, 64, 64, 32), 3, 1), ((2, 64, 64, 32), 5, 1),
                              ((2, 64, 64, 48), 3, 2), ((2, 64, 64, 48), 5, 2),
                              ((2, 45, 31, 40), 3, 1), ((3, 37, 53, 24), 5, 2),
                              ((2, 64, 64, 240), 3, 1), ((1, 32, 32, 1056), 5, 1),
                              ((1, 16, 16, 3072), 3, 1), ((2, 33, 35, 240), 5, 2)):
        x32 = torch.randn(shape, generator=gen).cuda()
        kern = torch.randn((k, k, 1, shape[-1]), generator=gen).cuda()
        for x in (x32, x32.to(torch.bfloat16)):
            check_dw_case(f"{shape} k{k} stride {strides}", x, kern, strides, errs)
    shape, n = (2, 20, 24, 32), 2 * 20 * 24 * 32
    for dtype in (torch.float32, torch.bfloat16):  # 16-byte misaligned: plain-load staging
        x = torch.randn((n + 1,), generator=gen).cuda().to(dtype)[1:].view(shape)
        kern = torch.randn((3, 3, 1, 32), generator=gen).cuda()
        check_dw_case(f"{shape} k3 misaligned view", x, kern, 1, errs)


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------


def phase_nhwc_slice(path: Path, hp, plain):
    """The rest of single-model serving; returns (the NHWC route's engine,
    the launch counts summed over its main-path runs)."""
    import torch

    from deadtrees_tpu_torch.infer import TorchInference
    from deadtrees_tpu_torch.infer.tta import apply_view
    from deadtrees_tpu_torch.models import create_model
    from deadtrees_tpu_torch.ops import (
        LAUNCHES,
        fold_effunetpp_decoder,
        fused_forward,
        reset_launch_counts,
    )

    nhwc = TorchInference(path, fused_decoder="nhwc")
    rng = np.random.default_rng(SEED + 13)
    totals = {k: 0 for k in LAUNCHES}
    for bs in (1, 4, 32, 128):
        img = rng.integers(0, 256, (bs, IMG, IMG, 4), dtype=np.uint8)
        reset_launch_counts()
        a = nhwc.run(img)
        counts = dict(LAUNCHES)
        b = plain.run(img)
        assert a.shape == (bs, IMG, IMG) and a.dtype == np.uint8, a.shape
        agree = float((a == b).mean())
        log(f"  nhwc bf16 bs {bs:>3}: vs plain class-map agreement {agree:.5f} (bar "
            f"{AGREE_BF16}); launches {counts}; classes "
            f"{np.bincount(a.ravel(), minlength=3).tolist()}")
        others = {k: v for k, v in counts.items() if k not in FAT}
        if any(counts[k] != FAT_BLOCKS for k in FAT) or any(others.values()):
            raise AssertionError(f"nhwc forward launches {counts}, expected {FAT_BLOCKS} "
                                 "of each fat-cell pass and nothing else")
        if agree < AGREE_BF16:
            raise AssertionError(f"nhwc engine agreement {agree}")
        for k, v in counts.items():
            totals[k] += v
        del img, a, b

    model32 = create_model(**hp, dtype=torch.float32)
    model32.load_state_dict(nhwc.model.state_dict())
    model32 = model32.cuda().eval()
    folded32 = fold_effunetpp_decoder(model32)
    with torch.no_grad():
        for bs in (1, 4):
            img = torch.from_numpy(rng.integers(0, 256, (bs, IMG, IMG, 4), dtype=np.uint8))
            x = fused_input(nhwc, img.cuda())
            reset_launch_counts()
            got = fused_forward(model32, folded32, x, layout="nhwc")
            counts = {k: LAUNCHES[k] for k in FAT}
            ref = model32(x)
            err = max_err(got, ref)
            bar = FORWARD_F32_BAR * max(1.0, float(ref.abs().max()))
            log(f"  f32 bs {bs}: fused_forward(layout='nhwc') vs model logits max err "
                f"{err:.3e} (bar {bar:.3e}); launches {counts}")
            if any(v != FAT_BLOCKS for v in counts.values()) or err > bar:
                raise AssertionError(f"nhwc f32 forward: err {err}, launches {counts}")
    del model32, folded32

    for quantized in ("w8", "w8a8"):
        engine = TorchInference(path, quantized=quantized)
        for bs in (4, 32):
            img = rng.integers(0, 256, (bs, IMG, IMG, 4), dtype=np.uint8)
            reset_launch_counts()
            a = engine.run(img)
            counts = dict(LAUNCHES)
            agree = float((a == plain.run(img)).mean())
            log(f"  {quantized} bs {bs:>2}: agreement with the unquantized engine {agree:.5f} "
                f"(bar > {AGREE_QUANT}); launches {counts}")
            if agree <= AGREE_QUANT or (quantized == "w8a8" and any(counts.values())):
                raise AssertionError(f"{quantized} engine: agreement {agree}, launches {counts}")
        del engine

    engine = TorchInference(path, tta=8)
    img = rng.integers(0, 256, (4, IMG, IMG, 4), dtype=np.uint8)
    base = engine.run(img)
    agree = float((base == plain.run(img)).mean())
    parts = []
    for k, flip in ((1, False), (2, False), (3, False), (0, True), (1, True)):
        view = apply_view(torch.from_numpy(img), k, flip).contiguous().numpy()
        want = apply_view(torch.from_numpy(base), k, flip).numpy()
        mismatch = float((engine.run(view) != want).mean())
        parts.append(f"rot{k * 90}{' flip' if flip else ''} {mismatch:.2e}")
        if mismatch >= TTA_MISMATCH:
            raise AssertionError(f"tta=8 is not equivariant: ({k}, {flip}) {mismatch}")
    log(f"  tta=8 bs 4: agreement with the plain engine {agree:.5f}; mismatch of the "
        f"transformed prediction (bar {TTA_MISMATCH:g}): " + "; ".join(parts))
    del engine
    torch.cuda.empty_cache()
    return nhwc, totals


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------


def encoder_dw_shapes(model, bsz: int, img: int = IMG):
    """{(B, H, W, C, k): count} of the b5 encoder's stride-1 depthwise
    convs at ``img``² input (forward hooks on one bs-1 encoder pass)."""
    import torch

    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append((tuple(inp[0].shape), mod.kernel_size[0])))
        for blk in model.encoder.modules() if hasattr(blk, "conv_dw")
        for m in (blk.conv_dw,) if m.stride[0] == 1]
    try:
        with torch.no_grad(), model.autocast("cuda"):
            model.encoder(torch.zeros((1, 4, img, img), device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    shapes = {}
    for (_, c, hh, ww), k in seen:
        key = (bsz, hh, ww, c, k)
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def nhwc_bounds(shape, fp, skip: str, itemsize: int, h_itemsize: int):
    """(bytes, flops, 1x1-product flops) of each NHWC pass: the CHW
    formula with h's item size as a parameter."""
    import torch

    from deadtrees_tpu_torch.ops import fused_cell as fc

    bsz, hh, ww, cin = shape
    hw = hh * ww
    cm = fp.w1.shape[1]
    cout = fp.w2.shape[1]
    k = fp.dw.shape[0]
    n_tiles = fc.pass1_tiles(hh, ww, k, torch.bfloat16 if itemsize == 2 else torch.float32)
    w1_bytes = 4 * (fp.w1.numel() + fp.b1.numel() + fp.dw.numel() + fp.b_dw.numel())
    p1_bytes = bsz * hw * (cin * itemsize + cm * h_itemsize) + bsz * n_tiles * cm * 4 + w1_bytes
    p1_mm = 2 * bsz * hw * cin * cm
    p1_flops = p1_mm + 2 * bsz * hw * k * k * cm
    x_read = cin if skip != "none" else 0
    w2_bytes = 4 * (fp.w2.numel() + fp.b2.numel() + fp.sse_w.numel() + bsz * cm
                    + (fp.wsk.numel() + fp.bsk.numel() if skip == "conv" else 0))
    p2_bytes = bsz * hw * (cm * h_itemsize + (x_read + cout) * itemsize) + w2_bytes
    p2_mm = 2 * bsz * hw * (cm * cout + (cin * cout if skip == "conv" else 0))
    p2_flops = p2_mm + 5 * bsz * hw * cm
    return (p1_bytes, p1_flops, p1_mm), (p2_bytes, p2_flops, p2_mm)


def _add_time(t, ms, pms, nbytes, flops, mult=1, mm_flops=0, tensor_cores=False):
    """Add one shape's times and bounds (``mult`` launches of it) to the
    row ``t``; returns (its bound in ms, what bounds it). The bound takes
    the rates of the kernel's arithmetic: everything in float32 on the CUDA
    cores, or with ``tensor_cores`` the 1x1 products at the bf16 tensor
    rate; ``f32_bound_ms`` and ``tc_bound_ms`` keep both."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f32_ops_ms = flops / F32_FLOP_PER_S * 1e3
    tc_ops_ms = (mm_flops / TC_FLOP_PER_S + (flops - mm_flops) / F32_FLOP_PER_S) * 1e3
    ops_ms = tc_ops_ms if tensor_cores else f32_ops_ms
    for key, val in (("ms", ms), ("plain_ms", pms), ("bound_ms", max(bytes_ms, ops_ms)),
                     ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                     ("f32_bound_ms", max(bytes_ms, f32_ops_ms)),
                     ("tc_bound_ms", max(bytes_ms, tc_ops_ms))):
        t[key] = t.get(key, 0.0) + val * mult
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "ops"


def phase_nhwc_timings(path: Path, model, nhwc, plain, card: str, errs):
    """Route latencies, the new kernels' times, the NHWC route's profile.
    Returns the per-kernel time rows and the route latencies by batch size
    ({bs: {route: ms}})."""
    import torch
    import torch.nn.functional as F

    from deadtrees_tpu_torch.infer import TorchInference
    from deadtrees_tpu_torch.ops import depthwise as dwm
    from deadtrees_tpu_torch.ops import fused_cell as fc
    from deadtrees_tpu_torch.ops import fused_mbconv as fm

    chw = TorchInference(path, fused_decoder="chw")
    rng = np.random.default_rng(SEED + 14)
    route_ms = {}
    log(f"latency by route (median, host clock around run(), H2D and D2H included; "
        f"rounds of plain, chw, nhwc, nhwc, chw, plain) on {card}")
    for bs, rounds in ((1, 7), (4, 7), (32, 4), (128, 2)):
        img = rng.integers(0, 256, (bs, IMG, IMG, 4), dtype=np.uint8)
        times = {"plain": [], "chw": [], "nhwc": []}
        engines = {"plain": plain, "chw": chw, "nhwc": nhwc}
        for engine in engines.values():
            engine.run(img)
        for _ in range(rounds):
            for label in ("plain", "chw", "nhwc", "nhwc", "chw", "plain"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engines[label].run(img)
                times[label].append(time.perf_counter() - t0)
        med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
        route_ms[bs] = med
        log(f"  bs {bs:>3}: nhwc {med['nhwc']:.3f} ms, chw {med['chw']:.3f} ms, plain "
            f"{med['plain']:.3f} ms ({bs * 1e3 / med['nhwc']:.2f} / "
            f"{bs * 1e3 / med['chw']:.2f} / {bs * 1e3 / med['plain']:.2f} img/s; "
            f"{2 * rounds} runs each)")
        del img
    del chw

    log(f"NHWC kernels per launch at the {FAT_BLOCKS} fat shapes (bf16 x, bs 4, CUDA "
        f"events, median of 21) on {card}; bound = the tc bound for both passes (their "
        f"bf16 products on the tensor cores): max(bytes / {HBM_BYTES_PER_S:.3g} B/s, 1x1 "
        f"FLOPs / {TC_FLOP_PER_S:.3g} + the rest / {F32_FLOP_PER_S:.3g} FLOP/s); h's item "
        "size 2 (kernel 2) or 4 (kernel 3)")
    gen = torch.Generator().manual_seed(SEED + 15)
    names = FAT + K3
    tot = {n: {} for n in names + (DW,)}
    for name, i, shape, fp in fat_block_shapes(model, 4):
        x = torch.randn(shape, generator=gen).cuda().to(torch.bfloat16)
        skip = "conv" if fp.wsk is not None else "identity"
        hw = shape[1] * shape[2]
        parts = []
        for kernel3, (n1, n2), h_dtype in ((False, FAT, torch.bfloat16),
                                           (True, K3, torch.float32)):
            h, psum = fc.nhwc_pass1(x, fp, h_dtype=h_dtype, count=n1)
            gate = fm.cse_gate(psum.sum(1), fp, hw)
            rows = (
                (n1, lambda: fc.nhwc_pass1(x, fp, h_dtype=h_dtype, count=n1),
                 lambda: fc.nhwc_pass1_reference(x, fp, h_dtype=h_dtype)),
                (n2, lambda: fc.nhwc_pass2(h, x, gate, fp, skip=skip, count=n2),
                 lambda: fc.nhwc_pass2_reference(h, x, gate, fp, skip=skip)),
            )
            b1, b2 = nhwc_bounds(shape, fp, skip, 2, 4 if kernel3 else 2)
            for (kname, kern, ref), (nbytes, flops, mm) in zip(rows, (b1, b2)):
                ms, pms = cuda_time_ms(kern), cuda_time_ms(ref)
                bound, by = _add_time(tot[kname], ms, pms, nbytes, flops, mm_flops=mm,
                                      tensor_cores=True)
                parts.append(f"{'k3' if kernel3 else 'k2'} p{kname[-1]} {ms:.4f} "
                             f"(plain {pms:.4f}, bound {bound:.4f} {by}, share "
                             f"{bound / ms:.1%})")
        log(f"  {name}.conv{i + 1} {tuple(shape[1:])}: " + "; ".join(parts))
    for kname in names:
        t = tot[kname]
        log(f"  {kname}: one forward's {FAT_BLOCKS} launches {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes "
            f"{t['bytes_ms']:.4f}, ops {t['ops_ms']:.4f}), share {t['bound_ms'] / t['ms']:.1%}; "
            f"f32 bound {t['f32_bound_ms']:.4f} ms, tc bound {t['tc_bound_ms']:.4f} ms")

    shapes = encoder_dw_shapes(model, TRAIN_BS)
    log(f"depthwise kernel at the b5 encoder's {sum(shapes.values())} stride-1 depthwise "
        f"convs ({len(shapes)} shapes, bs {TRAIN_BS}, {IMG}², bf16; CUDA events, median "
        f"of 21) on {card}; library = F.conv2d(groups=C) on the same tensor; cold = "
        f"L2 emptied by a {L2_FLUSH_BYTES >> 20} MiB write before each repetition "
        "(outside the events)")
    lib_ms = lib_cold = cold = host = lib_host = 0.0
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for (bsz, hh, ww, c, k), n in sorted(shapes.items(), key=lambda kv: -kv[0][1]):
        x = torch.randn((bsz, hh, ww, c), generator=gen).cuda().to(torch.bfloat16)
        kern = (torch.randn((k, k, 1, c), generator=gen) * 0.2).cuda()
        check_dw_case(f"encoder ({bsz}, {hh}, {ww}, {c}) k{k}", x, kern, 1, errs)
        w_lib = kern.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
        x_lib = x.permute(0, 3, 1, 2)
        ms = cuda_time_ms(lambda: dwm.depthwise_conv2d(x, kern, force="cuda"))
        pms = cuda_time_ms(lambda: dwm.depthwise_conv2d_reference(x, kern), reps=5)
        lms = cuda_time_ms(lambda: F.conv2d(x_lib, w_lib, padding=k // 2, groups=c))
        cms = cuda_time_ms(lambda: dwm.depthwise_conv2d(x, kern, force="cuda"),
                           flush=flush)
        clms = cuda_time_ms(lambda: F.conv2d(x_lib, w_lib, padding=k // 2, groups=c),
                            flush=flush)
        nbytes = 2 * x.numel() * 2 + kern.numel() * 4
        flops = 2 * k * k * x.numel()
        bound, by = _add_time(tot[DW], ms, pms, nbytes, flops, n)
        lib_ms += lms * n
        cold += cms * n
        lib_cold += clms * n
        plan = dwm.depthwise_tile_plan(hh, ww, c, k, 1, 2, batch=bsz,
                                       sms=torch.cuda.get_device_properties(0).multi_processor_count)
        host += host_ms_per_call(lambda: dwm.depthwise_conv2d(x, kern, force="cuda")) * n
        lib_host += host_ms_per_call(
            lambda: F.conv2d(x_lib, w_lib, padding=k // 2, groups=c)) * n
        log(f"  ({bsz}, {hh}, {ww}, {c}) k{k} x{n}: kernel {ms:.4f} ms (share of bound "
            f"{bound / ms:.1%}; cold {cms:.4f}, share {bound / cms:.1%}), plain {pms:.4f}, "
            f"library {lms:.4f} (cold {clms:.4f}), bound {bound:.4f} {by}; tile "
            f"{plan.th}x{plan.tw}x{plan.cbv * plan.v} ch, {plan.threads} threads, "
            f"{plan.smem_bytes} B, grid {plan.grid}")
        del x, x_lib
    del flush
    t = tot[DW]
    t.update(library_ms=lib_ms, cold_ms=cold, library_cold_ms=lib_cold, host_ms=host,
             library_host_ms=lib_host)
    log(f"  {DW}: the encoder's stride-1 depthwise convs {t['ms']:.4f} ms (cold "
        f"{cold:.4f}), plain {t['plain_ms']:.4f} ms, library {lib_ms:.4f} ms (cold "
        f"{lib_cold:.4f}), bound {t['bound_ms']:.4f} ms (bytes {t['bytes_ms']:.4f}, ops "
        f"{t['ops_ms']:.4f}); share of bound {t['bound_ms'] / t['ms']:.1%} (cold "
        f"{t['bound_ms'] / cold:.1%}); host time of the 35 calls {host:.4f} ms, of the "
        f"library's {lib_host:.4f} ms (mean of 200 calls a shape, card kept busy)")
    torch.cuda.empty_cache()
    return tot, route_ms


def phase_nhwc_profile(nhwc, card: str) -> None:
    """Device time by kernel group and idle share of the nhwc route at bs
    32 and 128 (torch.profiler, as phase 6)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 16)
    trace_dir = REPO / "build" / "chip_smoke"
    log(f"profile of the nhwc route: torch.profiler over 2 runs of run() (H2D and D2H "
        f"included), per run, on {card}")
    for bs in (32, 128):
        img = rng.integers(0, 256, (bs, IMG, IMG, 4), dtype=np.uint8)
        nhwc.run(img)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                nhwc.run(img)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 2
        path = trace_dir / f"trace_nhwc_bs{bs}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        groups = {}
        for e in events:
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                g = _kernel_group(e)
                groups[g] = groups.get(g, 0.0) + e["dur"] / 2e3  # ms per run
        if not groups:
            raise RuntimeError("torch.profiler recorded no device activity")
        busy = sum(groups.values())
        parts = "; ".join(f"{g} {ms:.3f}" for g, ms in
                          sorted(groups.items(), key=lambda kv: -kv[1]))
        log(f"  nhwc bs {bs:>3}: wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms, idle "
            f"{1 - busy / (wall * 1e3):.1%}; ms by group: {parts}")


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------


def augment_bound_ms(shape) -> tuple:
    """(bound ms, bytes ms, ops ms) of one jitter + normalize call: the
    uint8 batch and α, β read once, the float32 NCHW batch written once;
    8 float operations an element (two products, a sum, clip, floor,
    subtract, divide) and one add an element for the image mean."""
    bsz, hh, ww, c = shape
    n = bsz * hh * ww * c
    nbytes = n + 8 * bsz + 4 * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 9 * n / F32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def phase_augment(card: str) -> dict:
    """Kernel 4 against its plain version on the card; the exact EDT
    against scipy. Returns the kernel's row of the kernels line (without
    its launch count)."""
    import torch

    from deadtrees_tpu_torch.data import DATASET_CONFIG
    from deadtrees_tpu_torch.ops import augment as aug

    mean, std = DATASET_CONFIG.mean, DATASET_CONFIG.std
    gen = torch.Generator().manual_seed(SEED + 7)
    log(f"augment kernel vs plain (bar: max abs err <= {AUGMENT_BAR:g} and no grey-step "
        "flip; bit-equality expected)")
    worst = 0.0
    for shape in ((TRAIN_BS, IMG, IMG, 4), (1, 256, 256, 4), (1, 1024, 1024, 4),
                  (2, 40, 72, 4), (3, IMG, IMG, 3)):
        img = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).cuda()
        img[:, : shape[1] // 8] = 255  # saturated rows: the clip bites at both ends
        img[:, -(shape[1] // 8):] = 0
        alpha = 0.85 + 0.3 * torch.rand(shape[0], generator=gen)
        beta = 0.4 * torch.rand(shape[0], generator=gen) - 0.2
        alpha[0], beta[0] = 1.15, 0.2
        alpha, beta = alpha.cuda(), beta.cuda()
        ref = aug.augment_jitter_normalize_reference(img, alpha, beta, mean, std)
        got = aug.augment_jitter_normalize(img, alpha, beta, mean, std)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        differ = int((got != ref).sum())
        step = 1.0 / (255.0 * max(std))
        flips = int(((got - ref).abs() > 0.5 * step).sum())
        jit = aug.color_jitter_u8(img, alpha, beta)
        clipped = (float((jit == 255).float().mean()), float((jit == 0).float().mean()))
        log(f"  {str(shape):<22} max abs err {err:.3e}, elements that differ {differ}, "
            f"grey-step flips {flips}; share clipped at 255 / 0: {clipped[0]:.3f} / "
            f"{clipped[1]:.3f}")
        if err > AUGMENT_BAR or flips:
            raise AssertionError(f"augment kernel disagrees with its plain version at {shape}")
        worst = max(worst, err)

    shape = (TRAIN_BS, IMG, IMG, 4)
    img = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).cuda()
    alpha = (0.85 + 0.3 * torch.rand(TRAIN_BS, generator=gen)).cuda()
    beta = (0.4 * torch.rand(TRAIN_BS, generator=gen) - 0.2).cuda()
    ms = cuda_time_ms(lambda: aug.augment_jitter_normalize(img, alpha, beta, mean, std))
    plain_ms = cuda_time_ms(
        lambda: aug.augment_jitter_normalize_reference(img, alpha, beta, mean, std))
    mean_ms = cuda_time_ms(lambda: aug.image_mean(img))
    img_mean = aug.image_mean(img)
    chan = torch.cat(aug.channel_constants(mean, std, 4, img.device)).contiguous()
    kernel_ms = cuda_time_ms(lambda: aug.launch(img, alpha, beta, img_mean, chan))
    bound, bytes_ms, ops_ms = augment_bound_ms(shape)
    log(f"augment at {shape} (CUDA events, median of 21) on {card}: wrapper {ms:.4f} ms "
        f"(the kernel's launch alone {kernel_ms:.4f} ms, the exact image-mean reduction "
        f"alone {mean_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"(bytes {bytes_ms:.4f}, ops {ops_ms:.4f})")

    phase_edt()
    return {"name": AUGMENT, "route": "cuda", "source": AUGMENT_SOURCE,
            "replaces": AUGMENT_REPLACES, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def phase_edt() -> None:
    """The exact EDT on the card against scipy on 512² masks."""
    import scipy.ndimage
    import torch

    from deadtrees_tpu_torch.losses import edt

    rng = np.random.default_rng(SEED + 8)
    masks = {"all False": np.zeros((IMG, IMG), bool), "all True": np.ones((IMG, IMG), bool),
             "one pixel": np.zeros((IMG, IMG), bool), "sparse": rng.random((IMG, IMG)) > 0.999,
             "blobs": np.zeros((IMG, IMG), bool)}
    masks["one pixel"][IMG * 3 // 5, 17] = True
    for y, x, h, w in rng.integers(0, IMG // 2, (12, 4)):
        masks["blobs"][y:y + h % 64 + 8, x:x + w % 64 + 8] = True
    got = edt(torch.from_numpy(np.stack(list(masks.values()))).cuda()).cpu().numpy()
    parts = []
    for (name, m), g in zip(masks.items(), got):
        # scipy measures the distance to the nearest zero of its input;
        # with no True pixel the port's documented value is sqrt(1e12)
        want = (np.full(m.shape, 1e6) if not m.any()
                else scipy.ndimage.distance_transform_edt(~m))
        err = float(np.abs(g - want).max())
        parts.append(f"{name} {err:.2e}")
        if err > EDT_BAR * max(1.0, float(np.abs(want).max()) if not m.any() else 1.0):
            raise AssertionError(f"EDT on the card disagrees with scipy: {name} {err}")
    log(f"EDT on the card vs scipy, 512² masks, max abs err (bar {EDT_BAR:g}): "
        + "; ".join(parts))


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------


def _tiff(arr: np.ndarray, mode: str) -> bytes:
    """An uncompressed TIFF by PIL, the shard writer's format."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="TIFF")
    return buf.getvalue()


def write_train_shards(root: Path, test: int = 0, train: int = 64) -> None:
    """Train shards of 32 (two by default) and a val shard of 32 samples
    (and ``test`` test samples): 512² RGBN TIFF tiles, masks of random
    rectangles of classes 1 and 2, lu layers."""
    from deadtrees_tpu_torch.data.shardwriter import ShardWriter

    rng = np.random.default_rng(SEED + 9)
    for split, n in (("train", train), ("val", 32), ("test", test)):
        if not n:
            continue
        with ShardWriter(str(root / split / "train-combo-%06d.tar"), maxcount=32) as w:
            for i in range(n):
                mask = np.zeros((IMG, IMG), np.uint8)
                for cls in (1, 2):
                    for y, x, h, ww in rng.integers(0, IMG * 3 // 4, (3, 4)):
                        side = IMG // 5
                        mask[y:y + h % side + IMG // 32, x:x + ww % side + IMG // 32] = cls
                img = rng.integers(0, 256, (IMG, IMG, 4), dtype=np.uint8)
                w.write({"__key__": f"{split}_{i:04d}", "rgbn.tif": _tiff(img, "RGBA"),
                         "mask.tif": _tiff(mask, "L"),
                         "lu.tif": _tiff((rng.random((IMG, IMG)) > 0.3).astype(np.uint8), "L"),
                         "txt": f"{float((mask > 0).mean() * 100):.2f}"})
    (root / "test").mkdir(exist_ok=True)


def train_config(data_dir: Path) -> dict:
    """The flagship recipe (configs/experiment/flagship_b5_multistage.yaml,
    bs 16 from the datamodule config) cut to 2 epochs of 4 train and 2 val
    batches, the encoder frozen in the first (MultiStage unfreeze_epoch 1)."""
    return {
        "data_dir": str(data_dir), "seed": SEED,
        "datamodule": {"pattern": "train-combo-*.tar", "batch_size": TRAIN_BS},
        "model": {
            "network": {"architecture": "efficientunet++",
                        "encoder_name": "timm-efficientnet-b5",
                        "decoder_channels": [256, 128, 64, 32, 16],
                        "classes": ["background", "conifers", "deciduous"],
                        "in_channels": 4, "losses": ["GDICE", "FOCAL", "BOUNDARY"]},
            "training": {"learning_rate": 3e-4, "cosineannealing_tmax": 10},
        },
        "trainer": {"max_epochs": 2, "min_epochs": 1, "precision": "bf16",
                    "gradient_clip_val": 0.5, "limit_train_batches": TRAIN_STEPS,
                    "limit_val_batches": VAL_STEPS, "remat": False},
        "callbacks": {
            "multistage": {"unfreeze_epoch": 1, "lr_reduce_epoch": None},
            "model_checkpoint": {"monitor": "val/dice", "mode": "max",
                                 "dirpath": "checkpoints/"},
            "early_stopping": {"monitor": "val/dice", "patience": 200},
        },
        "logger": {"kind": "csv", "save_dir": "metrics"},
    }


def _train_group(event, launched_in) -> str:
    name = event.get("name", "")
    low = name.lower()
    if event.get("cat") != "kernel":
        return "copies"
    group = port_kernel_group(name)
    if group is not None:
        return group
    if launched_in == "edt":
        return "EDT"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer"
    if any(k in low for k in ("conv", "cudnn", "xmma", "gemm", "cutlass", "winograd", "sm90")):
        return "conv/GEMM library"
    return "elementwise, reductions"


def profile_train_step(trainer, host_batch, card: str) -> None:
    """torch.profiler over one training batch as the data module feeds it
    (upload, augment, EDT) and one train step; device time by group and
    the device's idle share. Kernels are told apart by name, and the EDT's
    by the host range they were launched in."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from deadtrees_tpu_torch.data.augment import augment_batch
    from deadtrees_tpu_torch.losses import batch_one_hot2dist, class2one_hot

    gen = torch.Generator().manual_seed(SEED + 10)

    def one_batch():
        with record_function("augment"):
            dev = {k: host_batch[k].cuda(non_blocking=True) for k in ("image", "mask")}
            out = augment_batch(gen, dev["image"], dev["mask"])
        with record_function("edt"):
            out["distmap"] = batch_one_hot2dist(class2one_hot(out["mask"], 3))
        with record_function("train_step"):
            trainer.train_step(trainer.state, out, 1)

    one_batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_batch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    path = REPO / "build" / "chip_smoke" / "trace_train_step.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}

    def launched_in(kernel):
        rt = launch.get(kernel.get("args", {}).get("correlation"))
        if rt is None:
            return None
        for r in ranges:
            if r["tid"] == rt["tid"] and r["ts"] <= rt["ts"] <= r["ts"] + r["dur"]:
                return r["name"]
        return None

    groups = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            g = _train_group(e, launched_in(e))
            groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3
    if not groups:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy = sum(groups.values())
    parts = "; ".join(f"{g} {ms:.3f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
    log(f"train step profile (bs {TRAIN_BS}, {IMG}², bf16; upload + augment + EDT + one step) "
        f"on {card}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
        f"{1 - busy / wall:.1%}; ms by group: {parts}")


def phase_train(card: str) -> dict:
    """Fit the flagship, then the checks and timings of the training path.
    Returns the augment kernel's launches during the fit, the step time and
    the EDT time of one batch."""
    import csv

    import torch

    from deadtrees_tpu_torch.infer import TorchInference
    from deadtrees_tpu_torch.losses import batch_one_hot2dist, class2one_hot
    from deadtrees_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from deadtrees_tpu_torch.train import Trainer
    from deadtrees_tpu_torch.train.steps import bn_buffers

    root = REPO / "build" / "chip_smoke" / "train"
    t0 = time.perf_counter()
    write_train_shards(root / "data")
    log(f"train shards: 2 x 32 train + 32 val samples of {IMG}² RGBN TIFF written in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = train_config(root / "data")
    trainer = Trainer(cfg, work_dir=root / "run")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = trainer.fit()
    fit_s = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = trainer.state.step
    with open(root / "run" / "metrics" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    log(f"fit: {len(rows)} epochs, {steps} train steps + {VAL_STEPS} val batches an epoch in "
        f"{fit_s:.2f} s (build and first-step warm-up included); launches {counts}; peak "
        f"memory {peak / 2**30:.2f} GiB; remat {cfg['trainer']['remat']}")
    for r in rows:
        log(f"  epoch {int(float(r['epoch']))}: train loss {float(r['train/total_loss']):.4f} "
            f"(dice {float(r['train/dice_loss']):.4f}, focal {float(r['train/focal_loss']):.4f}, "
            f"boundary {float(r['train/boundary_loss']):.4f}), grad norm "
            f"{float(r['train/grad_norm']):.4f}, val loss {float(r['val/total_loss']):.4f}, "
            f"val dice {float(r['val/dice']):.4f}, {float(r['steps_per_sec']):.3f} steps/s")
        losses = [float(r[k]) for k in r if k.endswith("_loss")]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite losses in epoch {r['epoch']}: {r}")
    if steps != 2 * TRAIN_STEPS or counts[AUGMENT] != steps:
        raise AssertionError(f"augment launches {counts[AUGMENT]} for {steps} train batches")
    if any(counts[k] for k in REPLACES):
        raise AssertionError(f"the train path launched the fused decoder: {counts}")

    engine = TorchInference(result["best_ckpt"], fused_decoder="auto")
    tile = np.random.default_rng(SEED).integers(0, 256, (1, IMG, IMG, 4), dtype=np.uint8)
    classes = engine.run(tile)
    if classes.shape != (1, IMG, IMG) or classes.dtype != np.uint8 or classes.max() > 2:
        raise AssertionError(f"best checkpoint served {classes.shape} {classes.dtype}")
    log(f"best checkpoint {Path(result['best_ckpt']).name} served by TorchInference: "
        f"classes {np.bincount(classes.ravel(), minlength=3).tolist()}")
    del engine

    dm = trainer.datamodule
    gen = torch.Generator().manual_seed(SEED + 11)
    with contextlib.closing(dm.train_batches(gen)) as batches:
        batch = next(batches)
    batch.pop("files")
    batch.pop("lu", None)
    losses, times = [], []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = trainer.train_step(trainer.state, batch, 1)
        losses.append(float(m["total_loss"]))
        times.append(time.perf_counter() - t0)
    log(f"8 steps on one repeated batch: total loss {' '.join(f'{v:.4f}' for v in losses)}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall on a repeated batch: {losses}")
    step_ms = statistics.median(times[1:]) * 1e3
    log(f"train step (host clock, synchronized, median of steps 2-8) on {card}: "
        f"{step_ms:.3f} ms, {TRAIN_BS * 1e3 / step_ms:.2f} samples/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    mask = batch["mask"]
    edt_ms = cuda_time_ms(lambda: batch_one_hot2dist(class2one_hot(mask, 3)), reps=5, warmup=1)
    log(f"distance maps (EDT) for one batch ({TRAIN_BS} x 3 classes x {IMG}²), CUDA events, "
        f"median of 5: {edt_ms:.3f} ms")

    bad = dict(batch)
    bad["image"] = batch["image"].clone()
    bad["image"][0, 0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt = trainer.state.optimizer
    moments, count = [t.clone() for t in opt.mu + opt.nu], opt.count.clone()
    n_bn = len(bn_buffers(trainer.model))
    step0 = trainer.state.step
    _, m = trainer.train_step(trainer.state, bad, 1)
    if np.isfinite(float(m["total_loss"])) or trainer.state.step != step0 + 1:
        raise AssertionError("the NaN batch gave a finite loss or did not tick the step")
    changed = [k for k, v in trainer.model.state_dict().items() if not torch.equal(v, before[k])]
    if changed or not torch.equal(opt.count, count) or not all(
            torch.equal(a, b) for a, b in zip(opt.mu + opt.nu, moments)):
        raise AssertionError(f"a NaN batch changed the state: {changed[:5]}")
    log(f"NaN batch: loss {float(m['total_loss'])}; parameters, {n_bn} BN buffers and the "
        "Adam state unchanged, step ticked")

    profile_train_step(trainer, _one_host_batch(dm), card)
    return {"launches": counts[AUGMENT], "step_ms": step_ms, "edt_ms": edt_ms}


def _one_host_batch(dm) -> dict:
    """One pinned uint8 host batch as the data module's producer makes it."""
    from deadtrees_tpu_torch.data.pipeline import _BatchProducer
    from deadtrees_tpu_torch.data.tar import make_sample_stream

    producer = _BatchProducer(make_sample_stream(dm.train_shards), dm.cfg.batch_size,
                              dm.cfg, pin=True)
    try:
        return next(iter(producer))
    finally:
        producer.stop()


# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------


def _device_busy_ms(events) -> tuple:
    """(union of the device's busy intervals, ms by kind) over a trace's
    kernel, copy and memset events; the union counts a copy that overlaps
    a kernel on another stream once."""
    spans, kinds = [], {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        name = e.get("name", "")
        kind = ("H2D" if "HtoD" in name else "D2H" if "DtoH" in name
                else "kernels" if e["cat"] == "kernel" else "other copies")
        kinds[kind] = kinds.get(kind, 0.0) + e["dur"] / 1e3
        spans.append((e["ts"], e["ts"] + e["dur"]))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, kinds


def _geo_tags(x0: float, y0: float) -> dict:
    return {33550: (SCENE_PX, SCENE_PX, 0.0), 33922: (0.0, 0.0, 0.0, x0, y0, 0.0),
            34737: "ETRS89 / UTM 32N|"}


def phase_scenes(path: Path, hp, plain, plain_bs128_ms: float, card: str) -> dict:
    """The scene path (the fourth main path): ``predict_scene`` on a
    ragged scene against the plain model over the same chunk,
    ``predict_scenes`` against per-scene calls, its throughput, idle share
    and time split, the ensemble, and the scene CLI end to end. Returns
    the numbers for the scenes line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deadtrees_tpu_torch.core import save_checkpoint
    from deadtrees_tpu_torch.data import normalize
    from deadtrees_tpu_torch.geo import retile
    from deadtrees_tpu_torch.infer import (
        EnsembleInference,
        Tiler,
        make_blocks_nhwc,
        make_scene_predictor,
        predict_scene,
        predict_scenes,
        unmake_blocks_nhwc,
        unpack2,
    )
    from deadtrees_tpu_torch.infer import scene as scene_cli
    from deadtrees_tpu_torch.infer.geotiff import GEO_TAGS, GeoImage, read_geotiff, write_geotiff
    from deadtrees_tpu_torch.models import create_model, init_model, variables_from_state_dict

    t_phase = time.perf_counter()
    model = plain.model
    tile = (SCENE, SCENE)
    kw = dict(tile_shape=tile, subtile=IMG, batch_size=SCENE_BS)
    rng = np.random.default_rng(SEED + 30)
    out = {"plain_bs128_ms": plain_bs128_ms}

    # a ragged scene: the predictor's raw map is the plain model's argmax
    # over the same 128-subtile chunk, masked; subtiles beyond the scene are 0
    h, w = SCENE_RAGGED
    scene = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    tiler = Tiler(tile_shape=tile, subtile_shape=(IMG, IMG))
    tiler.load_array(scene)
    valid = tiler.subtiles_to_use
    raw_fn = make_scene_predictor(model, subtile=IMG, batch_size=SCENE_BS)
    raw = raw_fn(torch.from_numpy(tiler._indata), torch.from_numpy(valid)).cpu().numpy()
    blocks = make_blocks_nhwc(torch.from_numpy(tiler._indata).cuda(), IMG)
    n = blocks.shape[0]
    chunk = torch.cat([blocks, blocks.new_zeros((SCENE_BS - n,) + blocks.shape[1:])])
    with torch.no_grad():
        x = normalize(chunk.float(), plain.mean, plain.std).permute(0, 3, 1, 2).contiguous()
        ref = model(x).argmax(1).to(torch.uint8)[:n]
    ref = ref * torch.from_numpy(valid).cuda().to(torch.uint8)[:, None, None]
    ref = unmake_blocks_nhwc(ref, *tile).cpu().numpy()
    del blocks, chunk, x
    rows = -(-h // IMG)
    assert int(valid.sum()) == rows * (-(-w // IMG)) < n, valid
    if not np.array_equal(raw, ref):
        raise AssertionError(f"scene predictor vs the plain model's argmax: "
                             f"{int((raw != ref).sum())} pixels differ")
    assert not raw[rows * IMG:].any() and raw[:h, :w].any()
    got = predict_scene(model, scene, **kw)
    assert got.shape == (h, w) and np.array_equal(got, raw[:h, :w])
    eng = plain.run(tiler.get_all_batches())  # bs 16, argmax of the softmax
    tiler.put_all_batches(eng * valid[:, None, None])
    agree = float((tiler.prediction == got).mean())
    out["ragged_agreement"] = agree
    log(f"scene {h}x{w} in a {SCENE}² tile (bs {SCENE_BS}, {int(valid.sum())} of {n} "
        f"subtiles valid): predictor equal to the plain model's argmax over the same "
        f"chunk, {n - int(valid.sum())} padding subtiles zero; agreement with "
        f"TorchInference.run at bs {n}: {agree:.6f} (bar {AGREE_BF16})")
    assert agree >= AGREE_BF16, agree

    # 17 scenes: two full groups of 8 and a tail of 1, each equal to its own call
    stack = rng.integers(0, 256, (17,) + tile + (4,), dtype=np.uint8)
    scenes = list(stack)
    t0 = time.perf_counter()
    batched = predict_scenes(model, scenes, **kw)
    t_batched = time.perf_counter() - t0
    packed_fn = make_scene_predictor(model, subtile=IMG, batch_size=SCENE_BS, packed=True)
    for i, sc in enumerate(scenes):
        single = predict_scene(model, sc, predictor=packed_fn, **kw)
        if not np.array_equal(batched[i], single):
            raise AssertionError(f"predict_scenes vs predict_scene, scene {i}: "
                                 f"{int((batched[i] != single).sum())} pixels differ")
    log(f"predict_scenes on 17 scenes of {SCENE}² (groups 8, 8, 1 + 7 zero scenes) "
        f"equal to 17 predict_scene calls; {t_batched:.3f} s (first call)")
    np.save(DP_MAPS, np.stack(batched[:DP_SCENES]))  # phase 18 holds its sharded maps to these
    del batched

    # throughput: 16 scenes, median of 3 after a warm-up
    scenes = scenes[:16]
    tiles = 16 * (SCENE // IMG) ** 2
    predict_scenes(model, scenes, **kw)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_scenes(model, scenes, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    out.update(scene_tiles_per_s=tiles / wall, scenes_per_s=16 / wall, wall_ms=wall * 1e3,
               plain_rate=SCENE_BS * 1e3 / plain_bs128_ms)
    out["rate_vs_plain"] = out["scene_tiles_per_s"] / out["plain_rate"]
    trace = REPO / "build" / "chip_smoke" / "trace_scenes.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict_scenes(model, scenes, **kw)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace))
    busy, kinds = _device_busy_ms(json.loads(trace.read_text())["traceEvents"])
    if not kinds:
        raise RuntimeError("torch.profiler recorded no device activity")
    out.update(idle_share=1 - busy / prof_wall, profiled_wall_ms=prof_wall,
               device_ms_by_kind=kinds)

    # the time split of one dispatch of 8 scenes, each part alone
    g = SCENE_BS // (SCENE // IMG) ** 2
    pinned = torch.empty((g,) + tile + (4,), dtype=torch.uint8, pin_memory=True)
    t0 = time.perf_counter()
    for j in range(g):
        pinned[j].numpy()[:] = scenes[j]
    stage_ms = (time.perf_counter() - t0) * 1e3
    valid8 = torch.ones((g, (SCENE // IMG) ** 2), dtype=torch.bool, device="cuda")
    dev = pinned.cuda()
    h2d_ms = cuda_time_ms(lambda: dev.copy_(pinned, non_blocking=True), reps=5, warmup=1)
    fwd_ms = cuda_time_ms(lambda: packed_fn(dev, valid8), reps=3, warmup=1)
    packed = packed_fn(dev, valid8)
    host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
    d2h_ms = cuda_time_ms(lambda: host.copy_(packed, non_blocking=True), reps=5, warmup=1)
    t0 = time.perf_counter()
    for j in range(g):
        unpack2(host[j].numpy(), SCENE)
    unpack_ms = (time.perf_counter() - t0) * 1e3
    del dev, packed, pinned, host
    out["split_ms_per_dispatch"] = dict(stage=stage_ms, h2d=h2d_ms, forward=fwd_ms,
                                        d2h=d2h_ms, unpack=unpack_ms)
    serial = 2 * (stage_ms + h2d_ms + fwd_ms + d2h_ms + unpack_ms)
    log(f"scene throughput on {card}: 16 scenes of {SCENE}² at bs {SCENE_BS} (2 "
        f"dispatches of {g}): {wall * 1e3:.3f} ms (median of 3 after a warm-up; "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times)}), {out['scene_tiles_per_s']:.3f} "
        f"tiles of {IMG}²/s, {out['scenes_per_s']:.3f} scenes/s; the plain engine's bs "
        f"{SCENE_BS} (phase 11, {plain_bs128_ms:.3f} ms) gives {out['plain_rate']:.3f} "
        f"tiles/s: ratio {out['rate_vs_plain']:.4f}")
    log(f"  profile of one 16-scene call: wall {prof_wall:.3f} ms, device busy (union) "
        f"{busy:.3f} ms, idle {out['idle_share']:.2%}; device ms by kind: "
        + "; ".join(f"{k} {v:.3f}" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))
    log(f"  split of one dispatch of {g} scenes, each part alone: host staging into "
        f"pinned memory {stage_ms:.3f} ms, H2D {h2d_ms:.3f} ms, forward (blocks, "
        f"normalize, model, argmax, mask, stitch, pack) {fwd_ms:.3f} ms, D2H "
        f"{d2h_ms:.3f} ms, host unpack {unpack_ms:.3f} ms; two dispatches one after "
        f"another would take {serial:.3f} ms against {wall * 1e3:.3f} ms measured")

    # the ensemble: 3 x A equals A's argmax; A, A, B equals A; an even N raises
    img = rng.integers(0, 256, (4, IMG, IMG, 4), dtype=np.uint8)
    ens = EnsembleInference([path] * 3)
    assert ens.homogeneous and len(ens.models) == 3
    with torch.no_grad():
        x = normalize(torch.from_numpy(img).cuda().float(), plain.mean, plain.std)
        one = model(x.permute(0, 3, 1, 2).contiguous()).argmax(1).to(torch.uint8).cpu().numpy()
    voted = ens.run(img)
    assert np.array_equal(voted, one), int((voted != one).sum())
    del ens
    hp_b = dict(hp, decoder_channels=[128, 64, 32, 16, 16])
    other = init_model(create_model(**hp_b), generator=torch.Generator().manual_seed(SEED + 1))
    ckpt_b = path.with_name("flagship_b5_b.ckpt")
    save_checkpoint(ckpt_b, **variables_from_state_dict(other.state_dict()), hparams=hp_b)
    del other
    ens = EnsembleInference([path, path, ckpt_b])
    assert not ens.homogeneous
    mixed = ens.run(img)
    assert np.array_equal(mixed, plain.run(img)), int((mixed != plain.run(img)).sum())
    del ens
    try:
        EnsembleInference([path] * 2)
    except ValueError:
        pass
    else:
        raise AssertionError("an ensemble of 2 did not raise")
    log(f"ensemble at bs 4: 3 x flagship equal to one member's argmax; flagship, "
        f"flagship and a b5 with decoder {hp_b['decoder_channels']} (seed {SEED + 1}) "
        f"equal to the flagship's TorchInference; 2 members raise")

    # the CLI end to end: retile a 4096² GeoTIFF, add an empty tile, predict
    # every tile, mosaic; then one 3-checkpoint run on one tile
    work = path.parent / "scene_cli"
    if work.exists():
        shutil.rmtree(work)
    tiles_dir, out_dir = work / "tiles", work / "pred"
    work.mkdir(parents=True)
    src_tags = _geo_tags(SCENE_X0, SCENE_Y0)
    src = work / "ortho_src.tif"
    big = rng.integers(2, 256, (2 * SCENE, 2 * SCENE, 4), dtype=np.uint8)
    t0 = time.perf_counter()
    write_geotiff(src, big, {"tags": src_tags}, compress="none")
    records = retile(src, tiles_dir, tile_size=SCENE)
    assert len(records) == 4, records
    write_geotiff(tiles_dir / "ortho_zero.tif", np.zeros(tile + (4,), np.uint8),
                  {"tags": _geo_tags(SCENE_X0 - SCENE * SCENE_PX, SCENE_Y0)})
    t_retile = time.perf_counter() - t0
    mosaic = work / "mosaic.tif"
    torch.cuda.empty_cache()  # the CLI's process needs the card's memory
    cmd = [sys.executable, "-m", "deadtrees_tpu_torch.infer.scene", str(tiles_dir),
           str(path), "--all", "--outpath", str(out_dir), "--mosaic", str(mosaic)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"scene CLI failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    assert "skip empty scene: ortho_zero.tif" in res.stdout, res.stdout
    assert not (out_dir / "ortho_zero.tif").exists()
    names = sorted(r["filename"] for r in records)
    inputs = [read_geotiff(tiles_dir / nm) for nm in names]
    want = predict_scenes(model, [t.data for t in inputs], **kw)
    for nm, inp, wmap in zip(names, inputs, want):
        outp = read_geotiff(out_dir / nm)
        if not np.array_equal(outp.data[..., 0], wmap):
            raise AssertionError(f"CLI output {nm} differs from predict_scenes in "
                                 f"{int((outp.data[..., 0] != wmap).sum())} pixels")
        assert outp.geo["tags"] == inp.geo["tags"] and set(outp.geo["tags"]) <= set(GEO_TAGS)
    m = read_geotiff(mosaic)
    assert m.data.shape[:2] == (2 * SCENE, 2 * SCENE), m.data.shape
    assert m.bounds == GeoImage(big, {"tags": src_tags}).bounds, m.bounds
    whole = np.block([[want[0], want[1]], [want[2], want[3]]])
    assert np.array_equal(m.data[..., 0], whole)
    ens_out = work / "pred_ens"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        scene_cli.main([str(tiles_dir / names[0]), str(path), str(path), str(path),
                        "--outpath", str(ens_out)])
    t_ens = time.perf_counter() - t0
    assert f"wrote {ens_out / names[0]}" in printed.getvalue(), printed.getvalue()
    voted = read_geotiff(ens_out / names[0]).data[..., 0]
    ens_agree = float((voted == want[0]).mean())
    assert ens_agree >= AGREE_BF16, ens_agree
    out.update(cli_s=t_cli, cli_ensemble_s=t_ens, cli_ensemble_agreement=ens_agree)
    log(f"scene CLI: retiled a {2 * SCENE}² GeoTIFF into {len(records)} tiles + 1 empty "
        f"({t_retile:.2f} s); the CLI skipped the empty one, wrote {len(names)} maps equal "
        f"to predict_scenes with their tags, and a {2 * SCENE}² mosaic with the source's "
        f"bounds, in {t_cli:.2f} s (a process of its own); 3 checkpoints on one tile "
        f"(the CLI's main() in this process, {t_ens:.2f} s) agree with the single "
        f"checkpoint's map {ens_agree:.6f}")
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13
# ---------------------------------------------------------------------------


def recipe_overrides(data: Path, run_dir: Path) -> list:
    """The recipe of record (``configs/`` with
    ``experiment=flagship_b5_multistage``: b5, bs 16, bf16, lr 3e-4) cut to
    4 epochs of 4 train and 2 val batches, its stages brought forward."""
    return ["experiment=flagship_b5_multistage", f"data_dir={data}", f"run_dir={run_dir}",
            f"logger.save_dir={run_dir / 'metrics'}", f"trainer.max_epochs={RECIPE_EPOCHS}",
            f"trainer.limit_train_batches={TRAIN_STEPS}",
            f"trainer.limit_val_batches={VAL_STEPS}", "callbacks.multistage.unfreeze_epoch=1",
            "callbacks.multistage.lr_reduce_epoch=2", "callbacks.swa.swa_epoch_start=2",
            "print_config=false"]


def _cli(args, out: Path) -> subprocess.Popen:
    """``python -m deadtrees_tpu_torch`` in a process of its own, its
    output to ``out``.out / .err."""
    return subprocess.Popen(
        [sys.executable, "-m", "deadtrees_tpu_torch", *args], cwd=REPO,
        stdout=open(out.with_suffix(".out"), "w"), stderr=open(out.with_suffix(".err"), "w"))


def _cli_result(out: Path) -> dict:
    """The dict the CLI printed last (``nan`` read as None)."""
    import ast

    line = out.with_suffix(".out").read_text().strip().splitlines()[-1]
    return ast.literal_eval(re.sub(r"\bnan\b", "None", line))


def _cm_pixels(out: Path) -> int:
    m = re.search(r"CM - DEFAULT - PIXEL:\s*(\[\[.*?\]\])", out.with_suffix(".err").read_text(),
                  re.S)
    if m is None:
        raise AssertionError(f"no confusion matrix in {out.with_suffix('.err')}")
    return sum(int(v) for v in re.findall(r"\d+", m.group(1)))


def _stop_split(out: Path, t_sig: float) -> dict:
    """Seconds from SIGTERM (wall clock ``t_sig``) to the child's log lines
    of the trap, the stop at a step boundary and the checkpoints on disk."""
    import datetime

    marks = {"handler": "SIGTERM: stopping", "step boundary": "Stop requested",
             "checkpoints on disk": "Preempted: the checkpoints"}
    split = {}
    for line in out.with_suffix(".err").read_text().splitlines():
        for name, text in marks.items():
            if text in line and name not in split:
                stamp = datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f")
                split[name] = stamp.timestamp() - t_sig
    return split


def _equal_trees(got, want, where: str) -> int:
    """Bit-equality of two nested dicts of arrays; returns the leaf count."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{where}: keys {sorted(got)[:4]} != {sorted(want)[:4]}")
    n = 0
    for k in want:
        if isinstance(want[k], dict):
            n += _equal_trees(got[k], want[k], f"{where}/{k}")
        elif not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
            raise AssertionError(f"{where}/{k} differs from the file")
        else:
            n += 1
    return n


def phase_recipe(card: str) -> dict:
    """The recipe through the CLI and ``train()``: preemption, a resume
    bit-equal on load, MultiStage, SWA, the test after training, eval with
    and without TTA. Returns the numbers for the recipe line."""
    import csv
    import importlib.util

    import torch

    from deadtrees_tpu_torch.config import compose
    from deadtrees_tpu_torch.core import load_checkpoint, save_checkpoint, snapshot
    from deadtrees_tpu_torch.core.checkpoint import _build_payload, _encode
    from deadtrees_tpu_torch.core.msgpack_codec import unpackb
    from deadtrees_tpu_torch.data.pipeline import DeadtreesDataModule
    from deadtrees_tpu_torch.infer import TorchInference
    from deadtrees_tpu_torch.models import variables_from_state_dict
    from deadtrees_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from deadtrees_tpu_torch.train import Trainer, optimizer_state_dict, train

    t_phase = time.perf_counter()
    root = REPO / "build" / "chip_smoke" / "recipe"
    if root.exists():
        shutil.rmtree(root)
    data = root / "data"
    t0 = time.perf_counter()
    write_train_shards(data, test=RECIPE_TEST)
    out = {"shards_s": time.perf_counter() - t0}
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    log(f"recipe shards: 64 train, 32 val, {RECIPE_TEST} test tiles of {IMG}² written in "
        f"{out['shards_s']:.2f} s; matplotlib {'present' if has_mpl else 'absent'}")

    # run A: the CLI, preempted by SIGTERM once epoch 0 is checkpointed
    run_a = root / "runA"
    run_a.mkdir(parents=True)
    proc = _cli(["train", *recipe_overrides(data, run_a)], root / "runA")
    t_start = time.perf_counter()
    try:
        while True:
            found = sorted(run_a.glob("*/*/checkpoints/last.ckpt"))
            if found or proc.poll() is not None or time.perf_counter() - t_start > 600:
                break
            time.sleep(0.05)
        if not found:
            raise RuntimeError(f"run A wrote no last.ckpt (exit {proc.poll()}):\n"
                               + (root / "runA.err").read_text()[-4000:])
        t_epoch0 = time.perf_counter() - t_start
        t_sig_wall = time.time()
        proc.send_signal(signal.SIGTERM)
        t_sig = time.perf_counter()
        rc = proc.wait(timeout=300)
        out["sigterm_to_exit_s"] = time.perf_counter() - t_sig
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    last_a = found[0]
    res_a = _cli_result(root / "runA")
    ckpt_a = load_checkpoint(last_a)
    if rc != 0 or res_a.get("preempted") != 1.0 or int(ckpt_a["epoch"]) != 0 \
            or "opt_state" not in ckpt_a:
        raise AssertionError(f"run A: exit {rc}, result {res_a}, last.ckpt epoch "
                             f"{int(ckpt_a['epoch'])}, opt_state {'opt_state' in ckpt_a}")
    out.update(run_a_to_epoch0_ckpt_s=t_epoch0, ckpt_bytes=last_a.stat().st_size,
               run_a_step=int(ckpt_a["step"]),
               sigterm_split_s=_stop_split(root / "runA", t_sig_wall))
    log(f"run A (CLI): epoch 0's last.ckpt after {t_epoch0:.2f} s (process start, build and "
        f"the first epoch); SIGTERM to exit {out['sigterm_to_exit_s']:.3f} s, exit 0, "
        f"preempted; last.ckpt epoch 0, step {out['run_a_step']}, {out['ckpt_bytes']} bytes "
        "with the Adam state; after SIGTERM, by the child's log clock: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in out["sigterm_split_s"].items()))

    # run B: resume in this process, bit-equal on load, then the rest
    class CheckedTrainer(Trainer):
        def resume(self, path):
            start = super().resume(path)
            ckpt = load_checkpoint(path)
            held = variables_from_state_dict(self.model.state_dict())
            n = _equal_trees(held["params"], ckpt["params"], "params")
            n += _equal_trees(held["batch_stats"], ckpt["batch_stats"], "batch_stats")
            opt = snapshot(optimizer_state_dict(self.state.optimizer, self.model))
            n += _equal_trees(opt, unpackb(ckpt["opt_state"]), "opt_state")
            self.checked_leaves = n
            return start

    run_b = root / "runB"
    cfg = compose(REPO / "configs", overrides=recipe_overrides(data, run_b)
                  + [f"trainer.resume_from_checkpoint={last_a}"])
    trainer = CheckedTrainer(cfg, work_dir=run_b)
    finish = DeadtreesDataModule._finish_batch
    mapped = []  # one entry a finished batch (train, val, recalibration, test) that got maps

    def counted(self, *args, **kwargs):
        batch = finish(self, *args, **kwargs)
        if "distmap" in batch:
            mapped.append(1)
        return batch

    reset_launch_counts()
    DeadtreesDataModule._finish_batch = counted
    try:
        result = train(cfg, work_dir=run_b, trainer=trainer)
    finally:
        DeadtreesDataModule._finish_batch = finish
    counts = dict(LAUNCHES)
    steps = trainer.state.step - out["run_a_step"]
    lr = cfg["model"]["training"]["learning_rate"]
    stage = trainer.state.optimizer.schedule(0) / lr
    with open(run_b / "metrics" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    epochs = [int(float(r["epoch"])) for r in rows]
    if epochs != list(range(1, RECIPE_EPOCHS)) or steps != (RECIPE_EPOCHS - 1) * TRAIN_STEPS:
        raise AssertionError(f"run B: epochs {epochs}, {steps} steps")
    if counts[AUGMENT] != steps + trainer.swa_bn_batches:
        raise AssertionError(f"augment launches {counts[AUGMENT]} for {steps} train steps and "
                             f"{trainer.swa_bn_batches} recalibration batches")
    if counts["edt_columns"] != len(mapped) or counts["edt_rows"] != len(mapped) \
            or len(mapped) < steps + trainer.swa_bn_batches:
        raise AssertionError(f"EDT launches {counts} for {len(mapped)} batches with maps "
                             f"({steps} train steps, {trainer.swa_bn_batches} recalibration "
                             "batches and the val and test batches): expected 1 + 1 a batch")
    if any(v for k, v in counts.items() if k not in (AUGMENT, *EDT_KERNELS)):
        raise AssertionError(f"the recipe launched another kernel: {counts}")
    if abs(stage - 1 / 3) > 1e-9 or int(trainer.state.optimizer.count) != 2 * TRAIN_STEPS:
        raise AssertionError(f"the stage at the end: lr x {stage}, count "
                             f"{trainer.state.optimizer.count}")
    tests = {k: v for k, v in result.items() if k.startswith("test/")}
    if "swa_ckpt" not in result or len(tests) != 6 or not all(
            v is not None and np.isfinite(v) for v in tests.values()):
        raise AssertionError(f"run B result {result}")
    figures = sorted(p.name for p in (run_b / "figures").glob("*.png"))
    if has_mpl and len(figures) != 2 * (RECIPE_EPOCHS - 1):
        raise AssertionError(f"figures {figures}")
    if not has_mpl and figures:
        raise AssertionError(f"figures without matplotlib: {figures}")
    out.update(
        launches=counts[AUGMENT], train_steps=steps, swa_bn_batches=trainer.swa_bn_batches,
        edt_columns=counts["edt_columns"], edt_rows=counts["edt_rows"], edt_batches=len(mapped),
        resume_checked_leaves=trainer.checked_leaves,
        resume_load_s=trainer.timings["resume_s"][0],
        epochs=[{"epoch": e, "wall_s": w, "steps_per_s": float(r["steps_per_sec"]),
                 "train_loss": float(r["train/total_loss"]), "val_dice": float(r["val/dice"])}
                for e, w, r in zip(epochs, trainer.timings["epoch_s"], rows)],
        save_loop_s=trainer.timings["save_s"], swa_recal_s=trainer.timings["swa_recal_s"][0],
        figures=len(figures), matplotlib=has_mpl, test=tests,
        test_tiles_per_s=RECIPE_TEST / trainer.timings["test_s"][0])
    log(f"run B (train() in this process, resumed at epoch 1 from run A): {out['resume_checked_leaves']} "
        f"leaves (parameters, BN statistics, mu, nu, counts) bit-equal to the file on load "
        f"in {out['resume_load_s']:.3f} s; {steps} train steps + {trainer.swa_bn_batches} SWA "
        f"recalibration batches = {counts[AUGMENT]} augment launches; {len(mapped)} batches "
        f"with distance maps (train, val, recalibration, test) = {counts['edt_columns']} + "
        f"{counts['edt_rows']} EDT launches; lr x {stage:.6f} and "
        f"count {trainer.state.optimizer.count} at the end (fresh Adam at epoch 2)")
    for e in out["epochs"]:
        log(f"  epoch {e['epoch']}: {e['wall_s']:.3f} s wall (train, val, save), "
            f"{e['steps_per_s']:.3f} steps/s, train loss {e['train_loss']:.4f}, "
            f"val dice {e['val_dice']:.4f}")
    log(f"  checkpoint saves as the loop sees them (asynchronous): "
        f"{', '.join(f'{t:.3f}' for t in out['save_loop_s'])} s; SWA BN recalibration "
        f"({trainer.swa_bn_batches} batches) {out['swa_recal_s']:.3f} s; test after training "
        f"{out['test_tiles_per_s']:.2f} tiles/s; figures: "
        + (f"{len(figures)} written" if has_mpl else "skipped, matplotlib is absent"))

    # one save of each kind, timed from the loop's side
    kw = trainer._ckpt_kwargs(RECIPE_EPOCHS - 1)
    t0 = time.perf_counter()
    trainer._ckpt_writer.save(root / "async.ckpt", **kw)
    out["save_async_s"] = time.perf_counter() - t0
    trainer._ckpt_writer.wait()
    out["save_async_total_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_checkpoint(root / "sync.ckpt", **trainer._ckpt_kwargs(RECIPE_EPOCHS - 1))
    out["save_sync_s"] = time.perf_counter() - t0
    if (root / "sync.ckpt").stat().st_size != (root / "async.ckpt").stat().st_size:
        raise AssertionError("the asynchronous and synchronous files differ in size")
    # the writer thread's encode: buffers viewing the snapshot, against one
    # joined bytes object (the least a whole-file encode copies, GIL held)
    payload = _build_payload(**kw)
    t0 = time.perf_counter()
    chunks = _encode(payload)
    out["encode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    joined = b"".join(chunks)
    out["encode_join_s"] = time.perf_counter() - t0
    del kw, payload, chunks, joined
    tta = trainer.test(result["best_ckpt"], tta=8)
    out["test_tta8_tiles_per_s"] = RECIPE_TEST / trainer.timings["test_s"][-1]
    out["tta8_rate_ratio"] = out["test_tta8_tiles_per_s"] / out["test_tiles_per_s"]
    log(f"  one save of the final state ({(root / 'sync.ckpt').stat().st_size} bytes): the loop "
        f"waits {out['save_async_s']:.3f} s asynchronously ({out['save_async_total_s']:.3f} s "
        f"to the file on disk), {out['save_sync_s']:.3f} s synchronously; the encode "
        f"{out['encode_s']:.3f} s as buffers, {out['encode_join_s']:.3f} s more to join them "
        f"into one bytes object; test() with tta=8 "
        f"{out['test_tta8_tiles_per_s']:.2f} tiles/s, {out['tta8_rate_ratio']:.3f} of the "
        f"plain rate; test/dice {tests['test/dice']:.4f} plain, {tta['test/dice']:.4f} tta=8")

    for path in (result["swa_ckpt"], result["best_ckpt"]):
        engine = TorchInference(path)
        tile = np.random.default_rng(SEED + 40).integers(0, 256, (4, IMG, IMG, 4), dtype=np.uint8)
        classes = engine.run(tile)
        if classes.shape != (4, IMG, IMG) or classes.dtype != np.uint8 or classes.max() > 2:
            raise AssertionError(f"{path} served {classes.shape} {classes.dtype}")
        del engine
    log(f"swa.ckpt and {Path(result['best_ckpt']).name} served by TorchInference at bs 4")
    best = result["best_ckpt"]
    del trainer
    torch.cuda.empty_cache()  # the eval processes need the card's memory

    # run C: the eval CLI with and without tta=8
    evals = {}
    for name, extra in (("tta8", ["tta=8"]), ("plain", [])):
        t0 = time.perf_counter()
        proc = _cli(["eval", f"bestmodel={best}", *extra, *recipe_overrides(data, root / "runC")],
                    root / f"eval_{name}")
        rc = proc.wait(timeout=600)
        if rc != 0:
            raise RuntimeError(f"eval {name} failed ({rc}):\n"
                               + (root / f"eval_{name}.err").read_text()[-4000:])
        evals[name] = {"s": time.perf_counter() - t0, "metrics": _cli_result(root / f"eval_{name}"),
                       "cm_pixels": _cm_pixels(root / f"eval_{name}")}
    want_px = RECIPE_TEST * IMG * IMG
    for name, ev in evals.items():
        if sorted(ev["metrics"]) != sorted(tests) or ev["cm_pixels"] != want_px:
            raise AssertionError(f"eval {name}: {sorted(ev['metrics'])}, {ev['cm_pixels']} px")
    out["eval_cli"] = evals
    log(f"run C (eval CLI): tta=8 {evals['tta8']['s']:.2f} s, plain {evals['plain']['s']:.2f} s "
        f"(each a process of its own); both print the {len(tests)} test/* metrics over "
        f"{want_px} pixels; test/dice tta=8 {evals['tta8']['metrics']['test/dice']:.4f}, plain "
        f"{evals['plain']['metrics']['test/dice']:.4f} (run B's {tests['test/dice']:.4f})")
    shutil.rmtree(data)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13: {out['phase_s']:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 14
# ---------------------------------------------------------------------------

DECODE_SHARDS = 8
DECODE_SAMPLES = 64  # a shard
DECODE_THREADS = 4  # the recipe's num_workers (configs/datamodule/deadtrees_combo_*.yaml)
DATA_BATCHES = 12
DATA_FIT_STEPS = 8
MULTI_STEPS = 3
STRIP_ROWS = 16


def _tiff_deflate_pred2(arr: np.ndarray) -> bytes:
    """A TIFF of ``arr`` (H, W[, C]) uint8 in strips of ``STRIP_ROWS`` rows,
    deflate (zlib level 6) after the horizontal predictor 2, GDAL's default
    encoding of orthophotos; 4 bands carry unassociated alpha, as PIL's RGBA."""
    import struct
    import zlib

    a = arr if arr.ndim == 3 else arr[..., None]
    h, w, c = a.shape
    diff = a.astype(np.int16)
    diff[:, 1:] -= a[:, :-1]
    diff = diff.astype(np.uint8)
    strips = [zlib.compress(diff[y:y + STRIP_ROWS].tobytes(), 6) for y in range(0, h, STRIP_ROWS)]
    n = len(strips)
    tags = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, c, 8), (259, 3, 1, 8),
            (262, 3, 1, 2 if c > 1 else 1), (273, 4, n, 0), (277, 3, 1, c),
            (278, 3, 1, STRIP_ROWS), (279, 4, n, 0), (317, 3, 1, 2)]
    if c == 4:
        tags.append((338, 3, 1, 2))
    bits_at = 8 + 2 + 12 * len(tags) + 4
    offs_at = bits_at + 2 * c
    cnts_at = offs_at + 4 * n
    pos, offsets = cnts_at + 4 * n, []
    for strip in strips:
        offsets.append(pos)
        pos += len(strip)
    ifd = struct.pack("<H", len(tags))
    for tag, typ, count, value in tags:
        value = {258: value if c == 1 else bits_at, 273: offs_at, 279: cnts_at}.get(tag, value)
        ifd += struct.pack("<HHII", tag, typ, count, value)
    return (struct.pack("<2sHI", b"II", 42, 8) + ifd + struct.pack("<I", 0)
            + struct.pack(f"<{c}H", *[8] * c) + struct.pack(f"<{n}I", *offsets)
            + struct.pack(f"<{n}I", *map(len, strips)) + b"".join(strips))


def _decode_sample(i: int) -> tuple:
    """Sample ``i`` of the decode set: an RGBN tile of 8-pixel blocks plus
    4 bits of noise (deflate with the predictor compresses it about as it
    does an orthophoto), a mask of class rectangles, an lu layer."""
    rng = np.random.default_rng([SEED, 14, i])
    base = rng.integers(0, 240, (IMG // 8, IMG // 8, 4), dtype=np.uint8)
    img = np.repeat(np.repeat(base, 8, 0), 8, 1) + rng.integers(0, 16, (IMG, IMG, 4), np.uint8)
    mask = np.zeros((IMG, IMG), np.uint8)
    for cls in (1, 2):
        for y, x, h, w in rng.integers(0, IMG * 3 // 4, (3, 4)):
            mask[y:y + h % (IMG // 5) + IMG // 32, x:x + w % (IMG // 5) + IMG // 32] = cls
    lu = (rng.random((IMG, IMG)) > 0.3).astype(np.uint8)
    return img, mask, lu


def write_decode_shards(root: Path) -> None:
    """``DECODE_SHARDS`` shards of ``DECODE_SAMPLES`` tiles of 512² (RGBN,
    mask, lu), twice: uncompressed by PIL under ``plain/train`` and deflate
    with the predictor under ``deflate/train``. Sample keys are
    ``s{shard}_{index}``."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from deadtrees_tpu_torch.data.shardwriter import ShardWriter

    def encode(i):
        img, mask, lu = _decode_sample(i)
        key = f"s{i // DECODE_SAMPLES}_{i % DECODE_SAMPLES:04d}"
        txt = f"{float((mask > 0).mean() * 100):.2f}"
        plain = {"__key__": key, "rgbn.tif": _tiff(img, "RGBA"), "mask.tif": _tiff(mask, "L"),
                 "lu.tif": _tiff(lu, "L"), "txt": txt}
        deflate = {"__key__": key, "rgbn.tif": _tiff_deflate_pred2(img),
                   "mask.tif": _tiff_deflate_pred2(mask), "lu.tif": _tiff_deflate_pred2(lu),
                   "txt": txt}
        return plain, deflate

    writers = [ShardWriter(str(root / kind / "train" / "train-combo-%06d.tar"),
                           maxcount=DECODE_SAMPLES, write_pointers=False)
               for kind in ("plain", "deflate")]
    with ThreadPoolExecutor(os.cpu_count()) as pool, writers[0], writers[1]:
        for samples in pool.map(encode, range(DECODE_SHARDS * DECODE_SAMPLES)):
            for w, sample in zip(writers, samples):
                w.write(sample)
    for kind in ("plain", "deflate"):
        (root / kind / "val").mkdir()
        (root / kind / "test").mkdir()
        first = root / kind / "train" / "train-combo-000000.tar"
        (root / kind / "val" / first.name).symlink_to(first.resolve())


def _equal_samples(got, want, where: str) -> int:
    if len(got) != len(want) or not got:
        raise AssertionError(f"{where}: {len(got)} samples against {len(want)}")
    for g, w in zip(got, want):
        if g["stats"] != w["stats"] or sorted(g) != sorted(w) or not all(
                np.array_equal(g[k], w[k]) for k in ("image", "mask", "lu")):
            raise AssertionError(f"{where}: sample {w['stats']['file']} differs")
    return len(got)


def _stream_rate(shards, **kw) -> float:
    """Samples/s of one pass of ``make_sample_stream`` over ``shards``."""
    from deadtrees_tpu_torch.data.tar import make_sample_stream

    t0 = time.perf_counter()
    n = sum(1 for _ in make_sample_stream(shards, **kw))
    return n / (time.perf_counter() - t0)


def _data_module(splits: list, use_native: bool = True, **kw):
    """The recipe's datamodule (bs 16, 4 decode threads) over the
    [train, val, test] shard sources ``splits``."""
    from deadtrees_tpu_torch.data.pipeline import DataConfig, DeadtreesDataModule

    dm = DeadtreesDataModule(DataConfig(
        data_dir=[str(s) for s in splits], batch_size=TRAIN_BS, num_workers=DECODE_THREADS,
        use_native=use_native, seed=SEED, **kw))
    dm.setup()
    return dm


def _train_batch_rate(dm) -> float:
    """Batches/s of ``train_batches`` (decode, pinned upload, kernel 4, EDT)
    after its first batch, synchronized at the end."""
    import torch

    with contextlib.closing(dm.train_batches(torch.Generator().manual_seed(SEED))) as batches:
        next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DATA_BATCHES):
            next(batches)
        torch.cuda.synchronize()
        return DATA_BATCHES / (time.perf_counter() - t0)


def _short_fit(data: Path, work: Path, use_native: bool) -> dict:
    """``Trainer.fit()`` of the flagship recipe, one epoch of
    ``DATA_FIT_STEPS`` steps (unfrozen, as phase 8's step alone) and one
    val batch; its steps/s as the metrics file records it."""
    import csv

    from deadtrees_tpu_torch.train import Trainer

    cfg = train_config(data)
    cfg["datamodule"].update(num_workers=DECODE_THREADS, use_native=use_native)
    cfg["trainer"].update(max_epochs=1, limit_train_batches=DATA_FIT_STEPS,
                          limit_val_batches=1)
    cfg["callbacks"]["multistage"] = {"unfreeze_epoch": 0, "lr_reduce_epoch": None}
    t0 = time.perf_counter()
    trainer = Trainer(cfg, work_dir=work)
    trainer.fit()
    wall = time.perf_counter() - t0
    with open(work / "metrics" / "metrics.csv") as f:
        (row,) = list(csv.DictReader(f))
    if trainer.state.step != DATA_FIT_STEPS:
        raise AssertionError(f"the fit took {trainer.state.step} steps")
    return {"steps_per_s": float(row["steps_per_sec"]), "wall_s": wall}


def _multi_dataset_run(data: Path, run: Path, cut: list) -> dict:
    """``train datamodule=deadtrees_multi_datasets`` composed as the CLI
    composes it, 1 epoch of ``MULTI_STEPS`` steps and one val batch, the
    files of every batch recorded."""
    import torch

    from deadtrees_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from deadtrees_tpu_torch.train import Trainer, train
    from deadtrees_tpu_torch.train.entry import _compose

    overrides = ["datamodule=deadtrees_multi_datasets", f"data_dir={data}", f"run_dir={run}",
                 f"logger.save_dir={run / 'metrics'}", "trainer.max_epochs=1",
                 f"trainer.limit_train_batches={MULTI_STEPS}", "trainer.limit_val_batches=1",
                 "test_after_training=false", "print_config=false", f"seed={SEED}", *cut]
    cfg = _compose(overrides, REPO / "configs")
    files = {"train": [], "val": []}

    class RecordingTrainer(Trainer):
        def _build(self):
            super()._build()
            for split in files:
                batches = getattr(self.datamodule, f"{split}_batches")

                def recorded(*a, _batches=batches, _split=split, **k):
                    for b in _batches(*a, **k):
                        files[_split].append(list(b["files"]))
                        yield b

                setattr(self.datamodule, f"{split}_batches", recorded)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer = RecordingTrainer(cfg, work_dir=run)
    train(cfg, work_dir=run, trainer=trainer)
    return {"cfg": cfg["datamodule"], "files": files, "launches": LAUNCHES[AUGMENT],
            "steps": trainer.state.step, "wall_s": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


class _QuietHandler(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args) -> None:  # no line a request on stderr
        pass


def phase_data(card: str, train: dict) -> dict:
    """The training data path: decode rates, the train loop's data rate with
    the native reader on and off, the multi-dataset config, remote and
    cached shards. ``train`` holds phase 8's step and EDT times."""
    import functools
    import os
    import socketserver

    import torch

    from deadtrees_tpu_torch.data import native
    from deadtrees_tpu_torch.data.tar import (
        NATIVE_FALLBACKS,
        iter_tar_samples,
        make_sample_stream,
    )

    t_phase = time.perf_counter()
    root = REPO / "build" / "chip_smoke" / "data"
    if root.exists():
        shutil.rmtree(root)
    cores = os.cpu_count()
    out = {"cores": cores, "decode_threads": DECODE_THREADS}
    t0 = time.perf_counter()
    write_decode_shards(root)
    log(f"decode shards: 2 x {DECODE_SHARDS} x {DECODE_SAMPLES} tiles of {IMG}² (RGBN, mask, lu; "
        f"uncompressed and deflate + predictor 2) written in {time.perf_counter() - t0:.2f} s; "
        f"{cores} cores on the card's host")

    # 1. decode alone, on the card's host
    for kind in ("plain", "deflate"):
        shards = sorted(str(p) for p in (root / kind / "train").glob("*.tar"))
        mb = sum(Path(s).stat().st_size for s in shards) / 1e6
        half = shards[:len(shards) // 2]  # PIL's rate over half: the slow reader, the same rate
        rates = {"native_4": _stream_rate(shards, n_threads=DECODE_THREADS),
                 "pil": _stream_rate(half, prefer_native=False),
                 f"native_{cores}": _stream_rate(shards, n_threads=cores)}
        out[f"decode_{kind}"] = dict(rates, shard_mb=mb / len(shards))
        log(f"decode ({kind}, {mb / len(shards):.1f} MB a shard), samples/s of "
            f"make_sample_stream over {len(shards) * DECODE_SAMPLES} samples (PIL over "
            f"{len(half) * DECODE_SAMPLES}): " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
        extents = [g["rgbn.tif"] for g in native.index_shard_samples(shards[0]).values()]
        for threads in (DECODE_THREADS, cores):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                native.decode_batch(shards[0], extents, (IMG, IMG, 4), n_threads=threads)
                times.append(time.perf_counter() - t0)
            out[f"decode_batch_{kind}_{threads}_ms"] = statistics.median(times) * 1e3
        log(f"  native.decode_batch of one shard's {len(extents)} RGBN tiles of {IMG}² (read + "
            f"decode), median of 5: {out[f'decode_batch_{kind}_{DECODE_THREADS}_ms']:.2f} ms on "
            f"{DECODE_THREADS} threads, {out[f'decode_batch_{kind}_{cores}_ms']:.2f} ms on {cores}")
    one = [str(root / "plain" / "train" / "train-combo-000000.tar")]
    pil = list(make_sample_stream(one, prefer_native=False))
    n = _equal_samples(list(make_sample_stream(one)), pil, "native against PIL")
    n += _equal_samples(list(make_sample_stream([one[0].replace("plain", "deflate")])), pil,
                        "deflate decoded natively against PIL's uncompressed")
    log(f"native stream equal to the PIL stream, pixels and stats: {n} samples of 2 shards")

    # 2. the data path as the train loop sees it
    plain = root / "plain"
    rates = {}
    for use_native in (True, False, False, True):
        key = "native" if use_native else "pil"
        dm = _data_module([plain / "train", plain / "val", plain / "test"], use_native)
        rates.setdefault(key, []).append(_train_batch_rate(dm))
    out["train_batches_per_s"] = rates
    # phases 8 and 13 warmed the process up at these shapes (a first fit runs at
    # about half the rate: tools/time_data_path.py --fits)
    fits = {key: _short_fit(plain, root / f"fit_{key}", key == "native")
            for key in ("native", "pil")}
    out["fit"] = fits
    fit_rate = {k: v["steps_per_s"] for k, v in fits.items()}
    step_rate = 1e3 / train["step_ms"]
    edt_rate = 1e3 / train["edt_ms"]
    decode_rate = out["decode_plain"]["native_4"] / TRAIN_BS
    log(f"train_batches (bs {TRAIN_BS}: decode, pinned upload, kernel 4, EDT), batches/s in turns "
        f"native, PIL, PIL, native: {rates['native'][0]:.2f}, {rates['pil'][0]:.2f}, "
        f"{rates['pil'][1]:.2f}, {rates['native'][1]:.2f}")
    turns = ", ".join(f"{k} {v['steps_per_s']:.3f} ({v['wall_s']:.1f} s wall)"
                      for k, v in fits.items())
    log(f"fits of {DATA_FIT_STEPS} steps, steps/s of the metrics file: {turns}; beside: "
        f"the step alone {step_rate:.3f} steps/s (phase 8), the EDT alone {edt_rate:.2f} "
        f"batches/s, the native decode alone {decode_rate:.2f} batches/s on {DECODE_THREADS} "
        "threads")
    paces = {"decode": decode_rate, "EDT": edt_rate, "step": step_rate}
    pace = min(paces, key=paces.get)
    out["pace"] = pace
    # the card runs each batch's EDT before its step: together they cap the fit
    device_rate = 1e3 / (train["step_ms"] + train["edt_ms"])
    log(f"the epoch's pace is set by the {pace} ({paces[pace]:.3f} a second); with the EDT "
        f"before it on the card, {device_rate:.3f} steps/s at most; the fit reaches "
        f"{fit_rate['native'] / device_rate:.1%} of that natively, "
        f"{fit_rate['pil'] / device_rate:.1%} through PIL")

    # 3. the multi-dataset config at full width
    multi = root / "multi"
    multi.mkdir()
    names = ["train-balanced"] * 4 + ["train-negativesamples"] * 2 + ["train-randomsamples"] * 2
    for i, name in enumerate(names):
        src = plain / "train" / f"train-combo-{i:06d}.tar"
        (multi / f"{name}-{i % 4 if i < 4 else i % 2:06d}.tar").symlink_to(src)
    cut, run = [], None
    try:
        run = _multi_dataset_run(multi, root / "multi_run", cut)
    except torch.cuda.OutOfMemoryError as e:
        oom = str(e).splitlines()[0]
    if run is None:  # outside the handler: its traceback held the first run's tensors
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        cut = ["datamodule.batch_size=16", "datamodule.batch_size_extra=[1,7]"]
        log(f"multi-dataset at bs 32 did not fit ({oom}); cut to {cut}, the nearest split "
            "with the same shares")
        run = _multi_dataset_run(multi, root / "multi_run_cut", cut)
    bs, extra = run["cfg"]["batch_size"], run["cfg"]["batch_size_extra"]
    main_bs = bs - sum(extra)
    shard_of = {"train": ("s0", "s1", "s4", "s6"), "val": ("s2", "s5", "s7")}
    for split, batches in run["files"].items():
        groups = shard_of[split]
        want = [groups[:2] if split == "train" else groups[:1]] * main_bs + \
            [groups[-2:-1]] * extra[0] + [groups[-1:]] * extra[1]
        for files in batches:
            if len(files) != bs or not all(f.split("_")[0] in w for f, w in zip(files, want)):
                raise AssertionError(f"a {split} batch is not {main_bs} + {extra}: {files}")
    if run["steps"] != MULTI_STEPS or len(run["files"]["train"]) != MULTI_STEPS \
            or run["launches"] != MULTI_STEPS or not run["files"]["val"]:
        raise AssertionError(f"multi-dataset: {run['steps']} steps, kernel 4 launched "
                             f"{run['launches']} times, {len(run['files']['val'])} val batches")
    out["multi"] = {"batch_size": bs, "batch_size_extra": extra, "cut": cut,
                    "peak_gib": run["peak_gib"], "wall_s": run["wall_s"],
                    "launches": run["launches"]}
    log(f"multi-dataset (train datamodule=deadtrees_multi_datasets, b5, bf16, {IMG}²): bs {bs} = "
        f"{main_bs} + {' + '.join(map(str, extra))} in every train and val batch, "
        f"{MULTI_STEPS} steps + 1 val batch in {run['wall_s']:.1f} s, kernel 4 launched "
        f"{run['launches']} times, peak memory {run['peak_gib']:.2f} GiB"
        + (f", cut: {cut}" if cut else ", no cut"))

    # 4. remote and cached shards
    local = root / "remote_local"
    for split in ("train", "val", "test"):
        (local / split).mkdir(parents=True)
    for i in range(2):
        (local / "train" / f"train-combo-{i:06d}.tar").symlink_to(
            plain / "train" / f"train-combo-{i:06d}.tar")
    spec = f"pipe:cat {plain}/train/train-combo-{{000000..000001}}.tar"
    cache = root / "cache"
    dms = {"local": _data_module([local / "train", local / "val", local / "test"],
                                 distmap=False),
           "cached": _data_module([spec, local / "val", local / "test"], distmap=False,
                                  cache_dir=str(cache))}
    gens = {k: torch.Generator().manual_seed(SEED + 14) for k in dms}
    epoch_s = []
    for epoch in range(2):
        t0 = time.perf_counter()
        got = list(dms["cached"].train_batches(gens["cached"]))
        epoch_s.append(time.perf_counter() - t0)
        if epoch == 0 and len(list(cache.iterdir())) != 2:
            raise AssertionError(f"the cache holds {sorted(os.listdir(cache))}")
        want = list(dms["local"].train_batches(gens["local"]))
        if len(got) != len(want) or not got or any(
                g["files"] != w["files"] or not torch.equal(g["image"], w["image"])
                or not torch.equal(g["mask"], w["mask"]) for g, w in zip(got, want)):
            raise AssertionError(f"epoch {epoch} of the cached pipe: shards differs from local")
    handler = functools.partial(_QuietHandler, directory=str(plain / "train"))
    with socketserver.TCPServer(("127.0.0.1", 0), handler) as httpd:
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}/train-combo-000000.tar"
            t0 = time.perf_counter()
            over_http = list(iter_tar_samples(url))
            http_s = time.perf_counter() - t0
        finally:
            httpd.shutdown()
            server.join(10)
    if over_http != list(iter_tar_samples(one[0])):
        raise AssertionError("the shard read over http differs from the file")
    out["remote"] = {"cached_epoch_s": epoch_s, "http_shard_s": http_s}
    log(f"pipe: shards with cache_dir, 2 epochs of {len(got)} batches equal to the local shards' "
        f"(files, images, masks): {epoch_s[0]:.2f} s (fetch into the cache) and {epoch_s[1]:.2f} s"
        f"; one shard over http from a localhost server equal to the file in {http_s:.2f} s")

    if NATIVE_FALLBACKS:
        raise AssertionError(f"native decode fell back to PIL on {NATIVE_FALLBACKS}")
    out["native_fallbacks"] = 0
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 14: {out['phase_s']:.1f} s on {card}; native fallbacks 0")
    return out


# ---------------------------------------------------------------------------
# phase 15
# ---------------------------------------------------------------------------

COMPILED_BS = 4  # the serving batch phase 15 compiles (cut from 1, 4, 32 and 128)
SERVING_ROUTES = {
    "chw": {"fused_decoder": "chw"}, "auto": {"fused_decoder": "auto"},
    "nhwc": {"fused_decoder": "nhwc"}, "plain": {}, "w8": {"quantized": "w8"},
}
SCENE_CHUNK = 16  # the scene predictor's chunk phase 15 compiles (cut from 128)
COMPILED_SCENES = 16
# what each warmer compiles cold, in a process of its own; "auto" and w8
# trace the graphs of "chw" and plain at this batch and find them compiled
WARM_LANES = {"a": ("chw", "augment", "scene"), "b": ("nhwc", "plain")}
WARM_THREADS = 3  # inductor compile workers a warmer: 2 x 3 of the host's 8 cores
WARM_DIR = REPO / "build" / "chip_smoke" / "warm"
SERVER_REQUESTS = 8


def program_seconds(*programs) -> list:
    """The seconds of every compiling call of ``programs``
    (``core.compile_opts.Program.compiles``)."""
    return [round(s, 3) for p in programs for s, _ in p.compiles]


def _augment_batch_u8(bs: int = TRAIN_BS):
    """A train batch as the data module uploads it: uint8 RGBN, uint8 mask
    and lu (random), on the card."""
    import torch

    rng = np.random.default_rng(SEED + 19)
    return {"image": torch.from_numpy(rng.integers(0, 256, (bs, IMG, IMG, 4), np.uint8)).cuda(),
            "mask": torch.from_numpy(rng.integers(0, 3, (bs, IMG, IMG), np.uint8)).cuda(),
            "lu": torch.from_numpy(rng.integers(0, 2, (bs, IMG, IMG), np.uint8)).cuda()}


def _scenes(n: int = COMPILED_SCENES) -> list:
    rng = np.random.default_rng(SEED + 31)
    return [rng.integers(0, 256, (SCENE, SCENE, 4), dtype=np.uint8) for _ in range(n)]


def warm(lane: str) -> int:
    """``chip_smoke.py --warm LANE``, in a process of its own while the main
    process runs phases 2-13: compile the programs of phase 15 that
    ``WARM_LANES[LANE]`` names, cold (a fresh inductor cache under
    build/torch_compile), and write each one's compile seconds to
    build/chip_smoke/warm/LANE.json. Phase 15 compiles the same graphs in
    the main process from the cache (warm)."""
    import torch

    from deadtrees_tpu_torch.data.augment import _PROGRAM as augment_program
    from deadtrees_tpu_torch.data.augment import augment_batch, sample_augment_params
    from deadtrees_tpu_torch.infer import TorchInference, make_scene_predictor, predict_scenes

    set_precision()
    ckpt = WARM_DIR.parent / "flagship_b5.ckpt"
    img = np.random.default_rng(SEED + 15).integers(0, 256, (COMPILED_BS, IMG, IMG, 4), np.uint8)
    out = {}
    t0 = time.perf_counter()
    for name in WARM_LANES[lane]:
        if name == "augment":
            b = _augment_batch_u8()
            params = {k: v.cuda() for k, v in
                      sample_augment_params(torch.Generator().manual_seed(SEED), TRAIN_BS).items()}
            augment_batch(None, b["image"], b["mask"], b["lu"], params=params)
            out[name] = program_seconds(augment_program)
        elif name == "scene":
            model = TorchInference(ckpt).model
            fn = make_scene_predictor(model, subtile=IMG, batch_size=SCENE_CHUNK, packed=True)
            predict_scenes(model, _scenes(1), tile_shape=(SCENE, SCENE), subtile=IMG,
                           batch_size=SCENE_CHUNK, predictor=fn)
            out[name] = program_seconds(fn.program)
            del model, fn
        else:
            engine = TorchInference(ckpt, **SERVING_ROUTES[name])
            engine.run(img)
            out[name] = program_seconds(engine._calibrate, engine._program)
            del engine
        torch.compiler.reset()
        torch.cuda.empty_cache()
    out["lane_s"] = time.perf_counter() - t0
    (WARM_DIR / f"{lane}.json").write_text(json.dumps(out))
    return 0


def start_warmers() -> list:
    """Start one ``--warm`` process a lane; their output goes to
    build/chip_smoke/warm/LANE.log."""
    shutil.rmtree(WARM_DIR, ignore_errors=True)
    WARM_DIR.mkdir(parents=True)
    procs = []
    for lane in WARM_LANES:
        log_file = open(WARM_DIR / f"{lane}.log", "w")
        env = dict(os.environ, TORCHINDUCTOR_COMPILE_THREADS=str(WARM_THREADS))
        procs.append((lane, log_file, subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--warm", lane],
            cwd=REPO, env=env, stdout=log_file, stderr=subprocess.STDOUT)))
    log(f"phase 15's warmers started: {WARM_LANES} (cold compiles, in the background)")
    return procs


def stop_warmers(procs: list) -> None:
    for _, log_file, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        log_file.close()


def join_warmers(procs: list, timeout: float) -> dict:
    """Wait for the warmers; their cold compile seconds by lane and the
    seconds waited. Raises if one failed (its log's tail in the message)."""
    out = {}
    t0 = time.perf_counter()
    for lane, log_file, proc in procs:
        rc = proc.wait(max(1.0, timeout - (time.perf_counter() - t0)))
        log_file.flush()
        if rc != 0:
            tail = (WARM_DIR / f"{lane}.log").read_text()[-3000:]
            raise RuntimeError(f"the warmer of lane {lane} exited {rc}:\n{tail}")
        out[lane] = json.loads((WARM_DIR / f"{lane}.json").read_text())
    out["waited_s"] = time.perf_counter() - t0
    log(f"phase 15's warmers joined after {out['waited_s']:.1f} s of waiting: {out}")
    return out


def _profile(fn, reps: int, path: Path) -> dict:
    """torch.profiler over ``reps`` calls of ``fn`` after one outside it:
    wall per call, device busy per call (the union of the device's busy
    intervals), ms by group, the kernels by name and the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(2):  # a profile that recorded no device activity runs again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps * 1e3
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        if any(e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") for e in events):
            break
        log(f"  torch.profiler recorded no device activity in {path.name} (attempt {attempt})")
    busy, _ = _device_busy_ms(events)
    groups, kernels = {}, {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            g = _kernel_group(e)
            groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3 / reps
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    if not groups:
        raise RuntimeError("torch.profiler recorded no device activity")
    return {"wall_ms": wall, "busy_ms": busy / reps, "idle": 1 - busy / reps / wall,
            "groups": groups, "kernels": kernels, "events": events}


def count_kernels(kernels: dict, prefix: str) -> int:
    """Launches of the port's kernels whose name starts with ``prefix``
    (``pass1_``, ``nhwc_p2_``, ``augment_`` ...) in a trace's kernels."""
    n = 0
    for name, k in kernels.items():
        if port_kernel_group(name) is None:
            continue
        head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""), maxsplit=1)[0]
        if head.split("::")[-1].split()[-1].startswith(prefix):
            n += k
    return n


def replay_check(label: str, fn, path: Path, want: dict) -> dict:
    """Profile one call of a compiled program's replay: the port kernels'
    launches by name (``want``: prefix → count; the others 0), no
    host-to-device copy, no custom op's Python (the plain versions and the
    kernels' wrappers run only there) and a CUDA-graph launch."""
    prof = _profile(fn, 1, path)
    names = [e.get("name", "") for e in prof["events"]]
    h2d = sum(1 for e in prof["events"]
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))
    op_calls = sum(1 for n in names if n.startswith("deadtrees::"))
    graphs = sum(1 for n in names if n.startswith("cudaGraphLaunch"))
    launches = {k: count_kernels(prof["kernels"], k)
                for k in ("pass1_", "pass2_", "nhwc_p1_", "nhwc_p2_", "dw_", "augment_")}
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise AssertionError(f"{label}: one replay launched {launches}, expected {want}")
    if h2d or op_calls or not graphs:
        raise AssertionError(f"{label}: the replay made {h2d} host-to-device copies, ran "
                             f"{op_calls} custom ops' Python and {graphs} graph launches "
                             "(expected 0, 0 and at least 1)")
    return {"launches": {k: v for k, v in launches.items() if v}, "graph_launches": graphs}


def _turns(fn, reps: int = 10) -> dict:
    """Median ms of ``fn()`` compiled and eager, in turns (compiled, eager,
    eager, compiled), each turn after a call outside it."""
    import torch

    from deadtrees_tpu_torch.core.compile_opts import disable_compile

    times = {"compiled": [], "eager": []}
    for mode in ("compiled", "eager", "eager", "compiled"):
        with (disable_compile() if mode == "eager" else contextlib.nullcontext()):
            fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
        times[mode].append(statistics.median(ts))
    return {k: statistics.median(v) * 1e3 for k, v in times.items()}


def _groups_text(groups: dict) -> str:
    return "; ".join(f"{g} {v:.3f}" for g, v in sorted(groups.items(), key=lambda kv: -kv[1]))


def _compiled_serving(ckpt: Path) -> dict:
    import torch

    from deadtrees_tpu_torch.core.compile_opts import disable_compile, graphs_compiled
    from deadtrees_tpu_torch.infer import TorchInference

    rng = np.random.default_rng(SEED + 15)
    img = rng.integers(0, 256, (COMPILED_BS, IMG, IMG, 4), dtype=np.uint8)
    dev = torch.from_numpy(img).cuda()
    trace_dir = REPO / "build" / "chip_smoke"
    want = {"chw": {"pass1_": 22, "pass2_": 22}, "auto": {"pass1_": 22, "pass2_": 22},
            "nhwc": {"nhwc_p1_": 14, "nhwc_p2_": 14}}
    out = {}
    for route, kw in SERVING_ROUTES.items():
        engine = TorchInference(ckpt, **kw)
        before = graphs_compiled()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = engine.run(img)
        first_s = time.perf_counter() - t0
        with disable_compile():
            eager = engine.run(img)
        agree = float((got == eager).mean())
        if agree < AGREE_BF16:
            raise AssertionError(f"{route}: compiled vs eager class maps agree {agree}")
        ms = _turns(lambda: engine.run(img))
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = {}
        for mode in ("compiled", "eager"):
            with (disable_compile() if mode == "eager" else contextlib.nullcontext()):
                prof[mode] = _profile(lambda: engine.run(img), 3,
                                      trace_dir / f"trace_compiled_{route}_{mode}.json")
        replay = replay_check(route, lambda: engine.predict(dev),
                              trace_dir / f"trace_compiled_{route}_replay.json",
                              want.get(route, {}))
        c, e = prof["compiled"], prof["eager"]
        r = out[route] = {
            "first_call_s": first_s,
            "compile_s": program_seconds(engine._calibrate, engine._program),
            "graphs": graphs_compiled() - before, "agree_eager": agree,
            "latency_ms": ms["compiled"], "eager_latency_ms": ms["eager"],
            "tiles_per_s": COMPILED_BS * 1e3 / ms["compiled"],
            "eager_tiles_per_s": COMPILED_BS * 1e3 / ms["eager"],
            "wall_ms": c["wall_ms"], "busy_ms": c["busy_ms"], "idle": c["idle"],
            "eager_wall_ms": e["wall_ms"], "eager_busy_ms": e["busy_ms"], "eager_idle": e["idle"],
            "groups_ms": c["groups"], "eager_groups_ms": e["groups"], "peak_gib": peak,
            "replay": replay,
        }
        log(f"  {route:>5} bs {COMPILED_BS}: first call {first_s:.1f} s (compile "
            f"{r['compile_s']} s, {r['graphs']} graph(s)); class maps agree with eager "
            f"{agree:.5f}; run() {r['latency_ms']:.3f} ms compiled vs {r['eager_latency_ms']:.3f}"
            f" eager ({r['tiles_per_s']:.1f} vs {r['eager_tiles_per_s']:.1f} tiles/s); profiled "
            f"wall {c['wall_ms']:.3f} ms, busy {c['busy_ms']:.3f}, idle {c['idle']:.1%} (eager "
            f"{e['wall_ms']:.3f} / {e['busy_ms']:.3f} / {e['idle']:.1%}); peak {peak:.2f} GiB; "
            f"one replay: {replay['launches']}, {replay['graph_launches']} graph launch(es), "
            "no H2D, no op's Python")
        log(f"        ms by group, compiled: {_groups_text(c['groups'])}")
        log(f"        ms by group, eager:    {_groups_text(e['groups'])}")
        del engine, prof
        torch.compiler.reset()
        torch.cuda.empty_cache()
    return out


def _compiled_server(ckpt: Path) -> dict:
    """8 concurrent requests through ``serve_stdlib`` (phase 4's drive), in
    groups of ``COMPILED_BS`` (``max_batch``; the batcher waits long enough
    for each group to fill), answered by the engine's compiled programs."""
    from PIL import Image

    from deadtrees_tpu_torch.serve import SegmentationService, serve_stdlib

    service = SegmentationService(ckpt, batch_wait_ms=3000, max_batch=COMPILED_BS)
    server = serve_stdlib(service, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(SEED + 16)
    uploads = []
    for _ in range(SERVER_REQUESTS):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 4), dtype=np.uint8), "RGBA").save(
            buf, "PNG")
        uploads.append(buf.getvalue())
    results = [None] * SERVER_REQUESTS

    def post(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/segmentation", data=uploads[i],
            headers={"Content-Type": "image/png"}, method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            results[i] = (resp.status, resp.read())

    try:
        engine = service.engines["torch"]
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(SERVER_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        for i, r in enumerate(results):
            if r is None:
                raise AssertionError(f"request {i} got no answer")
            mask = np.asarray(Image.open(io.BytesIO(r[1])))
            if r[0] != 200 or mask.shape != (IMG, IMG):
                raise AssertionError(f"request {i}: {r[0]} {mask.shape}")
        dispatches = service.batchers["torch"].dispatches
        compiles = program_seconds(engine._program)
        if not compiles:
            raise AssertionError("the server's engine compiled no program")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    log(f"  server: {SERVER_REQUESTS} concurrent {IMG}² requests -> 200 in {wall:.3f} s "
        f"(its warm compile and two 3 s batch windows included), {dispatches} dispatches of "
        f"{COMPILED_BS}, program compiled in {compiles} s")
    return {"wall_s": wall, "dispatches": dispatches, "compile_s": compiles}


def _tile_agreement(got: list, want: list) -> np.ndarray:
    """Agreement of two lists of scene maps, per 512² subtile."""
    n = SCENE // IMG
    return np.array([(a == b).reshape(n, IMG, n, IMG).mean(axis=(1, 3))
                     for a, b in zip(got, want)]).ravel()


def _compiled_scenes(ckpt: Path) -> dict:
    """``predict_scenes`` over 16 scenes of 2048², its chunk one compiled
    program at bs ``SCENE_CHUNK`` (one scene a chunk, two dispatches in
    flight): maps equal to the same program run one scene at a time
    through ``predict_scene`` (one dispatch, synchronous), so that the
    overlap and the graph's output buffer change nothing; against the
    eager predictor's maps per 512² subtile (bf16 rounds elsewhere once
    fused); tiles/s in turns."""
    import torch

    from deadtrees_tpu_torch.core.compile_opts import disable_compile
    from deadtrees_tpu_torch.infer import (
        TorchInference,
        make_scene_predictor,
        predict_scene,
        predict_scenes,
    )

    model = TorchInference(ckpt).model
    scenes = _scenes()
    fn = make_scene_predictor(model, subtile=IMG, batch_size=SCENE_CHUNK, packed=True)
    kw = dict(tile_shape=(SCENE, SCENE), subtile=IMG, batch_size=SCENE_CHUNK, predictor=fn)
    t0 = time.perf_counter()
    got = predict_scenes(model, scenes, **kw)
    first_s = time.perf_counter() - t0
    one_by_one = [predict_scene(model, sc, **kw) for sc in scenes]
    unequal = [i for i, (a, b) in enumerate(zip(got, one_by_one)) if not np.array_equal(a, b)]
    if unequal:
        raise AssertionError(f"compiled scenes {unequal}: two dispatches in flight differ from "
                             "the same program run one scene at a time")
    with disable_compile():
        want = predict_scenes(model, scenes, **kw)
    tiles_agree = _tile_agreement(got, want)
    agree = float(tiles_agree.mean())
    if agree < AGREE_BF16 or tiles_agree.min() < AGREE_TILE:
        raise AssertionError(f"compiled scene maps agree {agree} with the eager predictor's, "
                             f"{tiles_agree.min()} on the worst 512² subtile")
    ms = _turns(lambda: predict_scenes(model, scenes, **kw), reps=2)
    tiles = COMPILED_SCENES * (SCENE // IMG) ** 2
    r = {"first_call_s": first_s, "compile_s": program_seconds(fn.program), "agree_eager": agree,
         "agree_eager_tile_min": float(tiles_agree.min()),
         "agree_eager_tile_quartiles": [float(q) for q in
                                        np.quantile(tiles_agree, [0.25, 0.5, 0.75])],
         "equal_one_scene_a_dispatch": True,
         "tiles_per_s": tiles * 1e3 / ms["compiled"],
         "eager_tiles_per_s": tiles * 1e3 / ms["eager"]}
    log(f"  scenes: {COMPILED_SCENES} of {SCENE}², chunk bs {SCENE_CHUNK}: maps equal to the "
        f"same program one scene a dispatch; agree with the eager predictor's {agree:.5f} "
        f"(per 512² subtile: min {r['agree_eager_tile_min']:.5f}, quartiles "
        f"{[round(q, 5) for q in r['agree_eager_tile_quartiles']]}); {r['tiles_per_s']:.2f} "
        f"tiles/s compiled vs {r['eager_tiles_per_s']:.2f} eager (in turns); first call "
        f"{first_s:.1f} s (compile {r['compile_s']} s)")
    del model, fn
    torch.compiler.reset()
    torch.cuda.empty_cache()
    return r


def _compiled_augment() -> dict:
    """``augment_batch`` at the training batch (16 × 512² RGBN, mask, lu)
    as one program: bit-equal to the eager call, kernel 4 once a replay."""
    import torch

    from deadtrees_tpu_torch.core.compile_opts import disable_compile
    from deadtrees_tpu_torch.data.augment import _PROGRAM as augment_program
    from deadtrees_tpu_torch.data.augment import augment_batch, sample_augment_params

    b = _augment_batch_u8()
    # drawn and uploaded once: the replay's trace holds no host-to-device copy
    params = {k: v.cuda() for k, v in
              sample_augment_params(torch.Generator().manual_seed(SEED), TRAIN_BS).items()}

    def call():
        return augment_batch(None, b["image"], b["mask"], b["lu"], params=params)

    got = call()
    with disable_compile():
        want = call()
    if any(not torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("the compiled augment differs from the eager one")
    replay = replay_check("augment", call, REPO / "build" / "chip_smoke" /
                          "trace_compiled_augment.json", {"augment_": 1})
    ms = _turns(call)
    r = {"compile_s": program_seconds(augment_program), "ms": ms["compiled"],
         "eager_ms": ms["eager"], "replay": replay}
    log(f"  augment_batch, bs {TRAIN_BS}: bit-equal to eager; kernel 4 once a replay; "
        f"{ms['compiled']:.3f} ms compiled vs {ms['eager']:.3f} eager (host clock, "
        f"synchronized; parameters drawn and uploaded outside); compile {r['compile_s']} s")
    return r


def phase_compiled(ckpt: Path, card: str, cold: dict, t_script: float) -> dict:
    """Phase 15 (module docstring): the compiled programs beside the eager
    path, in turns; ``cold`` holds the warmers' cold compile seconds."""
    t_phase = time.perf_counter()
    log(f"phase 15 on {card}: bs {COMPILED_BS} routes, the server, scenes at chunk "
        f"{SCENE_CHUNK}, the augment program")
    # the server last: it runs programs in a thread of its own
    out = {"cold": cold, "augment": _compiled_augment(), "serving": _compiled_serving(ckpt),
           "scenes": _compiled_scenes(ckpt), "server": _compiled_server(ckpt)}
    out["phase_s"] = time.perf_counter() - t_phase
    out["script_s"] = time.perf_counter() - t_script
    log(f"phase 15: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16
# ---------------------------------------------------------------------------

EXPORT_BS = (1, 4)
EXPORT_REPS = 9  # run() calls a route in the timing turns
EXPORT_REQUESTS = 4
INT8_SIZE_BAR = 0.6  # tests/test_quantize.py:90-110


def phase_export(ckpt: Path, card: str) -> dict:
    """Phase 16's first part (module docstring): export, load, agreement
    and the service. It runs while phase 15's warmers finish, where the
    main process would otherwise wait."""
    import torch
    from PIL import Image

    from deadtrees_tpu_torch.infer import ExportedInference, TorchInference
    from deadtrees_tpu_torch.infer.export import export_inference
    from deadtrees_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from deadtrees_tpu_torch.serve import SegmentationService

    t_phase = time.perf_counter()
    log(f"phase 16 on {card}: the exported artifacts at {IMG}²")
    out = {}
    engines = {}
    for name, kw in (("float", {}), ("int8", {"quantize": True}), ("cpu", {"device": "cpu"})):
        path = ckpt.with_name(f"flagship_b5_{name}.ptexp")
        t0 = time.perf_counter()
        export_inference(ckpt, path, image_size=IMG, **kw)
        t1 = time.perf_counter()
        engines[name] = ExportedInference(path)
        out[name] = {"path": str(path), "export_s": t1 - t0, "load_s": time.perf_counter() - t1,
                     "bytes": path.stat().st_size}
        log(f"  {name}: exported in {t1 - t0:.1f} s, {out[name]['bytes']} bytes, loaded in "
            f"{out[name]['load_s']:.1f} s on {engines[name].device}")
    out["int8_over_float_bytes"] = out["int8"]["bytes"] / out["float"]["bytes"]
    assert out["int8_over_float_bytes"] < INT8_SIZE_BAR, out["int8_over_float_bytes"]
    pairs = {"float": (engines["float"], TorchInference(ckpt)),
             "int8": (engines["int8"], TorchInference(ckpt, quantized=True)),
             "cpu": (engines["cpu"], engines["float"])}
    rng = np.random.default_rng(SEED + 20)
    agree = {}
    reset_launch_counts()
    for bs in EXPORT_BS:
        img = rng.integers(0, 256, (bs, IMG, IMG, 4), dtype=np.uint8)
        for name, (engine, ref) in pairs.items():
            got = engine.run(img)
            assert got.shape == (bs, IMG, IMG) and got.dtype == np.uint8, got.shape
            agree[f"{name}_bs{bs}"] = float((got == ref.run(img)).mean())
    # the artifact is the plain model: no kernel of the port on its path
    assert not any(LAUNCHES.values()), dict(LAUNCHES)
    log(f"  class-map agreement (float vs plain, int8 vs w8, CPU-exported vs float): "
        f"{agree} (bar {AGREE_BF16}); kernel launches {dict(LAUNCHES)}")
    assert all(a >= AGREE_BF16 for a in agree.values()), agree
    out["agreement"] = agree

    service = SegmentationService(None, exported=out["float"]["path"])
    assert sorted(service.engines) == ["exported"]
    for _ in range(EXPORT_REQUESTS):
        tile = rng.integers(0, 256, (IMG, IMG, 4), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(tile, "RGBA").save(buf, "PNG")
        png, headers = service.segment(buf.getvalue(), "exported")
        mask = np.asarray(Image.open(io.BytesIO(png)))
        assert headers["X-model-type"] == "exported" and mask.shape == (IMG, IMG)
        np.testing.assert_array_equal(mask, np.uint8(engines["float"].run(tile[None])[0] * 255))
    service.close()
    out["requests"] = EXPORT_REQUESTS
    log(f"  SegmentationService(None, exported=...) answered {EXPORT_REQUESTS} requests")
    del engines, pairs, service
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16, exports: {out['phase_s']:.1f} s")
    return out


def phase_export_timings(ckpt: Path, exported: dict, card: str) -> dict:
    """Phase 16's second part, after phase 15 (no warmer compiles beside
    it): ``run()`` at bs 4 of the float and int8 artifacts and the plain
    engine, in turns, median of ``EXPORT_REPS``."""
    import torch

    from deadtrees_tpu_torch.infer import ExportedInference, TorchInference

    t_phase = time.perf_counter()
    routes = {"float": ExportedInference(exported["float"]["path"]),
              "int8": ExportedInference(exported["int8"]["path"]), "plain": TorchInference(ckpt)}
    img = np.random.default_rng(SEED + 21).integers(0, 256, (4, IMG, IMG, 4), dtype=np.uint8)
    for engine in routes.values():
        engine.run(img)  # warm-up
    times = {name: [] for name in routes}
    for rep in range(EXPORT_REPS):
        for name in (list(routes) if rep % 2 == 0 else list(routes)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routes[name].run(img)
            times[name].append((time.perf_counter() - t0) * 1e3)
    run_ms = {name: statistics.median(v) for name, v in times.items()}
    log(f"  run() at bs 4, median of {EXPORT_REPS} in turns: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in run_ms.items()) + f" on {card}")
    # where a run's time goes: device busy and idle, groups, kernel launches
    profiles = {}
    for name, engine in routes.items():
        prof = _profile(lambda: engine.run(img), 3, ckpt.parent / f"trace_exported_{name}.json")
        profiles[name] = {"wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                          "idle": prof["idle"], "groups_ms": prof["groups"],
                          "launches": sum(prof["kernels"].values()) / 3}
        log(f"  profile {name}: wall {prof['wall_ms']:.3f} ms, busy {prof['busy_ms']:.3f} ms, "
            f"idle {prof['idle']:.1%}, {profiles[name]['launches']:.0f} kernel launches a "
            f"run; ms by group {prof['groups']}")
    del routes
    torch.cuda.empty_cache()
    out = {"run_ms_bs4": run_ms, "profiles": profiles, "phase_s": time.perf_counter() - t_phase}
    log(f"phase 16, timings: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17
# ---------------------------------------------------------------------------


def zoo_step_setup(model):
    """The port's train step for ``model`` with the repo's recipe (losses,
    Adam at the configured learning rate), as the Trainer builds it."""
    from deadtrees_tpu_torch.train.loss import build_loss
    from deadtrees_tpu_torch.train.optim import OptimizerConfig, make_optimizer
    from deadtrees_tpu_torch.train.steps import TrainState, make_train_step

    loss = build_loss(["GDICE", "FOCAL", "BOUNDARY"], 3)
    state = TrainState(model, make_optimizer(model.parameters(), OptimizerConfig(
        learning_rate=3e-4, cosineannealing_tmax=10, gradient_clip_val=0.5,
        steps_per_epoch=ZOO_TRAIN_STEPS, accumulate_grad_batches=1)))
    return state, make_train_step(model, loss, num_classes=3)


def zoo_train(model, state, train_step, host: dict, params: dict) -> dict:
    """``ZOO_TRAIN_STEPS`` eager steps on one repeated batch at bs 16: the
    uint8 batch through the augment kernel (fixed augmentation, so the
    batch repeats) once a step, then the train step. Returns the losses,
    the step's median ms (host clock, synchronized, steps 2 on) and the
    peak memory."""
    import torch

    from deadtrees_tpu_torch.data.augment import augment_batch
    from deadtrees_tpu_torch.losses import batch_one_hot2dist, class2one_hot

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    distmap = None
    losses, times = [], []
    for _ in range(ZOO_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = augment_batch(None, host["image"], host["mask"], params=params)
        if distmap is None:  # the same mask every step: one EDT
            distmap = batch_one_hot2dist(class2one_hot(batch["mask"], 3))
        batch["distmap"] = distmap
        _, m = train_step(state, batch, 1)
        losses.append(float(m["total_loss"]))
        times.append(time.perf_counter() - t0)
    return {"losses": losses, "step_ms": statistics.median(times[1:]) * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "image": batch["image"]}


def zoo_recalibrate(model, image) -> None:
    """One train-mode forward at BatchNorm momentum 1, no gradients: the
    running statistics become the batch's, as a trained model's sit near
    its data's. Six steps from initialization leave them mostly at (0, 1),
    where eval mode does not normalize and the logits grow into the
    hundreds, and bfloat16 rounding then decides the argmax."""
    import torch

    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    saved = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(image)
    for m, momentum in zip(norms, saved):
        m.momentum = momentum
    model.eval()


def zoo_run_ms(engine, imgs: dict) -> dict:
    """``run()``'s median of ``ZOO_REPS`` calls a batch size, host clock,
    after one warm-up call."""
    out = {}
    for bs, img in imgs.items():
        engine.run(img)
        times = []
        for _ in range(ZOO_REPS):
            t0 = time.perf_counter()
            engine.run(img)
            times.append(time.perf_counter() - t0)
        out[str(bs)] = statistics.median(times) * 1e3
    return out


def zoo_own_argmax(engine, img_u8: np.ndarray) -> np.ndarray:
    import torch

    x = fused_input(engine, torch.from_numpy(img_u8).cuda())
    with torch.no_grad():
        return engine.model(x).argmax(1).cpu().numpy()


def zoo_fused_checks(engine, path: Path, errs: dict) -> dict:
    """efficientunet++ on a ResNet: kernels 1 and 2 against their plain
    versions at every shape this model gives them (bs 4, 512², float32 and
    bfloat16), the float32 fused forward on both layouts against the plain
    model, and the launches a forward on each bf16 route."""
    import torch

    from deadtrees_tpu_torch.infer import TorchInference
    from deadtrees_tpu_torch.models import create_model
    from deadtrees_tpu_torch.ops import (
        LAUNCHES,
        fold_effunetpp_decoder,
        fused_forward,
        reset_launch_counts,
    )

    out = {}
    model = engine.model
    gen = torch.Generator().manual_seed(SEED + 40)
    cells = flagship_block_shapes(model, 4)
    for name, i, shape, fp in cells:
        x32 = torch.randn(shape, generator=gen).cuda()
        for x in (x32, x32.to(torch.bfloat16)):
            check_case(f"{name}.conv{i + 1} {tuple(shape[1:])}", x, fp, errs)
    fat = fat_block_shapes(model, 4)
    log(f"  kernel 2 at the {len(fat)} fat blocks of this model: "
        + ", ".join(f"{n}.conv{i + 1}" for n, i, _, _ in fat))
    for name, i, shape, fp in fat:
        x32 = torch.randn(shape, generator=gen).cuda()
        for x in (x32, x32.to(torch.bfloat16)):
            check_nhwc_case(f"{name}.conv{i + 1} {tuple(shape[1:])}", x, fp, errs)
    out["kernel_shapes"] = {"chw": len(cells), "nhwc_fat": len(fat)}

    hp = engine.hparams
    model32 = create_model(**hp, dtype=torch.float32)
    model32.load_state_dict(model.state_dict())
    model32 = model32.cuda().eval()
    folded32 = fold_effunetpp_decoder(model32)
    img = np.random.default_rng(SEED + 41).integers(0, 256, (4, IMG, IMG, 4), dtype=np.uint8)
    x = fused_input(engine, torch.from_numpy(img).cuda())
    with torch.no_grad():
        ref = model32(x)
        for layout in ("chw", "nhwc"):
            got = fused_forward(model32, folded32, x, layout=layout)
            err = max_err(got, ref)
            bar = FORWARD_F32_BAR * max(1.0, float(ref.abs().max()))
            agree = float((got.argmax(1) == ref.argmax(1)).float().mean())
            log(f"  f32 {layout}: fused_forward vs the plain model, logits max err {err:.3e} "
                f"(bar {bar:.3e}), class-map agreement {agree:.5f} (bar {AGREE_BF16})")
            if err > bar or agree < AGREE_BF16:
                raise AssertionError(f"efficientunet++ on a ResNet, {layout}: {err} {agree}")
            out[f"f32_{layout}"] = {"max_err": err, "bar": bar, "agree": agree}
        want = ref.argmax(1).cpu().numpy()
    del model32, folded32, ref, got
    # bf16, as served: each route's maps against the float32 model's. The
    # bf16 routes round in other places, so near-ties flip between them;
    # a fused route must stand as close to float32 as the plain bf16 model
    launches, to_f32 = {}, {"plain": float((zoo_own_argmax(engine, img) == want).mean())}
    for layout, kw in (("chw", {"fused_decoder": "chw"}), ("nhwc", {"fused_decoder": "nhwc"})):
        routed = engine if layout == "chw" else TorchInference(path, **kw)
        reset_launch_counts()
        maps = routed.run(img)
        launches[layout] = {k: v for k, v in LAUNCHES.items() if v}
        to_f32[layout] = float((maps == want).mean())
        log(f"  bf16 {layout} route at bs 4: launches a forward {launches[layout]}; maps "
            f"vs the float32 model {to_f32[layout]:.5f} (plain bf16 {to_f32['plain']:.5f})")
        if to_f32[layout] < to_f32["plain"] - BF16_ROUTE_SLACK:
            raise AssertionError(f"the bf16 {layout} route stands further from float32 than "
                                 f"the plain bf16 model: {to_f32}")
    out["bf16_agreement_with_f32"] = to_f32
    out["launches_per_forward"] = launches
    return out


def zoo_service(path: Path) -> int:
    """The REST service on a plain-route checkpoint answers a few 512²
    requests over HTTP, with no kernel launched."""
    from PIL import Image

    from deadtrees_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from deadtrees_tpu_torch.serve import SegmentationService, serve_stdlib

    service = SegmentationService(path)
    assert service.route == "plain" and not service.engines["torch"].fused_decoder
    server = serve_stdlib(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(SEED + 42)
    reset_launch_counts()
    try:
        for _ in range(ZOO_REQUESTS):
            tile = rng.integers(0, 256, (IMG, IMG, 4), dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(tile, "RGBA").save(buf, "PNG")
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/segmentation",
                data=buf.getvalue(), headers={"Content-Type": "image/png"}, method="POST")
            with urllib.request.urlopen(req, timeout=300) as resp:
                mask = np.asarray(Image.open(io.BytesIO(resp.read())))
                assert resp.status == 200 and mask.shape == (IMG, IMG), resp.status
            want = service.engines["torch"].run(tile[None])[0]
            np.testing.assert_array_equal(mask, np.uint8(want * 255))
        assert not any(LAUNCHES.values()), dict(LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    return ZOO_REQUESTS


def zoo_export(path: Path, engine) -> dict:
    """The checkpoint exported with ``export_inference`` at 512² on the
    card; the artifact's maps against the plain engine's."""
    from deadtrees_tpu_torch.infer import ExportedInference
    from deadtrees_tpu_torch.infer.export import export_inference

    out_path = path.with_suffix(".ptexp")
    t0 = time.perf_counter()
    export_inference(path, out_path, image_size=IMG)
    export_s = time.perf_counter() - t0
    exported = ExportedInference(out_path)
    img = np.random.default_rng(SEED + 43).integers(0, 256, (4, IMG, IMG, 4), dtype=np.uint8)
    agree = float((exported.run(img) == engine.run(img)).mean())
    log(f"  exported in {export_s:.1f} s ({out_path.stat().st_size} bytes); artifact vs plain "
        f"engine class-map agreement {agree:.5f} (bar {AGREE_BF16})")
    if agree < AGREE_BF16:
        raise AssertionError(f"the exported artifact disagrees with the plain engine: {agree}")
    return {"export_s": export_s, "bytes": out_path.stat().st_size, "agree": agree}


def phase_zoo(card: str, configs=ZOO) -> list:
    """Phase 17 (module docstring): the model zoo at full width, eager. For
    each configuration: ``ZOO_TRAIN_STEPS`` train steps at bs 16 from
    ``init_model`` (seed 0), the trained weights written as a JAX-format
    checkpoint, served by ``TorchInference`` on the service's route and
    timed; one ``zoo`` JSON line each."""
    import torch

    from deadtrees_tpu_torch.core import save_checkpoint
    from deadtrees_tpu_torch.data.augment import sample_augment_params
    from deadtrees_tpu_torch.infer import TorchInference
    from deadtrees_tpu_torch.models import create_model, init_model
    from deadtrees_tpu_torch.models import tensor_variables_from_state_dict
    from deadtrees_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from deadtrees_tpu_torch.serve.server import serving_route

    t_phase = time.perf_counter()
    log(f"phase 17 on {card}: the model zoo at full width ({IMG}², decoder "
        f"{list(ZOO_DECODER)}, bs {TRAIN_BS} training)")
    root = REPO / "build" / "chip_smoke" / "zoo"
    root.mkdir(parents=True, exist_ok=True)
    host = _augment_batch_u8()
    params = {k: v.cuda() for k, v in
              sample_augment_params(torch.Generator().manual_seed(SEED + 44), TRAIN_BS).items()}
    rng = np.random.default_rng(SEED + 45)
    imgs = {bs: rng.integers(0, 256, (bs, IMG, IMG, 4), dtype=np.uint8) for bs in ZOO_RUN_BS}
    lines = []
    for arch, encoder in configs:
        t_cfg = time.perf_counter()
        hp = {"architecture": arch, "encoder_name": encoder, "decoder_channels": list(ZOO_DECODER),
              "in_channels": 4, "classes": 3, "encoder_weights": None}
        model = init_model(create_model(**hp), generator=torch.Generator().manual_seed(SEED))
        model = model.cuda()
        n_params = sum(p.numel() for p in model.parameters())
        state, train_step = zoo_step_setup(model)
        reset_launch_counts()
        train = zoo_train(model, state, train_step, host, params)
        aug_launches = LAUNCHES[AUGMENT]
        losses = train["losses"]
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{arch}/{encoder}: the loss did not fall: {losses}")
        if aug_launches != ZOO_TRAIN_STEPS or train["peak_gib"] * 2**30 >= 80e9:
            raise AssertionError(f"{arch}/{encoder}: augment launches {aug_launches}, "
                                 f"peak {train['peak_gib']:.2f} GiB")
        zoo_recalibrate(model, train.pop("image"))
        path = root / f"{arch}_{encoder}.ckpt".replace("+", "p")
        save_checkpoint(path, **tensor_variables_from_state_dict(model.state_dict()),
                        hparams=hp)
        del model, state, train_step
        torch.cuda.empty_cache()
        route = serving_route(path)
        engine = TorchInference(path, fused_decoder="auto" if route == "auto" else False)
        line = {"config": f"{arch}/{encoder}", "architecture": engine.model.architecture,
                "params": n_params, "route": route, "train_steps": ZOO_TRAIN_STEPS,
                "train_step_ms": train["step_ms"], "train_peak_gib": train["peak_gib"],
                "loss_first": losses[0], "loss_last": losses[-1],
                "augment_launches": aug_launches}
        line["run_ms"] = zoo_run_ms(engine, imgs)
        agree = {}
        for bs in ZOO_RUN_BS:
            got, own = engine.run(imgs[bs]), zoo_own_argmax(engine, imgs[bs])
            agree[str(bs)] = float((got == own).mean())
        line["own_argmax_agreement"] = agree
        if (arch, encoder) == ZOO_FUSED:
            errs = {name: 0.0 for name in (*REPLACES, *FAT)}
            line["fused"] = zoo_fused_checks(engine, path, errs)
            line["fused"]["max_abs_err"] = errs
        # the plain route is the model's own argmax; the fused route ("auto",
        # bs <= 32) rounds to bf16 in other places: zoo_fused_checks holds it
        # against the float32 model, and its agreement is reported here
        if route == "plain" and min(agree.values()) < 1.0:
            raise AssertionError(f"{arch}/{encoder}: class maps vs the model's own argmax "
                                 f"{agree}")
        log(f"  {arch}/{encoder}: {n_params / 1e6:.2f}M params, route {route}; train step "
            f"{train['step_ms']:.1f} ms, peak {train['peak_gib']:.2f} GiB, loss "
            f"{' '.join(f'{v:.4f}' for v in losses)}; run() "
            + ", ".join(f"bs {b} {ms:.1f} ms" for b, ms in line["run_ms"].items())
            + f"; maps vs own argmax {agree}")
        if (arch, encoder) == ZOO_SERVED:
            line["requests"] = zoo_service(path)
            log(f"  the REST service (plain route) answered {line['requests']} requests")
        if (arch, encoder) == ZOO_EXPORTED:
            line["exported"] = zoo_export(path, engine)
        del engine
        torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t_cfg
        lines.append(line)
    phase_s = time.perf_counter() - t_phase
    for line in lines:
        line["phase_s"] = phase_s
    log(f"phase 17: {phase_s:.1f} s")
    return lines


# ---------------------------------------------------------------------------
# phase 18
# ---------------------------------------------------------------------------

DP_DIR = REPO / "build" / "chip_smoke" / "dp"
DP_MAPS = REPO / "build" / "chip_smoke" / "scenes16_maps.npy"  # phase 12's 16 maps
DP_STEPS = 8
DP_F32_BS = 4  # the float32 comparison's global batch (2 a rank)
DP_EPOCHS = 2
DP_SCENES = 16
DP_TIMEOUT = 420  # seconds a child of phase 18 may take
DP_AGREE = 0.99  # tests/test_spatial_parallel.py:43 (mismatch < 1e-2)
# the float32 step of two ranks against one process on the card: the share of
# the parameters allowed an update of the other sign apart (0.058 % in the
# first runs), and how much further from a float64 step the two ranks' clipped
# gradient may lie than the one-process step's (float32 convolutions over 512²
# put both about 1e-3 of the largest element away, in the stem and the first
# blocks; the ranks 1.175e-3, one process 1.491e-3)
DP_F32_SHARE = 1e-3
DP_F64_RATIO = 2.0
OPT_CLIP = 0.5  # gradient_clip_val of the recipe (train_config)


def _dp_flat(model) -> "torch.Tensor":
    import torch

    return torch.cat([t.detach().reshape(-1).float() for t in model.state_dict().values()])


def _dp_batch():
    """Phase 8's first train batch (bs 16: decode, kernel 4, EDT), one
    generator seed, on the card."""
    import torch

    from deadtrees_tpu_torch.train import Trainer

    trainer = Trainer(train_config(REPO / "build" / "chip_smoke" / "train" / "data"),
                      work_dir=DP_DIR / "batch")
    trainer._build()
    with contextlib.closing(trainer.datamodule.train_batches(
            torch.Generator().manual_seed(SEED + 18))) as batches:
        batch = next(batches)
    return {k: batch[k] for k in ("image", "mask", "distmap")}


def _dp_steps(batch, steps: int = DP_STEPS):
    """A fresh flagship trainer (the seed's weights) takes ``steps`` train
    steps on ``batch``; returns its parameters and buffers, flat."""
    import torch

    from deadtrees_tpu_torch.train import Trainer

    trainer = Trainer(train_config(REPO / "build" / "chip_smoke" / "train" / "data"),
                      work_dir=DP_DIR / "steps")
    trainer._build()
    for _ in range(steps):
        trainer.train_step(trainer.state, batch, 1)
    torch.cuda.synchronize()
    flat = _dp_flat(trainer.model).cpu()
    del trainer
    torch.cuda.empty_cache()
    return flat


def _dp_f32_step(batch, mesh=None):
    """One float32 step of the flagship (seed's weights) on ``batch`` (this
    rank's slice under ``mesh``): (metrics, Adam's first moment, the
    parameters and buffers), flat, on the host."""
    import torch

    from deadtrees_tpu_torch.models import create_model, init_model
    from deadtrees_tpu_torch.train import (
        OptimizerConfig,
        TrainState,
        build_loss,
        make_optimizer,
        make_train_step,
    )

    cfg = train_config(Path("."))
    net = cfg["model"]["network"]
    model = create_model(net["architecture"], net["encoder_name"],
                         decoder_channels=net["decoder_channels"], in_channels=4, classes=3,
                         dtype=torch.float32)
    model = init_model(model, generator=torch.Generator().manual_seed(SEED)).cuda()
    state = TrainState(model, make_optimizer(model.parameters(), OptimizerConfig(steps_per_epoch=1)))
    step = make_train_step(model, build_loss(net["losses"], 3), num_classes=3, mesh=mesh)
    _, metrics = step(state, batch, 1)
    torch.cuda.synchronize()
    out = ({k: float(v) for k, v in metrics.items()},
           torch.cat([m.reshape(-1) for m in state.optimizer.mu]).cpu(), _dp_flat(model).cpu())
    del model, state, step
    torch.cuda.empty_cache()
    return out


def _dp_f64_mu(batch):
    """Adam's first moment after the one-process step of
    :func:`_dp_f32_step`, from a float64 forward and backward of the same
    model and batch (the clipped gradient × 0.1): the reference that both
    float32 steps are measured against."""
    import torch

    from deadtrees_tpu_torch.losses import class2one_hot
    from deadtrees_tpu_torch.models import create_model, init_model
    from deadtrees_tpu_torch.train import build_loss

    net = train_config(Path("."))["model"]["network"]
    model = create_model(net["architecture"], net["encoder_name"],
                         decoder_channels=net["decoder_channels"], in_channels=4, classes=3,
                         dtype=torch.float32)
    model = init_model(model, generator=torch.Generator().manual_seed(SEED)).cuda().double()
    model.train()
    b = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    logits = model(b["image"])
    probs = torch.softmax(logits, 1)
    total, _ = build_loss(net["losses"], 3)(probs, class2one_hot(b["mask"], 3).double(),
                                            logits=logits, distmap=b["distmap"], epoch=1)
    grads = torch.autograd.grad(total, list(model.parameters()))
    flat = torch.cat([g.reshape(-1) for g in grads])
    scale = min(1.0, OPT_CLIP / float(flat.norm()))
    out = (0.1 * scale * flat).float().cpu()
    del model, logits, probs, total, grads, flat
    torch.cuda.empty_cache()
    return out


def _event_ms(fn, reps: int) -> float:
    import torch

    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def dp_nccl1() -> int:
    """Child 1 of phase 18 (no group, then a one-rank NCCL group): 8 bf16
    steps at bs 16 with and without the group (deterministic cuDNN), the
    NCCL all-reduce of the flat gradient buffer, and the one-process
    float32 step that the two ranks are held to."""
    import torch
    import torch.distributed as dist

    from deadtrees_tpu_torch.parallel import create_mesh

    set_precision()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    batch = _dp_batch()
    t0 = time.perf_counter()
    a = _dp_steps(batch)
    out["steps_s"] = time.perf_counter() - t0
    port = int(os.environ["DP_PORT"])
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    mesh = create_mesh(1)
    b = _dp_steps(batch)
    out["nccl1_bit_equal"] = bool(torch.equal(a, b))
    out["nccl1_max_abs"] = float((a - b).abs().max())
    n = sum(p.numel() for p in _dp_model_params())
    buf = torch.randn(n, device="cuda")
    out["grad_buffer_bytes"] = n * 4
    out["nccl1_all_reduce_ms"] = _event_ms(lambda: dist.all_reduce(buf, group=mesh.group), 10)
    del buf
    dist.destroy_process_group()
    if not out["nccl1_bit_equal"]:  # the bar becomes the spread of two runs without a group
        out["spread_no_group"] = float((a - _dp_steps(batch)).abs().max())
    small = {k: v[:DP_F32_BS].contiguous() for k, v in batch.items()}
    torch.save(small, DP_DIR / "f32_batch.pt")
    torch.save(_dp_f32_step(small), DP_DIR / "f32_ref.pt")
    torch.save(_dp_f64_mu(small), DP_DIR / "f64_mu.pt")
    # the spread of the one-process step itself: cuDNN's other algorithms
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    torch.save(_dp_f32_step(small)[1], DP_DIR / "f32_ref_mu2.pt")
    (DP_DIR / "nccl1.json").write_text(json.dumps(out))
    return 0


def _dp_named_params():
    import torch

    from deadtrees_tpu_torch.models import create_model

    net = train_config(Path("."))["model"]["network"]
    with torch.device("meta"):
        model = create_model(net["architecture"], net["encoder_name"],
                             decoder_channels=net["decoder_channels"], in_channels=4, classes=3)
    return list(model.named_parameters())


def _dp_model_params():
    return [p for _, p in _dp_named_params()]


def dp_ranks() -> int:
    """Child 2 of phase 18, one of two gloo ranks on the card: the float32
    step against the one-process step, the gloo all-reduce of the flat
    gradient buffer, and 16 scenes through the sharded predictor."""
    import torch
    import torch.distributed as dist

    from deadtrees_tpu_torch.infer import TorchInference, make_scene_predictor, predict_scenes
    from deadtrees_tpu_torch.parallel import create_mesh, distributed_init, shard_batch
    from deadtrees_tpu_torch.train import OptimizerConfig

    set_precision()
    distributed_init(backend="gloo")
    mesh = create_mesh(2)
    out = {"rank": mesh.rank}
    batch = shard_batch(torch.load(DP_DIR / "f32_batch.pt"), mesh)
    metrics, mu, flat = _dp_f32_step(batch, mesh)
    ref_metrics, ref_mu, ref_flat = torch.load(DP_DIR / "f32_ref.pt")
    out["f32_rel"] = {k: abs(metrics[k] - v) / max(abs(v), 1e-12)
                      for k, v in ref_metrics.items()}
    floor = 1e-4 * float(ref_mu.abs().max())
    out["f32_mu_over_bar"] = int(((mu - ref_mu).abs() > 1e-4 * ref_mu.abs() + floor).sum())
    out["f32_mu_max_rel"] = float((mu - ref_mu).abs().max()) / float(ref_mu.abs().max())
    f64 = torch.load(DP_DIR / "f64_mu.pt")
    top = float(f64.abs().max())
    out["f32_ref_vs_f64"] = float((ref_mu - f64).abs().max()) / top
    out["f32_ranks_vs_f64"] = float((mu - f64).abs().max()) / top
    names = [n for n, _ in _dp_named_params()]
    sizes = [p.numel() for _, p in _dp_named_params()]
    worst = []
    for name, a, r, t in zip(names, mu.split(sizes), ref_mu.split(sizes), f64.split(sizes)):
        worst.append((float((a - t).abs().max()) / top, float((r - t).abs().max()) / top,
                      float(t.abs().max()) / top, name))
    out["f32_worst_vs_f64"] = sorted(worst, reverse=True)[:6]
    mu2 = torch.load(DP_DIR / "f32_ref_mu2.pt")
    out["f32_ref_over_bar"] = int(((mu2 - ref_mu).abs() > 1e-4 * ref_mu.abs() + floor).sum())
    out["f32_ref_max_rel"] = float((mu2 - ref_mu).abs().max()) / float(ref_mu.abs().max())
    d = (flat - ref_flat).abs()
    out["f32_param_max_abs"] = float(d.max())
    lr = OptimizerConfig().learning_rate
    out["f32_param_flips"] = int((d > lr).sum())  # an update of the other sign (±lr)
    out["f32_params"] = d.numel()
    same = torch.tensor([float(flat.double().sum()), float(flat.double().square().sum())])
    both = torch.cat([same, -same])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    out["f32_ranks_equal"] = bool(torch.equal(both[:2], -both[2:]))

    n = sum(p.numel() for p in _dp_model_params())
    buf = torch.randn(n, device="cuda")
    out["gloo2_all_reduce_ms"] = _event_ms(lambda: dist.all_reduce(buf), 3)
    del buf

    engine = TorchInference(REPO / "build" / "chip_smoke" / "flagship_b5.ckpt")
    rng = np.random.default_rng(SEED + 30)  # phase 12's draws: the ragged scene, then 17
    rng.integers(0, 256, SCENE_RAGGED + (4,), dtype=np.uint8)
    scenes = list(rng.integers(0, 256, (17, SCENE, SCENE, 4), dtype=np.uint8)[:DP_SCENES])
    predictor = make_scene_predictor(engine.model, subtile=IMG, batch_size=SCENE_BS, mesh=mesh,
                                     packed=True)
    kw = dict(tile_shape=(SCENE, SCENE), subtile=IMG, batch_size=SCENE_BS, predictor=predictor)
    maps = predict_scenes(engine.model, scenes, **kw)
    want = np.load(DP_MAPS)
    out["scene_agreement"] = float(np.mean([(m == w).mean() for m, w in zip(maps, want)]))
    times = []
    for _ in range(3):
        dist.all_reduce(torch.zeros(1))  # the ranks start together
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_scenes(engine.model, scenes, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["scene_tiles_per_s"] = DP_SCENES * (SCENE // IMG) ** 2 / statistics.median(times)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    (DP_DIR / f"ranks_{mesh.rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def _dp_run(args, name: str, env=None) -> float:
    """Run a child of phase 18 in a session of its own, killed at
    DP_TIMEOUT; its output in DP_DIR/name.log. Returns its seconds."""
    log_path = DP_DIR / f"{name}.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen(args, cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
                                env={**os.environ, **(env or {})}, start_new_session=True)
        try:
            rc = proc.wait(timeout=DP_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise AssertionError(f"phase 18: {name} overran {DP_TIMEOUT} s; {log_path}")
    if rc != 0:
        tail = log_path.read_text()[-3000:]
        raise AssertionError(f"phase 18: {name} exited {rc}:\n{tail}")
    return time.perf_counter() - t0


def _torchrun(*args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", *args]


def _dp_data() -> Path:
    """8 train shards of 32 noise tiles (4 a rank) and a val shard, in
    phase 8's format (phase 14's shards are written after this phase)."""
    data = DP_DIR / "data"
    write_train_shards(data, train=8 * 32)
    return data


def _rank_logs(log_dir: Path) -> dict:
    """{rank: the rank's stderr} of a torchrun with --log-dir and --redirects 3."""
    logs = {}
    for path in log_dir.rglob("stderr.log"):
        logs[int(path.parent.name)] = path.read_text()
    if sorted(logs) != [0, 1]:
        raise AssertionError(f"phase 18: rank logs {sorted(logs)} under {log_dir}")
    return logs


def phase_parallel(card: str, train: dict) -> dict:
    """Data parallelism on the card, in child processes (this process
    joins no group): NCCL with one rank against no group, two gloo ranks
    (the float32 step, the recipe's trainer through torchrun and the CLI,
    sharded scenes). Returns the numbers of the parallel line."""
    import ast
    import csv

    from deadtrees_tpu_torch.train.trainer import SWA_BN_BATCHES

    t_phase = time.perf_counter()
    if DP_DIR.exists():
        shutil.rmtree(DP_DIR)
    DP_DIR.mkdir(parents=True)
    out = {"card": card}
    port = _free_port()
    out["nccl1_s"] = _dp_run([sys.executable, str(REPO / "chip_smoke.py"), "--dp", "nccl1"],
                             "nccl1", {"DP_PORT": str(port)})
    one = json.loads((DP_DIR / "nccl1.json").read_text())
    out.update(one)
    if one["nccl1_bit_equal"]:
        log(f"phase 18: {DP_STEPS} bf16 steps at bs {TRAIN_BS} under a one-rank NCCL group "
            f"bit-equal to the same steps without a group (cuDNN deterministic)")
    elif one["nccl1_max_abs"] > one["spread_no_group"]:
        raise AssertionError(f"phase 18: NCCL with one rank differs by {one['nccl1_max_abs']}, "
                             f"two runs without a group by {one['spread_no_group']}")
    log(f"phase 18: one all_reduce of the flat gradient buffer ({one['grad_buffer_bytes']} "
        f"bytes), NCCL, one rank: {one['nccl1_all_reduce_ms']:.3f} ms on {card}")

    out["ranks_s"] = _dp_run(_torchrun(str(REPO / "chip_smoke.py"), "--dp", "ranks"), "ranks")
    ranks = [json.loads((DP_DIR / f"ranks_{r}.json").read_text()) for r in (0, 1)]
    for r in ranks:
        bad = {k: v for k, v in r["f32_rel"].items() if k in ("total_loss", "grad_norm")
               and v > 1e-4}
        if bad or not r["f32_ranks_equal"]:
            raise AssertionError(f"phase 18: float32 step of rank {r['rank']}: {r}")
        if (r["f32_param_flips"] > DP_F32_SHARE * r["f32_params"]
                or r["f32_ranks_vs_f64"] > DP_F64_RATIO * r["f32_ref_vs_f64"]):
            raise AssertionError(f"phase 18: float32 gradient / parameters of rank "
                                 f"{r['rank']}: {r}")
        if r["scene_agreement"] < DP_AGREE:
            raise AssertionError(f"phase 18: sharded scenes agree {r['scene_agreement']}")
    r0 = ranks[0]
    out.update({k: r0[k] for k in ("f32_rel", "f32_mu_over_bar", "f32_mu_max_rel",
                                   "f32_ref_over_bar", "f32_ref_max_rel", "f32_ref_vs_f64",
                                   "f32_ranks_vs_f64", "f32_worst_vs_f64",
                                   "f32_param_max_abs", "f32_params",
                                   "f32_param_flips", "gloo2_all_reduce_ms",
                                   "scene_agreement", "scene_tiles_per_s")})
    out["ranks_peak_gib"] = [r["peak_gib"] for r in ranks]
    log(f"phase 18: float32 step of 2 gloo ranks (global bs {DP_F32_BS}) against one process: "
        f"rel. error {r0['f32_rel']}, gradient elements over the bar {r0['f32_mu_over_bar']} "
        f"(largest error {r0['f32_mu_max_rel']:.3e} of the largest element; two one-process "
        f"steps with other cuDNN algorithms: {r0['f32_ref_over_bar']}, "
        f"{r0['f32_ref_max_rel']:.3e}; largest error against a float64 step: one process "
        f"{r0['f32_ref_vs_f64']:.3e}, two ranks {r0['f32_ranks_vs_f64']:.3e}; worst tensors "
        f"(ranks, one process, size; of the largest element) {r0['f32_worst_vs_f64']}), "
        f"parameters max |d| {r0['f32_param_max_abs']:.3e}, {r0['f32_param_flips']} of "
        f"{r0['f32_params']} a step of the other sign; the ranks equal")
    log(f"phase 18: one all_reduce of the flat gradient buffer, gloo, two ranks on one card: "
        f"{r0['gloo2_all_reduce_ms']:.3f} ms; {DP_SCENES} scenes of {SCENE}² through "
        f"predict_scenes, 2 ranks x {SCENE_BS // 2} subtiles a chunk: agreement with phase 12 "
        f"{r0['scene_agreement']:.6f}, {r0['scene_tiles_per_s']:.2f} tiles/s (two ranks share "
        f"one card: the path, not a speed-up)")

    data = _dp_data()
    run_dir = DP_DIR / "run"
    log_dir = DP_DIR / "torchrun_logs"
    overrides = ["experiment=flagship_b5_multistage", f"data_dir={data}", f"run_dir={run_dir}",
                 f"logger.save_dir={run_dir / 'metrics'}", "trainer.devices=2",
                 f"trainer.max_epochs={DP_EPOCHS}", f"trainer.limit_train_batches={TRAIN_STEPS}",
                 f"trainer.limit_val_batches={VAL_STEPS}", "callbacks.multistage.unfreeze_epoch=0",
                 "callbacks.multistage.lr_reduce_epoch=null", "callbacks.swa.swa_epoch_start=1",
                 f"datamodule.batch_size={TRAIN_BS}", "logger.kind=csv", "print_config=false"]
    out["train_s"] = _dp_run(_torchrun("--log-dir", str(log_dir), "--redirects", "3", "-m",
                                       "deadtrees_tpu_torch", "train", "--backend", "gloo",
                                       *overrides), "train")
    logs = _rank_logs(log_dir)
    metrics_files = list(run_dir.rglob("metrics.csv"))
    ckpts = sorted(p.name for p in run_dir.rglob("*.ckpt"))
    if len(metrics_files) != 1 or "last.ckpt" not in ckpts or "swa.ckpt" not in ckpts:
        raise AssertionError(f"phase 18: metrics files {metrics_files}, checkpoints {ckpts}")
    with open(metrics_files[0]) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["train/total_loss"]) for r in rows]
    if len(rows) != DP_EPOCHS or any(float(r["replicas_equal"]) != 1.0 for r in rows) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 18: the 2-rank fit's metrics {rows}")
    vals, launches, peaks = {}, {}, {}
    for rank, text in logs.items():
        vals[rank] = re.findall(r"epoch (\d+), rank \d+: val (\{.*\})", text)
        m = re.search(r"rank \d of 2: (\d+) steps, kernel launches (\{.*?\}), peak device "
                      r"memory ([\d.]+) GiB", text)
        if m is None:
            raise AssertionError(f"phase 18: no launch line in rank {rank}'s log")
        launches[rank] = ast.literal_eval(m.group(2))[AUGMENT]
        peaks[rank] = float(m.group(3))
        steps = int(m.group(1))
    if vals[0] != vals[1] or len(vals[0]) != DP_EPOCHS:
        raise AssertionError(f"phase 18: the ranks' val metrics differ: {vals}")
    want = DP_EPOCHS * TRAIN_STEPS + SWA_BN_BATCHES
    if steps != DP_EPOCHS * TRAIN_STEPS or set(launches.values()) != {want}:
        raise AssertionError(f"phase 18: kernel 4 launches {launches}, want {want} a rank "
                             f"({steps} steps + {SWA_BN_BATCHES} recalibration batches)")
    step_ms = 1e3 / float(rows[-1]["steps_per_sec"])
    out.update(train_losses=losses, train_val=[ast.literal_eval(v) for _, v in vals[0]],
               train_launches=launches, train_peak_gib=peaks, train_step_ms=step_ms,
               phase8_step_ms=train["step_ms"])
    log(f"phase 18: the recipe's trainer on 2 gloo ranks through torchrun and the CLI "
        f"(global bs {TRAIN_BS}, {TRAIN_BS // 2} a rank, {DP_EPOCHS} epochs of {TRAIN_STEPS} "
        f"steps, SWA from epoch 1): train loss {losses}, val equal on both ranks, parameters "
        f"equal after every epoch, kernel 4 {launches} ({steps} steps + {SWA_BN_BATCHES} "
        f"recalibration batches a rank), peak memory {peaks} GiB; epoch {DP_EPOCHS - 1} at "
        f"{step_ms:.1f} ms a step (data included) against phase 8's one-process bs-"
        f"{TRAIN_BS} step of {train['step_ms']:.1f} ms (two ranks share one card)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18: {out['phase_s']:.1f} s on {card}")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    if not (REPO / "deadtrees_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: no deadtrees_tpu_torch package next to {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--warm"]:
        return warm(sys.argv[2])
    if sys.argv[1:2] == ["--dp"]:
        return {"nccl1": dp_nccl1, "ranks": dp_ranks}[sys.argv[2]]()
    t_start = time.perf_counter()
    from deadtrees_tpu_torch.core.compile_opts import disable_compile
    from deadtrees_tpu_torch.data.tar import NATIVE_FALLBACKS

    NATIVE_FALLBACKS.clear()  # phases 8, 13 and 14 read their shards natively

    phase_device()
    card = card_line()
    errs = {name: 0.0 for name in REPLACES}
    workdir = REPO / "build" / "chip_smoke"
    ckpt = workdir / "flagship_b5.ckpt"
    workdir.mkdir(parents=True, exist_ok=True)
    hp, model = build_flagship(ckpt)
    warmers = start_warmers()
    try:
        # phases 2-14 run eagerly (module docstring); phase 15 compiles
        with disable_compile():
            model = model.cuda().eval()
            phase_kernels(model, errs)
            phase_edt_kernels(card)

            fused, plain = phase_slice(ckpt, hp)
            counts = phase_server(ckpt)
            tot = phase_timings(model, fused, plain, card)
            phase_profile(fused, plain, card)
            del fused
            errs.update({name: 0.0 for name in (*NHWC_REPLACES, DW)})
            phase_nhwc_kernels(model, errs)
            nhwc, nhwc_counts = phase_nhwc_slice(ckpt, hp, plain)
            nhwc_tot, route_ms = phase_nhwc_timings(ckpt, model, nhwc, plain, card, errs)
            phase_nhwc_profile(nhwc, card)
            del nhwc
            torch.cuda.empty_cache()
            scenes = phase_scenes(ckpt, hp, plain, route_ms[SCENE_BS]["plain"], card)
            del plain, model
            torch.cuda.empty_cache()
            augment_row = phase_augment(card)
            train = phase_train(card)
            augment_row["launches"] = train["launches"]
            torch.cuda.empty_cache()
            recipe = phase_recipe(card)
            torch.cuda.empty_cache()
            # phase 16's exports fill the wait for the warmers, whose memory
            # is free before phase 14's 74 GiB batch
            exported = phase_export(ckpt, card)
            zoo = phase_zoo(card)
            torch.cuda.empty_cache()
            parallel = phase_parallel(card, train)
            cold = join_warmers(warmers, 1200)
            data = phase_data(card, train)
        torch.cuda.empty_cache()
        compiled = phase_compiled(ckpt, card, cold, t_start)
    finally:
        stop_warmers(warmers)
    with disable_compile():
        exported["timings"] = phase_export_timings(ckpt, exported, card)

    kernels = []
    for name in REPLACES:
        t = tot[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
            "library_ms": None, "tc_bound_ms": t["tc_bound_ms"],
            "f32_bound_ms": t["f32_bound_ms"],
        })
    kernels.append({k: augment_row[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms")})
    # no products: the same bound
    kernels[-1]["tc_bound_ms"] = kernels[-1]["f32_bound_ms"] = augment_row["bound_ms"]
    rows = [(name, NHWC_SOURCE, NHWC_REPLACES[name]) for name in NHWC_REPLACES]
    for name, source, replaces in rows + [(DW, DW_SOURCE, DW_REPLACES)]:
        t = nhwc_tot[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": nhwc_counts[name], "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
            "library_ms": t.get("library_ms"), "tc_bound_ms": t["tc_bound_ms"],
            "f32_bound_ms": t["f32_bound_ms"],
        })
        if name == DW:
            kernels[-1].update({k: t[k] for k in ("cold_ms", "library_cold_ms", "host_ms",
                                                   "library_host_ms")})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print("scenes " + json.dumps(dict(scenes, card=card)))
    print("recipe " + json.dumps(dict(recipe, card=card)))
    print("data " + json.dumps(dict(data, card=card)))
    print("compiled " + json.dumps(dict(compiled, card=card)))
    print("exported " + json.dumps(dict(exported, card=card,
                                        script_s=time.perf_counter() - t_start)))
    for line in zoo:
        print("zoo " + json.dumps(dict(line, card=card)))
    print("parallel " + json.dumps(dict(parallel, script_s=time.perf_counter() - t_start)))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
