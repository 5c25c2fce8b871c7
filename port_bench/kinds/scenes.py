"""Scene cells: batch inference as the scene CLI runs it.

Set-up draws the traffic's pool of uint8 scenes on the device from the
seed and moves it to the host, makes the seed's weights and sets every
BatchNorm's running statistics from one train-mode forward of the
reference over the first ``calibration_tiles`` subtiles, builds the
configuration's model in its serving type, ``make_scene_predictor`` at
the traffic's chunk (packed maps) and warms it with one call.

The window calls ``predict_scenes`` (``infer/sliding.py``) on
consecutive groups of ``scenes_per_call`` scenes of the pool until
``--seconds`` have passed; every call returns its class maps on the host.

The check: ``checked_scenes`` of the window's maps, drawn from the seed
(a reservoir over every scene the window finished), against the float32
reference's logits over the same scene, subtile by subtile: the widest gap
by which the logit of the class the program gave lies below the
reference's best.
"""

from __future__ import annotations

import random
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from port_bench.harness import flops
from port_bench.harness import traffic as gen
from port_bench.harness import weights
from port_bench.harness.record import Record, checks
from port_bench.reference import model as ref_model
from port_bench.reference.core import Numerics, float32_exact

RANGES = ("window", "call")


def normalize(tiles_u8: torch.Tensor, traffic: Dict) -> torch.Tensor:
    """(N, T, T, C) uint8 → (N, C, T, T) float32, ``(x − 255 m) / (255 s)``."""
    c = tiles_u8.shape[-1]
    m = torch.tensor(traffic["normalize"]["mean"][:c], device=tiles_u8.device) * 255.0
    s = torch.tensor(traffic["normalize"]["std"][:c], device=tiles_u8.device) * 255.0
    return ((tiles_u8.float() - m) / s).permute(0, 3, 1, 2).contiguous()


def subtiles(scene: np.ndarray, t: int) -> np.ndarray:
    """(S, S, C) → (n, t, t, C), rows of subtiles in order."""
    s, _, c = scene.shape
    return scene.reshape(s // t, t, s // t, t, c).transpose(0, 2, 1, 3, 4).reshape(-1, t, t, c)


class Run:
    def __init__(self, cell, seed: int, device: torch.device, root: Path):
        self.cell, self.seed, self.device, self.root = cell, int(seed), device, root
        self.config, self.traffic = cell.config, cell.traffic
        self.setup_parts: Dict[str, float] = {}
        self.kept: List = []  # (pool index, class map) of the reservoir

    def setup(self) -> None:
        from deadtrees_tpu_torch.infer.sliding import make_scene_predictor
        from deadtrees_tpu_torch.models import create_model

        tr, cfg = self.traffic, self.config
        t = time.perf_counter()
        pool = gen.scene_pool(self.seed, tr, self.device)
        self.scenes = [pool[i] for i in range(pool.shape[0])]
        self.weights = weights.make(cfg, self.seed, self.device)
        per_scene = (tr["scene"] // tr["subtile"]) ** 2
        calib = np.concatenate([subtiles(s, tr["subtile"])
                                for s in self.scenes[:-(-tr["calibration_tiles"] // per_scene)]])
        x = normalize(torch.from_numpy(calib[:tr["calibration_tiles"]]).to(self.device), tr)
        with float32_exact():
            weights.calibrate(self.weights, cfg, x)
        del x
        self.setup_parts["inputs_s"] = time.perf_counter() - t

        t = time.perf_counter()
        prog = cfg["program"]
        self.model = create_model(prog["architecture"], prog["encoder_name"],
                                  decoder_channels=cfg["decoder_channels"],
                                  in_channels=cfg["in_channels"], classes=cfg["classes"],
                                  dtype=torch.bfloat16 if cfg["precision"] == "bf16"
                                  else torch.float32)
        self.model.load_state_dict(self.weights, strict=True)
        self.model.to(self.device).eval()
        self.predictor = make_scene_predictor(
            self.model, subtile=tr["subtile"], batch_size=tr["batch_size"], packed=True,
            device=self.device)
        self.setup_parts["build_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self._call(0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_parts["warmup_s"] = time.perf_counter() - t
        from deadtrees_tpu_torch.ops import _build

        self.setup_parts["nvcc_s"] = sum(_build.build_seconds.values())
        self.setup_parts["compile_s"] = sum(s for s, _ in self.predictor.program.compiles)

    def _call(self, start: int) -> list:
        from deadtrees_tpu_torch.infer.sliding import predict_scenes

        tr = self.traffic
        n = tr["scenes_per_call"]
        idx = [(start + j) % len(self.scenes) for j in range(n)]
        maps = predict_scenes(self.model, [self.scenes[i] for i in idx],
                              tile_shape=(tr["scene"], tr["scene"]), subtile=tr["subtile"],
                              batch_size=tr["batch_size"], predictor=self.predictor,
                              device=self.device)
        return list(zip(idx, maps))

    def window(self, seconds: float, tracer=None) -> Record:
        from torch.profiler import record_function

        tr = self.traffic
        rng = random.Random(self.seed)
        k = tr["checked_scenes"]
        spans: Dict[str, list] = {"call": []}
        seen = 0
        start = 0
        if tracer is not None:
            tracer.start()
        with record_function("window"):
            t0 = time.perf_counter()
            while True:
                a = time.perf_counter()
                with record_function("call"):
                    done = self._call(start)
                b = time.perf_counter()
                spans["call"].append((a, b))
                start += len(done)
                for item in done:  # reservoir sampling of the finished scenes
                    if len(self.kept) < k:
                        self.kept.append(item)
                    else:
                        j = rng.randrange(seen + 1)
                        if j < k:
                            self.kept[j] = item
                    seen += 1
                if b - t0 >= seconds:
                    break
            t1 = time.perf_counter()
        trace = tracer.stop() if tracer is not None else None
        per_scene = (tr["scene"] // tr["subtile"]) ** 2
        calls = len(spans["call"])
        return Record(
            cell=self.cell.name, window_s=t1 - t0, setup_s=0.0,
            counters={"scenes": seen, "tiles": seen * per_scene, "calls": calls,
                      "dispatches": calls * -(-tr["scenes_per_call"] * per_scene
                                              // tr["batch_size"]), "failed": 0},
            spans=spans, setup=dict(self.setup_parts),
            facts={"flops_per_tile": _flops_per_tile(self.config, tr)},
            trace=trace)

    def free(self) -> None:
        del self.model, self.predictor
        torch.cuda.empty_cache()

    def check(self) -> List[Check]:
        gaps = []
        for i, cmap in self.kept:
            z = reference_logits(self.config, self.traffic, self.weights, self.scenes[i],
                                 self.device)
            classes = torch.from_numpy(np.ascontiguousarray(cmap)).to(self.device)
            gaps.append(logit_gap(z, classes))
            say(f"scene {i}: widest gap {gaps[-1]:.6g}, logits max |z| "
                f"{float(z.abs().max()):.6g} mean |z| {float(z.abs().mean()):.6g}, "
                f"classes off the reference's argmax {float((z.argmax(0) != classes).float().mean()):.6g}")
        got = {"map_gap": max(gaps)}
        return checks(got, self.cell.limits)

    def close(self) -> None:
        pass


@torch.no_grad()
def reference_logits(config: Dict, traffic: Dict, params: Dict, scene: np.ndarray, device,
                     numerics: str = "float32") -> torch.Tensor:
    """(K, S, S) float32 logits of the reference over one scene, one
    subtile block of ``reference_tiles`` at a time."""
    t = traffic["subtile"]
    s = scene.shape[0]
    tiles = subtiles(scene, t)
    out = torch.empty((config["classes"], s, s), device=device)
    step = traffic["reference_tiles"]
    with float32_exact():
        for a in range(0, len(tiles), step):
            x = normalize(torch.from_numpy(tiles[a:a + step]).to(device), traffic)
            z = ref_model.forward(params, x, config, train=False, numerics=Numerics(numerics))
            for j in range(z.shape[0]):
                r, c = divmod(a + j, s // t)
                out[:, r * t:(r + 1) * t, c * t:(c + 1) * t] = z[j]
    return out


def logit_gap(logits: torch.Tensor, classes: torch.Tensor) -> float:
    """The widest gap between the reference's best logit and the logit of
    the class given, over every pixel; infinite where a class is out of
    range."""
    if int(classes.max()) >= logits.shape[0]:
        return float("inf")
    given = logits.gather(0, classes.long()[None]).squeeze(0)
    return float((logits.max(0).values - given).max())


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _flops_per_tile(config: Dict, traffic: Dict) -> float:
    params = {l.name: torch.empty(l.shape, device="meta") for l in ref_model.leaves(config)}
    x = torch.empty((1, config["in_channels"], traffic["subtile"], traffic["subtile"]),
                    device="meta")
    return float(sum(flops.forward_flops(
        lambda: ref_model.forward(params, x, config, train=False))))
