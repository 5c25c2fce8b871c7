"""The output check's control and planted faults, read at a cell's size.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the cell's inputs and weights as a run does and
puts a stand-in in the program's place, then prints what the check
compares (``kinds/<kind>.compare``), one JSON line a seed:

- ``control``: the reference a step below the configuration's precision
  (fp8 convolutions for the bf16 model; for training also the batch,
  float32 in the configuration, in bfloat16);
- ``witness_bf16``: the reference with the configuration's own bf16
  convolutions, a second witness of what that precision reads;
- faults a cell of the kind can have: ``half_batch`` (training: each
  step's loss over the first half of the batch; scenes: the second half
  of each scene's subtiles left at 0), ``altered`` (one answer changed
  where it is produced: an image element, or an 8×8 block of a map) and,
  for training, ``unchanged`` (a step that leaves the state as it was).

The benchmark's runs never run this; the limits in ``limits/`` lie
between the program's readings and these.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench.harness import env, spec  # noqa: E402
from port_bench.harness import traffic as gen  # noqa: E402
from port_bench.harness import weights  # noqa: E402


def train_batches(cell, seed: int):
    """The checked steps' samples and generator states: the first samples
    in order, the recipe's generator drawn from as the data module does."""
    from port_bench.kinds import train
    from port_bench.reference import batch as ref_batch

    bs = cell.traffic["batch_size"]
    g = torch.Generator().manual_seed(train.seed31(seed))
    files, states = [], []
    for k in range(cell.traffic["checked_steps"]):
        files.append([f"s{i:06d}" for i in range(k * bs, (k + 1) * bs)])
        states.append(g.get_state())
        ref_batch.draw_from(g, bs)
    return files, states


def train_readings(cell, seed: int, device) -> dict:
    from port_bench.kinds import train

    tr, cfg = cell.traffic, cell.config
    files, states = train_batches(cell, seed)

    def side(**kw):
        return train.reference_outputs(cfg, tr, seed, device, files, states, **kw)

    ref = side()
    altered = dict(ref, images=[im.clone() for im in ref["images"]])
    altered["images"][0][0, 0, 0, 0] += 1.0
    unchanged = dict(ref, delta_norms={n: 0.0 for n in ref["delta_norms"]})
    return {"control": train.compare(side(numerics="fp8", batch_dtype=torch.bfloat16), ref),
            "witness_bf16": train.compare(side(numerics="bf16"), ref),
            "faults": {"half_batch": train.compare(side(half_batch=True), ref),
                       "altered": train.compare(altered, ref),
                       "unchanged": train.compare(unchanged, ref)}}


def scenes_readings(cell, seed: int, device) -> dict:
    from port_bench.kinds import scenes
    from port_bench.reference.core import float32_exact

    tr, cfg = cell.traffic, cell.config
    pool = gen.scene_pool(seed, tr, device)
    params = weights.make(cfg, seed, device)
    per_scene = (tr["scene"] // tr["subtile"]) ** 2
    calib = np.concatenate([scenes.subtiles(s, tr["subtile"])
                            for s in pool[:-(-tr["calibration_tiles"] // per_scene)]])
    with float32_exact():
        weights.calibrate(params, cfg, scenes.normalize(
            torch.from_numpy(calib[:tr["calibration_tiles"]]).to(device), tr))
    rng = random.Random(seed)
    out = {"control": {"map_gap": 0.0}, "witness_bf16": {"map_gap": 0.0},
           "faults": {"half_batch": {"map_gap": 0.0}, "altered": {"map_gap": 0.0}}}
    t = tr["subtile"]
    for i in rng.sample(range(len(pool)), tr["checked_scenes"]):
        z = scenes.reference_logits(cfg, tr, params, pool[i], device)
        fp8 = scenes.reference_logits(cfg, tr, params, pool[i], device, numerics="fp8").argmax(0)
        best = z.argmax(0)
        half = best.clone()
        n = tr["scene"] // t
        for j in range(per_scene // 2, per_scene):  # the scene's second half left out
            r, c = divmod(j, n)
            half[r * t:(r + 1) * t, c * t:(c + 1) * t] = 0
        altered = best.clone()
        altered[:8, :8] = (altered[:8, :8] + 1) % cfg["classes"]
        bf16 = scenes.reference_logits(cfg, tr, params, pool[i], device, numerics="bf16").argmax(0)
        out["control"]["map_gap"] = max(out["control"]["map_gap"], scenes.logit_gap(z, fp8))
        out["witness_bf16"]["map_gap"] = max(out["witness_bf16"]["map_gap"],
                                             scenes.logit_gap(z, bf16))
        out.setdefault("logits", []).append(
            {"max_abs": float(z.abs().max()), "mean_abs": float(z.abs().mean()),
             "bf16_flips": float((bf16 != best).float().mean()),
             "fp8_flips": float((fp8 != best).float().mean())})
        for key, classes in (("half_batch", half), ("altered", altered)):
            out["faults"][key]["map_gap"] = max(out["faults"][key]["map_gap"],
                                                scenes.logit_gap(z, classes))
    return out


def readings(cell, seed: int, device) -> dict:
    return {"train": train_readings, "scenes": scenes_readings}[cell.kind](cell, seed, device)


def main(argv=None, root: Path = ROOT, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload, root)
    if device is None:
        device = env.require_cuda(cell.chips)
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name, "seed": seed, **readings(cell, seed, device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
