"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (process start to the window's start)
builds the cell from its files (``harness/spec.py``), then the window runs
for ``--seconds`` and the output check compares what the timed path
produced with the plain reference (``reference/``), once the window has
closed and the program's state is freed. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a device trace
of the window. The last line of standard output is one JSON object;
standard error ends with each number compared beside its limit.

Exits 2 on a bad argument or cell, 3 without the CUDA cards the cell asks
for, 4 when a module of the JAX package, or JAX itself, was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.harness import env, spec  # noqa: E402
from port_bench.harness.record import Record  # noqa: E402
from port_bench.harness.report import breakdown, device_info, round_trip  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(args, root: Path = ROOT, device=None) -> dict:
    """The run's result object; ``device`` None asks for the cell's CUDA
    cards (the tests pass the CPU)."""
    cell = spec.cell(args.workload, root)
    env.configure(root)
    import torch

    if device is None:
        device = env.require_cuda(cell.chips)
    kind = importlib.import_module(f"port_bench.kinds.{cell.kind}")
    metrics = cell.per_layer if args.trace else cell.end_to_end
    readers = {m["name"]: spec.reader(m["name"], root) for m in metrics}

    job = kind.Run(cell, args.seed, device, root)
    try:
        job.setup()
        setup_s = time.perf_counter() - T0
        say("setup " + json.dumps({"setup_s": setup_s, **job.setup_parts}))
        tracer = None
        if args.trace:
            from port_bench.harness.trace import Tracer

            tracer = Tracer(kind.RANGES)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        record: Record = job.window(args.seconds, tracer)
        record.setup_s = setup_s
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        job.free()
        checks = job.check()
    finally:
        job.close()
    values = {}
    for m in metrics:
        v = readers[m["name"]](record)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    failed = int(record.counters.get("failed", 0))
    attempted = int(record.counters.get("steps", record.counters.get("scenes", 0)))
    result = {
        "correct": failed == 0 and all(c.ok for c in checks),
        "attempted": attempted,
        "failed": failed,
        "metrics": values,
        "device": device_info(device, cell.chips, peak, record.trace),
    }
    if record.trace is not None:
        result["breakdown"] = breakdown(record.trace)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:  # the last lines of standard error
        say(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}")
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result = run(args)
    except spec.SpecError as e:
        say(f"error: {e}")
        return 2
    except env.NoDevice as e:
        say(f"error: {e}")
        return 3
    loaded = env.forbidden_loaded()
    if loaded:
        say(f"error: the process loaded {loaded}: the benchmark measures the port alone")
        return 4
    print(json.dumps(round_trip(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
