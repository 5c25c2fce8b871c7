"""One rank of the port's data-parallel CPU tests (tests/test_torch_parallel.py
starts two of them over gloo on 127.0.0.1, each with a time limit).

    python tests/torch_dp_worker.py SCENARIO RANK WORLD PORT WORKDIR

``step``: the unet/resnet18 of ``WORKDIR/init.pt`` takes one float32 train
step on its slice of the global batch of ``WORKDIR/batch.npz``, then a step
whose batch holds a NaN on rank 1 only; then the sharded scene predictor
on ``scene``. ``trainer``: ``Trainer.fit()`` of ``WORKDIR/config.json``,
then a fit whose stop is asked for on rank 1 only.
Each rank writes ``WORKDIR/<scenario>_rank<R>.pt`` with what it saw,
including the collectives called in each part.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

COLLECTIVES = (
    "all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "reduce", "gather", "scatter", "all_to_all",
    "all_to_all_single", "barrier", "send", "recv", "isend", "irecv",
    "broadcast_object_list", "monitored_barrier",
)
CALLS: list = []


def record_collectives() -> None:
    """Wrap every collective of ``torch.distributed`` to log its name."""
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            CALLS.append(_name)
            return _fn(*args, **kwargs)

        setattr(dist, name, wrapped)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1) if a.ndim == 4 else a))


def unet():
    from deadtrees_tpu_torch.models import create_model

    return create_model("unet", "resnet18", in_channels=4, classes=3,
                        decoder_channels=(16, 16, 8, 8, 8), dtype=torch.float32)


def scenario_step(mesh, work: Path) -> dict:
    from deadtrees_tpu_torch.infer.sliding import make_scene_predictor
    from deadtrees_tpu_torch.parallel import replicate, shard_batch
    from deadtrees_tpu_torch.train import (
        OptimizerConfig,
        TrainState,
        build_loss,
        make_optimizer,
        make_train_step,
    )

    init = torch.load(work / "init.pt")
    data = np.load(work / "batch.npz")
    model = unet()
    model.load_state_dict(init)
    state = TrainState(model, make_optimizer(model.parameters(), OptimizerConfig(steps_per_epoch=1)))
    replicate(state, mesh)
    step = make_train_step(model, build_loss(["GDICE", "FOCAL", "BOUNDARY"], 3), num_classes=3,
                           mesh=mesh)
    batch = shard_batch({k: nchw(data[k]) for k in ("image", "mask", "distmap")}, mesh)
    out = {}
    del CALLS[:]
    _, metrics = step(state, batch, 0)
    out["step_calls"] = list(CALLS)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    # Adam's first moment after one step: 0.1 × the clipped global gradient
    out["mu"] = {k: v.clone() for k, v in zip(
        [n for n, _ in model.named_parameters()], state.optimizer.mu)}

    bad = dict(batch)
    bad["image"] = batch["image"].clone()
    if mesh.rank == 1:
        bad["image"][0, 0, 0, 0] = float("nan")
    opt = state.optimizer
    before = [t.clone() for t in opt.state_tensors()]
    _, m = step(state, bad, 0)
    out["nan_loss"] = float(m["total_loss"])
    out["nan_state_unchanged"] = all(
        torch.equal(v, out["state"][k]) for k, v in model.state_dict().items())
    out["nan_opt_unchanged"] = all(
        torch.equal(a, b) for a, b in zip(opt.state_tensors(), before))

    model.load_state_dict(init)
    model.eval()
    scene, valid = torch.from_numpy(data["scene"]), torch.ones(16, dtype=torch.bool)
    out["scene_single"] = make_scene_predictor(model, subtile=64, batch_size=16,
                                               device="cpu")(scene, valid)
    predict = make_scene_predictor(model, subtile=64, batch_size=16, mesh=mesh, device="cpu")
    del CALLS[:]
    out["scene_sharded"] = predict(scene, valid)
    out["scene_calls"] = list(CALLS)
    try:
        make_scene_predictor(model, subtile=64, batch_size=15, mesh=mesh, device="cpu")
        out["odd_batch_raises"] = False
    except ValueError:
        out["odd_batch_raises"] = True
    return out


def scenario_trainer(mesh, work: Path) -> dict:
    from deadtrees_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from deadtrees_tpu_torch.train import Trainer

    cfg = json.loads((work / "config.json").read_text())
    trainer = Trainer(cfg, work_dir=work / "run", device="cpu")
    reset_launch_counts()
    del CALLS[:]
    result = trainer.fit()
    # a stop asked for on rank 1 alone: both ranks stop at the same boundary
    stopped = Trainer(cfg, work_dir=work / "stopped", device="cpu")
    if mesh.rank == 1:
        stopped.request_stop()
    stop_result = stopped.fit()
    return {
        "stop_preempted": stop_result.get("preempted"),
        "stop_step": stopped.state.step,
        "result": {k: v for k, v in result.items() if isinstance(v, float)},
        "best_ckpt": result.get("best_ckpt"),
        "step": trainer.state.step,
        "steps_per_epoch": trainer.datamodule.steps_per_epoch,
        "state": {k: v.clone() for k, v in trainer.model.state_dict().items()},
        "last_cm": trainer.last_cm,
        "launches": dict(LAUNCHES),
        "collectives": sorted(set(CALLS)),
    }


def main() -> int:
    scenario, rank, world, port, work = sys.argv[1:6]
    rank, world, work = int(rank), int(world), Path(work)
    torch.set_num_threads(1)
    from deadtrees_tpu_torch.parallel import create_mesh, distributed_init

    distributed_init(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = create_mesh(world, device="cpu")
    record_collectives()
    out = {"step": scenario_step, "trainer": scenario_trainer}[scenario](mesh, work)
    torch.save(out, work / f"{scenario}_rank{rank}.pt")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
