"""The port's data parallelism on the CPU, against the JAX mesh.

Two ranks are spawned workers (``tests/torch_dp_worker.py``) over gloo on
127.0.0.1, each with a time limit of its own; a worker that overruns it is
killed and the test fails. The model is unet/resnet18 with decoder
(16, 16, 8, 8, 8), float32, from the port's tree filled from numpy
(``tests/test_torch_models.fill_tree``).

- One train step of the two ranks on a global batch of 8 (4 a rank) at
  64² against JAX's ``make_train_step`` on the same batch over the
  8-device CPU mesh (the setup of ``tests/test_multiprocess.py``
  ``_single_process_metrics``): every scalar metric within 1e-4, that
  test's bar. The ranks' parameters and BatchNorm statistics are
  bit-equal. Against JAX: the running statistics within 1e-5 (relative
  to max(1, |x|)); the parameters within 2·lr + 1e-6, since Adam's first
  update is ±lr for every gradient above eps and a gradient that is zero
  up to rounding (a bias before a train-mode BatchNorm) may take either
  sign, and at most 0.1 % of them more than lr apart. The clipped
  global gradient (Adam's first moment over 0.1) within rtol 1e-4 and a
  floor of 1e-4 of its largest element, the bar of
  ``tests/test_torch_train_step.py``. The same step of one process on the
  whole batch (the port, no group) gives the same metrics to 1e-5 and the
  gradient to the same bar. (With float32 sums in the global BatchNorm
  the deepest layers' gradients missed it by 1.4 ×: float64 sums put
  them as close to a float64 step as the one-process BatchNorm's.)
- A NaN in rank 1's slice leaves both ranks' parameters, BatchNorm
  statistics and Adam state unchanged.
- Only ``all_reduce`` and ``broadcast`` are called during a step, and one
  ``all_reduce`` during a sharded scene call.
- The sharded scene predictor against the single one and against JAX's:
  mismatch < 1e-2 (``tests/test_spatial_parallel.py``'s bar).
- ``Trainer.fit()`` on two ranks: rank 0 alone writes the metrics file and
  the checkpoints, the val metrics and confusion matrices are equal on
  both, each epoch takes the smaller rank's steps, the parameters stay
  bit-equal. A stop asked for on one rank stops both at the same step
  boundary (the SIGTERM contract: the launcher signals every rank, and
  the ranks agree on the boundary).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deadtrees_tpu.infer.sliding import make_scene_predictor as jax_make_scene_predictor
from deadtrees_tpu.losses.functional import batch_one_hot2dist, class2one_hot
from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu.parallel import create_mesh as jax_create_mesh
from deadtrees_tpu.parallel import replicate as jax_replicate
from deadtrees_tpu.parallel import shard_batch as jax_shard_batch
from deadtrees_tpu.train import (
    OptimizerConfig as JaxOptimizerConfig,
    TrainState as JaxTrainState,
    build_loss as jax_build_loss,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from deadtrees_tpu_torch.models import (
    create_model,
    state_dict_from_variables,
    tensor_variables_from_state_dict,
)
from deadtrees_tpu_torch.parallel import (
    batch_sharding,
    create_mesh,
    distributed_init,
    replicate,
    replicate_sharding,
    shard_batch,
)
from deadtrees_tpu_torch.parallel.mesh import batch_all, batch_mean, batch_sum, global_batch
from deadtrees_tpu_torch.train import (
    OptimizerConfig,
    TrainState,
    build_loss,
    make_optimizer,
    make_train_step,
)
from tests.test_torch_models import fill_tree

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dp_worker.py"
WORKER_TIMEOUT = 240  # seconds a rank may take
N = 64
DEC = (16, 16, 8, 8, 8)
LOSSES = ["GDICE", "FOCAL", "BOUNDARY"]
LR = OptimizerConfig().learning_rate


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(scenario: str, work: Path, world: int = 2) -> list:
    """Start ``world`` workers of ``scenario``; each has WORKER_TIMEOUT
    seconds, then all are killed. Returns each rank's output."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), scenario, str(r), str(world), str(port), str(work)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a {scenario} rank overran {WORKER_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {scenario} failed:\n{log[-3000:]}"
    return [torch.load(work / f"{scenario}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def _variables():
    with torch.device("meta"):
        model = create_model("unet", "resnet18", in_channels=4, classes=3,
                             decoder_channels=DEC, dtype=torch.float32)
    return fill_tree(tensor_variables_from_state_dict(model.state_dict()), seed=5)


def _global_batch():
    rng = np.random.default_rng(0)
    mask = np.zeros((8, N, N), np.int32)
    for b in range(8):
        y, x = rng.integers(0, N // 2, 2)
        mask[b, y:y + N // 3, x:x + N // 4] = 1 + b % 2
        mask[b, N - 12:N - 2, 2:14] = 2 - b % 2
    img = (mask[..., None] * 0.4 + rng.normal(size=(8, N, N, 4))).astype(np.float32)
    distmap = np.asarray(batch_one_hot2dist(class2one_hot(jnp.asarray(mask), 3)))
    scene = rng.integers(0, 255, (256, 256, 4), np.uint8)
    return {"image": img, "mask": mask, "distmap": distmap, "scene": scene}


@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp_step")
    variables = _variables()
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in
                state_dict_from_variables(variables).items()}, work / "init.pt")
    data = _global_batch()
    np.savez(work / "batch.npz", **data)
    return variables, data, run_ranks("step", work)


def _jax_model():
    return jax_create_model("unet", "resnet18", in_channels=4, classes=3,
                            decoder_channels=DEC, dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_step(step_case):
    """JAX's step on the global batch over the 8-device CPU mesh."""
    variables, data, _ = step_case
    mesh = jax_create_mesh()
    assert mesh.devices.size == 8
    tx = jax_make_optimizer(JaxOptimizerConfig(steps_per_epoch=1))
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), variables)
    state = jax_replicate(JaxTrainState.create(params=v["params"],
                                               batch_stats=v["batch_stats"], tx=tx), mesh)
    step = jax_make_train_step(_jax_model(), jax_build_loss(LOSSES, 3), num_classes=3)
    batch = jax_shard_batch({k: data[k] for k in ("image", "mask", "distmap")}, mesh)
    new, metrics = step(state, batch, jnp.int32(0))
    tree = {"params": jax.device_get(new.params), "batch_stats": jax.device_get(new.batch_stats)}
    mu = state_dict_from_variables({"params": jax.device_get(new.opt_state[1].mu),
                                    "batch_stats": tree["batch_stats"]})
    mu = {k: v for k, v in mu.items() if "running" not in k and "num_batches" not in k}
    return {k: float(v) for k, v in metrics.items()}, state_dict_from_variables(tree), mu


def test_two_rank_step_matches_the_jax_mesh_step(step_case, jax_step):
    _, _, (r0, r1) = step_case
    jax_metrics, jax_state, jax_mu = jax_step
    assert set(r0["metrics"]) == set(jax_metrics)
    for k, v in jax_metrics.items():
        assert r0["metrics"][k] == r1["metrics"][k], k  # one global batch: one number
        assert abs(r0["metrics"][k] - v) < 1e-4, (k, r0["metrics"][k], v)
    # the clipped global gradient (Adam's first moment / 0.1): rtol 1e-4, with
    # a floor of 1e-4 of the largest, as tests/test_torch_train_step.py holds it
    floor = 1e-4 * max(float(np.abs(np.asarray(v)).max()) for v in jax_mu.values())
    for k, want in jax_mu.items():
        want = torch.as_tensor(np.asarray(want))
        assert torch.equal(r0["mu"][k], r1["mu"][k]), k
        assert torch.all((r0["mu"][k] - want).abs() <= 1e-4 * want.abs() + floor), k
    flips = total = 0
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k  # the ranks stay bit-equal
        want = torch.as_tensor(np.asarray(jax_state[k]))
        if "running" in k:
            bar = 1e-5 * torch.clamp(want.abs(), min=1.0)
            assert torch.all((v - want).abs() <= bar), k
        elif v.is_floating_point():
            d = (v - want).abs()
            assert float(d.max()) <= 2 * LR + 1e-6, (k, float(d.max()))
            flips += int((d > LR).sum())
            total += d.numel()
    assert flips <= 1e-3 * total, flips / total


def test_two_rank_step_matches_one_process(step_case):
    variables, data, (r0, _) = step_case
    model = create_model("unet", "resnet18", in_channels=4, classes=3, decoder_channels=DEC,
                         dtype=torch.float32)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in
                           state_dict_from_variables(variables).items()})
    state = TrainState(model, make_optimizer(model.parameters(), OptimizerConfig(steps_per_epoch=1)))
    step = make_train_step(model, build_loss(LOSSES, 3), num_classes=3)
    batch = {k: torch.from_numpy(np.ascontiguousarray(np.moveaxis(data[k], -1, 1)
                                                      if data[k].ndim == 4 else data[k]))
             for k in ("image", "mask", "distmap")}
    _, metrics = step(state, batch, 0)
    for k, v in metrics.items():
        assert abs(float(v) - r0["metrics"][k]) <= 1e-5 * max(1.0, abs(float(v))), k
    for k, v in model.state_dict().items():
        if "running" in k:
            assert torch.allclose(v, r0["state"][k], rtol=1e-5, atol=1e-6), k
    mus = dict(zip([n for n, _ in model.named_parameters()], state.optimizer.mu))
    floor = 1e-4 * max(float(v.abs().max()) for v in mus.values())
    for k, v in mus.items():
        assert torch.all((v - r0["mu"][k]).abs() <= 1e-4 * v.abs() + floor), k


def test_a_nan_on_one_rank_leaves_both_ranks_unchanged(step_case):
    for out in step_case[2]:
        assert not np.isfinite(out["nan_loss"])
        assert out["nan_state_unchanged"] and out["nan_opt_unchanged"]


def test_only_all_reduce_and_broadcast_are_called(step_case):
    for out in step_case[2]:
        assert out["step_calls"] and set(out["step_calls"]) <= {"all_reduce", "broadcast"}
        assert out["scene_calls"] == ["all_reduce"]


def test_sharded_scenes_match_single_and_jax(step_case):
    variables, data, outs = step_case
    single = _jax_model_scene(variables, data["scene"])
    for out in outs:
        sharded = out["scene_sharded"].numpy()
        assert sharded.shape == (256, 256)
        assert (sharded != out["scene_single"].numpy()).mean() < 1e-2
        assert (sharded != single).mean() < 1e-2
        assert out["odd_batch_raises"]
    assert torch.equal(outs[0]["scene_sharded"], outs[1]["scene_sharded"])


def _jax_model_scene(variables, scene):
    predict = jax_make_scene_predictor(_jax_model(), subtile=64, batch_size=16)
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    return np.asarray(predict(v["params"], v["batch_stats"], jnp.asarray(scene),
                              jnp.ones((16,), bool)))


# -- the trainer on two ranks ---------------------------------------------------


def _trainer_config(data: Path) -> dict:
    return {
        "data_dir": str(data), "seed": 3,
        "datamodule": {"pattern": "train-combo-*.tar", "batch_size": 4, "num_workers": 1},
        "model": {
            "network": {"architecture": "unet", "encoder_name": "resnet18",
                        "decoder_channels": list(DEC), "classes": 3, "in_channels": 4,
                        "losses": LOSSES},
            "training": {"learning_rate": 1e-3, "cosineannealing_tmax": 10},
        },
        "trainer": {"max_epochs": 2, "min_epochs": 1, "precision": "f32", "devices": 2},
        "callbacks": {
            "model_checkpoint": {"monitor": "val/dice", "mode": "max", "dirpath": "checkpoints/"},
            "early_stopping": {"monitor": "val/dice", "patience": 200},
        },
        "logger": {"kind": "csv", "save_dir": "metrics"},
    }


@pytest.fixture(scope="module")
def trainer_case(tmp_path_factory):
    from tests.test_torch_trainer import write_shard

    work = tmp_path_factory.mktemp("dp_trainer")
    data = work / "data"
    # three train shards of 4: rank 0 reads two, rank 1 one; bs 4 = 2 a rank
    for i in range(3):
        (shard,) = write_shard(str(work / f"s{i}" / "train-combo-%06d.tar"), 4, 10 + i, f"t{i}")
        (data / "train").mkdir(parents=True, exist_ok=True)
        Path(shard).rename(data / "train" / f"train-combo-{i:06d}.tar")
    write_shard(str(data / "val" / "train-combo-%06d.tar"), 4, 20, "val")
    (data / "test").mkdir()
    (work / "config.json").write_text(json.dumps(_trainer_config(data)))
    return work, run_ranks("trainer", work)


def test_trainer_on_two_ranks(trainer_case):
    work, (r0, r1) = trainer_case
    assert r0["steps_per_epoch"] == r1["steps_per_epoch"] == 2  # min(8, 4) // 2
    assert r0["step"] == r1["step"] == 4  # 2 epochs of the smaller rank's 2 steps
    assert r0["result"] == r1["result"] and "val/dice" in r0["result"]
    assert np.array_equal(r0["last_cm"], r1["last_cm"])
    assert r0["last_cm"].sum() == 4 * 32 * 32  # the whole val batch, both halves
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    metrics = list((work / "run").rglob("metrics.csv"))
    assert len(metrics) == 1
    assert len(metrics[0].read_text().splitlines()) == 3
    assert (work / "run" / "checkpoints" / "last.ckpt").exists()
    assert Path(r1["best_ckpt"]).exists()
    assert set(r0["collectives"]) <= {"all_reduce", "broadcast"}


def test_a_stop_on_one_rank_stops_both_at_one_boundary(trainer_case):
    work, outs = trainer_case
    for out in outs:  # rank 1 alone was asked: both stop before the first step
        assert out["stop_preempted"] == 1.0 and out["stop_step"] == 0
    assert (work / "stopped" / "checkpoints" / "last.ckpt").exists()


# -- the mesh on one process ------------------------------------------------------


def test_one_process_mesh_is_the_identity():
    assert distributed_init() is False  # no WORLD_SIZE: nothing to join
    mesh = create_mesh(1, device="cpu")
    assert (mesh.rank, mesh.size, mesh.distributed) == (0, 1, False)
    with pytest.raises(ValueError, match="needs as many ranks"):
        create_mesh(2, device="cpu")
    x = torch.arange(6.0).reshape(6, 1)
    out = shard_batch({"image": x, "files": ["a"]}, mesh)
    assert torch.equal(out["image"], x) and out["files"] == ["a"]
    assert replicate(x, mesh) is x
    with global_batch(mesh):
        assert batch_sum(x) is x and batch_mean(x) is x
        flag = torch.tensor(True)
        assert batch_all(flag) is flag


def test_shardings_split_axis_zero():
    from deadtrees_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(torch.device("cpu"), rank=1, size=4)
    assert batch_sharding(mesh).local_range(8) == (2, 4)
    assert replicate_sharding(mesh).local_range(8) == (0, 8)
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(mesh).local_range(6)
