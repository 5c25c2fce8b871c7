"""The port's Trainer on the CPU, and its checkpoints in the JAX package.

``Trainer.fit()`` runs 2 epochs × 2 steps of the b0 EfficientUnet++ with
narrow decoder channels over two tiny shards (train and val, 32² RGBN
TIFF tiles written with the port's ``ShardWriter``), with the MultiStage
freeze in the first epoch. Its best checkpoint must load in
``deadtrees_tpu.core.load_model`` and give the port's float32 logits to
1e-4. The data-parallel configuration errors are here; two ranks in
tests/test_torch_parallel.py; the rest of the recipe in
tests/test_torch_recipe.py.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deadtrees_tpu.core import load_model as jax_load_model
from deadtrees_tpu_torch.core import load_model
from deadtrees_tpu_torch.data.pipeline import DataConfig, DeadtreesDataModule
from deadtrees_tpu_torch.data.shardwriter import ShardWriter
from deadtrees_tpu_torch.data.tar import count_shard_samples, iter_tar_samples
from deadtrees_tpu_torch.infer import TorchInference
from deadtrees_tpu_torch.train import Trainer

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and torch's default of a thread per core then oversubscribes the
    machine; these small models run as fast on two."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiff(arr, mode):
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="TIFF")
    return buf.getvalue()


def write_shard(pattern, n, seed, prefix):
    rng = np.random.default_rng(seed)
    with ShardWriter(pattern, maxcount=n) as w:
        for i in range(n):
            mask = np.zeros((SIZE, SIZE), np.uint8)
            mask[4:20, 6:26] = 1 + i % 2
            w.write({
                "__key__": f"{prefix}_{i:04d}",
                "rgbn.tif": _tiff(rng.integers(0, 256, (SIZE, SIZE, 4), dtype=np.uint8), "RGBA"),
                "mask.tif": _tiff(mask, "L"),
                "lu.tif": _tiff(rng.integers(0, 2, (SIZE, SIZE), dtype=np.uint8), "L"),
                "txt": f"{float(mask.astype(bool).mean() * 100):.2f}",
            })
    return w.shards


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    write_shard(str(d / "train" / "train-combo-%06d.tar"), 4, 0, "tile")
    write_shard(str(d / "val" / "train-combo-%06d.tar"), 4, 1, "val")
    (d / "test").mkdir()
    return d


def _config(dataset, **over):
    cfg = {
        "data_dir": str(dataset),
        "seed": 1,
        "datamodule": {"pattern": "train-combo-*.tar", "batch_size": 2},
        "model": {
            "network": {
                "architecture": "efficientunet++",
                "encoder_name": "timm-efficientnet-b0",
                "decoder_channels": [32, 24, 16, 12, 8],
                "classes": ["background", "conifers", "deciduous"],
                "in_channels": 4,
                "losses": ["GDICE", "FOCAL", "BOUNDARY"],
            },
            "training": {"learning_rate": 1e-3, "cosineannealing_tmax": 10},
        },
        "trainer": {"max_epochs": 2, "min_epochs": 1, "precision": "f32",
                    "limit_train_batches": 2, "limit_val_batches": 1, "devices": 1},
        "callbacks": {
            "multistage": {"unfreeze_epoch": 1, "lr_reduce_epoch": None},
            "model_checkpoint": {"monitor": "val/dice", "mode": "max", "dirpath": "checkpoints/"},
            "early_stopping": {"monitor": "val/dice", "patience": 200},
        },
        "logger": {"kind": "csv", "save_dir": "metrics"},
    }
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def fitted(dataset, tmp_path_factory):
    work = tmp_path_factory.mktemp("run")
    trainer = Trainer(_config(dataset), work_dir=work, device="cpu")
    return trainer, trainer.fit(), work


def test_fit_writes_metrics_and_checkpoints(fitted):
    trainer, result, work = fitted
    assert 0 <= result["val/dice"] <= 1
    assert all(np.isfinite(v) for k, v in result.items() if k.startswith("val/"))
    assert (work / "checkpoints" / "last.ckpt").exists()
    assert result["best_ckpt"].endswith(".ckpt")
    rows = (work / "metrics" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 3 and "steps_per_sec" in rows[0] and "train/grad_norm" in rows[0]
    assert "tile_" in (work / "train_stats.csv").read_text()
    assert "val_" in (work / "val_stats.csv").read_text()
    assert trainer.state.step == 4
    assert trainer.last_cm.sum() == 2 * SIZE * SIZE


def test_best_checkpoint_loads_in_the_jax_package(fitted):
    _, result, _ = fitted
    jmodel, variables, hp = jax_load_model(result["best_ckpt"])
    assert hp["encoder_name"] == "timm-efficientnet-b0" and hp["classes"] == 3
    model, _, _ = load_model(result["best_ckpt"], device="cpu")
    model = model.float()
    model.dtype = torch.float32
    x = np.random.default_rng(0).normal(size=(2, SIZE, SIZE, 4)).astype(np.float32)
    jmodel = jmodel.clone(dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy().transpose(0, 2, 3, 1)
    err = float(np.abs(got - want).max())
    assert err < 1e-4, f"logits max err {err} (max |ref| {np.abs(want).max():.3g})"
    classes = TorchInference(result["best_ckpt"], device="cpu").run(
        np.zeros((1, SIZE, SIZE, 4), np.uint8))
    assert classes.shape == (1, SIZE, SIZE) and classes.dtype == np.uint8


def test_datamodule_batches(dataset):
    dm = DeadtreesDataModule(DataConfig(
        data_dir=[str(dataset / s) for s in ("train", "val", "test")],
        pattern="train-combo-*.tar", batch_size=2, device="cpu"))
    dm.setup()
    assert dm.steps_per_epoch == 2 and dm.shard_size == 4
    shard = dm.train_shards[0]
    assert count_shard_samples(shard) == 4 and len(list(iter_tar_samples(shard))) == 4
    batches = list(dm.train_batches(torch.Generator().manual_seed(0)))
    assert len(batches) == 2
    b = batches[0]
    assert b["image"].shape == (2, 4, SIZE, SIZE) and b["image"].dtype == torch.float32
    assert b["mask"].shape == (2, SIZE, SIZE) and b["distmap"].shape == (2, 3, SIZE, SIZE)
    assert b["lu"].dtype == torch.int64 and len(b["files"]) == 2
    # a fresh stream seed each epoch: the sample order changes
    orders = [[f for b in dm.train_batches(g) for f in b["files"]]
              for g in [torch.Generator().manual_seed(s) for s in range(4)]]
    assert len({tuple(o) for o in orders}) > 1
    val = list(dm.val_batches())
    assert [f for b in val for f in b["files"]] == [f"val_{i:04d}" for i in range(4)]


def test_two_class_collapse(dataset):
    dm = DeadtreesDataModule(DataConfig(
        data_dir=[str(dataset / s) for s in ("train", "val", "test")],
        pattern="train-combo-*.tar", batch_size=4, classes=2, device="cpu"))
    dm.setup()
    (batch,) = list(dm.val_batches())
    assert int(batch["mask"].max()) == 1 and batch["distmap"].shape[1] == 2


def _devices_without_ranks(d, tmp):
    with pytest.raises(ValueError, match="torch.distributed.run --nproc-per-node 4"):
        Trainer(_config(d, trainer={"devices": 4}), tmp, "cpu")


def _a_rank_without_train_shards(d, tmp):
    dm = DeadtreesDataModule(DataConfig(data_dir=[str(d / s) for s in ("train", "val", "test")],
                                        process_index=1, process_count=2, device="cpu"))
    with pytest.raises(ValueError, match="process 1 of 2 got no train shard"):
        dm.setup()


def _process_count_in_the_config(d, tmp):
    trainer = Trainer(_config(d, datamodule={"pattern": "train-combo-*.tar", "batch_size": 2,
                                             "process_index": 0, "process_count": 2}),
                      tmp, "cpu")
    trainer._build()
    dm = trainer.datamodule
    assert (dm.process_index, dm.process_count, dm.local_batch_size) == (0, 2, 1)
    (batch, *_) = list(dm.val_batches())
    assert batch["image"].shape[0] == 1 and batch["files"] == ["val_0000"]


DATA_PARALLEL = {
    "devices": _devices_without_ranks,
    "process_count": _a_rank_without_train_shards,
    "process_count in the config": _process_count_in_the_config,
}


@pytest.mark.parametrize("feature", list(DATA_PARALLEL))
def test_data_parallel_configuration(dataset, tmp_path, feature):
    """``trainer.devices: N`` needs N ranks and names the launch command;
    a rank without train shards raises; the config's process override
    makes one process a rank of a simulated group (local batches)."""
    DATA_PARALLEL[feature](dataset, tmp_path)


def test_trainer_runs_on_cuda_unless_asked(dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_config(dataset), tmp_path)
