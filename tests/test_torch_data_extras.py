"""``pattern_extra`` mixing, shard balancing and the trainer's datamodule
configs in the port, against the JAX package.

Extra datasets split into train and val by the main set's train fraction;
every batch is the main part (``batch_size - sum(batch_size_extra)``)
followed by each extra's part, in order. Validation batches equal JAX's
(normalized images to 1e-6, ``files`` equal) and the train batches'
composition and order equal JAX's for one stream seed. Every
``configs/datamodule/*.yaml`` composes and takes a step through the port's
``Trainer`` on the CPU with a small model.
"""

import traceback
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from deadtrees_tpu.data.balance import split_df as jax_split_df
from deadtrees_tpu.data.pipeline import DataConfig as JaxDataConfig
from deadtrees_tpu.data.pipeline import DeadtreesDataModule as JaxDataModule
from deadtrees_tpu_torch.config import compose
from deadtrees_tpu_torch.data.balance import split_df
from deadtrees_tpu_torch.data.pipeline import DataConfig, DeadtreesDataModule
from deadtrees_tpu_torch.train import Trainer
from tests.test_torch_native import write_shard

MAIN = "train-balanced-000*.tar"
EXTRAS = ["train-negativesamples-000*.tar", "train-randomsamples-000*.tar"]
REPO_CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """5 main shards of 6, 3 negative shards of 4 (no lu layer), 4 random
    shards of 5, tiles of 32²."""
    d = tmp_path_factory.mktemp("extras")
    for i in range(5):
        write_shard(d / f"train-balanced-{i:06d}.tar", 6, seed=i, prefix=f"bal{i}")
    for i in range(3):
        write_shard(d / f"train-negativesamples-{i:06d}.tar", 4, seed=10 + i, prefix=f"neg{i}",
                    with_lu=False)
    for i in range(4):
        write_shard(d / f"train-randomsamples-{i:06d}.tar", 5, seed=20 + i, prefix=f"rnd{i}")
    return d


def _configs(data, **kw):
    common = dict(data_dir=str(data), pattern=MAIN, batch_size=8, pattern_extra=EXTRAS,
                  batch_size_extra=[2, 3], distmap=False, **kw)
    ours = DeadtreesDataModule(DataConfig(device="cpu", **common))
    theirs = JaxDataModule(JaxDataConfig(use_native=False, **common))
    ours.setup()
    theirs.setup()
    return ours, theirs


def test_extra_split_and_main_batch_size_equal_jax(data):
    ours, theirs = _configs(data)
    assert ours.main_batch_size == theirs.main_batch_size == 3
    assert ours.train_shards == theirs.train_shards and len(ours.train_shards) == 3
    assert ours.extra_train_shards == theirs.extra_train_shards
    assert ours.extra_valid_shards == theirs.extra_valid_shards
    assert [len(s) for s in ours.extra_train_shards] == [2, 3]
    assert [len(s) for s in ours.extra_valid_shards] == [1, 1]
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 3 * 6 // 8


def test_val_batches_with_extras_equal_jax(data):
    ours, theirs = _configs(data)
    got = list(ours.val_batches())
    want = list(theirs.val_batches())
    assert len(got) == len(want) == 2  # 6 val samples of the main set, 3 a batch
    for g, w in zip(got, want):
        assert g["files"] == list(w["files"])
        assert [f[:3] for f in g["files"]] == ["bal"] * 3 + ["neg"] * 2 + ["rnd"] * 3
        image = np.asarray(w["image"]).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g["image"].numpy(), image, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(g["mask"].numpy(), np.asarray(w["mask"]))
        np.testing.assert_array_equal(g["lu"].numpy(), np.asarray(w["lu"]))
        assert not g["lu"][3:5].any()  # the negatives have no lu layer: zeros


@pytest.mark.parametrize("stream_seed", [0, 12345])
def test_train_batches_compose_as_jax(data, stream_seed):
    """For one stream seed the train batches hold JAX's samples in JAX's
    order: main, then each extra, the extras seeded seed + 1 + i."""
    ours, theirs = _configs(data)
    shuffle = max(ours.cfg.shuffle_buffer, ours.shard_size)
    got = [b["files"] for b in ours._stream(
        ours.train_shards, ours.extra_train_shards, shuffle=shuffle, train=True, loop=False,
        generator=torch.Generator().manual_seed(0), stream_seed=stream_seed)]
    want = [list(b["files"]) for b in theirs._combined_stream(
        theirs.train_shards, theirs.extra_train_shards, shuffle=shuffle, train=True,
        loop=False, rng=jax.random.PRNGKey(0), stream_seed=stream_seed)]
    assert got == want and len(got) == 3 * 6 // 3  # the main part sets the epoch
    for files in got:
        assert [f[:3] for f in files] == ["bal"] * 3 + ["neg"] * 2 + ["rnd"] * 3


def test_train_batches_from_the_generator(data):
    ours, _ = _configs(data)
    batches = list(ours.train_batches(torch.Generator().manual_seed(3)))
    assert len(batches) == 6
    b = batches[0]
    assert b["image"].shape == (8, 4, 32, 32) and b["mask"].shape == (8, 32, 32)
    assert b["lu"].shape == (8, 32, 32) and not b["lu"][3:5].any()
    again = [b["files"] for b in ours.train_batches(torch.Generator().manual_seed(3))]
    assert again == [b["files"] for b in batches]


def test_test_batches_see_no_extras(data):
    """Test batches are the main set's alone, at the whole batch size."""
    ours, theirs = _configs(data)
    ours.cfg.batch_size = theirs.cfg.batch_size = 3
    got = [b["files"] for b in ours.test_batches()]
    assert got == [list(b["files"]) for b in theirs.test_batches()]
    assert got and all(f.startswith("bal") for fs in got for f in fs)


REFUSALS = {
    "train/val/test layout": lambda d: dict(data_dir=[str(d)] * 3),
    "lengths differ": lambda d: dict(data_dir=str(d), batch_size_extra=[2]),
    "no batch_size_extra": lambda d: dict(data_dir=str(d), batch_size_extra=None),
    "remote data_dir with a glob": lambda d: dict(data_dir=f"pipe:cat {d}/s-{{0..3}}.tar"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_pattern_extra_refusals_equal_jax(data, case):
    kw = dict(pattern=MAIN, batch_size=8, pattern_extra=EXTRAS, batch_size_extra=[2, 3])
    kw.update(REFUSALS[case](data))
    with pytest.raises(ValueError) as theirs:
        JaxDataModule(JaxDataConfig(**kw))
    with pytest.raises(ValueError) as ours:
        DeadtreesDataModule(DataConfig(device="cpu", **kw))
    assert str(ours.value) == str(theirs.value)


def test_extras_the_reference_would_hang_on_raise(data):
    """No main samples left, or an extra whose train or val part is empty
    (its looping stream would spin forever): refused."""
    with pytest.raises(ValueError, match="no main samples"):
        DeadtreesDataModule(DataConfig(data_dir=str(data), pattern=MAIN, batch_size=5,
                                       pattern_extra=EXTRAS, batch_size_extra=[2, 3],
                                       device="cpu"))
    dm = DeadtreesDataModule(DataConfig(data_dir=str(data), pattern=MAIN, batch_size=8,
                                        pattern_extra=["train-negativesamples-000000.tar"],
                                        batch_size_extra=[2], device="cpu"))
    with pytest.raises(ValueError, match="matched 1 shard"):
        dm.setup()


# The JAX package's half only supplies the expected values. Its open_shard
# closes a pipe: stream before the tar's end padding, and `cat` then dies of
# SIGPIPE, which it raises as "exit 141" at random
# (tests/test_torch_remote_shards.py holds that defect deterministically).
# So it reads the same shards through a command whose exit status does not
# depend on when its reader closes the pipe; the shard names are mapped back.
# The port reads through the plain `pipe:cat`.
EXIT_0 = "; exit 0"


def test_remote_extras_mix_with_a_remote_main_set(data):
    spec = f"pipe:cat {data}/train-balanced-{{000000..000004}}.tar"
    extras = [f"pipe:cat {data}/train-negativesamples-{{000000..000002}}.tar"]
    kw = dict(batch_size=5, batch_size_extra=[2], distmap=False)
    ours = _streamed(lambda: DeadtreesDataModule(DataConfig(
        device="cpu", data_dir=spec, pattern_extra=extras, **kw)))
    theirs = _streamed(lambda: JaxDataModule(JaxDataConfig(
        use_native=False, data_dir=spec + EXIT_0, pattern_extra=[e + EXIT_0 for e in extras],
        **kw)))
    failed = {name: half for name, half in (("port", ours), ("JAX package", theirs))
              if isinstance(half, str)}
    assert not failed, "\n".join(f"the {k}'s stream failed:\n{v}" for k, v in failed.items())
    assert ours[0] == [[s[:-len(EXIT_0)] for s in shards] for shards in theirs[0]]
    assert ours[0][0][0].startswith("pipe:cat ") and ours[0][0][0].endswith(".tar")
    assert ours[1] == theirs[1] and len(ours[1]) == 2


def _streamed(make):
    """(extra train shards, val batches' files) of the data module that
    ``make`` builds, or the traceback of what it raised: each package's half
    runs on its own, so that a failure names the package and its error."""
    try:
        dm = make()
        dm.setup()
        return dm.extra_train_shards, [list(b["files"]) for b in dm.val_batches()]
    except Exception:
        return traceback.format_exc()


@pytest.mark.parametrize("size", [1, 3, 4, 10])
def test_split_df_equals_jax(size):
    rng = np.random.default_rng(size)
    df = pd.DataFrame({"tile": [f"t{i:03d}" for i in range(10)],
                       "frac": rng.uniform(0.1, 50.0, 10).round(1)})
    assert split_df(df, size) == jax_split_df(df, size)
    df.loc[3, "frac"] = 0.0
    for fn in (split_df, jax_split_df):
        with pytest.raises(ValueError, match="deadtrees"):
            fn(df, size)
    assert split_df(df, size, require_deadtrees=False) == jax_split_df(
        df, size, require_deadtrees=False)
    with pytest.raises(ValueError, match="between 1 and len"):
        split_df(df, 11, require_deadtrees=False)


# ---------------------------------------------------------------------------
# the trainer over every datamodule config
# ---------------------------------------------------------------------------

DATAMODULES = sorted(p.stem for p in (REPO_CONFIGS / "datamodule").glob("*.yaml"))


@pytest.fixture(scope="module")
def config_data(tmp_path_factory):
    """Every pattern the datamodule configs name: 4 shards of 32 tiles of 32²
    each (2 train, 1 val, 1 test, as the fractions split 4)."""
    d = tmp_path_factory.mktemp("configs")
    for k, name in enumerate(("balanced", "combo", "negativesamples", "randomsamples")):
        for i in range(4):
            write_shard(d / f"train-{name}-{i:06d}.tar", 32, seed=10 * k + i,
                        prefix=f"{name[:3]}{i}")
    return d


def _composed(datamodule, data, work):
    cfg = compose(REPO_CONFIGS, "config", overrides=[
        f"datamodule={datamodule}", f"data_dir={data}", "seed=0",
        "model.network.encoder_name=timm-efficientnet-b0",
        "model.network.decoder_channels=[16,12,8,8,8]", "trainer.precision=f32",
        "trainer.max_epochs=1", "trainer.limit_train_batches=1", "trainer.limit_val_batches=1",
        f"logger.save_dir={work}/metrics",
    ])
    cfg["callbacks"]["log_confusion_matrix"] = False
    cfg["callbacks"]["log_image_predictions"] = False
    return cfg


def test_every_datamodule_config_is_covered():
    assert len(DATAMODULES) == 6 and "deadtrees_multi_datasets" in DATAMODULES


@pytest.mark.parametrize("datamodule", DATAMODULES)
def test_trainer_takes_a_step_with_every_datamodule_config(datamodule, config_data, tmp_path):
    cfg = _composed(datamodule, config_data, tmp_path)
    dmc = cfg["datamodule"]
    trainer = Trainer(cfg, tmp_path, device="cpu")
    result = trainer.fit()
    dm = trainer.datamodule
    assert dm.cfg.num_workers == dmc["num_workers"] and dm.cfg.use_native
    assert dm.cfg.batch_size_extra == dmc.get("batch_size_extra")
    assert dm.cfg.in_channels == cfg["model"]["network"]["in_channels"]
    assert trainer.state.step == 1
    assert 0 <= result["val/dice"] <= 1
    batch = next(iter(dm.val_batches()))
    assert len(batch["files"]) == dmc["batch_size"]
    assert batch["image"].shape[1] == dm.cfg.in_channels
    if dmc.get("pattern_extra"):
        main = dmc["batch_size"] - sum(dmc["batch_size_extra"])
        parts = [f[:3] for f in batch["files"]]
        assert parts == ["bal"] * main + ["neg"] * 2 + ["ran"] * 15


def test_trainer_passes_the_reader_settings(config_data, tmp_path):
    cfg = _composed("deadtrees_multi_datasets", config_data, tmp_path)
    cfg["datamodule"].update(num_workers=3, use_native=False, cache_dir=str(tmp_path / "c"),
                             batch_size=6, batch_size_extra=[1, 2])
    trainer = Trainer(cfg, tmp_path, device="cpu")
    trainer._build()
    dm = trainer.datamodule
    assert (dm.cfg.num_workers, dm.cfg.use_native, dm.cfg.cache_dir) == (
        3, False, str(tmp_path / "c"))
    assert dm.cfg.batch_size_extra == [1, 2] and dm.main_batch_size == 3
    assert dm.cfg.pattern_extra == EXTRAS
