"""The port's config loader against the JAX package's: the same dicts.

``deadtrees_tpu_torch.config.compose`` must give exactly the dict that
``deadtrees_tpu.config.compose`` gives over the repo's ``configs/``: the
default composition, every option of every group, the flagship recipe,
and the overrides and error cases of tests/test_config.py.
"""

from pathlib import Path

import pytest

from deadtrees_tpu.config import ConfigError as JaxConfigError
from deadtrees_tpu.config import compose as jax_compose
from deadtrees_tpu_torch.config import ConfigError, compose, to_yaml

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"
GROUP_OPTIONS = sorted(
    f"{g.name}={f.stem}"
    for g in CONFIG_DIR.iterdir() if g.is_dir()
    for f in g.glob("*.yaml")
)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TRAIN_DATASET_PATH", "/data/test")


@pytest.mark.parametrize("overrides", [
    [],
    ["experiment=flagship_b5_multistage"],
    ["experiment=flagship_b5_multistage", "data_dir=/d", "trainer.max_epochs=4",
     "trainer.limit_train_batches=4", "callbacks.multistage.lr_reduce_epoch=2",
     "callbacks.swa.swa_epoch_start=2", "run_dir=build/r", "tta=8"],
    ["model=unet", "trainer.max_epochs=7", "datamodule=deadtrees_multi_datasets_singleclass_rgb"],
    ["mode=debug", "trainer.max_epochs=5"],
    ["+optimized_metric=val/dice"],
    ["model.network.decoder_channels=[32,24,16,12,8]", "seed=null", "trainer.remat=true"],
    ["logger=wandb", "callbacks=wandb", "bestmodel=x.ckpt"],
], ids=["default", "flagship", "flagship_cut", "groups", "debug", "plus", "values", "wandb"])
def test_compose_matches_jax(overrides):
    got = compose(CONFIG_DIR, overrides=overrides)
    assert got == jax_compose(CONFIG_DIR, overrides=overrides)
    assert got["data_dir"] == ("/d" if "data_dir=/d" in overrides else "/data/test")


@pytest.mark.parametrize("option", GROUP_OPTIONS)
def test_every_group_option_matches_jax(option):
    got = compose(CONFIG_DIR, overrides=[option])
    assert got == jax_compose(CONFIG_DIR, overrides=[option])
    assert to_yaml(got)


def test_flagship_recipe():
    cfg = compose(CONFIG_DIR, overrides=["experiment=flagship_b5_multistage"])
    net = cfg["model"]["network"]
    assert net["encoder_name"] == "timm-efficientnet-b5"
    assert net["decoder_channels"] == [256, 128, 64, 32, 16]
    assert cfg["datamodule"]["batch_size"] == 16 and cfg["trainer"]["precision"] == "bf16"
    assert cfg["callbacks"]["swa"] == {"swa_epoch_start": 250}
    assert cfg["test_after_training"] is True
    # nothing is instantiated from _target_: it stays a string
    assert cfg["datamodule"]["_target_"] == "deadtrees_tpu.data.pipeline.DeadtreesDataModule"


def test_errors_match_jax(tmp_path, monkeypatch):
    with pytest.raises(ConfigError):
        compose(CONFIG_DIR, overrides=["model=doesnotexist"])
    with pytest.raises(JaxConfigError):
        jax_compose(CONFIG_DIR, overrides=["model=doesnotexist"])
    with pytest.raises(ConfigError, match="key=value"):
        compose(CONFIG_DIR, overrides=["trainer.max_epochs"])
    (tmp_path / "c.yaml").write_text("x: ${env:SURELY_UNSET_VAR_123}\n")
    with pytest.raises(ConfigError, match="SURELY_UNSET_VAR_123"):
        compose(tmp_path, "c")
    (tmp_path / "d.yaml").write_text("x: ${env:SURELY_UNSET_VAR_123,fallback}\n")
    assert compose(tmp_path, "d") == jax_compose(tmp_path, "d") == {"x": "fallback"}
    (tmp_path / "e.yaml").write_text("- a\n- b\n")
    with pytest.raises(ConfigError, match="mapping"):
        compose(tmp_path, "e")
