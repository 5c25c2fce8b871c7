"""The port's ensemble engine and scene CLI against the JAX package's.

b0 EfficientUnet++ checkpoints written by the JAX ``save_checkpoint``:
``EnsembleInference([A] * 3)`` agrees with the JAX ensemble to a class-map
mismatch < 2e-2 in bfloat16 (the bar of test_torch_engine.py) and is equal
to the argmax of one member's logits; a heterogeneous trio (A, A and a b0
with other decoder channels) is equal to the port's single A; a built tie
(three members whose heads output class 0, 1 and 2 everywhere) votes the
smallest class in both packages. The scene CLI on the CPU writes the same
maps as ``predict_scenes``, skips an empty scene and keeps the tags.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, TiffImagePlugin
from test_torch_engine import HP
from test_torch_models import numpy_variables

from deadtrees_tpu.core import save_checkpoint as jax_save_checkpoint
from deadtrees_tpu.infer import EnsembleInference as JaxEnsemble
from deadtrees_tpu.infer.geotiff import read_geotiff as jax_read_geotiff
from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu_torch.core import load_model
from deadtrees_tpu_torch.data import normalize
from deadtrees_tpu_torch.data.config import DATASET_CONFIG
from deadtrees_tpu_torch.infer import EnsembleInference, Tiler, TorchInference, predict_scenes
from deadtrees_tpu_torch.infer import scene as scene_cli

HP_B = dict(HP, decoder_channels=[16, 16, 8, 8, 8])
PX = 0.5
X0, Y0 = 400000.0, 5300000.0


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads, as in test_torch_engine.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _save(path, hp, variables):
    jax_save_checkpoint(path, params=variables["params"],
                        batch_stats=variables["batch_stats"], hparams=hp)
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A, B (other decoder channels), three members whose head votes
    class 0, 1, 2 everywhere, and one with 2 classes."""
    root = tmp_path_factory.mktemp("ens")
    var_a = numpy_variables(jax_create_model(**HP, dtype=jnp.float32), 32, seed=11)
    out = {
        "A": _save(root / "a.ckpt", HP, var_a),
        "B": _save(root / "b.ckpt", HP_B, numpy_variables(
            jax_create_model(**HP_B, dtype=jnp.float32), 32, seed=12)),
    }
    for k in range(3):
        head = var_a["params"]["segmentation_head"]["Conv_0"]
        params = dict(var_a["params"], segmentation_head={"Conv_0": {
            "kernel": np.zeros_like(head["kernel"]),
            "bias": np.eye(3, dtype=np.float32)[k],
        }})
        out[f"vote{k}"] = _save(root / f"vote{k}.ckpt", HP,
                                {"params": params, "batch_stats": var_a["batch_stats"]})
    hp2 = dict(HP, classes=2)
    out["classes2"] = _save(root / "c2.ckpt", hp2, numpy_variables(
        jax_create_model(**hp2, dtype=jnp.float32), 32, seed=13))
    return out


def _img(bs, seed, size=32):
    return np.random.default_rng(seed).integers(0, 256, (bs, size, size, 4), np.uint8)


def test_homogeneous_ensemble_matches_jax_and_one_member(ckpts):
    img = _img(2, 0)
    ens = EnsembleInference([ckpts["A"]] * 3, device="cpu")
    assert ens.homogeneous and ens.in_channels == 4 and ens.device.type == "cpu"
    got = ens.run(img)
    want = JaxEnsemble([ckpts["A"]] * 3).run(img)
    assert got.shape == want.shape == (2, 32, 32) and got.dtype == np.uint8
    assert (got != want).mean() < 2e-2
    model, _, _ = load_model(ckpts["A"], device="cpu")
    x = normalize(torch.from_numpy(img).float(), DATASET_CONFIG.mean, DATASET_CONFIG.std)
    with torch.no_grad():
        single = model(x.permute(0, 3, 1, 2).contiguous()).argmax(1).numpy()
    np.testing.assert_array_equal(got, single)


def test_heterogeneous_ensemble_equals_majority_member(ckpts):
    img = _img(2, 1)
    ens = EnsembleInference([ckpts["A"], ckpts["A"], ckpts["B"]], device="cpu")
    assert not ens.homogeneous
    got = ens.run(img)
    np.testing.assert_array_equal(got, TorchInference(ckpts["A"], device="cpu").run(img))
    assert ens.in_channels == 4


def test_ensemble_errors(ckpts, monkeypatch):
    with pytest.raises(ValueError, match="odd number"):
        EnsembleInference([ckpts["A"]] * 2, device="cpu")
    with pytest.raises(ValueError, match="agree on `classes`"):
        EnsembleInference([ckpts["A"], ckpts["A"], ckpts["classes2"]], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EnsembleInference([ckpts["A"]])


def test_tie_votes_smallest_class(ckpts):
    """One vote each for classes 0, 1, 2: the smallest wins, in the port
    and in JAX; two votes for 2 beat one for 1."""
    img = _img(1, 2)
    tie = [ckpts["vote0"], ckpts["vote1"], ckpts["vote2"]]
    ens = EnsembleInference(tie, device="cpu")
    assert ens.homogeneous
    np.testing.assert_array_equal(ens.run(img), 0)
    np.testing.assert_array_equal(JaxEnsemble(tie).run(img), 0)
    for k in range(3):  # each member alone votes its class everywhere
        np.testing.assert_array_equal(EnsembleInference([tie[k]], device="cpu").run(img), k)
    two_one = [ckpts["vote2"], ckpts["vote2"], ckpts["vote1"]]
    np.testing.assert_array_equal(EnsembleInference(two_one, device="cpu").run(img), 2)


def _write_scene(path, data, x0):
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[33550] = (PX, PX, 0.0)
    info[33922] = (0.0, 0.0, 0.0, x0, Y0, 0.0)
    info[34737] = "ETRS89 / UTM 32N|"
    Image.fromarray(data).save(str(path), format="TIFF", tiffinfo=info)


def test_scene_cli_on_cpu(ckpts, tmp_path, capsys, monkeypatch):
    """Three 100 × 150 scenes side by side and one empty scene: the CLI
    writes the maps ``predict_scenes`` gives (tile auto-sized to 192,
    subtile 64, bs 4), with the inputs' tags, skips the empty scene, and
    mosaics the three; three checkpoints vote through the ensemble path."""
    rng = np.random.default_rng(3)
    src = tmp_path / "in"
    src.mkdir()
    scenes = []
    for k in range(3):
        data = rng.integers(2, 256, (100, 150, 4), np.uint8)
        _write_scene(src / f"ortho_{k}.tif", data, X0 + PX * 150 * k)
        scenes.append(data)
    _write_scene(src / "ortho_empty.tif", np.zeros((100, 150, 4), np.uint8), X0 - PX * 150)
    out = tmp_path / "out"
    base = [str(src), str(ckpts["A"]), "--all", "--outpath", str(out), "--bs", "4",
            "--subtile", "64"]
    scene_cli.main(base + ["--device", "cpu", "--mosaic", str(tmp_path / "mosaic.tif")])
    printed = capsys.readouterr().out
    assert "tile shape auto-sized to 192" in printed
    assert "skip empty scene: ortho_empty.tif" in printed
    assert not (out / "ortho_empty.tif").exists()
    model, _, _ = load_model(ckpts["A"], device="cpu")
    want = predict_scenes(model, scenes, tile_shape=(192, 192), subtile=64, batch_size=4,
                          device="cpu")
    for k in range(3):
        got = jax_read_geotiff(out / f"ortho_{k}.tif")
        np.testing.assert_array_equal(got.data[..., 0], want[k])
        assert got.geo["tags"] == jax_read_geotiff(src / f"ortho_{k}.tif").geo["tags"]
    mosaic = jax_read_geotiff(tmp_path / "mosaic.tif")
    np.testing.assert_array_equal(mosaic.data[..., 0], np.concatenate(want, axis=1))
    assert mosaic.bounds == (X0, Y0 - PX * 100, X0 + PX * 450, Y0)
    assert "wrote mosaic" in printed and "3 tiles, 100x450 px" in printed

    ens_out = tmp_path / "ens"
    scene_cli.main([str(src / "ortho_1.tif"), str(ckpts["A"]), str(ckpts["A"]),
                    str(ckpts["B"]), "--outpath", str(ens_out), "--bs", "4",
                    "--subtile", "64", "--device", "cpu"])
    tiler = Tiler(tile_shape=(192, 192), subtile_shape=(64, 64))
    tiler.load_array(scenes[1])
    tiler.put_batches(TorchInference(ckpts["A"], device="cpu").run(tiler.get_batches()))
    got = jax_read_geotiff(ens_out / "ortho_1.tif")
    np.testing.assert_array_equal(got.data[..., 0], tiler.prediction)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scene_cli.main(base)  # no --device: CUDA
