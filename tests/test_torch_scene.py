"""The port's scene predictor against the JAX package's.

A b0 EfficientUnet++ checkpoint written by the JAX ``save_checkpoint``
runs whole 100 × 150 scenes through ``predict_scene`` / ``predict_scenes``
of both packages (tile 128 × 192, subtile 64). Class maps agree to a
mismatch < 2e-2 in bfloat16 as served (the bar of test_torch_engine.py:
bf16 rounds at other places in the two frameworks) and < 1e-3 with both
models in float32; padding subtiles come out exactly zero; within the
port, batched and per-scene dispatches are equal. One JAX predictor is
shared across calls, so each scene-stack shape compiles once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import HP
from test_torch_models import numpy_variables

from deadtrees_tpu.core import save_checkpoint as jax_save_checkpoint
from deadtrees_tpu.infer import JaxInference
from deadtrees_tpu.infer import sliding as jsliding
from deadtrees_tpu.infer.packing import unpack2 as jax_unpack2
from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu_torch.core import load_model
from deadtrees_tpu_torch.infer import (
    Tiler,
    make_scene_predictor,
    predict_scene,
    predict_scenes,
    unpack2,
)
from deadtrees_tpu_torch.models import create_model, state_dict_from_variables

TILE = (128, 192)
SUB = 64
BS = 4
BF16_BAR = 2e-2
F32_BAR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads, as in test_torch_engine.py: the suite runs in
    several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    jmodel = jax_create_model(**HP, dtype=jnp.float32)
    variables = numpy_variables(jmodel, 32, seed=11)
    path = tmp_path_factory.mktemp("ckpt") / "effunetpp_b0.ckpt"
    jax_save_checkpoint(
        path, params=variables["params"], batch_stats=variables["batch_stats"],
        hparams=HP,
    )
    return path, variables


@pytest.fixture(scope="module")
def jax_bf16(ckpt):
    """The JAX engine's bf16 model and one shared packed scene predictor."""
    eng = JaxInference(ckpt[0])
    pred = jsliding.make_scene_predictor(eng.model, subtile=SUB, batch_size=BS, packed=True)
    return eng, pred


@pytest.fixture(scope="module")
def port_bf16(ckpt):
    model, _, _ = load_model(ckpt[0], device="cpu")
    return model


def _scenes(n, seed, shape=(100, 150, 4)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, np.uint8) for _ in range(n)]


def _mismatch(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, (a.shape, b.shape)
    return float((a != b).mean())


def test_scene_matches_jax_bf16(jax_bf16, port_bf16):
    eng, jpred = jax_bf16
    scene = _scenes(1, 2)[0]
    want = jsliding.predict_scene(eng.model, eng.variables, scene, tile_shape=TILE,
                                  subtile=SUB, batch_size=BS, predictor=jpred)
    got = predict_scene(port_bf16, scene, tile_shape=TILE, subtile=SUB, batch_size=BS,
                        device="cpu")
    assert got.shape == (100, 150)
    assert _mismatch(got, want) < BF16_BAR


def test_scene_batch_matches_jax_bf16(jax_bf16, port_bf16):
    """3 scenes, 2 per dispatch: a full group and a zero-padded tail."""
    eng, jpred = jax_bf16
    scenes = _scenes(3, 3)
    want = jsliding.predict_scenes(eng.model, eng.variables, scenes, tile_shape=TILE,
                                   subtile=SUB, batch_size=BS, scenes_per_dispatch=2,
                                   predictor=jpred)
    got = predict_scenes(port_bf16, scenes, tile_shape=TILE, subtile=SUB, batch_size=BS,
                         scenes_per_dispatch=2, device="cpu")
    assert len(got) == 3
    for g, w in zip(got, want):
        assert _mismatch(g, w) < BF16_BAR


def test_scene_matches_jax_float32(ckpt):
    path, variables = ckpt
    jmodel = jax_create_model(**HP, dtype=jnp.float32)
    model = create_model(**HP, dtype=torch.float32)
    model.load_state_dict(state_dict_from_variables(variables, encoder_name=model.encoder_name))
    model.eval()
    scene = _scenes(1, 4)[0]
    want = jsliding.predict_scene(jmodel, variables, scene, tile_shape=TILE, subtile=SUB,
                                  batch_size=BS)
    got = predict_scene(model, scene, tile_shape=TILE, subtile=SUB, batch_size=BS,
                        device="cpu")
    assert _mismatch(got, want) < F32_BAR


def test_padding_subtiles_are_zero(jax_bf16, port_bf16):
    """Tile 192 × 256 around a 100 × 150 scene: a 3 × 4 grid of which the
    top-left 2 × 3 subtiles hold data. The raw (unpacked) maps are zero in
    the other six, exactly, in both packages."""
    eng, _ = jax_bf16
    tile = (192, 256)
    t = Tiler(tile_shape=tile, subtile_shape=(SUB, SUB))
    t.load_array(_scenes(1, 5)[0])
    valid = t.subtiles_to_use
    assert valid.reshape(3, 4).tolist() == [[True] * 3 + [False]] * 2 + [[False] * 4]
    jpred = jsliding.make_scene_predictor(eng.model, subtile=SUB, batch_size=BS, packed=True)
    want = jax_unpack2(np.asarray(jpred(eng.variables["params"], eng.variables["batch_stats"],
                                        jnp.asarray(t._indata), jnp.asarray(valid))), tile[1])
    pred = make_scene_predictor(port_bf16, subtile=SUB, batch_size=BS, device="cpu")
    raw = pred(torch.from_numpy(t._indata), torch.from_numpy(valid)).numpy()
    packed = make_scene_predictor(port_bf16, subtile=SUB, batch_size=BS, packed=True,
                                  device="cpu")
    np.testing.assert_array_equal(
        unpack2(packed(torch.from_numpy(t._indata), torch.from_numpy(valid)), tile[1]), raw
    )
    assert raw.shape == want.shape == tile
    pad = np.ones(tile, bool)
    pad[:128, :192] = False
    np.testing.assert_array_equal(raw[pad], 0)
    np.testing.assert_array_equal(want[pad], 0)
    assert _mismatch(raw[:100, :150], want[:100, :150]) < BF16_BAR


def test_batched_equals_per_scene_and_model(port_bf16):
    """Within the port: the batched dispatch (3 scenes, 2 a dispatch) is
    equal to per-scene calls, and the top-left subtile is the argmax of
    the model's logits on it."""
    scenes = _scenes(3, 6)
    batched = predict_scenes(port_bf16, scenes, tile_shape=TILE, subtile=SUB, batch_size=BS,
                             scenes_per_dispatch=2, device="cpu")
    for scene, got in zip(scenes, batched):
        single = predict_scene(port_bf16, scene, tile_shape=TILE, subtile=SUB,
                               batch_size=BS, device="cpu")
        np.testing.assert_array_equal(got, single)
    from deadtrees_tpu_torch.data import normalize
    from deadtrees_tpu_torch.data.config import DATASET_CONFIG

    x = torch.from_numpy(scenes[0][None, :SUB, :SUB]).float()
    img = normalize(x, DATASET_CONFIG.mean, DATASET_CONFIG.std).permute(0, 3, 1, 2)
    with torch.no_grad():
        direct = port_bf16(img).argmax(1)[0].numpy().astype(np.uint8)
    np.testing.assert_array_equal(batched[0][:SUB, :SUB], direct)


def test_tta_matches_jax(jax_bf16, port_bf16):
    eng, _ = jax_bf16
    scene = _scenes(1, 7)[0]
    want = jsliding.predict_scene(eng.model, eng.variables, scene, tile_shape=TILE,
                                  subtile=SUB, batch_size=BS, tta=4)
    got = predict_scene(port_bf16, scene, tile_shape=TILE, subtile=SUB, batch_size=BS,
                        tta=4, device="cpu")
    assert _mismatch(got, want) < BF16_BAR


def test_scene_entry_points_need_cuda_or_cpu(port_bf16, monkeypatch):
    """With no CUDA and no device asked for, the entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = _scenes(1, 8)[0]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_scene_predictor(port_bf16, subtile=SUB)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_scene(port_bf16, scene, tile_shape=TILE, subtile=SUB)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_scenes(port_bf16, [scene], tile_shape=TILE, subtile=SUB)
    with pytest.raises(ValueError, match="model lies on"):
        make_scene_predictor(port_bf16, subtile=SUB, device="meta")
