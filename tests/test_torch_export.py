"""The port's exported inference artifact against the JAX package's.

One JAX-written b0 checkpoint (the engine tests' model) is exported by
both packages at 64²: the port's float artifact through its CLI, its int8
artifact with ``export_inference(quantize=True)``, JAX's float artifact
with JAX's ``export_inference``. Bars, the JAX package's own:

- the port's ``ExportedInference`` against JAX's, and against the port's
  plain ``TorchInference``, at bs 1 and 3 from the one artifact (the batch
  is dynamic): class-map mismatch < 1e-2
  (tests/test_checkpoint_engine.py:254-267);
- int8: the artifact under 0.6 × the float one's bytes and agreement
  > 0.999 with ``TorchInference(quantized=True)``
  (tests/test_quantize.py:90-110); the ``weights`` payload is the bytes
  JAX's exporter writes for the same checkpoint;
- each package's loader refuses the other's file with ``ValueError``;
  ``meta`` carries JAX's keys and values;
- ``SegmentationService(None, exported=...)`` answers ``model_type=
  "exported"`` with the JAX service's PNG (mismatch < 1e-2, the same
  bytes where the maps agree).
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image
from test_torch_models import numpy_variables

from deadtrees_tpu.core import load_checkpoint as jax_load_checkpoint
from deadtrees_tpu.core import save_checkpoint as jax_save_checkpoint
from deadtrees_tpu.infer import ExportedInference as JaxExportedInference
from deadtrees_tpu.infer import export as jax_export
from deadtrees_tpu.infer.quantize import quantize_params as jax_quantize_params
from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu.serve import SegmentationService as JaxSegmentationService
from deadtrees_tpu_torch.__main__ import main as cli
from deadtrees_tpu_torch.core.msgpack_codec import unpackb
from deadtrees_tpu_torch.infer import ExportedInference, TorchInference
from deadtrees_tpu_torch.infer import export
from deadtrees_tpu_torch.serve import SegmentationService

S = 64
HP = dict(
    architecture="efficientunet++",
    encoder_name="timm-efficientnet-b0",
    decoder_channels=[24, 16, 16, 8, 8],
    in_channels=4,
    classes=3,
    encoder_weights=None,
)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    variables = numpy_variables(jax_create_model(**HP, dtype=jnp.float32), 32, seed=11)
    path = tmp_path_factory.mktemp("export") / "effunetpp_b0.ckpt"
    jax_save_checkpoint(path, params=variables["params"],
                        batch_stats=variables["batch_stats"], hparams=HP)
    return path


@pytest.fixture(scope="module")
def artifacts(ckpt):
    """The port's float artifact (the CLI's default file name), its int8
    artifact and JAX's float artifact."""
    assert cli(["export", str(ckpt), "--image-size", str(S), "--device", "cpu"]) == 0
    ours = ckpt.with_suffix(export.SUFFIX)
    int8 = ckpt.parent / "int8.ptexp"
    export.export_inference(ckpt, int8, image_size=S, quantize=True, device="cpu")
    theirs = ckpt.parent / "jax.dtexp"
    jax_export.export_inference(ckpt, theirs, image_size=S)
    return {"ours": ours, "int8": int8, "jax": theirs}


@pytest.fixture(scope="module")
def engines(ckpt, artifacts):
    return {
        "exported": ExportedInference(artifacts["ours"], device="cpu"),
        "jax": JaxExportedInference(artifacts["jax"]),
        "plain": TorchInference(ckpt, device="cpu"),
    }


def _batch(bs, seed=None):
    rng = np.random.default_rng(bs if seed is None else seed)
    return rng.integers(0, 255, (bs, S, S, 4), np.uint8)


@pytest.mark.parametrize("bs", [1, 3])
def test_exported_matches_jax_and_the_plain_engine(engines, bs):
    img = _batch(bs)
    got = engines["exported"].run(img)
    assert got.shape == (bs, S, S) and got.dtype == np.uint8
    assert (got != engines["jax"].run(img)).mean() < 1e-2
    assert (got != engines["plain"].run(img)).mean() < 1e-2


def test_the_cli_writes_an_artifact_that_loads(ckpt, artifacts, engines):
    assert artifacts["ours"] == ckpt.with_suffix(".ptexp") and artifacts["ours"].is_file()
    assert engines["exported"].meta["image_size"] == S
    img = torch.from_numpy(_batch(2))
    out = engines["exported"].predict(img)
    assert out.shape == (2, S, S) and out.dtype == torch.uint8


def test_quantized_artifact(ckpt, artifacts):
    assert artifacts["int8"].stat().st_size < 0.6 * artifacts["ours"].stat().st_size
    eng = ExportedInference(artifacts["int8"], device="cpu")
    assert eng.meta["quantized"] is True
    img = _batch(2, seed=7)
    out = eng.run(img)
    assert out.shape == (2, S, S)
    agree = (out == TorchInference(ckpt, device="cpu", quantized=True).run(img)).mean()
    assert agree > 0.999, agree


def _payload(path, magic):
    with open(path, "rb") as f:
        assert f.read(len(magic)) == magic
        return unpackb(f.read())


def test_weights_payload_is_the_jax_exporters(ckpt, artifacts):
    """JAX's exporter writes ``msgpack_serialize(tree_map(np.asarray,
    quantize_params(params)))`` (deadtrees_tpu/infer/export.py:67-69)."""
    params = jax_load_checkpoint(ckpt)["params"]
    want = serialization.msgpack_serialize(
        jax.tree_util.tree_map(np.asarray, jax_quantize_params(params)))
    got = _payload(artifacts["int8"], export._MAGIC)["weights"]
    assert got == want
    ours, theirs = unpackb(got), serialization.msgpack_restore(want)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_meta_has_the_jax_keys(artifacts):
    ours = json.loads(_payload(artifacts["ours"], export._MAGIC)["meta"])
    theirs = json.loads(_payload(artifacts["jax"], jax_export._MAGIC)["meta"])
    assert ours == theirs
    assert set(ours) == {"in_channels", "image_size", "classes", "quantized", "hparams"}


def test_each_loader_refuses_the_other_packages_file(artifacts):
    with pytest.raises(ValueError, match="Not an exported artifact"):
        export.load_exported(artifacts["jax"], device="cpu")
    with pytest.raises(ValueError, match="Not an exported artifact"):
        ExportedInference(artifacts["jax"], device="cpu")
    for name in ("ours", "int8"):
        with pytest.raises(ValueError, match="Not an exported artifact"):
            jax_export.load_exported(artifacts[name])


def test_the_program_moves_to_another_device(artifacts):
    """An artifact traced on the CPU runs on another device through
    ``move_to_device_pass``; on ``meta`` every op checks its device and
    shapes, so nothing in the program stays bound to the CPU."""
    program, meta = export.load_exported(artifacts["int8"], device="meta")
    out = program(torch.zeros((5, S, S, 4), dtype=torch.uint8, device="meta"))
    assert out.device.type == "meta" and out.shape == (5, S, S) and out.dtype == torch.uint8


def test_export_needs_cuda_unless_told(ckpt, artifacts, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        export.export_inference(ckpt, tmp_path / "x.ptexp", image_size=S)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["export", str(ckpt), str(tmp_path / "y.ptexp")])
    with pytest.raises(RuntimeError, match="CUDA"):
        ExportedInference(artifacts["ours"])
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentationService(None, exported=artifacts["ours"])
    assert not (tmp_path / "x.ptexp").exists() and not (tmp_path / "y.ptexp").exists()


def _png(seed):
    buf = io.BytesIO()
    Image.fromarray(_batch(1, seed=seed)[0], "RGBA").save(buf, "PNG")
    return buf.getvalue()


def test_service_serves_an_artifact_alone(artifacts):
    service = SegmentationService(None, exported=artifacts["ours"], device="cpu")
    theirs = JaxSegmentationService(None, exported=artifacts["jax"])
    assert service.health()["models"] == ["exported"]
    for seed in (3, 4):
        png, headers = service.segment(_png(seed), "exported")
        jpng, _ = theirs.segment(_png(seed), "exported")
        assert headers["X-model-type"] == "exported"
        got, want = (np.asarray(Image.open(io.BytesIO(b))) for b in (png, jpng))
        assert got.shape == (S, S) and (got != want).mean() < 1e-2
        assert (png == jpng) == np.array_equal(got, want)
    with pytest.raises(ValueError, match="exported"):
        service.segment(_png(3), "torch")
