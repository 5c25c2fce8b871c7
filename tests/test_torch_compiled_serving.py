"""The serving routes as compiled programs, on the CPU.

Every route of ``TorchInference`` runs as one program per shape, compiled
here with ``aot_eager`` and ``fullgraph=True`` (``DEADTREES_COMPILE_OPTS``),
and serves the class maps of the same route run eagerly under
``disable_compile()``: equal, since both run the same kernels' plain
versions in the same order. This file holds plain, ``"auto"``, ``"chw"``,
``"nhwc"`` and w8, and the compiled ``"auto"`` engine against
``JaxInference`` under the bar of ``tests/test_torch_engine.py`` (bf16,
mismatch < 2e-2); ``tests/test_torch_compiled_quant_tta.py`` holds w8a8
(its calibrate and predict programs), TTA and the cut of ``"auto"``. The
geometry is ``tests/test_torch_engine.py``'s: a b0 EfficientUnet++
checkpoint written by the JAX package, decoder channels (24, 16, 16, 8,
8), 32² tiles.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import numpy_variables

from deadtrees_tpu.core import save_checkpoint as jax_save_checkpoint
from deadtrees_tpu.infer import JaxInference
from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu_torch.core import compile_opts
from deadtrees_tpu_torch.core.compile_opts import disable_compile, graphs_compiled
from deadtrees_tpu_torch.infer import TorchInference

HP = dict(
    architecture="efficientunet++",
    encoder_name="timm-efficientnet-b0",
    decoder_channels=[24, 16, 16, 8, 8],
    in_channels=4,
    classes=3,
    encoder_weights=None,
)
ROUTES = {
    "plain": {},
    "auto": dict(fused_decoder="auto"),
    "chw": dict(fused_decoder="chw"),
    "nhwc": dict(fused_decoder="nhwc"),
    "w8": dict(quantized="w8"),
}


@pytest.fixture(autouse=True, scope="module")
def aot_eager():
    """Programs compile with aot_eager on two intra-op threads (the suite
    runs in several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    old = os.environ.get(compile_opts.ENV)
    os.environ[compile_opts.ENV] = "backend=aot_eager"
    yield
    torch.set_num_threads(n)
    if old is None:
        del os.environ[compile_opts.ENV]
    else:
        os.environ[compile_opts.ENV] = old


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    jmodel = jax_create_model(**HP, dtype=jnp.float32)
    variables = numpy_variables(jmodel, 32, seed=11)
    path = tmp_path_factory.mktemp("ckpt") / "effunetpp_b0.ckpt"
    jax_save_checkpoint(path, params=variables["params"],
                        batch_stats=variables["batch_stats"], hparams=HP, step=5, epoch=2)
    return path


def check_route(ckpt, kw):
    """The route of ``kw`` compiled serves the maps of the same route run
    eagerly; returns the compiled and the eager engine."""
    img = np.random.default_rng(0).integers(0, 255, (2, 32, 32, 4), np.uint8)
    engine = TorchInference(ckpt, device="cpu", **kw)
    before = graphs_compiled()
    got = engine.run(img)
    again = engine.run(img)  # the same shape: no second program
    programs = 2 if kw.get("quantized") == "w8a8" else 1  # w8a8: calibrate, predict
    assert graphs_compiled() - before == programs
    assert len(engine._program.compiles) == 1
    eager = TorchInference(ckpt, device="cpu", **kw)
    with disable_compile():
        want = eager.run(img)
    assert got.shape == (2, 32, 32) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, want)
    return engine, eager


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_compiled_route_serves_the_eager_maps(ckpt, route):
    check_route(ckpt, ROUTES[route])


def test_compiled_engine_matches_jax_engine(ckpt):
    img = np.random.default_rng(0).integers(0, 255, (1, 32, 32, 4), np.uint8)
    want = JaxInference(ckpt, fused_decoder="auto").run(img)
    got = TorchInference(ckpt, device="cpu", fused_decoder="auto").run(img)
    assert got.shape == want.shape == (1, 32, 32) and got.dtype == np.uint8
    mismatch = (got != want).mean()
    assert mismatch < 2e-2, f"class-map mismatch {mismatch}"
