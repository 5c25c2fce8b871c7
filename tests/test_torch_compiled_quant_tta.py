"""w8a8, TTA and the cut of ``"auto"`` as compiled programs, on the CPU.

The rest of ``tests/test_torch_compiled_serving.py`` (its fixtures and
geometry): the w8a8 engine's calibrate and predict programs give the
eager engine's scales and maps, the TTA engine (4 views) its maps, and
``"auto"`` resolves its cut at 32 per batch size, at trace time, as the
JAX engine does.
"""

import numpy as np
import torch
from test_torch_compiled_serving import aot_eager, check_route, ckpt  # noqa: F401

from deadtrees_tpu_torch.infer import TorchInference


def test_compiled_w8a8_calibrates_and_serves_as_eager(ckpt):  # noqa: F811
    engine, eager = check_route(ckpt, dict(quantized="w8a8"))
    assert len(engine._calibrate.compiles) == 1
    for k, v in eager._scales.items():
        assert torch.equal(engine._scales[k], v), k


def test_compiled_tta_serves_as_eager(ckpt):  # noqa: F811
    check_route(ckpt, dict(tta=4))


def test_auto_resolves_its_cut_per_shape(ckpt, monkeypatch):  # noqa: F811
    """Under ``"auto"`` each batch size traces one side of the cut at 32,
    one program each: a batch of 33 the plain model, a batch of 32 the
    fused decoder. The two models are stubbed (as in
    ``tests/test_torch_engine.py``): their numbers are checked above."""
    from deadtrees_tpu_torch.ops import fused_decoder as tfd

    engine = TorchInference(ckpt, device="cpu", fused_decoder="auto")

    def fused_stub(model, folded, img, **kwargs):
        return torch.zeros((img.shape[0], 3) + img.shape[2:])

    def plain_stub(img):
        logits = torch.zeros((img.shape[0], 3) + img.shape[2:])
        logits[:, 2] = 1.0
        return logits

    monkeypatch.setattr(tfd, "fused_forward", fused_stub)
    monkeypatch.setattr(engine, "model", plain_stub)
    rng = np.random.default_rng(1)
    big = rng.integers(0, 255, (33, 32, 32, 4), np.uint8)
    for _ in range(2):
        np.testing.assert_array_equal(engine.run(big), np.full((33, 32, 32), 2, np.uint8))
        np.testing.assert_array_equal(engine.run(big[:32]), np.zeros((32, 32, 32), np.uint8))
    assert len(engine._program.compiles) == 2  # one program per batch size
