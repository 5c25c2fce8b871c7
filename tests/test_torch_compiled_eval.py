"""The eval and predict steps as compiled programs, on the CPU.

The geometry and fixtures of ``tests/test_torch_compiled_train.py``
(``aot_eager``, ``fullgraph=True``). The eval step's program gives the
eager step's metrics, and confusion matrices equal to ``torch.bincount``'s,
with and without ``lu`` (one program each); the predict step's program the
eager one's classes and probabilities; the trainer's SWA BatchNorm pass,
one program a batch, the eager pass's running statistics.
"""

import torch
from test_torch_compiled_train import K, _port, aot_eager, data  # noqa: F401

from deadtrees_tpu_torch.core.compile_opts import Program, disable_compile
from deadtrees_tpu_torch.train import build_loss, make_eval_step, make_predict_step
from deadtrees_tpu_torch.train.steps import bn_buffers
from tests.test_torch_train_step import _port_batch


def test_compiled_eval_step_matches_eager_and_bincount(data):  # noqa: F811
    _, variables, batch = data
    model, _ = _port(variables)
    step = make_eval_step(model, build_loss(["GDICE", "FOCAL", "BOUNDARY"], K), num_classes=K)
    for keys in (("image", "mask", "distmap", "lu"), ("image", "mask", "distmap")):
        pb = _port_batch(batch, keys)
        got = step(None, pb, 3)
        with disable_compile():
            want = step(None, pb, 3)
        assert set(got) == set(want) and ("cm_masked" in got) == ("lu" in keys)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7, msg=k)
        with torch.no_grad():
            pred = model(pb["image"]).argmax(1).reshape(-1)
        idx = pb["mask"].reshape(-1).long() * K + pred
        assert torch.equal(got["cm"], torch.bincount(idx, minlength=K * K).reshape(K, K))
        if "lu" in keys:
            masked = torch.where(pb["lu"].reshape(-1) == 1, idx, torch.full_like(idx, K * K))
            assert torch.equal(got["cm_masked"],
                               torch.bincount(masked, minlength=K * K + 1)[:-1].reshape(K, K))
    assert len(step.programs[0].compiles) == 2  # with and without lu


def test_compiled_predict_step_and_bn_pass_match_eager(data):  # noqa: F811
    _, variables, batch = data
    model, _ = _port(variables)
    predict = make_predict_step(model)
    img = _port_batch(batch)["image"]
    classes, probs = predict(img)
    with disable_compile():
        want_classes, want_probs = predict(img)
    assert torch.equal(classes, want_classes)
    torch.testing.assert_close(probs, want_probs, rtol=1e-6, atol=1e-7)

    # the SWA BatchNorm pass (Trainer._recalibrate_bn's program)
    stats = []
    for compiled in (True, False):
        m, _ = _port(variables)
        m.train(True)
        bn_pass = Program(lambda x, m=m: m(x), "cpu")
        with torch.no_grad():
            if compiled:
                bn_pass(img)
                bn_pass(img)
            else:
                with disable_compile():
                    bn_pass(img)
                    bn_pass(img)
        stats.append([b.clone() for b in bn_buffers(m)])
    for a, b in zip(*stats):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
