"""The plain reference against itself at a tiny size."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from port_bench.harness import weights
from port_bench.reference import batch as ref_batch
from port_bench.reference import model as ref_model
from port_bench.reference import step as ref_step
from port_bench.reference.core import Numerics
from port_bench.tests.conftest import DATA, REPO

TINY = json.loads((DATA / "configs" / "tiny-effunetpp.json").read_text())
R34 = json.loads((REPO / "port_bench" / "configs" / "unet-r34.json").read_text())
B5 = json.loads((REPO / "port_bench" / "configs" / "effunetpp-b5.json").read_text())


@pytest.mark.parametrize("config", [TINY, R34], ids=["effunetpp", "unet"])
def test_checkpointed_step_equals_the_plain_one(config):
    params = weights.make(config, 5, "cpu")
    names = [l.name for l in ref_model.leaves(config) if l.is_param]
    x = torch.randn(2, 4, 32, 32, generator=torch.Generator().manual_seed(0))
    mask = torch.randint(0, 3, (2, 32, 32), generator=torch.Generator().manual_seed(1))
    dist = ref_batch.distmaps(mask.numpy(), 3)
    got = {}
    for ckpt in (False, True):
        leaves = [params[n].detach().requires_grad_(True) for n in names]
        run = dict(params, **dict(zip(names, leaves)))
        logits = ref_model.forward(run, x, config, train=True, checkpoint=ckpt)
        total, _ = ref_step.loss(logits, mask, dist, config["recipe"]["losses"])
        got[ckpt] = [total.detach()] + list(torch.autograd.grad(total, leaves))
    for a, b in zip(got[False], got[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("config", [TINY, R34, B5], ids=["tiny", "unet-r34", "effunetpp-b5"])
def test_the_configuration_states_the_reference_s_parameter_count(config):
    if "parameters" in config:
        assert ref_model.n_params(config) == config["parameters"]
    names = [l.name for l in ref_model.leaves(config)]
    assert len(names) == len(set(names))
    assert set(ref_model.residual_bns(config)) <= {n.rsplit(".", 1)[0] for n in names}


def test_calibrated_statistics_make_eval_equal_train_on_their_batch():
    params = weights.make(TINY, 9, "cpu")
    x = torch.randn(4, 4, 32, 32, generator=torch.Generator().manual_seed(2))
    weights.calibrate(params, TINY, x)
    with torch.no_grad():
        train = ref_model.forward(params, x, TINY, train=True)
        evaled = ref_model.forward(params, x, TINY, train=False)
    torch.testing.assert_close(evaled, train, rtol=1e-4, atol=1e-4)


def test_fp8_rounds_each_convolution_operand():
    t = torch.tensor([1.0, 0.3, -0.07, 448.0 / 3])
    q = Numerics("fp8").operand(t)
    assert not torch.equal(q, t) and float((q - t).abs().max() / t.abs().max()) < 2 ** -4
    assert torch.equal(Numerics("float32").operand(t), t)


def test_the_draw_repeats_from_a_state_and_follows_the_generator():
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    a = ref_batch.draw(state, 16)
    b = ref_batch.draw_from(g, 16)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert set(a["rot_k"].tolist()) <= {0, 1, 2, 3}
    assert bool(((a["alpha"] >= 0.85) & (a["alpha"] <= 1.15)).all())


def test_signed_distances_by_hand():
    mask = np.zeros((1, 5, 5), np.int64)
    mask[0, 1:4, 1:4] = 1
    d = ref_batch.distmaps(mask, 3)[0]
    assert float(d[1, 2, 2]) == -1.0  # two steps in: -(2 - 1)
    assert float(d[1, 1, 1]) == 0.0  # on the edge, inside
    assert float(d[1, 0, 0]) == pytest.approx(2 ** 0.5)  # outside, diagonal
    assert float(d[2].abs().sum()) == 0.0  # an absent class: a zero map
