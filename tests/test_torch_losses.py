"""The port's losses, metrics and distance maps against the JAX package.

The same numpy inputs go to both: JAX takes channel-last (B, H, W, K)
tensors, the port channel-first (B, K, H, W); the tests permute. Bars:
the exact EDT and the signed distance maps to 1e-5 (the two packages run
the same float32 operations); every loss and metric to rtol 1e-5 (sums
in another order); confusion matrices equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import distance_transform_edt

from deadtrees_tpu.losses import functional as jfn
from deadtrees_tpu.losses import losses as jl
from deadtrees_tpu.losses import metrics as jm
from deadtrees_tpu.train.loss import build_loss as jax_build_loss
from deadtrees_tpu_torch.losses import functional as tfn
from deadtrees_tpu_torch.losses import losses as tl
from deadtrees_tpu_torch.losses import metrics as tm
from deadtrees_tpu_torch.ops import edt as tedt
from deadtrees_tpu_torch.train.loss import build_loss

K = 3
RTOL = 1e-5


def _cf(x):
    """numpy channel-last (B, H, W, K) → torch channel-first."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def _masks(n=64):
    rng = np.random.default_rng(0)
    masks = {
        "random": rng.random((n, n)) > 0.7,
        "all_false": np.zeros((n, n), bool),
        "all_true": np.ones((n, n), bool),
        "single_pixel": np.zeros((n, n), bool),
        "blob": np.zeros((n, n), bool),
    }
    masks["single_pixel"][17, 40] = True
    masks["blob"][10:30, 5:20] = True
    return masks


@pytest.mark.parametrize("name", list(_masks()))
def test_edt_matches_jax(name):
    """Each package against scipy's exact EDT first, so that a failure names
    the half that is wrong; then the two against each other."""
    mask = _masks()[name]
    want = np.asarray(jfn.edt(jnp.asarray(mask)))
    got = tfn.edt(torch.from_numpy(mask)).numpy()
    if mask.any():  # scipy has no finite answer for an all-False mask
        exact = distance_transform_edt(~mask)
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5,
                                   err_msg="the port's edt against scipy")
        np.testing.assert_allclose(want, exact, rtol=0, atol=1e-5,
                                   err_msg="the JAX package's edt against scipy")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if name == "all_false":
        assert np.isfinite(got).all() and got.min() == pytest.approx(1e6)


def test_edt_row_chunks_cover_every_row(monkeypatch):
    """The row-block loop gives the same maps with blocks of a few rows."""
    masks = torch.from_numpy(np.stack(list(_masks().values())))
    want = tfn.edt(masks)
    monkeypatch.setattr(tedt, "_ENVELOPE_FLOATS", 3 * 64 * 64)
    torch.testing.assert_close(tfn.edt(masks), want, rtol=0, atol=0)


def test_one_hot2dist_matches_jax():
    rng = np.random.default_rng(1)
    seg = np.zeros((4, 64, 64), np.int32)
    seg[0] = rng.integers(0, 3, (64, 64))
    seg[1, 10:40, 10:40] = 1  # class 2 absent: zero map
    seg[2] = 2  # all one class
    seg[3, 5, 5] = 1
    one_hot = np.asarray(jfn.class2one_hot(jnp.asarray(seg), K))
    want = np.asarray(jfn.batch_one_hot2dist(jnp.asarray(one_hot)))
    got = tfn.batch_one_hot2dist(tfn.class2one_hot(torch.from_numpy(seg), K))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 1), rtol=0, atol=1e-5)
    assert not got[1, 2].any()
    one = tfn.one_hot2dist(tfn.class2one_hot(torch.from_numpy(seg[:1]), K)[0])
    np.testing.assert_allclose(one.numpy(), np.moveaxis(want[0], -1, 0), rtol=0, atol=1e-5)


def test_one_hot2dist_on_the_cpu_is_the_custom_op_plain_version():
    """On a CPU tensor ``batch_one_hot2dist`` goes through the custom op
    ``deadtrees::signed_distance_maps``, whose CPU implementation is the
    plain version: bit-equal to it, and no EDT kernel launched."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from deadtrees_tpu_torch.ops.launches import LAUNCHES, reset_launch_counts

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    seg = tfn.class2one_hot(torch.from_numpy(np.random.default_rng(4).integers(0, K, (2, 24, 40))),
                            K)
    seen = []
    reset_launch_counts()
    with Ops():
        got = tfn.batch_one_hot2dist(seg)
    assert seen == [torch.ops.deadtrees.signed_distance_maps.default]
    assert LAUNCHES["edt_columns"] == LAUNCHES["edt_rows"] == 0
    want = tfn.batch_one_hot2dist_reference(seg)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_one_hot_helpers_match_jax():
    rng = np.random.default_rng(2)
    seg = rng.integers(0, K, (2, 8, 8))
    probs = rng.dirichlet(np.ones(K), (2, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tfn.class2one_hot(torch.from_numpy(seg), K).numpy(),
        np.moveaxis(np.asarray(jfn.class2one_hot(jnp.asarray(seg), K)), -1, 1))
    np.testing.assert_array_equal(
        tfn.probs2class(_cf(probs)).numpy(), np.asarray(jfn.probs2class(jnp.asarray(probs))))
    np.testing.assert_array_equal(
        tfn.probs2one_hot(_cf(probs)).numpy(),
        np.moveaxis(np.asarray(jfn.probs2one_hot(jnp.asarray(probs))), -1, 1))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (2, 16, 16, K)).astype(np.float32)
    probs = np.asarray(jnp.asarray(logits) - jnp.asarray(logits).max(-1, keepdims=True))
    probs = np.exp(probs) / np.exp(probs).sum(-1, keepdims=True)
    seg = rng.integers(0, K, (2, 16, 16)).astype(np.int32)
    seg[1, :4] = 0
    target = np.asarray(jfn.class2one_hot(jnp.asarray(seg), K))
    dist = np.asarray(jfn.batch_one_hot2dist(jnp.asarray(target)))
    return {"logits": logits, "probs": probs.astype(np.float32), "seg": seg,
            "target": target, "dist": dist}


LOSSES = {
    "cross_entropy": (lambda m: m.CrossEntropy(idc=[0, 1, 2]), "target"),
    "generalized_dice": (lambda m: m.GeneralizedDice(idc=[1, 2]), "target"),
    "gdice": (lambda m: m.GeneralizedDiceLoss(), "target"),
    "dice": (lambda m: m.DiceLoss(idc=[1, 2]), "target"),
    "dice_gather": (lambda m: m.DiceLoss(idc=[0, 2]), "target"),
    "surface": (lambda m: m.SurfaceLoss(idc=[1, 2]), "dist"),
    "focal": (lambda m: m.FocalLoss(idc=[0, 1, 2], gamma=2), "target"),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_matches_jax(data, name):
    make, second = LOSSES[name]
    want = float(make(jl)(jnp.asarray(data["probs"]), jnp.asarray(data[second])))
    got = float(make(tl)(_cf(data["probs"]), _cf(data[second])))
    assert got == pytest.approx(want, rel=RTOL, abs=1e-7)


@pytest.mark.parametrize("mode", ["default", "GDL"])
def test_gwdl_matches_jax(data, mode):
    m = [[0.0, 1.0, 1.0], [1.0, 0.0, 0.5], [1.0, 0.5, 0.0]]
    want = float(jl.GeneralizedWassersteinDiceLoss(m, weighting_mode=mode)(
        jnp.asarray(data["logits"]), jnp.asarray(data["seg"])))
    got = float(tl.GeneralizedWassersteinDiceLoss(m, weighting_mode=mode)(
        _cf(data["logits"]), torch.from_numpy(data["seg"])))
    assert got == pytest.approx(want, rel=RTOL)


def test_metrics_match_jax(data):
    jp, jt = jnp.asarray(data["probs"]), jnp.asarray(data["target"])
    tp, tt = _cf(data["probs"]), _cf(data["target"])
    for kw in ({}, {"ignore_channels": [0]}, {"ignore_channels": [1]}, {"threshold": None}):
        assert float(tm.fscore(tp, tt, **kw)) == pytest.approx(float(jm.fscore(jp, jt, **kw)),
                                                               rel=RTOL)
    pred = np.asarray(jfn.probs2one_hot(jp))
    for bg in (True, False):
        want = float(jm.dice_score(jnp.asarray(pred), jt, include_background=bg))
        got = float(tm.dice_score(_cf(pred), tt, include_background=bg))
        assert got == pytest.approx(want, rel=RTOL)


def test_confusion_matrices_equal(data):
    rng = np.random.default_rng(4)
    pred = data["probs"].argmax(-1)
    seg, lu = data["seg"], rng.integers(0, 2, data["seg"].shape)
    for norm in (None, "true"):
        want = np.asarray(jm.confusion_matrix(jnp.asarray(pred), jnp.asarray(seg),
                                              num_classes=K, normalize=norm))
        got = tm.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(seg),
                                  num_classes=K, normalize=norm).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        want = np.asarray(jm.masked_confusion_matrix(
            jnp.asarray(pred), jnp.asarray(seg), jnp.asarray(lu), num_classes=K, normalize=norm))
        got = tm.masked_confusion_matrix(torch.from_numpy(pred), torch.from_numpy(seg),
                                         torch.from_numpy(lu), num_classes=K,
                                         normalize=norm).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert tm.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(seg),
                               num_classes=K).sum() == seg.size


CONFIGS = [
    ["GDICE", "FOCAL", "BOUNDARY"],
    ["GDICE", "FOCAL", "BOUNDARY-RAMPED"],
    ["DICE", "FOCAL"],
    ["DICE", "BOUNDARY"],
    ["GWDICE", "FOCAL", "BOUNDARY"],
    ["GDICE"],
]


@pytest.mark.parametrize("losses", CONFIGS, ids=["+".join(c) for c in CONFIGS])
@pytest.mark.parametrize("epoch", [0, 5, 150])
def test_compound_loss_matches_jax(data, losses, epoch):
    want_total, want = jax_build_loss(losses, K)(
        jnp.asarray(data["probs"]), jnp.asarray(data["target"]),
        logits=jnp.asarray(data["logits"]), distmap=jnp.asarray(data["dist"]), epoch=epoch)
    got_total, got = build_loss(losses, K)(
        _cf(data["probs"]), _cf(data["target"]), logits=_cf(data["logits"]),
        distmap=_cf(data["dist"]), epoch=epoch)
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=RTOL, abs=1e-7), k
    assert float(got_total) == pytest.approx(float(want_total), rel=RTOL)


def test_compound_loss_rules():
    loss = build_loss(["GDICE", "BOUNDARY-RAMPED"], K)
    assert [loss.alpha(e) for e in (0, 9, 98, 500)] == pytest.approx([0.01, 0.1, 0.99, 0.99])
    with pytest.raises(ValueError, match="GDICE _OR_ DICE"):
        build_loss(["GDICE", "DICE"], K)
    with pytest.raises(ValueError, match="dice-family"):
        build_loss(["FOCAL"], K)
    with pytest.raises(NotImplementedError):
        build_loss(["GDICE", "LOVASZ"], K)
