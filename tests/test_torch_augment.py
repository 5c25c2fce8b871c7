"""The port's training augmentation against the JAX package.

Kernel 4's plain version (``deadtrees_tpu_torch.ops.augment``, what the
port runs for a CPU batch) against ``augment_pallas`` (run as
tests/test_augment_pallas.py runs it: interpret mode off the TPU) and
against the XLA path of ``augment_batch`` (``_color_jitter_u8`` +
``normalize``), with the same fixed α, β, flips and rotation: the random
streams of the two packages differ, so the parameters are made with numpy
and passed to both.

Bar: atol 1e-5 (tests/test_augment_pallas.py's own). The per-image mean
is an exact integer sum in the port and a float32 reduction in JAX, so the
two may round ``v·α + β·mean`` to the two sides of an integer: at most 1 in
10⁴ elements may differ by exactly one grey step, 1/(255·s_c); the test
counts them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deadtrees_tpu.data import augment as jaug
from deadtrees_tpu.ops.augment_pallas import augment_pallas
from deadtrees_tpu_torch.data import augment as taug
from deadtrees_tpu_torch.ops import augment as tops

MEAN = (0.3661029729, 0.3875165941, 0.3501133538, 0.5797285859)
STD = (0.2388708549, 0.2103625723, 0.2050272174, 0.2025812523)
ATOL = 1e-5
MAX_STEP_SHARE = 1e-4


def _params(rng, b):
    """α and β that make the jitter and the clipping bite, one sample
    untouched; flips and rotations covering every case."""
    alpha = rng.uniform(0.85, 1.15, b).astype(np.float32)
    beta = rng.uniform(-0.2, 0.2, b).astype(np.float32)
    alpha[0], beta[0] = 1.0, 0.0
    return {
        "flip_h": np.arange(b) % 3 == 1,
        "flip_v": np.arange(b) % 3 == 2,
        "rot_k": (np.arange(b) % 4).astype(np.int32),
        "alpha": alpha,
        "beta": beta,
    }


def _image(rng, shape):
    """uint8 noise with saturated patches, so the clip takes both ends."""
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[:, :4] = 255
    img[:, -4:] = 0
    return img


def _compare(got, want, c):
    """Max error outside grey-step flips, and the number of flips."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    step = 1.0 / (255.0 * np.asarray(STD[:c]))
    flips = diff > ATOL
    if flips.any():  # every disagreement must be exactly one grey step
        step_of = np.broadcast_to(step[None, :, None, None], diff.shape)[flips]
        np.testing.assert_allclose(diff[flips], step_of, rtol=1e-4)
    return float(np.where(flips, 0.0, diff).max()), int(flips.sum())


@pytest.mark.parametrize("shape", [(3, 64, 48, 4), (3, 64, 48, 3)], ids=["rgbn", "rgb"])
def test_kernel_plain_matches_augment_pallas(shape):
    rng = np.random.default_rng(shape[-1])
    img = _image(rng, shape)
    p = _params(rng, shape[0])
    want = augment_pallas(
        jnp.asarray(img), jnp.asarray(p["alpha"]), jnp.asarray(p["beta"]),
        mean=MEAN, std=STD, interpret=True,
    )
    want = np.asarray(want).transpose(0, 3, 1, 2)
    got = tops.augment_jitter_normalize(
        torch.from_numpy(img), torch.from_numpy(p["alpha"]), torch.from_numpy(p["beta"]),
        MEAN, STD,
    )
    assert got.shape == want.shape and got.dtype == torch.float32
    err, flips = _compare(got.numpy(), want, shape[-1])
    assert err <= ATOL, err
    assert flips <= MAX_STEP_SHARE * img.size, f"{flips} grey-step flips in {img.size}"


@pytest.mark.parametrize("c", [4, 3])
def test_augment_batch_matches_xla_path(c):
    """The whole train transform with fixed parameters: dihedral + jitter +
    normalize, image and mask, against the JAX package's XLA path."""
    rng = np.random.default_rng(10 + c)
    b, n = 8, 32
    img = _image(rng, (b, n, n, c))
    mask = rng.integers(0, 3, (b, n, n)).astype(np.int32)
    lu = rng.integers(0, 2, (b, n, n)).astype(np.int32)
    p = _params(rng, b)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    geo = (jp["flip_h"], jp["flip_v"], jp["rot_k"])
    want = jaug.normalize(
        jaug._color_jitter_u8(jaug._apply_dihedral(jnp.asarray(img), *geo), jp["alpha"], jp["beta"]),
        MEAN[:c], STD[:c],
    )
    got = taug.augment_batch(
        None, torch.from_numpy(img), torch.from_numpy(mask), torch.from_numpy(lu),
        mean=MEAN, std=STD, params={k: torch.from_numpy(v) for k, v in p.items()},
    )
    err, flips = _compare(got["image"].numpy(), np.asarray(want).transpose(0, 3, 1, 2), c)
    assert err <= ATOL, err
    assert flips <= MAX_STEP_SHARE * img.size, f"{flips} grey-step flips in {img.size}"
    for name, t in (("mask", mask), ("lu", lu)):
        want_t = np.asarray(jaug._apply_dihedral(jnp.asarray(t), *geo))
        np.testing.assert_array_equal(got[name].numpy(), want_t)
        assert got[name].dtype == torch.int64


def test_apply_dihedral_matches_jax():
    rng = np.random.default_rng(3)
    b = 16
    flips = np.arange(b) % 4
    fh, fv = flips == 1, flips == 2
    rot = (np.arange(b) // 4).astype(np.int32)
    for arr in (rng.integers(0, 256, (b, 12, 12, 4), dtype=np.uint8),
                rng.integers(0, 3, (b, 12, 12)).astype(np.int32)):
        want = jaug._apply_dihedral(jnp.asarray(arr), jnp.asarray(fh), jnp.asarray(fv),
                                    jnp.asarray(rot))
        got = taug._apply_dihedral(torch.from_numpy(arr), torch.from_numpy(fh),
                                   torch.from_numpy(fv), torch.from_numpy(rot))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_color_jitter_matches_jax():
    rng = np.random.default_rng(4)
    img = _image(rng, (4, 16, 16, 4))
    p = _params(rng, 4)
    want = np.asarray(jaug._color_jitter_u8(jnp.asarray(img), jnp.asarray(p["alpha"]),
                                            jnp.asarray(p["beta"])))
    got = taug._color_jitter_u8(torch.from_numpy(img), torch.from_numpy(p["alpha"]),
                                torch.from_numpy(p["beta"])).numpy()
    assert np.mean(got != want) <= MAX_STEP_SHARE
    assert np.abs(got - want).max() <= 1.0


def test_augment_param_distributions():
    """tests/test_data.py::test_augment_param_distributions on the port's
    sampler."""
    params = taug.sample_augment_params(torch.Generator().manual_seed(0), 4096)
    flip_any = (params["flip_h"] | params["flip_v"]).numpy()
    assert not (params["flip_h"] & params["flip_v"]).any()
    assert 0.45 < flip_any.mean() < 0.55  # OneOf p=0.5
    rot_k = params["rot_k"].numpy()
    assert 0.55 < (rot_k == 0).mean() < 0.70  # off (0.5) + k=0 (0.125)
    alpha = params["alpha"].numpy()
    assert np.all((alpha >= 0.85) & (alpha <= 1.15))
    assert 0.45 < (alpha == 1.0).mean() < 0.55
    beta = params["beta"].numpy()
    assert np.all((beta >= -0.2) & (beta <= 0.2))
    assert 0.45 < (beta == 0.0).mean() < 0.55


def test_val_path_is_plain_normalize():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (2, 16, 16, 4), dtype=np.uint8)
    mask = rng.integers(0, 3, (2, 16, 16)).astype(np.int32)
    want = jaug.augment_batch(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(mask),
                              train=False)
    got = taug.augment_batch(torch.Generator(), torch.from_numpy(img), torch.from_numpy(mask),
                             train=False)
    np.testing.assert_allclose(got["image"].numpy(),
                               np.asarray(want["image"]).transpose(0, 3, 1, 2), atol=ATOL)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))


def test_train_path_draws_from_the_generator():
    img = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (4, 8, 8, 4),
                                                             dtype=np.uint8))
    a = taug.augment_batch(torch.Generator().manual_seed(1), img)["image"]
    b = taug.augment_batch(torch.Generator().manual_seed(1), img)["image"]
    assert a.shape == (4, 4, 8, 8) and torch.equal(a, b)


def test_image_mean_is_exact():
    """Above 2^24 a float32 sum drops units; the integer sum does not."""
    img = torch.full((1, 512, 512, 4), 255, dtype=torch.uint8)
    img[0, 0, 0, 0] = 254
    want = (255 * img.numel() - 1) / img.numel()
    assert float(tops.image_mean(img)[0]) == np.float32(want)


def test_wrapper_raises_on_what_it_cannot_take():
    img = torch.zeros((2, 8, 8, 4), dtype=torch.uint8)
    a = torch.ones(2)
    with pytest.raises(ValueError, match="uint8"):
        tops.augment_jitter_normalize(img.float(), a, a, MEAN, STD)
    with pytest.raises(ValueError, match="shape"):
        tops.augment_jitter_normalize(img, torch.ones(3), a, MEAN, STD)
    with pytest.raises(ValueError, match="channels"):
        tops.augment_jitter_normalize(img, a, a, MEAN[:3], STD[:3])
