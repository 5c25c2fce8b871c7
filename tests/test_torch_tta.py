"""The port's test-time augmentation against the JAX package.

The views are the JAX ones exactly (``torch.rot90(x, k, dims=(1, 2))`` is
``jnp.rot90(x, k, axes=(1, 2))`` on NHWC), the wrapped predictor gives
the JAX probabilities for the same logits function (a deliberately
asymmetric 3×3 conv, float32, 1e-5), and averaging over the group makes
it equivariant: a rotated or flipped tile gives the rotated or flipped
prediction. The cases are those of tests/test_tta.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deadtrees_tpu.infer import tta as jtta
from deadtrees_tpu_torch.infer.tta import (
    DIHEDRAL,
    ROTATIONS,
    apply_view,
    invert_view,
    make_tta_fn,
)


def _kernel(seed, cin=4, classes=3):
    return np.random.default_rng(seed).normal(size=(3, 3, cin, classes)).astype(np.float32)


def _torch_conv(kern):
    w = torch.from_numpy(kern).permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW

    def logits_fn(x):  # NHWC in, NHWC out
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)

    return logits_fn


def _jax_conv(kern):
    k = jnp.asarray(kern)

    def logits_fn(x):
        return jax.lax.conv_general_dilated(
            x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    return logits_fn


def test_views_match_jax_and_invert():
    x = np.random.default_rng(0).normal(size=(2, 8, 8, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    assert DIHEDRAL == jtta.DIHEDRAL and ROTATIONS == jtta.ROTATIONS
    seen = set()
    for k, f in DIHEDRAL:
        view = apply_view(xt, k, f)
        np.testing.assert_array_equal(view.numpy(), np.asarray(jtta.apply_view(jnp.asarray(x), k, f)))
        np.testing.assert_array_equal(invert_view(view, k, f).numpy(), x)
        seen.add(view.numpy().tobytes())
    assert len(seen) == 8


@pytest.mark.parametrize("views", [4, 8])
def test_tta_matches_jax(views):
    kern = _kernel(1)
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 4)).astype(np.float32)
    want = np.asarray(jtta.make_tta_fn(_jax_conv(kern), views)(jnp.asarray(x)))
    got = make_tta_fn(_torch_conv(kern), views)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("views", [4, 8])
def test_tta_group_equivariance(views):
    """tta(g(x)) == g(tta(x)) for every g in the group averaged over."""
    tta = make_tta_fn(_torch_conv(_kernel(3)), views)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 16, 16, 4)).astype(np.float32))
    base = tta(x)
    for k, f in (DIHEDRAL if views == 8 else ROTATIONS):
        torch.testing.assert_close(tta(apply_view(x, k, f)), apply_view(base, k, f),
                                   atol=1e-5, rtol=0)


def test_tta_rejects_non_square_and_bad_views():
    fn = _torch_conv(_kernel(5))
    with pytest.raises(ValueError, match="views"):
        make_tta_fn(fn, 3)
    with pytest.raises(ValueError, match="square"):
        make_tta_fn(fn, 4)(torch.zeros((1, 8, 16, 4)))
