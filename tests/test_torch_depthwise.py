"""The port's depthwise convolution against the JAX one.

Shapes of tests/test_depthwise.py, k 3 and 5, plus stride 2 and a ragged
H, W that the JAX Pallas route hands to XLA. The JAX side runs its Pallas
kernel in interpret mode (``force="pallas"``) or XLA (``force="xla"``);
the port's side runs the kernel's plain version and the library route.
Bar: rtol = atol = 1e-5, the JAX test's own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deadtrees_tpu.ops.depthwise import depthwise_conv2d as jax_depthwise
from deadtrees_tpu_torch.ops import depthwise as tdw
from deadtrees_tpu_torch.ops.launches import LAUNCHES, reset_launch_counts

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, ks, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(ks, ks, 1, shape[-1])).astype(np.float32)
    return x, k


@pytest.mark.parametrize("shape,ks", [
    ((2, 32, 32, 16), 3),
    ((1, 64, 32, 8), 5),
    ((3, 16, 16, 24), 3),
])
def test_depthwise_matches_jax_pallas(shape, ks):
    x, k = _inputs(shape, ks, seed=shape[-1])
    want = np.asarray(jax_depthwise(jnp.asarray(x), jnp.asarray(k), force="pallas",
                                    interpret=True))
    reset_launch_counts()
    ref = tdw.depthwise_conv2d_reference(torch.from_numpy(x), torch.from_numpy(k))
    lib = tdw.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(k))
    assert LAUNCHES["depthwise_conv2d"] == 0
    np.testing.assert_allclose(ref.numpy(), want, **TOL)
    np.testing.assert_allclose(lib.numpy(), want, **TOL)


@pytest.mark.parametrize("shape,ks,strides", [
    ((2, 32, 32, 8), 3, 2),
    ((2, 33, 17, 8), 5, 2),
    ((1, 21, 13, 4), 3, 1),
    ((1, 20, 12, 6), 7, 1),
])
def test_depthwise_strides_and_ragged_match_jax(shape, ks, strides):
    """Shapes the JAX Pallas route leaves to XLA (stride 2, H % 8 != 0):
    the port's kernel takes them itself, so its plain version is held to
    JAX's answer there."""
    x, k = _inputs(shape, ks, seed=ks * 10 + strides)
    want = np.asarray(jax_depthwise(jnp.asarray(x), jnp.asarray(k), strides=strides,
                                    force="pallas", interpret=True))
    ref = tdw.depthwise_conv2d_reference(torch.from_numpy(x), torch.from_numpy(k),
                                         strides=strides)
    lib = tdw.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(k), strides=strides,
                               force="torch")
    assert ref.shape == want.shape == lib.shape
    np.testing.assert_allclose(ref.numpy(), want, **TOL)
    np.testing.assert_allclose(lib.numpy(), want, **TOL)


def test_depthwise_bfloat16_output_dtype():
    x, k = _inputs((1, 8, 8, 4), 3, seed=1)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ref = tdw.depthwise_conv2d_reference(xt, torch.from_numpy(k))
    assert ref.dtype == torch.bfloat16
    want = tdw.depthwise_conv2d_reference(xt.float(), torch.from_numpy(k))
    torch.testing.assert_close(ref, want.to(torch.bfloat16), rtol=0, atol=0)


def test_depthwise_rejects_what_it_cannot_take():
    x = torch.zeros((1, 8, 8, 4))
    k = torch.zeros((3, 3, 1, 4))
    with pytest.raises(ValueError, match="device"):  # the kernel route needs the card
        tdw.depthwise_conv2d(x, k, force="cuda")
    with pytest.raises(ValueError, match="force"):
        tdw.depthwise_conv2d(x, k, force="pallas")
    with pytest.raises(ValueError, match="strides"):
        tdw.depthwise_conv2d(x, k, strides=3)
    with pytest.raises(ValueError, match="kernel shape"):
        tdw.depthwise_conv2d(x, torch.zeros((4, 4, 1, 4)))
    with pytest.raises(ValueError, match="kernel shape"):
        tdw.depthwise_conv2d(x, torch.zeros((3, 3, 1, 5)))
    with pytest.raises(ValueError, match="dtype"):
        tdw.depthwise_conv2d(x.half(), k)
