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


# ---------------------------------------------------------------------------
# the kernel's tile plan (csrc/depthwise.cu takes it as arguments)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def b5_encoder_dw_shapes():
    """{(H, W, C, k, stride)} of every depthwise conv of the b5 encoder at
    bs 16, 512², traced on the meta device (no data, no weights)."""
    from deadtrees_tpu_torch.models import create_model

    with torch.device("meta"):
        model = create_model(architecture="efficientunet++",
                             encoder_name="timm-efficientnet-b5", in_channels=4, classes=3,
                             decoder_channels=[256, 128, 64, 32, 16])
    seen = set()
    for blk in model.encoder.modules():
        if hasattr(blk, "conv_dw"):
            blk.conv_dw.register_forward_hook(lambda mod, inp, out: seen.add(
                (*inp[0].shape[2:], inp[0].shape[1], mod.kernel_size[0], mod.stride[0])))
    with torch.no_grad():
        model.encoder(torch.zeros((16, 4, 512, 512), device="meta"))
    return sorted(seen)


def _assert_plan_covers_once(height, width, channels, k, stride, itemsize, batch, vector=True):
    """Replay the kernel's index math for every block and thread: each
    output pixel and channel is written exactly once."""
    plan = tdw.depthwise_tile_plan(height, width, channels, k, stride, itemsize, batch=batch,
                                   vector=vector)
    ho, wo = (height - 1) // stride + 1, (width - 1) // stride + 1
    p = tdw.DW_PIXELS
    groups = plan.tw // p
    assert plan.tw % p == 0 and plan.th % plan.rows == 0
    assert plan.threads == plan.cbv * groups * (plan.th // plan.rows) <= tdw.DW_THREADS
    assert plan.smem_bytes <= min(tdw.DW_SMEM_BUDGET, tdw.DW_SMEM_MAX)
    ih, iw = (plan.th - 1) * stride + k, (plan.tw - 1) * stride + k
    assert plan.smem_bytes >= 2 * (ih * iw * plan.cbv * plan.v * itemsize
                                   + k * k * plan.cbv * plan.v * 4)  # two stages
    gx, gy, gz = plan.grid
    assert plan.tiles == gx * gy * gz < 2 ** 31 and gz == batch  # persistent blocks walk them
    col_tiles = -(-wo // plan.tw)
    chunk = plan.cbv * plan.v
    assert gx % col_tiles == 0 and gy == -(-ho // plan.th)
    chunks = gx // col_tiles
    assert (chunks - 1) * chunk < channels <= chunks * chunk
    if plan.vector:
        assert channels % plan.v == 0 and plan.v * itemsize == 16
    else:
        assert plan.v == 1
    count = np.zeros((ho, wo), np.int64)
    for ty in range(gy):
        for tx in range(col_tiles):
            for ri in range(plan.th // plan.rows):
                oy = ty * plan.th + ri * plan.rows
                for gi in range(groups):
                    ox = tx * plan.tw + gi * p
                    count[oy:min(oy + plan.rows, ho), ox:min(ox + p, wo)] += 1
    assert (count == 1).all()
    written = [c * chunk + cv * plan.v + j for c in range(chunks) for cv in range(plan.cbv)
               for j in range(plan.v) if c * chunk + cv * plan.v < channels]
    assert sorted(written) == list(range(channels))
    return plan


def test_depthwise_tile_plan_at_the_b5_encoder_shapes(b5_encoder_dw_shapes):
    """Every depthwise conv of the b5 encoder (bs 16, 512², bf16), the 35
    stride-1 and the 4 stride-2 ones."""
    assert len(b5_encoder_dw_shapes) == 14
    assert {c for _, _, c, _, _ in b5_encoder_dw_shapes} >= {24, 48, 240, 384, 768, 1056,
                                                            1824, 3072}
    for hh, ww, c, k, stride in b5_encoder_dw_shapes:
        plan = _assert_plan_covers_once(hh, ww, c, k, stride, 2, 16)
        assert plan.vector and plan.threads >= 64
        assert plan.tiles >= tdw.DW_BLOCKS_PER_SM * tdw.H100_SMS


@pytest.mark.parametrize("sms", [16, 132])
def test_depthwise_tile_plan_follows_the_sm_count(sms):
    """The plan takes the card's SM count: it asks for DW_BLOCKS_PER_SM
    tiles an SM, and for no more halo than that needs."""
    shape = (16, 16, 1824, 5, 1, 2)
    plan = tdw.depthwise_tile_plan(*shape, batch=16, sms=sms)
    assert plan.tiles >= tdw.DW_BLOCKS_PER_SM * sms
    fewest = tdw.depthwise_tile_plan(*shape, batch=16, sms=1)
    assert fewest.th * fewest.tw >= plan.th * plan.tw


@pytest.mark.parametrize("shape,k,stride,itemsize,vector", [
    ((256, 256, 24), 3, 1, 2, True),  # C = 24: three 16-byte runs a pixel
    ((256, 256, 24), 3, 2, 2, True),
    ((37, 53, 24), 5, 2, 4, True),  # ragged, stride 2, float32
    ((37, 53, 24), 3, 1, 2, True),
    ((37, 53, 20), 5, 1, 2, True),  # C % 8 != 0 in bf16: plain-load staging
    ((20, 12, 6), 7, 1, 4, True),  # a k taken at run time
    ((20, 24, 32), 3, 1, 4, False),  # a misaligned x: plain-load staging
    ((16, 16, 88), 5, 1, 2, True),  # 11 runs: no divisor up to 8, a ragged chunk
    ((1, 1, 8), 3, 2, 2, True),
])
def test_depthwise_tile_plan_covers_the_output_once(shape, k, stride, itemsize, vector):
    plan = _assert_plan_covers_once(*shape, k, stride, itemsize, 3, vector=vector)
    assert plan.vector == (vector and shape[2] % (16 // itemsize) == 0)
