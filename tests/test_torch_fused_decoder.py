"""The port's fused decoder forward against the JAX one.

Geometry of tests/test_fused_decoder.py (b0 encoder, decoder channels
(24, 16, 16, 8, 8), 32² input, float32). The JAX side runs its Pallas
kernels in interpret mode; the port runs on CPU tensors, so every one of
its fused blocks takes the plain version. Bar: max error < 5e-3, the JAX
test's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import numpy_variables

from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu.ops import fused_decoder as jfd
from deadtrees_tpu.ops import fused_mbconv as jfm
from deadtrees_tpu_torch.models import create_model, state_dict_from_variables
from deadtrees_tpu_torch.ops import fused_cell as tfc
from deadtrees_tpu_torch.ops import fused_decoder as tfd
from deadtrees_tpu_torch.ops import fused_mbconv as tfm

HP = dict(in_channels=4, classes=3, decoder_channels=(24, 16, 16, 8, 8))


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_create_model(
        "efficientunet++", "timm-efficientnet-b0", dtype=jnp.float32, **HP
    )
    variables = numpy_variables(jmodel, 32)
    model = create_model(
        "efficientunet++", "timm-efficientnet-b0", dtype=torch.float32, **HP
    ).eval()
    model.load_state_dict(state_dict_from_variables(variables))
    return jmodel, variables, model


def test_fused_forward_matches_jax(pair):
    jmodel, variables, model = pair
    img = np.random.default_rng(2).normal(size=(1, 32, 32, 4)).astype(np.float32)
    folded_j = jfd.fold_effunetpp_decoder(variables)
    want = np.asarray(jax.jit(
        lambda v, x: jfd.fused_forward(jmodel, v, folded_j, x, interpret=True)
    )(variables, jnp.asarray(img)))

    folded = tfd.fold_effunetpp_decoder(model)
    assert len(folded) == 11 and all(len(pair) == 2 for pair in folded.values())
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    tfm.reset_launch_counts()
    with torch.no_grad():
        got = tfd.fused_forward(model, folded, x)
        plain = model(x)
    # CPU tensors take the plain version: no kernel launch is counted
    assert all(n == 0 for n in tfm.LAUNCHES.values()), tfm.LAUNCHES
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err < 5e-3, f"max err {err}"
    assert np.abs(plain.numpy().transpose(0, 2, 3, 1) - got).max() < 5e-3


def test_folded_block_matches_jax_xla_block(pair):
    """The plain ``folded_block`` against ``folded_block_xla`` on the same
    folded weights (cell x_0_1, conv1: projected skip; conv2: identity)."""
    jmodel, variables, model = pair
    folded_j = jfd.fold_effunetpp_decoder(variables)
    folded = tfd.fold_effunetpp_decoder(model)
    rng = np.random.default_rng(3)
    for i in (0, 1):
        fp = folded["x_0_1"][i]
        x = rng.normal(size=(2, fp.w1.shape[0], 12, 20)).astype(np.float32)
        want = np.asarray(jfd.folded_block_xla(jnp.asarray(x), folded_j["x_0_1"][i]))
        got = tfd.folded_block(torch.from_numpy(x), fp).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        fused = tfm.fused_inverted_residual_chw(torch.from_numpy(x), fp).numpy()
        np.testing.assert_allclose(fused, want, atol=1e-4, rtol=0)
    # the port folds exactly what the JAX package folds, cell by cell
    for name, (fp0, fp1) in folded.items():
        for fp, fp_j in ((fp0, folded_j[name][0]), (fp1, folded_j[name][1])):
            for field, want in fp_j._asdict().items():
                got = getattr(fp, field)
                assert (got is None) == (want is None), (name, field)
                if want is not None:
                    np.testing.assert_allclose(
                        got.numpy(), np.asarray(want), atol=1e-6, err_msg=f"{name}.{field}"
                    )


def test_unported_layout_raises(pair):
    """Both JAX layouts are ported; any other layout raises."""
    _, _, model = pair
    folded = tfd.fold_effunetpp_decoder(model)
    with pytest.raises(ValueError, match="layout"):
        tfd.fused_forward(model, folded, torch.zeros((1, 4, 32, 32)), layout="hwcn")


def test_fused_forward_nhwc_matches_jax(pair):
    """``layout="nhwc"`` against JAX's ``fused_forward(..., interpret=True,
    layout="nhwc")`` (bar 5e-3, the JAX test's own), and the routing: the
    port sends to ``fused_ir_fat`` exactly the blocks that JAX's
    ``_one_block_nhwc`` sends there in interpret mode."""
    import deadtrees_tpu.ops.fused_cell as jfc

    jmodel, variables, model = pair
    img = np.random.default_rng(2).normal(size=(1, 32, 32, 4)).astype(np.float32)
    folded_j = jfd.fold_effunetpp_decoder(variables)
    jax_routed, port_routed = [], []
    jax_fat = jfc.fused_ir_fat

    def jax_spy(x, fp, **kwargs):
        jax_routed.append(tuple(x.shape))
        return jax_fat(x, fp, **kwargs)

    jfc.fused_ir_fat = jax_spy
    try:
        want = np.asarray(jfd.fused_forward(
            jmodel, variables, folded_j, jnp.asarray(img), interpret=True, layout="nhwc"))
    finally:
        jfc.fused_ir_fat = jax_fat

    folded = tfd.fold_effunetpp_decoder(model)
    port_fat = tfc.fused_ir_fat

    def port_spy(x, fp, **kwargs):
        port_routed.append(tuple(x.shape))
        return port_fat(x, fp, **kwargs)

    tfc.fused_ir_fat = port_spy
    try:
        with torch.no_grad():
            got = tfd.fused_forward(
                model, folded, torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                layout="nhwc")
    finally:
        tfc.fused_ir_fat = port_fat
    assert port_routed == jax_routed and len(port_routed) > 0, (port_routed, jax_routed)
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err < 5e-3, f"max err {err}"


def test_folded_block_nhwc_matches_jax_xla_block(pair):
    """The plain ``folded_block_nhwc`` against ``folded_block_xla_nhwc`` on
    the same folded weights (cell x_0_1: projected skip, then identity)."""
    _, variables, model = pair
    folded_j = jfd.fold_effunetpp_decoder(variables)
    folded = tfd.fold_effunetpp_decoder(model)
    rng = np.random.default_rng(4)
    for i in (0, 1):
        fp = folded["x_0_1"][i]
        x = rng.normal(size=(2, 12, 20, fp.w1.shape[0])).astype(np.float32)
        want = np.asarray(jfd.folded_block_xla_nhwc(jnp.asarray(x), folded_j["x_0_1"][i]))
        got = tfd.folded_block_nhwc(torch.from_numpy(x), fp).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_jax_fold_is_what_the_kernel_reads():
    """The folded tensors the kernels take have the JAX package's
    orientation (output channel last), so one FoldedBlockParams layout
    serves both packages: the JAX fields in JAX's order, then the port's
    optional bf16 splits for its tensor-core passes (W1 for pass 1; W2,
    Wsk and w_sse for pass 2; W1 in three terms for the NHWC pass 1 with
    float32 h)."""
    n = len(jfm.FoldedBlockParams._fields)
    packed = ("w1_packed", "w2_packed", "wsk_packed", "sse_packed", "w1_packed3")
    assert tfm.FoldedBlockParams._fields[:n] == jfm.FoldedBlockParams._fields
    assert tfm.FoldedBlockParams._fields[n:] == packed
    assert tfm.FoldedBlockParams._field_defaults == dict.fromkeys(packed)
