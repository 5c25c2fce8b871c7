"""Train-mode BatchNorm as one op (``deadtrees_tpu_torch/ops/batchnorm.py``).

On the CPU the op runs its plain version, which must be the arithmetic the
port's ``BatchNorm2d`` had before the op, bit for bit: y, the running mean,
the biased running variance, ``num_batches_tracked`` and the gradients of
x, weight and bias, in NCHW and channels-last, float32 and bfloat16, at an
even and an odd H·W. The op's schema, fake implementations and AOTAutograd
run are checked by ``torch.library.opcheck`` in
``tests/test_torch_custom_ops.py``; the kernels themselves on a card in
``tests/test_torch_kernels_cuda.py``.

The kernels' split over blocks (:func:`bn_plan`, the CUDA ops' own plan
in ``csrc/batchnorm_op.cpp``, which builds and runs here) is checked
here: at every BatchNorm of the three benchmarked models (the b5 and the
r34 at bs 16 and 512², the MiT-B5 U-Net at bs 8 and 1024², in the layout
each gets; shapes read on the meta device) the grid gives the H100's 132
SMs at least one block each, and every chunk is one the kernels can
take.
"""

import collections

import pytest
import torch
import torch.nn.functional as F

from deadtrees_tpu_torch.models import create_model
from deadtrees_tpu_torch.models.blocks import BatchNorm2d
from deadtrees_tpu_torch.ops import batchnorm as bn
from deadtrees_tpu_torch.ops.launches import LAUNCHES, reset_launch_counts

SHAPES = [(2, 5, 6, 8), (3, 4, 5, 7)]  # even H·W, odd H·W
H100_SMS = 132


def _before_the_op(module, x):
    """``BatchNorm2d``'s train branch as the port had it before the op."""
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        m = module.momentum
        module.running_mean.mul_(1.0 - m).add_(mean * m)
        module.running_var.mul_(1.0 - m).add_(var * m)
        module.num_batches_tracked.add_(1)
    return F.batch_norm(x, None, None, module.weight, module.bias, True, 0.0, module.eps)


def _step(shape, dtype, channels_last, forward):
    g = torch.Generator().manual_seed(7)
    x = (torch.randn(shape, generator=g) * 3 + 1.5).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(shape, generator=g).to(dtype)
    module = BatchNorm2d(shape[1])
    with torch.no_grad():
        module.weight.copy_(torch.randn(shape[1], generator=g))
        module.bias.copy_(torch.randn(shape[1], generator=g))
        module.running_mean.copy_(torch.randn(shape[1], generator=g))
        module.running_var.copy_(torch.rand(shape[1], generator=g) + 0.5)
    module.train()
    x.requires_grad_(True)
    for _ in range(2):  # the second step moves buffers that the first moved
        y = forward(module, x)
    y.backward(dy)
    return (y, module.running_mean, module.running_var, module.num_batches_tracked, x.grad,
            module.weight.grad, module.bias.grad)


@pytest.mark.parametrize("shape", SHAPES, ids=["even", "odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "nhwc"])
def test_the_op_is_the_former_train_branch_bit_for_bit(shape, dtype, channels_last):
    reset_launch_counts()
    got = _step(shape, dtype, channels_last, BatchNorm2d.forward)
    want = _step(shape, dtype, channels_last, _before_the_op)
    names = ("y", "running_mean", "running_var", "num_batches_tracked", "dx", "dweight",
             "dbias")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.stride() == b.stride(), name
        assert torch.equal(a, b), name
    assert int(got[3]) == 2
    assert all(LAUNCHES[k] == 0 for k in bn.KERNELS), dict(LAUNCHES)


def test_the_op_returns_the_saved_float32_statistics():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 3, 5, 6, generator=g).bfloat16()
    rm, rv, nbt = torch.zeros(3), torch.ones(3), torch.zeros((), dtype=torch.int64)
    y, mean, invstd = torch.ops.deadtrees.batch_norm_train(x, torch.ones(3), torch.zeros(3), rm,
                                                          rv, nbt, 1.0, 1e-5)
    var, want_mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
    assert mean.dtype == invstd.dtype == torch.float32 and y.dtype == torch.bfloat16
    torch.testing.assert_close(mean, want_mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(invstd, torch.rsqrt(var + 1e-5), rtol=1e-5, atol=0)
    # momentum 1: the running buffers become the batch's statistics
    assert torch.equal(rm, want_mean) and torch.equal(rv, var) and int(nbt) == 1


def test_a_single_value_per_channel_raises_as_before():
    module = BatchNorm2d(3).train()
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        module(torch.randn(1, 3, 1, 1))


@pytest.mark.parametrize("make", [
    lambda: torch.randn(2, 8, 4, 4, dtype=torch.float16),
    lambda: torch.randn(2, 8, 4, 4, dtype=torch.float64),
    lambda: torch.randn(2, 8, 4),
    lambda: torch.randn(2, 8, 4, 6)[..., ::2],
    lambda: torch.randn(2, 4, 8, 4).transpose(1, 2),
], ids=["float16", "float64", "3d", "strided", "transposed"])
def test_the_kernels_take_only_their_layouts_and_types(make):
    """What a CUDA tensor of another type or layout meets: a raise, and
    no fallback. The check is the CUDA implementation's, before it touches
    the device, so it runs here on CPU tensors sent to it by key."""
    bn.load()
    x = make()
    params = [torch.ones(8), torch.zeros(8), torch.zeros(8), torch.ones(8)]
    cuda = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)
    with pytest.raises(ValueError):
        torch.ops.deadtrees.batch_norm_train.default.redispatch(
            cuda, x, *params, torch.zeros((), dtype=torch.int64), 0.1, 1e-5)
    with pytest.raises(ValueError):
        torch.ops.deadtrees.batch_norm_train_backward.default.redispatch(
            cuda, x, x, *params[:3])


def _bn_inputs(model, x, run):
    """(shape, channels-last) of every BatchNorm input of ``run(model, x)``."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(
        (tuple(a[0].shape), not a[0].is_contiguous())))
        for m in model.modules() if isinstance(m, BatchNorm2d)]
    with torch.no_grad():
        run(model, x)
    for h in hooks:
        h.remove()
    return seen


def _meta_bn_inputs(architecture, encoder, bs, img):
    """(shape, channels-last) of every BatchNorm input of a forward of the
    model at (bs, 4, img, img): shapes read on the meta device, which has
    no autocast (encoder and decoder are called; the head has no BatchNorm)
    and keeps no channels-last layout through a convolution. A MiT
    encoder's stage maps are views of token sequences, with channels-last
    strides, which the decoder's convolutions keep: the layouts there are
    read from a float32 CPU forward of the MiT-B0 U-Net at bs 2 and 64²,
    whose decoder (the only BatchNorms) is the B5's (at bs 1 the maps'
    strides are NCHW ones too, and the convolutions keep NCHW)."""
    with torch.device("meta"):
        model = create_model(architecture, encoder, in_channels=4, classes=3).eval()
    x = torch.empty((bs, 4, img, img), device="meta")
    if encoder.startswith("mit"):
        dims = [model.encoder.get_submodule(f"norm{s}").normalized_shape[0] for s in (1, 2, 3, 4)]
        maps = tuple(torch.empty((bs, img >> (s + 2), img >> (s + 2), d), device="meta")
                     .permute(0, 3, 1, 2) for s, d in enumerate(dims))
        model.encoder.stages = lambda _: maps
    seen = _bn_inputs(model, x, lambda m, t: m.decoder(m.encoder(t)))
    if encoder.startswith("mit"):
        small = create_model(architecture, "mit_b0", in_channels=4, classes=3,
                             dtype=torch.float32).eval()
        layouts = _bn_inputs(small, torch.zeros(2, 4, 64, 64), lambda m, t: m(t))
        assert len(layouts) == len(seen)
        seen = [(shape, cl) for (shape, _), (_, cl) in zip(seen, layouts)]
    return seen


MODELS = {
    "effunetpp-b5": ("efficientunetplusplus", "timm-efficientnet-b5", 16, 512, 192),
    "unet-r34": ("unet", "resnet34", 16, 512, 46),
    "unet-mit-b5": ("unet", "mit_b5", 8, 1024, 10),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_every_batchnorm_of_the_benchmarked_models_fills_the_card(name):
    architecture, encoder, bs, img, count = MODELS[name]
    inputs = _meta_bn_inputs(architecture, encoder, bs, img)
    assert len(inputs) == count
    if encoder.startswith("mit"):
        assert all(channels_last for _, channels_last in inputs)
    else:
        assert not any(channels_last for _, channels_last in inputs)
    for (n, c, h, w), channels_last in collections.Counter(inputs):
        plan = bn.bn_plan(n, c, h * w, channels_last, 2, True, H100_SMS)
        assert plan.v == 8, (n, c, h, w)  # 16-byte vectors at every shape of these models
        groups = c // plan.v if channels_last else c  # blocks a chunk
        assert plan.chunks * groups >= H100_SMS, (n, c, h, w, plan)
        assert plan.chunks <= bn.BN_MAX_CHUNKS
        assert (plan.chunks - 1) * plan.chunk < plan.units <= plan.chunks * plan.chunk
        assert plan.chunk * (1 if channels_last else plan.v) <= bn.BN_MAX_CHUNK
        assert plan.units * (1 if channels_last else plan.v) == n * h * w


@pytest.mark.parametrize("args, want", [
    # (n, c, hw, nhwc, itemsize, aligned): a ragged run or pixel, or a
    # misaligned tensor, reads single elements
    ((2, 5, 35, False, 2, True), 1),
    ((2, 5, 32, False, 2, False), 1),
    ((2, 12, 9, True, 2, True), 1),
    ((2, 12, 9, True, 4, True), 4),
    ((2, 5, 32, False, 4, True), 4),
])
def test_the_plan_reads_vectors_only_where_they_fit(args, want):
    plan = bn.bn_plan(*args)
    assert plan.v == want
    n, c, hw, nhwc = args[:4]
    assert plan.units == (n * hw if nhwc else n * hw // plan.v)
    assert plan.chunks == 1  # too few values to split
