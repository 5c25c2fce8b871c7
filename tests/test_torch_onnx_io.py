"""The port's ONNX reader against the JAX package's, and the port's model
through ONNX and back.

- The same bytes go to both readers: the same nodes, opset and
  initializers, and the same recovered state dict, array for array; the
  two writers write the same bytes.
- Unfused (``onnx_from_torch_modules(fuse_bn=False)``): the recovered
  state dict is the port model's (tests/test_onnx_io.py's unfused case).
- Fused (the reference's export flags): the de-fused identity BatchNorm
  synthesizes ``var = 1 - eps`` at the eps the PORT's BatchNorm uses at
  that site, so the recovered state dict loads into ``create_model`` with
  ``strict=True`` and gives the source model's logits within 3e-3 with
  equal argmax, for an encoder eps of 1e-3 and of 1e-5
  (tests/test_onnx_io.py:236-250).
- The real TorchScript exporter's bytes, both flavors, under the skip
  condition of tests/test_onnx_torch_export_oracle.py.
- The model zoo: unet, unet++ and resunet on resnet18 and resunet++ on
  timm-efficientnet-b0 (64², the JAX converter tests' decoder widths)
  through the writer, fused and unfused, and resunet++ through the real
  exporter, whose fused bytes fold the last gate's BatchNorm across its
  Sequential.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deadtrees_tpu.models import onnx_io as jax_onnx_io
from deadtrees_tpu_torch.models import (
    create_model,
    init_model,
    onnx_io,
    state_dict_from_variables,
    tensor_variables_from_state_dict,
)
from tests.test_convert_flagship import DEC_CH
from tests.test_onnx_io import _randomize_bn
from tests.test_torch_models import fill_tree

HP = dict(architecture="efficientunet++", encoder_name="timm-efficientnet-b0",
          decoder_channels=DEC_CH, in_channels=4, classes=3)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(seed, **kw):
    """A port model with random weights, BatchNorms and conv biases (the
    real exporter merges equal initializers, such as the zero biases that
    ``init_model`` gives, under one name)."""
    model = create_model(**HP, dtype=torch.float32, **kw)
    gen = torch.Generator().manual_seed(seed)
    init_model(model, generator=gen)
    torch.manual_seed(seed)  # _randomize_bn draws from the global generator
    _randomize_bn(model)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.rand(m.bias.shape, generator=gen) * 0.2 - 0.1)
    return model.eval()


def _logits(model, seed=2):
    x = np.random.default_rng(seed).normal(size=(1, 4, 64, 64)).astype(np.float32)
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _load_recovered(sd, **kw):
    """A fresh port model with the recovered state dict, strictly: only
    ``num_batches_tracked``, which ONNX does not carry, may be missing."""
    model = create_model(**HP, dtype=torch.float32, **kw).eval()
    want = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(sd) == set(want), (
        f"missing={sorted(set(want) - set(sd))[:5]} extra={sorted(set(sd) - set(want))[:5]}"
    )
    full = dict(model.state_dict())
    full.update({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    model.load_state_dict(full, strict=True)
    return model


@pytest.mark.parametrize("fuse_bn", [False, True])
def test_reader_and_writer_match_jax(fuse_bn):
    model = _model(0)
    data = onnx_io.onnx_from_torch_modules(model, fuse_bn=fuse_bn)
    assert data == jax_onnx_io.onnx_from_torch_modules(model, fuse_bn=fuse_bn)
    ours, theirs = onnx_io.read_onnx(data), jax_onnx_io.read_onnx(data)
    assert ours.opset == theirs.opset == 11
    assert (ours.inputs, ours.outputs) == (theirs.inputs, theirs.outputs)
    assert [vars(n) for n in ours.nodes] == [vars(n) for n in theirs.nodes]
    assert list(ours.initializers) == list(theirs.initializers)
    for k, v in ours.initializers.items():
        assert v.dtype == theirs.initializers[k].dtype
        np.testing.assert_array_equal(v, theirs.initializers[k], err_msg=k)
    assert onnx_io.scan_conventions(ours) == jax_onnx_io.scan_conventions(theirs)
    (sd, report), (jsd, jreport) = (onnx_io.state_dict_from_onnx(ours),
                                    jax_onnx_io.state_dict_from_onnx(theirs))
    assert report == jreport and report["fused_graph"] == fuse_bn
    assert list(sd) == list(jsd)
    for k in sd:
        assert sd[k].dtype == jsd[k].dtype
        np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)


def test_unfused_export_recovers_the_port_state_dict():
    model = _model(0)
    sd, report = onnx_io.state_dict_from_onnx(
        onnx_io.read_onnx(onnx_io.onnx_from_torch_modules(model, fuse_bn=False)))
    assert not report["fused_graph"]
    want = model.state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(v, want[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(_logits(_load_recovered(sd)), _logits(model))


@pytest.mark.parametrize("eps", [1e-3, 1e-5])
def test_fused_export_logits_parity(eps):
    """The fused graph, de-fused at the encoder eps the loading model is
    built with: every synthesized BatchNorm is an identity at the eps of
    the port's module at that site."""
    model = _model(1)
    graph = onnx_io.read_onnx(onnx_io.onnx_from_torch_modules(model, fuse_bn=True))
    assert not any(n.op_type == "BatchNormalization" for n in graph.nodes)
    assert onnx_io.scan_conventions(graph)["fused"]
    sd, report = onnx_io.state_dict_from_onnx(graph, encoder_bn_eps=eps)
    assert report["fused_graph"]
    assert ("encoder.conv_stem", "encoder.bn1") in report["defused_pairs"]
    loaded = _load_recovered(sd, encoder_bn_eps=eps)
    modules = dict(loaded.named_modules())
    for _conv, bn in report["defused_pairs"]:
        assert modules[bn].eps == pytest.approx(onnx_io._eps_for_site(bn, eps)), bn
    got, want = _logits(loaded), _logits(model)
    assert np.abs(got - want).max() < 3e-3, np.abs(got - want).max()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def _real_export(model, path, fold):
    """The TorchScript exporter with the reference's flags; skips as
    tests/test_onnx_torch_export_oracle.py does when it cannot run."""
    try:
        import onnx  # noqa: F401
    except ImportError:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "onnx_stub"))
    kwargs = dict(opset_version=11, do_constant_folding=fold, input_names=["input"],
                  output_names=["output"],
                  dynamic_axes={"input": {0: "batch"}, "output": {0: "batch"}})
    try:
        try:
            torch.onnx.export(model, (torch.zeros(1, 4, 64, 64),), str(path), dynamo=False,
                              **kwargs)
        except TypeError:
            torch.onnx.export(model, (torch.zeros(1, 4, 64, 64),), str(path), **kwargs)
    except Exception as e:  # pragma: no cover - environment-dependent
        pytest.skip(f"torch ONNX exporter unavailable here: {type(e).__name__}: {e}")
    if not path.exists() or path.stat().st_size == 0:  # pragma: no cover
        pytest.skip("torch ONNX exporter produced no file")


@pytest.mark.parametrize("fold", [False, True])
def test_real_export_round_trip(tmp_path, fold):
    model = _model(3)
    path = tmp_path / f"real_fold{fold}.onnx"
    _real_export(model, path, fold)
    graph = onnx_io.read_onnx(path)
    sd, report = onnx_io.state_dict_from_onnx(graph, encoder_bn_eps=1e-3)
    assert report["fused_graph"] == onnx_io.scan_conventions(graph)["fused"]
    if not fold:
        want = model.state_dict()
        for k, v in sd.items():
            np.testing.assert_allclose(v, want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    got, want = _logits(_load_recovered(sd)), _logits(model)
    assert np.abs(got - want).max() < 3e-3, np.abs(got - want).max()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


# ---------------------------------------------------------------------------
# the model zoo
# ---------------------------------------------------------------------------

ZOO_ENCODER = {"unet": "resnet18", "unet++": "resnet18", "resunet": "resnet18",
               "resunet++": "timm-efficientnet-b0"}
ZOO_DEC_CH = (16, 16, 8, 8, 8)


def _zoo_model(arch, seed=None):
    """A float32 port model of the zoo; with ``seed``, the JAX tests'
    numpy weights (BatchNorm statistics randomized, small biases) filled
    into its tree, else uninitialized on the meta device."""
    kw = dict(in_channels=4, classes=3, decoder_channels=ZOO_DEC_CH, dtype=torch.float32)
    if seed is None:
        return create_model(arch, ZOO_ENCODER[arch], **kw).eval()
    with torch.device("meta"):
        model = create_model(arch, ZOO_ENCODER[arch], **kw)
    tree = fill_tree(tensor_variables_from_state_dict(model.state_dict()), seed)
    model.load_state_dict(state_dict_from_variables(tree), assign=True)
    return model.eval()


def _zoo_recovered(arch, sd):
    model = _zoo_model(arch)
    want = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == want, (sorted(want - set(sd))[:5], sorted(set(sd) - want)[:5])
    full = dict(model.state_dict())
    full.update({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    model.load_state_dict(full, strict=True)
    return model


def _close(got, want):
    err = np.abs(got - want).max()
    assert err < 3e-3 * max(1.0, np.abs(want).max()), err
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("fuse_bn", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch", list(ZOO_ENCODER))
def test_reader_recovers_the_zoo(arch, fuse_bn):
    model = _zoo_model(arch, seed=7)
    graph = onnx_io.read_onnx(onnx_io.onnx_from_torch_modules(model, fuse_bn=fuse_bn))
    sd, report = onnx_io.state_dict_from_onnx(graph)
    assert report["fused_graph"] == fuse_bn
    # the ResNet's fixed convention, the EfficientNet's default
    resnet = ZOO_ENCODER[arch] == "resnet18"
    assert report["encoder_bn_eps_used"] == (1e-5 if resnet else 1e-3)
    if not fuse_bn:
        want = model.state_dict()
        for k, v in sd.items():
            np.testing.assert_array_equal(v, want[k].numpy(), err_msg=k)
    else:
        stem = ("encoder.conv1", "encoder.bn1") if resnet else (
            "encoder.conv_stem", "encoder.bn1")
        block = "x_0_0" if arch == "unet++" else "0"
        assert stem in report["defused_pairs"]
        assert (f"decoder.blocks.{block}.conv1.0",
                f"decoder.blocks.{block}.conv1.1") in report["defused_pairs"]
    _close(_logits(_zoo_recovered(arch, sd)), _logits(model))


def test_real_export_of_resunetpp(tmp_path):
    model = _zoo_model("resunet++", seed=8)
    path = tmp_path / "resunetpp.onnx"
    _real_export(model, path, True)
    sd, report = onnx_io.state_dict_from_onnx(onnx_io.read_onnx(path))
    assert report["fused_graph"]
    assert ("decoder.blocks.4.attention0.decoder_conv.2",
            "decoder.blocks.4.attention0.attn_conv.0") in report["defused_pairs"]
    _close(_logits(_zoo_recovered("resunet++", sd)), _logits(model))
