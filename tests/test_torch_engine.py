"""The port's checkpoint files and inference engine against the JAX ones.

A b0 EfficientUnet++ checkpoint written by the JAX ``save_checkpoint``
loads in the port's ``load_model``; ``TorchInference`` on the CPU serves
the same class maps as ``JaxInference`` (both in bfloat16, as served:
mismatch < 2e-2, since bf16 rounds at other places in the two frameworks
and the JAX package's own fused-vs-plain bar is 1e-2); and a checkpoint
written by the port loads in the JAX ``load_checkpoint`` with equal arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from test_torch_models import numpy_variables

from deadtrees_tpu.core import load_checkpoint as jax_load_checkpoint
from deadtrees_tpu.core import save_checkpoint as jax_save_checkpoint
from deadtrees_tpu.infer import JaxInference
from deadtrees_tpu.infer.packing import pack2 as jax_pack2
from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu_torch.core import load_checkpoint, load_model, save_checkpoint
from deadtrees_tpu_torch.core.msgpack_codec import packb, unpackb
from deadtrees_tpu_torch.infer import TorchInference, pack2, unpack2
from deadtrees_tpu_torch.infer import engine as tengine
from deadtrees_tpu_torch.models import (
    create_model,
    init_model,
    state_dict_from_variables,
    variables_from_state_dict,
)
from deadtrees_tpu_torch.ops import fused_decoder as tfd

# the keys the JAX trainer writes (train/trainer.py)
HP = dict(
    architecture="efficientunet++",
    encoder_name="timm-efficientnet-b0",
    decoder_channels=[24, 16, 16, 8, 8],
    in_channels=4,
    classes=3,
    encoder_weights=None,
)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and torch's default of a thread per core then oversubscribes the
    machine (the TTA engine's eight bf16 views slow down many times over);
    these small models run as fast on two."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    jmodel = jax_create_model(**HP, dtype=jnp.float32)
    variables = numpy_variables(jmodel, 32, seed=11)
    path = tmp_path_factory.mktemp("ckpt") / "effunetpp_b0.ckpt"
    jax_save_checkpoint(
        path, params=variables["params"], batch_stats=variables["batch_stats"],
        hparams=HP, step=5, epoch=2,
    )
    return path, variables


def _tree_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, p
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(p))


def test_port_loads_jax_checkpoint(jax_ckpt):
    path, variables = jax_ckpt
    model, loaded, hp = load_model(path, device="cpu")
    assert hp == HP
    assert not model.training and next(model.parameters()).device.type == "cpu"
    assert model.dtype == torch.bfloat16  # the JAX default compute type
    _tree_equal(loaded["params"], variables["params"])
    _tree_equal(loaded["batch_stats"], variables["batch_stats"])
    want = state_dict_from_variables(variables)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    ckpt = load_checkpoint(path)
    assert int(ckpt["step"]) == 5 and int(ckpt["epoch"]) == 2


def test_engine_matches_jax_engine(jax_ckpt):
    path, _ = jax_ckpt
    img = np.random.default_rng(0).integers(0, 255, (1, 32, 32, 4), np.uint8)
    want = JaxInference(path, fused_decoder="auto").run(img)
    engine = TorchInference(path, device="cpu", fused_decoder="auto")
    assert engine.uses_fused(1) and engine.folded is not None
    got = engine.run(img)
    assert got.shape == want.shape == (1, 32, 32) and got.dtype == np.uint8
    mismatch = (got != want).mean()
    assert mismatch < 2e-2, f"class-map mismatch {mismatch}"
    plain = TorchInference(path, device="cpu").run(img)
    assert (plain != want).mean() < 2e-2


def test_big_batch_takes_the_plain_route(jax_ckpt, monkeypatch):
    """More than 32 images run the plain model, 32 or fewer the fused
    decoder (the JAX engine's rule). The model is stubbed: the plain
    route's numbers are checked against JAX above."""
    path, _ = jax_ckpt
    engine = TorchInference(path, device="cpu", fused_decoder="auto")
    fused, plain = [], []

    def fused_spy(model, folded, img, **kwargs):
        fused.append(img.shape[0])
        return torch.zeros((img.shape[0], 3) + img.shape[2:])

    def plain_stub(img):
        plain.append(img.shape[0])
        logits = torch.zeros((img.shape[0], 3) + img.shape[2:])
        logits[:, 2] = 1.0
        return logits

    monkeypatch.setattr(tfd, "fused_forward", fused_spy)
    monkeypatch.setattr(engine, "model", plain_stub)
    big = np.random.default_rng(1).integers(0, 255, (33, 32, 32, 4), np.uint8)
    assert not engine.uses_fused(33) and engine.uses_fused(32)
    np.testing.assert_array_equal(engine.run(big), np.full((33, 32, 32), 2, np.uint8))
    assert (fused, plain) == ([], [33])
    np.testing.assert_array_equal(engine.run(big[:32]), np.zeros((32, 32, 32), np.uint8))
    assert (fused, plain) == ([32], [33])


def test_port_checkpoint_loads_in_jax(tmp_path):
    hp = dict(HP, decoder_channels=[16, 8, 8, 8, 8])
    model = init_model(create_model(**hp), generator=torch.Generator().manual_seed(3))
    variables = variables_from_state_dict(model.state_dict())
    path = tmp_path / "port.ckpt"
    save_checkpoint(path, **variables, hparams=hp, opt_state=b"\x00opaque\xff",
                    step=7, epoch=1, extra={"note": "port"})
    ckpt = jax_load_checkpoint(path)
    assert ckpt["hparams"] == hp and ckpt["extra"] == {"note": "port"}
    assert int(ckpt["step"]) == 7 and int(ckpt["epoch"]) == 1
    assert ckpt["opt_state"] == b"\x00opaque\xff"
    _tree_equal(ckpt["params"], variables["params"])
    _tree_equal(ckpt["batch_stats"], variables["batch_stats"])
    # and back: the port reads its own file to the same model
    again = load_model(path, device="cpu")[0].state_dict()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0, msg=k)


def test_codec_writes_the_bytes_flax_writes():
    rng = np.random.default_rng(4)
    payload = {
        "hparams": b'{"a": 1}', "step": np.int64(3), "epoch": np.int64(-1),
        "params": {"b": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32)},
                   "a": {"bias": np.arange(5, dtype=np.float32)}},
        "batch_stats": {}, "opt_state": bytes(range(256)) * 3,
        "misc": [1, -7, 300, -40000, 2**40, 1.5, "text", None, True, False],
    }
    ours = packb(payload)
    assert ours == serialization.msgpack_serialize(payload)
    back = unpackb(ours)
    _tree_equal(back["params"], payload["params"])
    assert back["misc"] == payload["misc"] and back["opt_state"] == payload["opt_state"]
    assert int(back["step"]) == 3 and int(back["epoch"]) == -1


def test_corrupted_checkpoint_raises(jax_ckpt, tmp_path):
    path, _ = jax_ckpt
    bad = tmp_path / "bad.ckpt"
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    bad.write_bytes(bytes(data))
    (tmp_path / "bad.ckpt.dtpu").write_text(
        path.with_name(path.name + ".dtpu").read_text()
    )
    with pytest.raises(ValueError, match="corrupted"):
        load_checkpoint(bad)
    garbage = tmp_path / "garbage.ckpt"
    garbage.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="checkpoint"):
        load_checkpoint(garbage)


def test_no_device_means_cuda(jax_ckpt, monkeypatch):
    path, _ = jax_ckpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchInference(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchInference(path, device="cuda")
    assert TorchInference(path, device="cpu").device.type == "cpu"


def test_unsupported_knobs_raise(jax_ckpt, tmp_path):
    """The JAX engine's refusals, as ValueError; a fused route asked of a
    checkpoint that is not efficientunet++ raises ValueError naming it."""
    path, _ = jax_ckpt
    for kwargs, match in (
        (dict(fused_decoder="fast"), "fused_decoder"),
        (dict(quantized="w4"), "quantized"),
        (dict(quantized="w8a8", fused_decoder="nhwc"), "w8a8"),
        (dict(quantized="w8a8", fused_decoder="auto"), "w8a8"),
        (dict(quantized="w8a8", quant_sites=("y", "q")), "quant_sites"),
        (dict(tta=5), "tta"),
        (dict(tta=4, fused_decoder="auto"), "standard predict path"),
        (dict(tta=True, quantized="w8a8"), "standard predict path"),
    ):
        with pytest.raises(ValueError, match=match):
            TorchInference(path, device="cpu", **kwargs)
    unet = tmp_path / "unet.ckpt"
    hp = dict(architecture="unet", encoder_name="resnet18", in_channels=4, classes=3,
              decoder_channels=[16, 16, 8, 8, 8])
    save_checkpoint(unet, **variables_from_state_dict(create_model(**hp).state_dict()),
                    hparams=hp)
    with pytest.raises(ValueError, match="unet on resnet18"):
        TorchInference(unet, device="cpu", fused_decoder="auto")


@pytest.fixture(scope="module")
def engine_img():
    return np.random.default_rng(0).integers(0, 255, (2, 32, 32, 4), np.uint8)


def _mismatch(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    return float((got != want).mean())


@pytest.mark.parametrize("options", [
    dict(fused_decoder="nhwc"), dict(quantized="w8"), dict(quantized=True),
], ids=["nhwc", "w8", "w8-true"])
def test_engine_options_match_jax_engine(jax_ckpt, engine_img, options):
    """Each engine option against the same ``JaxInference`` option, both in
    bfloat16 as served: mismatch < 2e-2 (the bar of
    test_engine_matches_jax_engine)."""
    path, _ = jax_ckpt
    want = JaxInference(path, **options).run(engine_img)
    engine = TorchInference(path, device="cpu", **options)
    assert _mismatch(engine.run(engine_img), want) < 2e-2
    if "fused_decoder" in options:
        assert engine.layout == "nhwc" and engine.uses_fused(33)


@pytest.mark.parametrize("tta", [4, 8, True])
def test_engine_tta_matches_jax_engine(jax_ckpt, engine_img, tta):
    """``tta`` against the JAX engine's TTA program: its normalize, its
    ``make_tta_fn`` and its model in bfloat16, with the model's forward
    jitted once for all views (the engine jits the whole unrolled program;
    the arithmetic is the same). Mismatch < 2e-2."""
    from deadtrees_tpu.core import load_model as jax_load_model
    from deadtrees_tpu.data.augment import normalize as jax_normalize
    from deadtrees_tpu.infer import tta as jtta

    path, _ = jax_ckpt
    jmodel, jvars, _ = jax_load_model(path)
    forward = jax.jit(lambda x: jmodel.apply(jvars, x, train=False))
    engine = TorchInference(path, device="cpu", tta=tta)
    views = 8 if tta is True else tta
    assert engine.tta_views == views and engine.folded is None
    img = jax_normalize(jnp.asarray(engine_img, jnp.float32), engine.mean, engine.std)
    want = np.asarray(jnp.argmax(jtta.make_tta_fn(forward, views)(img), -1)).astype(np.uint8)
    assert _mismatch(engine.run(engine_img), want) < 2e-2


def test_engine_w8a8_matches_jax_engine(jax_ckpt, engine_img):
    """w8a8 calibrates on the first batch and reuses its scales; its class
    maps agree with the JAX w8a8 engine's (< 2e-2) and, like JAX's, with
    the unquantized engine above JAX's own bar (> 0.95)."""
    path, _ = jax_ckpt
    want = JaxInference(path, quantized="w8a8").run(engine_img)
    engine = TorchInference(path, device="cpu", quantized="w8a8", quant_sites=("y", "h", "s"))
    assert engine._scales is None and engine.folded is not None
    got = engine.run(engine_img)
    scales = engine._scales
    assert scales is not None and len(scales) == 66
    np.testing.assert_array_equal(engine.run(engine_img), got)
    assert engine._scales is scales
    plain = TorchInference(path, device="cpu").run(engine_img)
    assert (got == plain).mean() > 0.95
    default = TorchInference(path, device="cpu", quantized="w8a8")
    assert default.quant_sites == frozenset({"y"})
    assert _mismatch(default.run(engine_img), want) < 2e-2


def test_w8_engine_serves_round_tripped_weights(jax_ckpt):
    """w8 loads each large kernel as its int8 round trip rounded to
    bfloat16; small leaves and BatchNorms stay as they were."""
    path, variables = jax_ckpt
    engine = TorchInference(path, device="cpu", quantized="w8")
    plain = TorchInference(path, device="cpu")
    w8, sd = engine.model.state_dict(), plain.model.state_dict()
    changed = [k for k in sd if not torch.equal(w8[k], sd[k])]
    assert changed and all(k.endswith("weight") for k in changed)
    for k in changed:
        assert torch.equal(w8[k].to(torch.bfloat16).float(), w8[k]), k
        assert w8[k].numel() >= 1024, k


def test_tta_engine_is_equivariant(jax_ckpt, engine_img):
    """tta=8 averages over the dihedral group: a rot90'd or flipped tile
    gives the rot90'd or flipped class map, up to near-ties of the bf16
    logits (< 1e-2 of pixels)."""
    path, _ = jax_ckpt
    engine = TorchInference(path, device="cpu", tta=8)
    base = engine.run(engine_img)
    for k, flip in ((1, False), (2, False), (3, True)):
        view = np.rot90(engine_img, k, axes=(1, 2))
        want = np.rot90(base, k, axes=(1, 2))
        if flip:
            view, want = view[:, :, ::-1], want[:, :, ::-1]
        assert _mismatch(engine.run(np.ascontiguousarray(view)), np.ascontiguousarray(want)) < 1e-2


def test_rgb_checkpoint_drops_nir(tmp_path):
    hp = dict(HP, in_channels=3, decoder_channels=[16, 8, 8, 8, 8])
    model = init_model(create_model(**hp), generator=torch.Generator().manual_seed(5))
    path = tmp_path / "rgb.ckpt"
    save_checkpoint(path, **variables_from_state_dict(model.state_dict()), hparams=hp)
    engine = TorchInference(path, device="cpu")
    assert engine.in_channels == 3 and len(engine.mean) == 3
    rgbn = np.random.default_rng(6).integers(0, 255, (1, 32, 32, 4), np.uint8)
    np.testing.assert_array_equal(engine.run(rgbn), engine.run(rgbn[..., :3]))
    # without hparams the count comes from the stem conv (flax HWIO)
    params = {"encoder": {"Conv_0": {"kernel": np.zeros((3, 3, 3, 48))}}}
    assert tengine._sniff_in_channels(params, {}) == 3


def test_pack2_matches_jax():
    cls = np.random.default_rng(7).integers(0, 3, (2, 5, 13), np.uint8)
    want = np.asarray(jax_pack2(jnp.asarray(cls)))
    np.testing.assert_array_equal(pack2(cls), want)
    np.testing.assert_array_equal(pack2(torch.from_numpy(cls)).numpy(), want)
    np.testing.assert_array_equal(unpack2(want, 13), cls)
    np.testing.assert_array_equal(unpack2(torch.from_numpy(want), 13), cls)
