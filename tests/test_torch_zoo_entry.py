"""The model zoo through the port's entry points, on the CPU.

- checkpoints cross both ways: a unet/resnet18 file of the JAX
  ``save_checkpoint`` loads through the port's ``load_model``, a file the
  port writes loads in the JAX ``load_model``, tree for tree;
- ``TorchInference`` serves a Unet plain, w8 and with TTA; the fused
  routes and w8a8 raise ``ValueError`` naming the architecture;
- the service picks its route from the checkpoint's architecture (plain
  for unet, ``"auto"`` for efficientunet++), building one engine;
- ``EnsembleInference`` of a unet/resnet18, an efficientunet++/b0 and a
  second unet agrees with the JAX ensemble on the same tiles (bfloat16,
  class-map mismatch < 2e-2 as in tests/test_torch_ensemble.py);
- ``Trainer`` takes a CPU step of ``experiment=quick_unet_debug`` and of
  ``model=segformer`` on 64² tiles, and every point of the architecture
  grid builds from its composed config;
- ``init_model`` draws every module family's kernels with the standard
  deviation of the JAX modules' initializers (he normal in the ResNets,
  the conv-BN-ReLU pairs and the ASPPs, lecun normal elsewhere).
"""

import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deadtrees_tpu.core import load_model as jax_load_model
from deadtrees_tpu.core import save_checkpoint as jax_save_checkpoint
from deadtrees_tpu.infer import EnsembleInference as JaxEnsemble
from deadtrees_tpu_torch.config import compose
from deadtrees_tpu_torch.core import load_model, save_checkpoint
from deadtrees_tpu_torch.data import normalize
from deadtrees_tpu_torch.data.config import DATASET_CONFIG
from deadtrees_tpu_torch.data.shardwriter import ShardWriter
from deadtrees_tpu_torch.infer import EnsembleInference, TorchInference
from deadtrees_tpu_torch.models import (
    canonical_architecture,
    create_model,
    init_model,
    tensor_variables_from_state_dict,
    variables_from_state_dict,
)
from deadtrees_tpu_torch.serve import server
from deadtrees_tpu_torch.train import Trainer
from tests.test_torch_models import _paths, fill_tree

REPO = Path(__file__).resolve().parents[1]
DEC_CH = [16, 16, 8, 8, 8]
SIZE = 64


def _hp(arch, encoder):
    return dict(architecture=arch, encoder_name=encoder, decoder_channels=DEC_CH,
                in_channels=4, classes=3, encoder_weights=None)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_variables(hp, seed):
    """The JAX model's variables filled as ``numpy_variables`` fills them,
    on the port's tree (held to the JAX tree in tests/test_torch_zoo.py)."""
    with torch.device("meta"):
        model = create_model(**hp)
    return fill_tree(tensor_variables_from_state_dict(model.state_dict()), seed)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """JAX-written checkpoints: two unet/resnet18 and an efficientunet++/b0."""
    root = tmp_path_factory.mktemp("zoo")
    out = {}
    for name, hp, seed in (("unet", _hp("unet", "resnet18"), 1),
                           ("unet_b", _hp("unet", "resnet18"), 2),
                           ("effunetpp", _hp("efficientunet++", "timm-efficientnet-b0"), 3)):
        variables = _jax_variables(hp, seed)
        out[name] = root / f"{name}.ckpt"
        jax_save_checkpoint(out[name], params=variables["params"],
                            batch_stats=variables["batch_stats"], hparams=hp)
    return out


def _same_tree(a, b):
    for coll in ("params", "batch_stats"):
        assert _paths(a[coll]) == _paths(b[coll]), coll
        for (p, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(a[coll]),
                                  jax.tree_util.tree_leaves_with_path(b[coll])):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=jax.tree_util.keystr(p))


def test_checkpoints_cross_both_ways(ckpts, tmp_path):
    model, variables, hp = load_model(ckpts["unet"], device="cpu")
    assert model.architecture == "unet" and model.encoder_name == "resnet18"
    _same_tree(variables_from_state_dict(model.state_dict()), variables)
    path = tmp_path / "port.ckpt"
    save_checkpoint(path, **variables_from_state_dict(model.state_dict()), hparams=hp)
    jmodel, jvariables, jhp = jax_load_model(path)
    assert jhp == hp and jmodel.architecture == "unet"
    _same_tree(jvariables, variables)


def _img(bs, seed):
    return np.random.default_rng(seed).integers(0, 256, (bs, SIZE, SIZE, 4), np.uint8)


def _model_argmax(model, img):
    x = normalize(torch.from_numpy(img).float(), DATASET_CONFIG.mean, DATASET_CONFIG.std)
    with torch.no_grad():
        return model(x.permute(0, 3, 1, 2).contiguous()).argmax(1).numpy()


def test_engine_serves_a_unet_and_refuses_the_fused_routes(ckpts):
    img = _img(2, 0)
    plain = TorchInference(ckpts["unet"], device="cpu")
    got = plain.run(img)
    assert got.shape == (2, SIZE, SIZE) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _model_argmax(plain.model, img))
    w8 = TorchInference(ckpts["unet"], device="cpu", quantized=True)
    assert (w8.run(img) == got).mean() > 0.9
    tta = TorchInference(ckpts["unet"], device="cpu", tta=4)
    assert tta.tta_views == 4 and tta.run(img).shape == (2, SIZE, SIZE)
    for kw in ({"fused_decoder": "chw"}, {"fused_decoder": "nhwc"},
               {"fused_decoder": "auto"}, {"quantized": "w8a8"}):
        with pytest.raises(ValueError, match="unet on resnet18"):
            TorchInference(ckpts["unet"], device="cpu", **kw)


@pytest.mark.parametrize("name,route", [("unet", "plain"), ("effunetpp", "auto")])
def test_service_route_follows_the_architecture(ckpts, monkeypatch, name, route):
    built = []

    class Recorder(TorchInference):
        def __init__(self, *args, **kwargs):
            built.append(kwargs)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr("deadtrees_tpu_torch.infer.TorchInference", Recorder)
    service = server.SegmentationService(checkpoint=ckpts[name], device="cpu")
    assert service.route == route == server.serving_route(ckpts[name])
    assert len(built) == 1
    assert service.engines["torch"].fused_decoder == (route == "auto" and "auto")
    assert server.serving_route(ckpts[name], tta=4) == "plain"


def test_mixed_ensemble_matches_jax(ckpts):
    members = [ckpts["unet"], ckpts["effunetpp"], ckpts["unet_b"]]
    img = _img(2, 5)
    ens = EnsembleInference(members, device="cpu")
    assert not ens.homogeneous
    assert [m.model.architecture for m in ens._members] == [
        "unet", "efficientunetplusplus", "unet"]
    got = ens.run(img)
    want = JaxEnsemble(members).run(img)
    assert got.shape == want.shape == (2, SIZE, SIZE)
    assert (got != want).mean() < 2e-2


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _tiff(arr, mode):
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="TIFF")
    return buf.getvalue()


def _write_shard(pattern, n, seed):
    rng = np.random.default_rng(seed)
    with ShardWriter(pattern, maxcount=n) as w:
        for i in range(n):
            mask = np.zeros((SIZE, SIZE), np.uint8)
            mask[8:40, 12:52] = 1 + i % 2
            w.write({
                "__key__": f"tile_{seed}_{i:04d}",
                "rgbn.tif": _tiff(rng.integers(0, 256, (SIZE, SIZE, 4), dtype=np.uint8), "RGBA"),
                "mask.tif": _tiff(mask, "L"),
                "lu.tif": _tiff(rng.integers(0, 2, (SIZE, SIZE), dtype=np.uint8), "L"),
                "txt": f"{float(mask.astype(bool).mean() * 100):.2f}",
            })


@pytest.mark.parametrize("override,arch,encoder", [
    ("experiment=quick_unet_debug", "unet", "resnet18"),
    ("model=segformer", "segformer", "mit-b0"),
], ids=["quick_unet_debug", "segformer"])
def test_trainer_steps_the_quick_unet_experiment(tmp_path, override, arch, encoder):
    """A CPU step of the repo's configs for the zoo, with the MultiStage
    freeze of the default callbacks (SegFormer has no encoder to freeze)."""
    data = tmp_path / "data"
    for split, seed in (("train", 0), ("val", 1), ("test", 2)):
        (data / split).mkdir(parents=True)
        _write_shard(str(data / split / "train-combo-%06d.tar"), 2, seed)
    cfg = compose(REPO / "configs", "config", overrides=[
        override, f"data_dir={data}", "trainer.precision=f32",
        "datamodule.batch_size=2", "datamodule.num_workers=1", "trainer.max_epochs=1",
        "trainer.limit_train_batches=1", "trainer.limit_val_batches=1",
        f"logger.save_dir={tmp_path}/metrics",
    ])
    cfg["callbacks"]["log_confusion_matrix"] = False
    cfg["callbacks"]["log_image_predictions"] = False
    trainer = Trainer(cfg, tmp_path / "run", device="cpu")
    result = trainer.fit()
    assert trainer.model.architecture == arch and trainer.model.encoder_name == encoder
    if arch == "unet":
        assert trainer.model.decoder_channels == (256, 128, 64, 32, 16)
    assert trainer.state.step == 1 and 0 <= result["val/dice"] <= 1
    model, _, hp = load_model(result["best_ckpt"], device="cpu")
    assert hp["architecture"] == arch and model.architecture == arch


def test_every_point_of_the_architecture_grid_builds():
    """The reference's sweep (configs/hparams_search/architecture_grid.yaml):
    every architecture × encoder point composes and builds as the Trainer
    builds it (on the meta device)."""
    grid = compose(REPO / "configs", "config", overrides=["hparams_search=architecture_grid"])
    params = grid["hparams_search"]["parameters"]
    archs = params["model.network.architecture"]["values"]
    encoders = params["model.network.encoder_name"]["values"]
    assert len(archs) * len(encoders) == 10
    for arch in archs:
        for encoder in encoders:
            cfg = compose(REPO / "configs", "config", overrides=[
                f"model.network.architecture={arch}", f"model.network.encoder_name={encoder}"])
            net = cfg["model"]["network"]
            with torch.device("meta"):
                model = create_model(net["architecture"], net["encoder_name"],
                                     decoder_channels=net["decoder_channels"],
                                     in_channels=net["in_channels"],
                                     classes=len(net["classes"]))
            assert (model.architecture, model.encoder_name) == (
                canonical_architecture(arch), encoder)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _normalized_std(kernels):
    """The std of every kernel scaled by sqrt(fan_in), pooled."""
    return float(np.concatenate([np.ravel(k) * np.sqrt(fan_in) for k, fan_in in kernels]).std())


def _init_families():
    """(name, JAX module, its init arguments, the port's module, variance ·
    fan_in) of every module family with its own initializer."""
    from deadtrees_tpu.models import blocks as jb
    from deadtrees_tpu.models import encoders as je
    from deadtrees_tpu.models import segformer as jsf
    from deadtrees_tpu_torch.models import blocks as tb
    from deadtrees_tpu_torch.models import encoders as te
    from deadtrees_tpu_torch.models import segformer as tsf

    x = (jnp.zeros((1, 16, 16, 32)),)
    return [
        ("resnet", je.ResNetEncoder(stage_sizes=(2, 2, 2, 2)), (jnp.zeros((1, 32, 32, 4)),),
         te.ResNetEncoder((2, 2, 2, 2), in_channels=4), 2.0),
        ("bottleneck", je.Bottleneck(16, strides=2), x, te.Bottleneck(32, 16, 2), 2.0),
        ("conv_bn_act", jb.ConvBnAct(48), x, tb.ConvBnAct(32, 48), 2.0),
        ("aspp", jb.ASPP(24), x, tb.ASPP(32, 24), 2.0),
        ("rupp_gate", jb.RUPPAttentionBlock(32), x + (None,),
         tb.RUPPAttentionBlock(32, 0, 32), 1.0),
        ("scse", jb.SCSEModule(), x, tb.SCSEModule(32), 1.0),
        ("head", jb.SegmentationHead(3), x, tb.SegmentationHead(32, 3), 1.0),
        ("mit_block", jsf.MiTBlock(64, 2, 2, 4), (jnp.zeros((1, 64, 64)), 8, 8),
         tsf.MiTBlock(64, 2, 2, 4), 1.0),
    ]


FAMILIES = ["resnet", "bottleneck", "conv_bn_act", "aspp", "rupp_gate", "scse", "head",
            "mit_block"]


@pytest.mark.parametrize("family", range(len(FAMILIES)), ids=FAMILIES)
def test_init_model_follows_the_jax_initializers(family):
    """Each module family's kernels, normalized by sqrt(fan_in), have the
    standard deviation of the JAX module's initializers within 10 %: he
    normal (sqrt 2) in the ResNets, the conv-BN-ReLU pair and the ASPP,
    lecun normal (1) elsewhere."""
    name, jmodule, args, tmodule, variance = _init_families()[family]
    params = jax.jit(lambda key: jmodule.init(key, *args))(jax.random.PRNGKey(0))["params"]
    want = _normalized_std(
        (np.asarray(leaf), np.prod(leaf.shape[:-1]))
        for p, leaf in jax.tree_util.tree_leaves_with_path(params) if p[-1].key == "kernel"
    )
    init_model(tmodule, generator=torch.Generator().manual_seed(0))
    got = _normalized_std(
        (m.weight.detach().numpy(), m.weight[0].numel())
        for m in tmodule.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
    )
    assert abs(got / want - 1) < 0.1, (name, got, want)
    assert abs(want / np.sqrt(variance) - 1) < 0.1, (name, want)


# ---------------------------------------------------------------------------
# the Adam state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,encoder", [("unet", "resnet18"), ("segformer", "mit-b0")])
def test_adam_state_crosses_to_flax_for_the_zoo(arch, encoder):
    """The optimizer state of a zoo model in flax's bytes: it loads into
    optax's state of the JAX model's tree leaf for leaf, and back."""
    from flax import serialization

    from deadtrees_tpu.train import OptimizerConfig as JaxOptimizerConfig
    from deadtrees_tpu.train import make_optimizer as jax_make_optimizer
    from deadtrees_tpu_torch.train import Optimizer, OptimizerConfig
    from deadtrees_tpu_torch.train.optim import optimizer_from_bytes, optimizer_to_bytes

    cfg = dict(learning_rate=1e-3, cosineannealing_tmax=3, gradient_clip_val=0.5,
               steps_per_epoch=2)
    model = create_model(**_hp(arch, encoder), dtype=torch.float32)
    opt = Optimizer(list(model.parameters()), OptimizerConfig(**cfg))
    gen = torch.Generator().manual_seed(9)
    for buf in opt.mu + opt.nu:
        buf.copy_(torch.rand(buf.shape, generator=gen))
    opt.count.fill_(3)
    params = variables_from_state_dict(model.state_dict())["params"]
    template = jax.jit(jax_make_optimizer(JaxOptimizerConfig(**cfg)).init)(params)
    restored = serialization.from_bytes(template, optimizer_to_bytes(opt, model))
    names = [n for n, _ in model.named_parameters()]
    for ours, tree in ((opt.mu, restored[1].mu), (opt.nu, restored[1].nu)):
        mine = variables_from_state_dict(dict(zip(names, ours)))["params"]
        _same_tree({"params": mine, "batch_stats": {}}, {"params": tree, "batch_stats": {}})
    assert int(restored[1].count) == 3
    fresh = Optimizer(list(model.parameters()), OptimizerConfig(**cfg))
    optimizer_from_bytes(fresh, model, serialization.to_bytes(restored))
    for a, b in zip(fresh.mu + fresh.nu, opt.mu + opt.nu):
        assert torch.equal(a, b)
