"""The U-Net family on MiT encoders (``models/mit.py``) against the
benchmark's plain reference (``port_bench/reference``, smp's layout) on
seeded random weights (``port_bench.harness.weights.make``), on the CPU:
the logits in float32, one training step's loss and gradients in
float64, the state dict, the empty stride-2 level; the reference's
parameter count, FLOP count and fp8 control; the attention's counter."""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import pytest
import torch

from deadtrees_tpu_torch.core import trace
from deadtrees_tpu_torch.losses.functional import class2one_hot
from deadtrees_tpu_torch.models import create_model, get_encoder
from deadtrees_tpu_torch.models.mit import MIT_ENCODERS
from deadtrees_tpu_torch.train.loss import build_loss
from port_bench.harness import flops, weights
from port_bench.reference import batch as ref_batch
from port_bench.reference import model as ref_model
from port_bench.reference import step as ref_step
from port_bench.reference.core import Net, Numerics
from port_bench.reference.encoders import mit as ref_mit

REPO = Path(__file__).resolve().parents[1]
MIT_B5 = json.loads((REPO / "port_bench" / "configs" / "unet-mit-b5.json").read_text())
DECODER = [32, 16, 16, 8, 8]
# float32 on the CPU, the same operations in another grouping: the
# logits within 1e-4 of max(1, max|ref|)
BAR = 1e-4
ARCHS = {"unet": "unet", "unet++": "unetplusplus"}


def config(encoder: str, architecture: str) -> dict:
    c = json.loads(json.dumps(MIT_B5))
    dims, depths = MIT_ENCODERS[encoder]
    c["encoder"].update(name=encoder, embed_dims=list(dims), depths=list(depths))
    c.update(architecture=ARCHS[architecture], decoder_channels=DECODER)
    return c


def models(encoder: str, architecture: str, seed: int = 3):
    c = config(encoder, architecture)
    params = weights.make(c, seed, "cpu")
    model = create_model(architecture, encoder, in_channels=4, classes=3,
                         decoder_channels=DECODER, dtype=torch.float32)
    model.load_state_dict(params, strict=True)
    return c, params, model


def _x(batch: int = 2, size: int = 64) -> torch.Tensor:
    return torch.randn(batch, 4, size, size, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("architecture", list(ARCHS))
@pytest.mark.parametrize("encoder", ["mit_b0", "mit_b1"])
def test_logits_match_the_reference(encoder, architecture, train):
    c, params, model = models(encoder, architecture)
    x = _x()
    with torch.no_grad():
        got = model.train(train)(x)
        want = ref_model.forward(dict(params), x, c, train=train)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 64, 64)
    assert float((got - want).abs().max()) < BAR * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("architecture", list(ARCHS))
def test_one_step_s_loss_and_every_gradient_match_the_reference(architecture):
    """In float64: at this size the U-Net++ cells' train-mode BatchNorms
    over a few values amplify float32's last digits to 1-2 % in the
    encoder's gradients. In float64 the two agree within 1e-6 of the
    leaf's norm (both losses weigh GDICE's classes in float32). On one
    thread: float64 convolutions on the CPU's threads, beside other test
    workers, ran 300 × slower (562 s against 2 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _one_step_matches(architecture)
    finally:
        torch.set_num_threads(threads)


def _one_step_matches(architecture):
    c, params, model = models("mit_b0", architecture)
    model.double()
    params = {k: v.double() if v.is_floating_point() else v for k, v in params.items()}
    names = [l.name for l in ref_model.leaves(c) if l.is_param]
    x = _x().double()
    mask = torch.randint(0, 3, (2, 64, 64), generator=torch.Generator().manual_seed(1))
    dist = ref_batch.distmaps(mask.numpy(), 3).double()
    want_parts, want = ref_step.grads(params, names, x, mask, dist, c, c["recipe"]["losses"],
                                      Numerics())
    logits = model.train()(x)
    loss = build_loss(c["recipe"]["losses"], 3)
    total, _ = loss(torch.softmax(logits, 1), class2one_hot(mask, 3).double(), distmap=dist)
    total.backward()
    assert abs(float(total) - want_parts["total_loss"]) < 1e-6 * abs(want_parts["total_loss"])
    got = dict(model.named_parameters())
    assert set(got) == set(names)
    norms = {n: float(g.norm()) for n, g in zip(names, want)}
    median = statistics.median(norms.values())
    for n, g in zip(names, want):
        gap = float((got[n].grad - g).norm()) / max(norms[n], median)
        assert gap < 1e-5, (n, gap)


def test_the_reference_s_leaves_load_strictly_and_the_stride_2_level_is_empty():
    c, params, model = models("mit_b0", "unet")
    assert list(model.state_dict()) and set(model.state_dict()) == set(params)
    encoder, channels = get_encoder("mit_b0", in_channels=4)
    assert channels == (4, 0, 32, 64, 160, 256)
    assert tuple(ref_mit.out_channels(c["encoder"], 4)) == channels
    feats = encoder(_x(2, 64))
    assert [tuple(f.shape) for f in feats] == [
        (2, 4, 64, 64), (2, 0, 32, 32), (2, 32, 16, 16), (2, 64, 8, 8), (2, 160, 4, 4),
        (2, 256, 2, 2)]
    names = set(model.state_dict())
    assert {"encoder.patch_embed1.proj.weight", "encoder.block1.0.attn.kv.weight",
            "encoder.block1.0.attn.sr.weight", "encoder.block1.0.attn.norm.weight",
            "encoder.block1.0.mlp.dwconv.dwconv.weight", "encoder.norm4.weight"} <= names
    assert "encoder.block4.0.attn.sr.weight" not in names  # ratio 1: no reduction
    assert "decoder.blocks.3.attention1.attention.weight" not in names
    with pytest.raises(TypeError):
        get_encoder("mit_b0", in_channels=4, bn_eps=1e-5)
    with pytest.raises(ValueError, match="mit_b5"):
        get_encoder("mit_b6")


def test_the_b5_configuration_s_parameter_count_on_the_meta_device():
    with torch.device("meta"):
        model = create_model("unet", "mit_b5", in_channels=4, classes=3)
    n = sum(p.numel() for p in model.parameters())
    assert n == MIT_B5["parameters"] == ref_model.n_params(MIT_B5)
    shapes = {l.name: l.shape for l in ref_model.leaves(MIT_B5)}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    assert [len(model.encoder.get_submodule(f"block{s}")) for s in (1, 2, 3, 4)] == [3, 6, 40, 3]


def test_the_flop_count_holds_4nmc_for_each_attention():
    c = config("mit_b0", "unet")
    c["encoder"]["depths"] = [1, 1, 1, 1]
    params = {l.name: torch.empty(l.shape, device="meta") for l in ref_model.leaves(c)}
    x = torch.empty((1, 4, 64, 64), device="meta")
    with flops.Counter() as counter:
        ref_model.forward(params, x, c, train=True)
    # (N, M, C) of the four attentions at 64²: 16², 8², 4², 2² queries
    want = [(256, 4, 32), (64, 4, 64), (16, 4, 160), (4, 4, 256)]
    products = [2 * n * m * ch for n, m, ch in want]
    for p in products:  # QKᵀ and PV, 2·N·M·C each
        assert counter.ops.count(p) >= 2, (p, counter.ops)


def test_fp8_moves_a_linear_s_output():
    g = torch.Generator().manual_seed(4)
    p = {"l.weight": torch.randn(16, 32, generator=g), "l.bias": torch.zeros(16)}
    x = torch.randn(8, 32, generator=g)
    exact = ref_mit._linear_fw(Net(p, train=True), x, "l")
    fp8 = ref_mit._linear_fw(Net(p, train=True, numerics=Numerics("fp8")), x, "l")
    torch.testing.assert_close(exact, x @ p["l.weight"].T)
    assert 1e-3 < float((fp8 - exact).abs().max() / exact.abs().max()) < 0.2


def test_attention_on_the_cpu_takes_the_plain_path_and_counts_it():
    model = create_model("unet", "mit_b0", in_channels=4, classes=3, decoder_channels=DECODER)
    trace.reset()
    trace.enable()
    try:
        with torch.no_grad():
            model.train()(_x(1, 64))
        got = trace.snapshot()["counters"]["model.attention_fused"]
    finally:
        trace.disable()
        trace.reset()
    assert got == (0.0, 8)  # 8 blocks of mit_b0, none fused on the CPU


@pytest.mark.parametrize("architecture,attention", [("unet", None), ("unet++", "scse"),
                                                    ("resunet++", "scse")])
def test_checkpoint_variables_round_trip(architecture, attention):
    """A MiT U-Net's state through the checkpoint's tree and back; the
    tree is the port's own (the JAX package has no such model)."""
    from deadtrees_tpu_torch.models import state_dict_from_variables, variables_from_state_dict

    model = create_model(architecture, "mit_b0", in_channels=4, classes=3,
                         decoder_channels=DECODER, decoder_attention_type=attention)
    sd = model.state_dict()
    variables = variables_from_state_dict(sd)
    assert "kv" in variables["params"]["encoder"]["block1_0"]["attn"]
    back = state_dict_from_variables(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k].to(v.dtype), v), k


def test_the_trainer_fits_a_mit_unet_and_reloads_its_checkpoint(tmp_path):
    import shutil

    from deadtrees_tpu_torch.config import compose
    from deadtrees_tpu_torch.core import load_model
    from deadtrees_tpu_torch.train import Trainer
    from port_bench.harness import traffic as gen

    data = tmp_path / "data"
    gen.write_train_shards(data, 7, {"tile": 64, "bands": 4, "classes": 3, "shards": 1,
                                     "shard_size": 4, "rectangles": 2, "lu_share": 0.7})
    for split in ("val", "test"):
        shutil.copy(next((data / "train").glob("*.tar")), data / split)
    cfg = compose(REPO / "configs", "config", overrides=[
        "experiment=flagship_b5_multistage", "model.network.architecture=unet",
        "model.network.encoder_name=mit_b0", "model.network.decoder_channels=[32,16,16,8,8]",
        f"data_dir={data}", "trainer.precision=f32", "datamodule.batch_size=2",
        "datamodule.num_workers=1", "trainer.max_epochs=1", "trainer.limit_train_batches=1",
        "trainer.limit_val_batches=1", "logger=csv", f"logger.save_dir={tmp_path}/metrics"])
    cfg["callbacks"]["log_confusion_matrix"] = False
    cfg["callbacks"]["log_image_predictions"] = False
    trainer = Trainer(cfg, tmp_path / "run", device="cpu")
    result = trainer.fit()
    assert trainer.state.step == 1 and trainer.model.encoder_name == "mit_b0"
    model, _, hp = load_model(result["best_ckpt"], device="cpu")
    assert hp["encoder_name"] == "mit_b0"
    want = model.state_dict()
    for k, v in trainer.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(want[k], v.cpu()), k
