"""The MiT family of the reference (``reference/encoders/mit.py``), the
UNet++ reference decoder and the attention's work
(``harness/attention.py``), at the tests' size on the CPU."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest
import torch

from port_bench import run as bench
from port_bench.harness import attention, weights
from port_bench.reference import batch as ref_batch
from port_bench.reference import model as ref_model
from port_bench.reference import step as ref_step
from port_bench.tests.conftest import REPO

MIT_B5 = json.loads((REPO / "port_bench" / "configs" / "unet-mit-b5.json").read_text())
TRAIN1024 = json.loads((REPO / "port_bench" / "traffic" / "train1024.json").read_text())


def tiny(architecture: str = "unet") -> dict:
    """mit_b0's widths and depths under a narrow decoder, float32."""
    c = json.loads(json.dumps(MIT_B5))
    c["encoder"].update(name="mit_b0", embed_dims=[32, 64, 160, 256], depths=[2, 2, 2, 2])
    c.update(architecture=architecture, decoder_channels=[32, 16, 16, 8, 8], precision="f32",
             name=f"tiny-{architecture}-mit-b0")
    del c["parameters"]
    c["program"] = {"architecture": architecture, "encoder_name": "mit_b0", "overrides": [
        "experiment=flagship_b5_multistage", f"model.network.architecture={architecture}",
        "model.network.encoder_name=mit_b0", "model.network.decoder_channels=[32,16,16,8,8]",
        "trainer.precision=f32"]}
    return c


@pytest.mark.parametrize("architecture", ["unet", "unetplusplus"])
def test_checkpointed_step_equals_the_plain_one(architecture):
    config = tiny(architecture)
    params = weights.make(config, 5, "cpu")
    names = [l.name for l in ref_model.leaves(config) if l.is_param]
    x = torch.randn(2, 4, 64, 64, generator=torch.Generator().manual_seed(0))
    mask = torch.randint(0, 3, (2, 64, 64), generator=torch.Generator().manual_seed(1))
    dist = ref_batch.distmaps(mask.numpy(), 3)
    got = {}
    for ckpt in (False, True):
        leaves = [params[n].detach().requires_grad_(True) for n in names]
        run = dict(params, **dict(zip(names, leaves)))
        logits = ref_model.forward(run, x, config, train=True, checkpoint=ckpt)
        total, _ = ref_step.loss(logits, mask, dist, config["recipe"]["losses"])
        got[ckpt] = [total.detach()] + list(torch.autograd.grad(total, leaves))
    for a, b in zip(got[False], got[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_the_configuration_states_the_reference_s_parameter_count():
    assert ref_model.n_params(MIT_B5) == MIT_B5["parameters"]
    names = [l.name for l in ref_model.leaves(MIT_B5)]
    assert len(names) == len(set(names)) and ref_model.residual_bns(MIT_B5) == []
    blocks = {n.split(".")[1] for n in names if n.startswith("encoder.block")}
    assert blocks == {"block1", "block2", "block3", "block4"}
    assert sum(1 for n in names if n.endswith(".attn.q.weight")) == 52


def test_the_attention_s_work_by_hand():
    config = {"encoder": {"patch_kernels": [7, 3], "patch_strides": [4, 2],
                          "embed_dims": [8, 16], "depths": [2, 1], "sr_ratios": [4, 1]}}
    traffic = {"tile": 64, "batch_size": 3}
    # stage 1: 16 × 16 = 256 queries, (16 / 4)² = 16 keys; stage 2: 8 × 8 = 64 and 64
    assert attention.blocks(config, traffic) == [(3, 256, 16, 8)] * 2 + [(3, 64, 64, 16)]
    flops = 2 * 12 * 3 * 256 * 16 * 8 + 12 * 3 * 64 * 64 * 16
    nbytes = 2 * 16 * 3 * (256 + 16) * 8 + 16 * 3 * (64 + 64) * 16
    assert sum(attention.flops(*b) for b in attention.blocks(config, traffic)) == flops
    assert sum(attention.nbytes(*b) for b in attention.blocks(config, traffic)) == nbytes
    bound = (2 * max(12 * 3 * 256 * 16 * 8 / 989e12, 16 * 3 * 272 * 8 / 3.35e12)
             + max(12 * 3 * 64 * 64 * 16 / 989e12, 16 * 3 * 128 * 16 / 3.35e12))
    assert math.isclose(attention.step_bound_s(config, traffic), bound, rel_tol=1e-12)


def test_the_cell_s_attention_is_the_forward_s_third():
    """324 GFLOP of the 1024² forward's attention products a sample, and
    the reference's own count of the whole forward holds them."""
    per_sample = {**TRAIN1024, "batch_size": 1}
    forward = sum(attention.flops(*b) for b in attention.blocks(MIT_B5, per_sample)) / 3
    assert 320e9 < forward < 330e9
    params = {l.name: torch.empty(l.shape, device="meta") for l in ref_model.leaves(MIT_B5)}
    x = torch.empty((1, 4, 1024, 1024), device="meta")
    from port_bench.harness import flops as counted

    total = sum(counted.forward_flops(lambda: ref_model.forward(params, x, MIT_B5, train=True)))
    assert 0.3 < forward / total < 0.4


def test_a_tiny_mit_cell_runs_correct_on_the_cpu(tiny_root, tmp_path):
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root, symlinks=True)
    config = tiny("unet")
    (root / "port_bench" / "configs" / "tiny-mit.json").write_text(json.dumps(config))
    (root / "port_bench" / "limits" / "train.tiny-mit.json").write_text(json.dumps(
        {"image_gap": 1e-4, "distmap_gap": 1e-3, "loss_gap": 1e-4, "grad_gap": None,
         "grad_gap_median": 1e-3, "update_gap": 1e-2}))
    bench_file = json.loads((root / "BENCHMARK.json").read_text())
    bench_file["configs"].append({"name": "tiny-mit", "source": "https://arxiv.org/abs/2105.15203",
                                  "file": "port_bench/configs/tiny-mit.json", "reduced": [],
                                  "why": "the tests' size"})
    bench_file["workloads"].append({"name": "train.tiny-mit", "config": "tiny-mit",
                                    "traffic": "tiny-train", "chips": 1, "why": "the tests' size"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench_file))
    args = SimpleNamespace(workload="train.tiny-mit", seed=2**31 + 9, seconds=1.0, trace=0)
    res = bench.run(args, root=root, device=torch.device("cpu"))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
