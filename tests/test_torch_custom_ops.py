"""The port's kernels as custom ops, and the compile options.

Each of the five kernels is a ``torch.library`` custom op of the port's
``deadtrees`` namespace (kernel 1's two passes, the NHWC pair as kernel
2 and as kernel 3, the augment kernel, the depthwise kernel), and so are
the EDT's two kernels (one op): nine ops, each checked here by
``torch.library.opcheck`` on CPU tensors (its schema, its fake
implementation's shapes and dtypes, and its run under AOTAutograd),
where the op runs the kernel's plain version. The compile options of
``core/compile_opts.py`` are checked against their rules, the
fixed-length counts of the eval step against ``torch.bincount``, and the
optimizer's update compiled with inductor on the CPU (one compile
thread, so that no worker pool starts inside the test's process) against
the same update run eagerly.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deadtrees_tpu_torch.core import compile_opts
from deadtrees_tpu_torch.core.compile_opts import (
    Program,
    compile_options,
    disable_compile,
    graphs_compiled,
)
from deadtrees_tpu_torch.losses.metrics import (
    bin_counts,
    confusion_matrix,
    masked_confusion_matrix,
)
from deadtrees_tpu_torch.losses.functional import class2one_hot
from deadtrees_tpu_torch.ops import augment as taug
from deadtrees_tpu_torch.ops import fused_cell as tfc
from deadtrees_tpu_torch.ops import fused_mbconv as tfm
from deadtrees_tpu_torch.train import Optimizer, OptimizerConfig

CIN, CMID, COUT = 16, 24, 8
REPO = Path(__file__).resolve().parents[1]


def _folded(seed=0, conv_skip=True):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return tfm.FoldedBlockParams(
        w1=t(CIN, CMID), b1=t(CMID), dw=t(3, 3, CMID), b_dw=t(CMID), cse_w1=t(CMID, 4),
        cse_b1=t(4), cse_w2=t(4, CMID), cse_b2=t(CMID), sse_w=t(CMID, 1), sse_b=t(1),
        w2=t(CMID, COUT), b2=t(COUT), wsk=t(CIN, COUT) if conv_skip else None,
        bsk=t(COUT) if conv_skip else None,
    ), t


def _op_cases():
    fp, t = _folded()
    flat = tfm.flat(fp)
    x = t(2, CIN, 10, 12)
    h, psum = tfm.chw_pass1(x, fp)
    gate = tfm.cse_gate(psum.sum(1), fp, 120)
    xn = t(2, 10, 12, CIN)
    hn, _ = tfc.nhwc_pass1_op(xn, fp)
    hn32, _ = tfc.nhwc_pass1_op(xn, fp, h_dtype=torch.float32)
    img = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 8, 8, 4)).astype(np.uint8))
    chan = taug.channel_table((0.4, 0.4, 0.3, 0.5), (0.2, 0.2, 0.2, 0.3), 4, "cpu")
    return {
        "chw_pass1": (torch.ops.deadtrees.chw_pass1, (x, flat, "hswish", 3)),
        "chw_pass2": (torch.ops.deadtrees.chw_pass2, (h, x, gate, flat, "conv")),
        "fused_ir_fat_pass1": (torch.ops.deadtrees.fused_ir_fat_pass1,
                               (xn, flat, "silu", 3, torch.float32)),
        "fused_ir_fat_pass2": (torch.ops.deadtrees.fused_ir_fat_pass2,
                               (hn, xn, gate, flat, "conv")),
        "fused_inverted_residual_pass1": (torch.ops.deadtrees.fused_inverted_residual_pass1,
                                          (xn, flat, "hswish", 3, torch.float32)),
        "fused_inverted_residual_pass2": (torch.ops.deadtrees.fused_inverted_residual_pass2,
                                          (hn32, xn, gate, flat, "none")),
        "augment_jitter_normalize": (torch.ops.deadtrees.augment_jitter_normalize,
                                     (img, t(2) * 0.1 + 1, t(2) * 0.1, taug.image_mean(img),
                                      chan)),
        "depthwise_conv2d": (torch.ops.deadtrees.depthwise_conv2d, (xn, t(5, 5, 1, CIN), 2)),
        "signed_distance_maps": (torch.ops.deadtrees.signed_distance_maps,
                                 (class2one_hot(torch.from_numpy(
                                     np.random.default_rng(2).integers(0, 3, (2, 9, 7))), 3),)),
    }


OPS = sorted(_op_cases())


@pytest.mark.parametrize("name", OPS)
def test_every_kernel_is_a_checked_custom_op(name):
    op, args = _op_cases()[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_the_ops_run_the_plain_versions_on_the_cpu():
    """On a CPU tensor each op is its kernel's plain version, and the fake
    implementation states the shapes it returns there (psum: one row)."""
    cases = _op_cases()
    op, (x, flat, act, k) = cases["chw_pass1"]
    fp = tfm.FoldedBlockParams(*flat)
    h, psum = op(x, flat, act, k)
    want_h, want_sums = tfm.chw_pass1_reference(x, fp, activation=act, ksize=k)
    assert torch.equal(h, want_h) and torch.equal(psum, want_sums)
    assert psum.shape == (2, 1, CMID)
    op, (xn, kern, strides) = cases["depthwise_conv2d"]
    from deadtrees_tpu_torch.ops.depthwise import depthwise_conv2d_reference

    assert torch.equal(op(xn, kern, strides), depthwise_conv2d_reference(xn, kern, strides=2))
    # kernel 1's tiles on the card, as csrc/fused_ir_chw.cu declares them
    assert tfm.chw_pass1_tile(3, torch.bfloat16) == (8, 32)
    assert tfm.chw_pass1_tile(3, torch.float32) == (14, 14)
    assert tfm.chw_pass1_tile(5, torch.float32) == (12, 12)
    assert tfm.chw_pass1_tiles(40, 72, 3, torch.bfloat16) == 5 * 3


def test_the_chw_library_must_tile_as_python_says():
    class FakeLib:
        def __init__(self, tile):
            self.fused_ir_chw_pass1 = self.fused_ir_chw_pass2 = lambda *a: 0
            self.fused_ir_chw_tile_size = tile

    def tile_of(k, bf16, axis):
        return (8, 32)[axis] if bf16 else 16 - 2 * (k // 2)

    assert tfm.bind_kernels(FakeLib(tile_of)) is not None
    with pytest.raises(RuntimeError, match="tiles"):
        tfm.bind_kernels(FakeLib(lambda k, bf16, axis: 16))


def test_compile_options_follow_their_rules(monkeypatch):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.delenv(compile_opts.ENV, raising=False)
    assert compile_options(cpu) is None  # the CPU runs eagerly by default
    assert compile_options(cuda) == dict(compile_opts.CUDA_DEFAULTS, backend="inductor")
    monkeypatch.setenv(compile_opts.ENV, "")  # empty: no options, inductor still
    assert compile_options(cuda) == {"backend": "inductor"}
    assert compile_options(cpu) is None
    monkeypatch.setenv(compile_opts.ENV, "backend=aot_eager, triton.cudagraphs=false,x=1.5")
    assert compile_options(cpu) == {"backend": "aot_eager", "triton.cudagraphs": False,
                                    "x": 1.5}
    with pytest.raises(ValueError, match="inductor"):
        compile_options(cuda)
    monkeypatch.delenv(compile_opts.EAGER_ENV, raising=False)
    with disable_compile():
        with disable_compile():
            assert compile_options(cpu) is None and compile_options(cuda) is None
        assert compile_options(cpu) is None
        # a process started inside the block runs eagerly too
        code = ("from deadtrees_tpu_torch.core.compile_opts import compile_options as c; "
                "print(c('cuda'))")
        child = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                               check=True, cwd=REPO, timeout=120)
        assert child.stdout.strip() == "None"
    assert compile_options(cpu)["backend"] == "aot_eager"
    assert compile_opts.EAGER_ENV not in os.environ
    assert compile_opts._parse("a=true,b=7,c=x") == {"a": True, "b": 7, "c": "x"}


def test_programs_not_by_default_compile_on_cuda_only_when_asked(monkeypatch):
    """A program made with ``by_default=False`` runs eagerly on CUDA unless
    ``DEADTREES_COMPILE_OPTS`` is set; on the CPU the flag changes nothing."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.delenv(compile_opts.ENV, raising=False)
    monkeypatch.delenv(compile_opts.EAGER_ENV, raising=False)
    assert compile_options(cuda, by_default=False) is None
    assert compile_options(cpu, by_default=False) is None
    program = compile_opts.Program(lambda x: x + 1, cuda, by_default=False)
    assert program.options() is None
    monkeypatch.setenv(compile_opts.ENV, "triton.cudagraphs=true")
    assert program.options() == {"backend": "inductor", "triton.cudagraphs": True}
    monkeypatch.setenv(compile_opts.ENV, "backend=aot_eager")
    assert compile_options(cpu, by_default=False) == {"backend": "aot_eager"}
    with disable_compile():
        assert program.options() is None


def test_a_program_compiles_only_when_asked(monkeypatch):
    def fn(x):
        return x * 2 + 1

    program = Program(fn, "cpu")
    x = torch.arange(4.0)
    monkeypatch.delenv(compile_opts.ENV, raising=False)
    before = graphs_compiled()
    assert torch.equal(program(x), x * 2 + 1)
    assert graphs_compiled() == before and program.compiles == []  # eager
    monkeypatch.setenv(compile_opts.ENV, "backend=aot_eager")
    for _ in range(3):
        assert torch.equal(program(x), x * 2 + 1)
    assert graphs_compiled() == before + 1  # one program for the shape
    assert len(program.compiles) == 1 and program.compiles[0][1] == 1
    program(torch.arange(5.0))  # another shape: another program
    assert graphs_compiled() == before + 2
    with disable_compile():
        program(torch.arange(6.0))
    assert graphs_compiled() == before + 2

    def breaks(x):
        torch._dynamo.graph_break()
        return x + 1

    with pytest.raises(Exception):  # fullgraph: the break raises, nothing runs eagerly
        Program(breaks, "cpu")(x)


def test_cuda_graph_state_is_set_up_in_other_threads():
    """A server's batching thread gets CUDA-graph trees of its own (PyTorch
    sets their thread-local state up only in the importing thread and in
    autograd's threads before 2.13)."""
    import threading

    from torch._inductor import cudagraph_trees

    found = []

    def worker():
        compile_opts._cudagraph_thread_state()
        compile_opts._cudagraph_thread_state()  # a second call keeps the state
        found.append(cudagraph_trees.get_container(0))
        found.append(cudagraph_trees.get_container(0))

    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive() and len(found) == 2 and found[0] is found[1]


def test_fixed_length_counts_equal_bincount():
    rng = np.random.default_rng(2)
    pred = torch.from_numpy(rng.integers(0, 3, (2, 16, 16)))
    target = torch.from_numpy(rng.integers(0, 3, (2, 16, 16)))
    lu = torch.from_numpy(rng.integers(0, 2, (2, 16, 16)))
    idx = target.reshape(-1) * 3 + pred.reshape(-1)
    assert torch.equal(bin_counts(idx, 9), torch.bincount(idx, minlength=9))
    assert bin_counts(idx, 12).dtype == torch.int64 and bin_counts(idx, 12).shape == (12,)
    want = torch.bincount(idx, minlength=9).reshape(3, 3)
    assert torch.equal(confusion_matrix(pred, target, num_classes=3), want)
    masked = torch.where(lu.reshape(-1) == 1, idx, torch.full_like(idx, 9))
    want_m = torch.bincount(masked, minlength=10)[:-1].reshape(3, 3)
    assert torch.equal(masked_confusion_matrix(pred, target, lu, num_classes=3), want_m)


def test_optimizer_update_compiled_with_inductor(monkeypatch):
    """The update program (clip, Adam, cosine rate from the device count,
    the guard) through inductor on the CPU equals the eager update, over a
    learning-rate change and a non-finite step, with no recompile."""
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    cfg = OptimizerConfig(learning_rate=1e-2, cosineannealing_tmax=2, steps_per_epoch=1)
    grads = [[torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32)) for s in shapes]
             for sc in (0.01, 3.0, 0.02, 5.0)]
    finite = [True, True, False, True]
    start = [rng.normal(size=s).astype(np.float32) for s in shapes]
    results = []
    for compiled in (True, False):
        params = [torch.from_numpy(a.copy()) for a in start]
        opt = Optimizer(params, cfg)
        program = Program(opt.step, "cpu")
        if compiled:
            monkeypatch.setenv(compile_opts.ENV, "backend=inductor,compile_threads=1")
        else:
            monkeypatch.delenv(compile_opts.ENV)
        before = graphs_compiled()
        for g, ok in zip(grads, finite):
            opt.load_grads(g)
            program(torch.tensor(ok))
        assert graphs_compiled() - before == int(compiled)
        results.append((params, opt))
    (p_c, o_c), (p_e, o_e) = results
    for a, b in zip(p_c + o_c.mu + o_c.nu, p_e + o_e.mu + o_e.nu):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert int(o_c.count) == int(o_e.count) == 3
