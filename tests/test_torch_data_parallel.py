"""The port's data module with several processes, against the JAX package's.

One process plays each rank through the ``process_index`` /
``process_count`` overrides (no process group), as
``tests/test_data.py``'s multi-host tests do: the disjoint round-robin
train shards and ``steps_per_epoch`` (the smallest rank's), the eval and
test slices sample for sample (files, images, masks; with an extra
dataset, the slices span the batch's parts), each rank decoding only its
slice (native and PIL readers), the ranks' train streams, and the
divisibility errors. Tiles are 16² RGBN TIFFs, 8 a shard.
"""

import numpy as np
import pytest
import torch

from deadtrees_tpu.data import DataConfig as JaxDataConfig
from deadtrees_tpu.data import DeadtreesDataModule as JaxDataModule
from deadtrees_tpu_torch.data import native
from deadtrees_tpu_torch.data import tar as tar_mod
from deadtrees_tpu_torch.data.pipeline import DataConfig, DeadtreesDataModule
from tests.test_data import _write_shard

SIZE = 16


def _write(root, n_main=7, n_extra=0):
    for i in range(n_main):
        _write_shard(root / f"train-{i:06d}.tar", 8, size=SIZE, seed=i, prefix=f"main{i}")
    for i in range(n_extra):
        _write_shard(root / f"rnd-{i:06d}.tar", 8, size=SIZE, seed=100 + i, prefix=f"rnd{i}")
    return root


def _modules(root, pi, pc, **kw):
    common = dict(data_dir=str(root), shuffle_buffer=0, process_index=pi, process_count=pc,
                  distmap=False, **kw)
    port = DeadtreesDataModule(DataConfig(device="cpu", **common))
    jax_dm = JaxDataModule(JaxDataConfig(**common))
    port.setup()
    jax_dm.setup()
    return port, jax_dm


@pytest.mark.parametrize("pc", [2, 3])
def test_shard_assignment_and_epoch_length_match_jax(tmp_path, pc):
    root = _write(tmp_path)
    local = []
    for pi in range(pc):
        port, jax_dm = _modules(root, pi, pc, pattern="train-*.tar", batch_size=6)
        assert port.train_shards == jax_dm.train_shards
        assert port.train_shards_local == jax_dm.train_shards_local
        assert port.local_batch_size == jax_dm.local_batch_size == 6 // pc
        assert port.steps_per_epoch == jax_dm.steps_per_epoch
        local += port.train_shards_local
    assert sorted(local) == sorted(port.train_shards)  # disjoint and complete


def _port_batches(batches):
    return [(b["image"].permute(0, 2, 3, 1).numpy(), b["mask"].numpy(), list(b["files"]))
            for b in batches]


def _jax_batches(batches):
    return [(np.asarray(b["image"]), np.asarray(b["mask"]), list(b["files"])) for b in batches]


@pytest.mark.parametrize("extras", [False, True])
def test_eval_and_test_slices_match_jax(tmp_path, extras):
    root = _write(tmp_path, n_main=8, n_extra=8 if extras else 0)
    kw = dict(pattern="train-*.tar", batch_size=4)
    if extras:
        kw.update(pattern_extra=["rnd-*.tar"], batch_size_extra=[2])
    single = _port_batches(_modules(root, 0, 1, **kw)[0].val_batches())
    halves = []
    for pi in (0, 1):
        port, jax_dm = _modules(root, pi, 2, **kw)
        for split in ("val_batches", "test_batches"):
            got = _port_batches(getattr(port, split)())
            want = _jax_batches(getattr(jax_dm, split)())
            assert len(got) == len(want) >= 1, split
            for (gi, gm, gf), (wi, wm, wf) in zip(got, want):
                assert gf == wf and gi.shape[0] == 2
                np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-6)
                np.testing.assert_array_equal(gm, wm)
            if split == "val_batches":
                halves.append(got)
    for (i0, m0, f0), (i1, m1, f1), (i, m, f) in zip(*halves, single):
        assert f0 + f1 == f  # the two slices are the one-process batch
        np.testing.assert_array_equal(np.concatenate([i0, i1]), i)
        np.testing.assert_array_equal(np.concatenate([m0, m1]), m)
        if extras:  # [main main | extra extra]: rank 0 the main part, rank 1 the extra
            assert all(x.startswith("main") for x in f0)
            assert all(x.startswith("rnd") for x in f1)


@pytest.mark.parametrize("use_native", [True, False])
def test_each_rank_decodes_only_its_slice(tmp_path, monkeypatch, use_native):
    root = _write(tmp_path, n_main=8)
    monkeypatch.setattr(tar_mod, "NATIVE_FALLBACKS", [])
    decoded = {"n": 0}
    if use_native:
        orig = native.decode_batch

        def counting(path, extents, shape, **kw):
            if shape[-1] == 4:
                decoded["n"] += len(extents)
            return orig(path, extents, shape, **kw)

        monkeypatch.setattr(native, "decode_batch", counting)
    else:
        orig = tar_mod.image_decoder

        def counting(data):
            decoded["n"] += 1
            return orig(data)

        monkeypatch.setattr(tar_mod, "image_decoder", counting)

    def run(pi, pc):
        decoded["n"] = 0
        dm = DeadtreesDataModule(DataConfig(
            data_dir=str(root), batch_size=4, shuffle_buffer=0, process_index=pi,
            process_count=pc, distmap=False, use_native=use_native, device="cpu"))
        dm.setup()
        n = sum(1 for _ in dm.val_batches())
        return n, decoded["n"]

    n_full, full = run(0, 1)
    (n0, d0), (n1, d1) = run(0, 2), run(1, 2)
    assert n0 == n1 == n_full >= 1
    assert full == 4 * n_full and d0 == d1 == 2 * n_full
    assert not tar_mod.NATIVE_FALLBACKS


def test_rank_train_streams_differ(tmp_path):
    """Disjoint main shards a rank; the one extra shard both ranks read
    is drawn in another order on each (the rank is in the stream seed)."""
    root = _write(tmp_path, n_main=4, n_extra=2)  # one extra train shard, one val
    files = []
    for pi in (0, 1):
        dm = DeadtreesDataModule(DataConfig(
            data_dir=str(root), pattern="train-*.tar", pattern_extra=["rnd-*.tar"],
            batch_size=4, batch_size_extra=[2], process_index=pi, process_count=2,
            distmap=False, device="cpu"))
        dm.setup()
        batches = list(dm.train_batches(torch.Generator().manual_seed(3)))
        assert batches and all(b["image"].shape[0] == 2 for b in batches)
        files.append([f for b in batches for f in b["files"]])
    main = [{f for f in fs if f.startswith("main")} for fs in files]
    assert main[0] and main[1] and not main[0] & main[1]
    extra = [[f for f in fs if f.startswith("rnd")] for fs in files]
    assert extra[0] != extra[1]


def test_batch_sizes_must_divide(tmp_path):
    root = _write(tmp_path, n_main=5, n_extra=2)
    dm = DeadtreesDataModule(DataConfig(data_dir=str(root), pattern="train-*.tar",
                                        batch_size=5, process_index=0, process_count=2,
                                        device="cpu"))
    dm.setup()
    with pytest.raises(ValueError, match="divisible"):
        dm.local_batch_size
    dm = DeadtreesDataModule(DataConfig(data_dir=str(root), pattern="train-*.tar",
                                        pattern_extra=["rnd-*.tar"], batch_size=4,
                                        batch_size_extra=[1], process_index=0,
                                        process_count=2, device="cpu"))
    dm.setup()
    with pytest.raises(ValueError, match="batch component 3 not divisible"):
        next(dm.train_batches())
