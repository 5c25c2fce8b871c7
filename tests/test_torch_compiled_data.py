"""The augment, scene-chunk and ensemble programs, compiled on the CPU.

Programs compile with ``aot_eager`` and ``fullgraph=True``:

- ``augment_batch`` (the dihedral, kernel 4's op with the exact image
  mean, the mask and ``lu`` transforms) gives the eager call's tensors bit
  for bit, in train mode with fixed parameters and in val mode;
- a scene predictor's chunk program (normalize, forward, argmax at the
  chunk's shape) gives the eager predictor's map, equal, padding subtiles
  zero;
- ``EnsembleInference``'s vote program gives the eager vote.

The model is a b0 EfficientUnet++ with narrow decoder channels, random
weights from a seed, float32.
"""

import os

import numpy as np
import pytest
import torch

from deadtrees_tpu_torch.core import compile_opts, save_checkpoint
from deadtrees_tpu_torch.core.compile_opts import disable_compile, graphs_compiled
from deadtrees_tpu_torch.data.augment import augment_batch, sample_augment_params
from deadtrees_tpu_torch.infer import EnsembleInference, make_scene_predictor
from deadtrees_tpu_torch.models import create_model, init_model, variables_from_state_dict

HP = dict(architecture="efficientunet++", encoder_name="timm-efficientnet-b0",
          decoder_channels=[16, 8, 8, 8, 8], in_channels=4, classes=3, encoder_weights=None)


@pytest.fixture(autouse=True, scope="module")
def aot_eager():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    old = os.environ.get(compile_opts.ENV)
    os.environ[compile_opts.ENV] = "backend=aot_eager"
    yield
    torch.set_num_threads(n)
    if old is None:
        del os.environ[compile_opts.ENV]
    else:
        os.environ[compile_opts.ENV] = old


@pytest.fixture(scope="module")
def model():
    m = init_model(create_model(**HP, dtype=torch.float32),
                   generator=torch.Generator().manual_seed(3))
    return m.eval()


def test_compiled_augment_is_bit_equal_to_eager():
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.integers(0, 256, (4, 24, 24, 4)).astype(np.uint8))
    mask = torch.from_numpy(rng.integers(0, 3, (4, 24, 24)).astype(np.int32))
    lu = torch.from_numpy(rng.integers(0, 2, (4, 24, 24)).astype(np.int32))
    params = sample_augment_params(torch.Generator().manual_seed(8), 4)
    params["rot_k"] = torch.tensor([0, 1, 2, 3])  # every rotation
    params["flip_h"] = torch.tensor([True, False, True, False])
    for train in (True, False):
        before = graphs_compiled()
        got = augment_batch(None, img, mask, lu, train=train, params=params)
        assert graphs_compiled() - before == 1  # one program
        with disable_compile():
            want = augment_batch(None, img, mask, lu, train=train, params=params)
        assert set(got) == set(want) == {"image", "mask", "lu"}
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # a batch without lu is a program of its own
    got = augment_batch(None, img, mask, train=True, params=params)
    with disable_compile():
        want = augment_batch(None, img, mask, train=True, params=params)
    assert set(got) == {"image", "mask"} and torch.equal(got["image"], want["image"])


def test_compiled_scene_chunk_equals_eager(model):
    rng = np.random.default_rng(5)
    scenes = rng.integers(0, 256, (2, 64, 64, 4)).astype(np.uint8)
    valid = np.ones((2, 4), bool)
    valid[1, 3] = False  # a padding subtile comes out zero
    predict = make_scene_predictor(model, subtile=32, batch_size=4, device="cpu")
    got = predict(torch.from_numpy(scenes), torch.from_numpy(valid))
    with disable_compile():
        want = make_scene_predictor(model, subtile=32, batch_size=4, device="cpu")(
            torch.from_numpy(scenes), torch.from_numpy(valid))
    assert got.shape == (2, 64, 64) and got.dtype == torch.uint8
    assert torch.equal(got, want)
    assert not got[1, 32:, 32:].any()


def test_compiled_ensemble_vote_equals_eager(model, tmp_path):
    variables = variables_from_state_dict(model.state_dict())
    paths = []
    for i in range(3):
        paths.append(tmp_path / f"m{i}.ckpt")
        save_checkpoint(paths[-1], **variables, hparams=HP)
    img = np.random.default_rng(6).integers(0, 256, (2, 32, 32, 4), np.uint8)
    ens = EnsembleInference(paths, device="cpu")
    assert ens.homogeneous
    got = ens.run(img)
    assert len(ens._program.compiles) == 1
    with disable_compile():
        want = ens.run(img)
    np.testing.assert_array_equal(got, want)
