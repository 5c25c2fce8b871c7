"""The one generator of the benchmark's inputs, driven by a traffic file.

Training (kind ``train``): tar shards of RGBN uint8 tiles, each sample
``s{i:06d}`` with ``rgbn.tif`` (uncompressed, 4 bands), ``mask.tif``
(rectangles of each foreground class on class 0), ``lu.tif`` (a land-use
layer) and ``txt`` (the foreground share), written with the standard
library's ``tarfile`` in the layout the recipe's data module reads
(``train/``, ``val/``, ``test/``). A sample is a function of the seed and
its index alone (:func:`train_sample`), so the reference rebuilds any
sample the program batched. Keys: ``tile``, ``bands``, ``classes``,
``shards``, ``shard_size``, ``rectangles``, ``lu_share``.

Scenes (kind ``scenes``): ``pool`` uint8 scenes of ``scene``² × ``bands``
made on the device from the seed in one call (:func:`scene_pool`).
"""

from __future__ import annotations

import io
import tarfile
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

SHARD_NAME = "train-combo-%06d.tar"


def _rng(seed: int, i: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), int(i)])


def train_sample(seed: int, i: int, traffic: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(image (T, T, bands) uint8, mask (T, T) uint8, lu (T, T) uint8)."""
    rng = _rng(seed, i)
    t = traffic["tile"]
    mask = np.zeros((t, t), np.uint8)
    side = t // 5
    for cls in range(1, traffic["classes"]):
        for y, x, h, w in rng.integers(0, t * 3 // 4, (traffic["rectangles"], 4)):
            mask[y:y + h % side + t // 32, x:x + w % side + t // 32] = cls
    image = rng.integers(0, 256, (t, t, traffic["bands"]), dtype=np.uint8)
    lu = (rng.random((t, t), dtype=np.float32) < traffic["lu_share"]).astype(np.uint8)
    return image, mask, lu


def sample_index(key: str) -> int:
    return int(key[1:])


def _tiff(arr: np.ndarray) -> bytes:
    """An uncompressed TIFF by PIL (RGBA for 4 bands, L for one)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="TIFF")
    return buf.getvalue()


def _add(tar: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def write_train_shards(root: Path, seed: int, traffic: Dict) -> None:
    """Writes ``shards`` × ``shard_size`` samples under ``root/train``
    (and empty ``val``, ``test``)."""
    for split in ("train", "val", "test"):
        (root / split).mkdir(parents=True, exist_ok=True)
    n = traffic["shard_size"]
    for s in range(traffic["shards"]):
        path = root / "train" / (SHARD_NAME % s)
        with tarfile.open(path, "w") as tar:
            for i in range(s * n, (s + 1) * n):
                image, mask, lu = train_sample(seed, i, traffic)
                key = f"s{i:06d}"
                # suffixes in sorted order, as the recipe's shard writer does
                _add(tar, f"{key}.lu.tif", _tiff(lu))
                _add(tar, f"{key}.mask.tif", _tiff(mask))
                _add(tar, f"{key}.rgbn.tif", _tiff(image))
                _add(tar, f"{key}.txt", f"{float((mask > 0).mean() * 100):.2f}".encode())


def scene_pool(seed: int, traffic: Dict, device) -> np.ndarray:
    """(pool, S, S, bands) uint8 on the host, drawn on the device."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    s = traffic["scene"]
    pool = torch.randint(0, 256, (traffic["pool"], s, s, traffic["bands"]), generator=g,
                         device=device, dtype=torch.uint8)
    return pool.cpu().numpy()
