"""Tar-shard sample streaming (the WebDataset-format reader), local files.

Counterpart of ``deadtrees_tpu.data.tar``: samples are groups of files in
plain tar shards (``{key}.rgbn.tif``, ``{key}.mask.tif``, ``{key}.lu.tif``,
``{key}.txt``), as the reference's ``wds.ShardWriter`` writes them.

- :func:`iter_tar_samples` streams key-grouped dicts of raw bytes from one
  shard (sample key = path up to the FIRST dot, suffix = the rest);
- :func:`decode_sample` is the reference's ``sample_decoder``: an
  RGBA-converted 4-band image, L-converted masks, txt → {file, frac};
- :class:`ShardSampleStream` iterates many shards with a buffered shuffle
  and reshuffles the shard order each pass.

Remote shards (``pipe:`` / http) and the native C++ reader are not
ported yet: asking for them raises ``NotImplementedError`` (the shard
cache is refused by ``data/pipeline.py``'s config).
"""

from __future__ import annotations

import io
import random
import tarfile
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

_QUEUED = "(ROADMAP.md, slice A queue)"


def is_remote_shard(url) -> bool:
    """True for shard sources that are streams, not local files."""
    return str(url).startswith(("pipe:", "http://", "https://"))


def _local(path) -> str:
    if is_remote_shard(path):
        raise NotImplementedError(f"remote shard {path!r} is not ported yet {_QUEUED}")
    return str(path)


def iter_tar_samples(path) -> Iterator[Dict[str, bytes]]:
    """Stream samples (dicts of raw bytes keyed by suffix, plus
    ``__key__``) from a local tar shard. Files are grouped by prefix, in
    tar order."""
    current_key: Optional[str] = None
    sample: Dict[str, bytes] = {}
    with tarfile.open(_local(path), "r") as tf:
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            if name.startswith("./"):
                name = name[2:]
            if "." not in name:
                continue
            key, suffix = name.split(".", 1)
            if key != current_key:
                if current_key is not None and sample:
                    sample["__key__"] = current_key.encode()
                    yield sample
                current_key = key
                sample = {}
            f = tf.extractfile(member)
            if f is not None:
                sample[suffix] = f.read()
        if current_key is not None and sample:
            sample["__key__"] = current_key.encode()
            yield sample


def image_decoder(data: bytes) -> np.ndarray:
    """4-band image decode (the reference's image_decoder)."""
    from PIL import Image

    with io.BytesIO(data) as stream:
        img = Image.open(stream)
        img.load()
        img = img.convert("RGBA")
    return np.asarray(img)


def mask_decoder(data: bytes) -> np.ndarray:
    """Single-band mask decode (the reference's mask_decoder)."""
    from PIL import Image

    with io.BytesIO(data) as stream:
        img = Image.open(stream)
        img.load()
        img = img.convert("L")
    return np.asarray(img)


def decode_sample(
    sample: Dict[str, bytes],
    img_suffix: str = "rgbn.tif",
    msk_suffix: str = "mask.tif",
    lu_suffix: str = "lu.tif",
) -> Dict:
    """Decode one raw sample: 'image' (H, W, 4) uint8, optional 'mask' /
    'lu' (H, W) uint8, and 'stats' {file, frac}."""
    if img_suffix not in sample:
        raise ValueError(f"Wrong image suffix provided: no {img_suffix!r} in the sample")
    out: Dict = {"image": image_decoder(sample[img_suffix])}
    if "txt" in sample:
        out["stats"] = {"file": sample["__key__"].decode(), "frac": float(sample["txt"])}
    if msk_suffix in sample:
        out["mask"] = mask_decoder(sample[msk_suffix])
    if lu_suffix in sample:
        out["lu"] = mask_decoder(sample[lu_suffix])
    return out


class ShardSampleStream:
    """Iterate decoded samples over a list of local shards, optionally
    forever. ``shuffle`` is the webdataset-style buffered shuffle size
    (0 = off); the shard order reshuffles each pass when shuffling is on."""

    def __init__(
        self,
        shards: Sequence[str],
        *,
        shuffle: int = 0,
        seed: int = 0,
        loop: bool = False,
    ):
        self.shards = [_local(s) for s in shards]
        self.shuffle = shuffle
        self.loop = loop
        self._rng = random.Random(seed)

    def __iter__(self) -> Iterator[Dict]:
        while True:
            shards = list(self.shards)
            if self.shuffle:
                self._rng.shuffle(shards)
            buf: List[Dict] = []
            for shard in shards:
                for raw in iter_tar_samples(shard):
                    sample = decode_sample(raw)
                    if self.shuffle <= 1:
                        yield sample
                        continue
                    buf.append(sample)
                    if len(buf) >= self.shuffle:
                        idx = self._rng.randrange(len(buf))
                        buf[idx], buf[-1] = buf[-1], buf[idx]
                        yield buf.pop()
            self._rng.shuffle(buf)
            yield from buf
            if not self.loop:
                return


def count_shard_samples(path) -> int:
    """Sample count of one shard, from the tar headers (no decode)."""
    return sum(1 for _ in iter_tar_samples(path))


def make_sample_stream(
    shards, *, shuffle: int = 0, seed: int = 0, loop: bool = False,
    prefer_native: bool = False,
) -> ShardSampleStream:
    """The Python stream; the native C++ reader is not ported yet."""
    if prefer_native:
        raise NotImplementedError(f"the native C++ shard reader is not ported yet {_QUEUED}")
    return ShardSampleStream(shards, shuffle=shuffle, seed=seed, loop=loop)
