"""Tar-shard sample streaming (the WebDataset-format reader).

Counterpart of ``deadtrees_tpu.data.tar``: samples are groups of files in
plain tar shards (``{key}.rgbn.tif``, ``{key}.mask.tif``, ``{key}.lu.tif``,
``{key}.txt``), as the reference's ``wds.ShardWriter`` writes them.

- :func:`open_shard` opens a local file, a ``pipe:CMD`` source (the
  command's stdout is the tar stream) or an http(s) URL;
  :func:`expand_shard_urls` expands a ``{000000..000123}`` brace range and
  :func:`cache_shard` copies a remote shard into a local cache once;
- :func:`iter_tar_samples` streams key-grouped dicts of raw bytes from one
  shard (sample key = path up to the FIRST dot, suffix = the rest);
- :func:`decode_sample` is the reference's ``sample_decoder``: an
  RGBA-converted 4-band image, L-converted masks, txt → {file, frac};
- :class:`ShardSampleStream` iterates many shards with a buffered shuffle
  and reshuffles the shard order each pass; :class:`NativeShardSampleStream`
  decodes each local shard whole through the C++ reader (``data/native.py``)
  and yields the same samples in the same order;
- ``raw=True`` defers the decode: the streams yield markers
  (``{"__raw__": bytes}`` from the Python reader, ``{"__native__":
  (shard, extents, (h, w))}`` from the native one, with the sample's
  stats) that :func:`materialize_samples` decodes later. Every rank of a
  data-parallel run streams the same raw eval batches (the same order and
  end) and decodes only its slice.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import logging
import os
import random
import re
import shutil
import subprocess
import tarfile
import threading
import urllib.request
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

_BRACE_RANGE = re.compile(r"\{(\d+)\.\.(\d+)\}")

# Local shards the native stream could not decode and read through PIL
# instead, one entry (and one warning) a shard read; clear it to count anew.
NATIVE_FALLBACKS: List[str] = []


def is_remote_shard(url) -> bool:
    """True for shard sources that are streams, not local files: ``pipe:CMD``
    and http(s) URLs."""
    return str(url).startswith(("pipe:", "http://", "https://"))


def expand_shard_urls(spec: str) -> List[str]:
    """WebDataset-style brace expansion: ``shard-{000000..000123}.tar`` →
    124 urls with the range's zero padding. A spec without a ``{a..b}``
    range is a one-element list."""
    m = _BRACE_RANGE.search(spec)
    if m is None:
        return [spec]
    lo, hi = int(m.group(1)), int(m.group(2))
    width = len(m.group(1))
    head, tail = spec[: m.start()], spec[m.end():]
    return [f"{head}{i:0{width}d}{tail}" for i in range(lo, hi + 1)]


@contextlib.contextmanager
def open_shard(url):
    """Open a shard source as a tarfile: a local path (random access), or a
    sequential stream (``mode="r|*"``) for ``pipe:`` and http(s) sources.

    A ``pipe:`` command that exits non-zero after a cleanly read stream
    raises: a truncated object-store read must not look like a short
    shard. A stream abandoned early (a closed generator, an error) kills
    the child instead of waiting for it."""
    url = str(url)
    if url.startswith("pipe:"):
        proc = subprocess.Popen(url[len("pipe:"):], shell=True, stdout=subprocess.PIPE)
        exhausted = False
        try:
            with tarfile.open(fileobj=proc.stdout, mode="r|*") as tf:
                yield tf
            exhausted = True
        finally:
            if exhausted:
                # the archive's end marker comes before the stream's end (tar
                # pads to its record size): read the rest, or a command still
                # writing it dies of SIGPIPE (exit 141) on a clean read
                while proc.stdout.read(1 << 16):
                    pass
                proc.stdout.close()
                rc = proc.wait()
                if rc != 0:
                    raise RuntimeError(f"shard pipe command failed (exit {rc}): {url}")
            else:
                proc.kill()
                proc.wait()
                proc.stdout.close()
    elif url.startswith(("http://", "https://")):
        with urllib.request.urlopen(url) as resp:
            with tarfile.open(fileobj=resp, mode="r|*") as tf:
                yield tf
    else:
        with tarfile.open(url, "r") as tf:
            yield tf


def cache_shard(url, cache_dir) -> str:
    """Copy a remote shard (``pipe:`` / http) into ``cache_dir`` once and
    return the local path; a local path passes through. Later epochs, and
    the native reader, which needs a real file, then read the copy. The
    download lands in a temporary of its process and thread and is renamed
    into place, so streams that fetch at once at worst fetch twice and
    never read a torn file. A pipe command's non-zero exit discards the
    download."""
    url = str(url)
    if not is_remote_shard(url):
        return url
    # {sha1(url)[:10]}-{base}: the JAX package's name, so either package
    # reads a cache the other filled
    base = url.rstrip("/").rsplit("/", 1)[-1].rsplit(" ", 1)[-1] or "shard.tar"
    if not base.endswith(".tar"):
        base += ".tar"
    local = Path(cache_dir) / f"{hashlib.sha1(url.encode()).hexdigest()[:10]}-{base}"
    if local.exists():
        return str(local)
    local.parent.mkdir(parents=True, exist_ok=True)
    tmp = local.with_suffix(local.suffix + f".tmp{os.getpid()}.{threading.get_ident()}")
    try:
        with open(tmp, "wb") as out:
            if url.startswith("pipe:"):
                rc = subprocess.run(url[len("pipe:"):], shell=True, stdout=out).returncode
                if rc != 0:
                    raise RuntimeError(f"shard pipe command failed (exit {rc}): {url}")
            else:
                with urllib.request.urlopen(url) as resp:
                    shutil.copyfileobj(resp, out)
        tmp.replace(local)
    finally:
        tmp.unlink(missing_ok=True)
    return str(local)


def iter_tar_samples(path) -> Iterator[Dict[str, bytes]]:
    """Stream samples (dicts of raw bytes keyed by suffix, plus
    ``__key__``) from a shard: a local file, a ``pipe:`` source or an
    http(s) URL (:func:`open_shard`). Files are grouped by prefix, in tar
    order."""
    current_key: Optional[str] = None
    sample: Dict[str, bytes] = {}
    with open_shard(path) as tf:
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
    """Iterate decoded samples over a list of shards, optionally forever.
    ``shuffle`` is the webdataset-style buffered shuffle size (0 = off); the
    shard order reshuffles each pass when shuffling is on. With
    ``cache_dir``, a remote shard is copied there on first touch and read
    from the copy (:func:`cache_shard`)."""

    def __init__(
        self,
        shards: Sequence[str],
        *,
        shuffle: int = 0,
        seed: int = 0,
        loop: bool = False,
        raw: bool = False,
        cache_dir: Optional[str] = None,
    ):
        self.shards = [str(s) for s in shards]
        if loop and not self.shards:
            raise ValueError("a looping sample stream needs at least one shard")
        self.shuffle = shuffle
        self.loop = loop
        self.raw = raw
        self.cache_dir = cache_dir
        self._rng = random.Random(seed)

    def _resolve(self, shard: str) -> str:
        """A remote shard's cached copy when there is a cache."""
        return shard if self.cache_dir is None else cache_shard(shard, self.cache_dir)

    def _iter_shard(self, shard: str) -> Iterator[Dict]:
        for raw in iter_tar_samples(shard):
            yield {"__raw__": raw} if self.raw else decode_sample(raw)

    def __iter__(self) -> Iterator[Dict]:
        while True:
            shards = list(self.shards)
            if self.shuffle:
                self._rng.shuffle(shards)
            buf: List[Dict] = []
            for shard in shards:
                for sample in self._iter_shard(self._resolve(shard)):
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
    """Sample count of one shard, by grouping its members (no decode)."""
    return sum(1 for _ in iter_tar_samples(path))


class NativeShardSampleStream(ShardSampleStream):
    """The stream through the C++ reader: each local shard's tar index,
    then its images, masks and lu layers decoded as three batches on
    ``n_threads`` threads (clamped to the host's cores). The samples, and
    their order, are those of :class:`ShardSampleStream`.

    A remote shard without a cache is a sequential stream, with no file
    for the tar index: it goes through the Python reader. A local shard
    that the C++ decoder refuses (planar TIFFs, a strip table that does
    not cover the image, members of other dims) is read through PIL, with
    a warning and an entry in :data:`NATIVE_FALLBACKS`. With ``raw=True``
    a local shard's samples are ``__native__`` markers: its tar index and
    the dims of its first image, decoded by :func:`materialize_samples`."""

    def __init__(self, *args, n_threads: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_threads = n_threads

    def _markers(self, shard: str) -> List[Dict]:
        """One ``__native__`` marker a sample of a local shard, with its
        stats (a few bytes, read now, so that materializing is decode
        work only)."""
        from deadtrees_tpu_torch.data import native

        samples = native.index_shard_samples(shard)
        keys = list(samples)
        if not keys:
            return []
        first = samples[keys[0]]["rgbn.tif"]
        out = []
        with open(shard, "rb") as f:
            f.seek(first[0])
            dims = native.tiff_decode(f.read(first[1])).shape[:2]
            for k in keys:
                marker: Dict = {"__native__": (shard, samples[k], dims)}
                if "txt" in samples[k]:
                    off, size = samples[k]["txt"]
                    f.seek(off)
                    marker["stats"] = {"file": k, "frac": float(f.read(size))}
                out.append(marker)
        return out

    def _iter_shard(self, shard: str) -> Iterator[Dict]:
        if is_remote_shard(shard):
            yield from super()._iter_shard(shard)
            return
        try:
            markers = self._markers(shard)
            samples = markers if self.raw else _decode_markers(shard, markers, self.n_threads)
        except (ValueError, KeyError, OSError) as e:
            _fall_back(shard, e)
            yield from super()._iter_shard(shard)
            return
        yield from samples


def _fall_back(shard: str, error: BaseException) -> None:
    log.warning(f"native decode of {shard} failed ({error!r}); reading it through PIL")
    NATIVE_FALLBACKS.append(shard)


def _decode_markers(shard: str, markers: List[Dict], n_threads: int) -> List[Dict]:
    """Decode ``__native__`` markers of one shard through the C++ reader:
    images, masks and lu layers as three batches; stats carried over."""
    from deadtrees_tpu_torch.data import native

    if not markers:
        return []
    h, w = markers[0]["__native__"][2]
    entries = [m["__native__"][1] for m in markers]

    def batch(suffix, c):
        if suffix not in entries[0]:
            return None
        return native.decode_batch(shard, [e[suffix] for e in entries], (h, w, c),
                                   n_threads=n_threads)

    rgbn, masks, lus = batch("rgbn.tif", 4), batch("mask.tif", 1), batch("lu.tif", 1)
    out = []
    for i, m in enumerate(markers):
        sample: Dict = {"image": rgbn[i]}
        if "stats" in m:
            sample["stats"] = m["stats"]
        if masks is not None:
            sample["mask"] = masks[i, ..., 0]
        if lus is not None:
            sample["lu"] = lus[i, ..., 0]
        out.append(sample)
    return out


def _decode_markers_pil(shard: str, markers: List[Dict]) -> List[Dict]:
    """The samples of :func:`_decode_markers`, each member through PIL."""
    out = []
    with open(shard, "rb") as f:

        def read(extent):
            f.seek(extent[0])
            return f.read(extent[1])

        for m in markers:
            entry = m["__native__"][1]
            sample: Dict = {"image": image_decoder(read(entry["rgbn.tif"]))}
            if "stats" in m:
                sample["stats"] = m["stats"]
            if "mask.tif" in entry:
                sample["mask"] = mask_decoder(read(entry["mask.tif"]))
            if "lu.tif" in entry:
                sample["lu"] = mask_decoder(read(entry["lu.tif"]))
            out.append(sample)
    return out


def materialize_samples(samples: List[Dict], *, n_threads: int = 4) -> List[Dict]:
    """Decode the markers of a ``raw=True`` stream, in their order:
    ``__raw__`` ones with :func:`decode_sample`, ``__native__`` ones grouped
    by shard through the C++ reader (one batch a member suffix a shard);
    decoded samples pass unchanged. A shard whose members the C++ decoder
    refuses is read through PIL, with a warning and an entry in
    :data:`NATIVE_FALLBACKS`."""
    out: List[Optional[Dict]] = [None] * len(samples)
    by_shard: Dict[str, List[int]] = {}
    for i, s in enumerate(samples):
        if "__raw__" in s:
            out[i] = decode_sample(s["__raw__"])
        elif "__native__" in s:
            by_shard.setdefault(s["__native__"][0], []).append(i)
        else:
            out[i] = s
    for shard, idxs in by_shard.items():
        markers = [samples[i] for i in idxs]
        try:
            decoded = _decode_markers(shard, markers, n_threads)
        except (ValueError, KeyError, OSError) as e:
            _fall_back(shard, e)
            decoded = _decode_markers_pil(shard, markers)
        for i, d in zip(idxs, decoded):
            out[i] = d
    return out  # type: ignore[return-value]


def make_sample_stream(
    shards, *, shuffle: int = 0, seed: int = 0, loop: bool = False,
    prefer_native: bool = True, n_threads: int = 4, raw: bool = False,
    cache_dir: Optional[str] = None,
) -> ShardSampleStream:
    """The native stream when ``prefer_native`` (its library is built on
    first use, and a failed build raises), else the PIL stream; ``raw``
    defers the decode (:func:`materialize_samples`)."""
    if prefer_native:
        from deadtrees_tpu_torch.data import native

        native.load()
        return NativeShardSampleStream(
            shards, shuffle=shuffle, seed=seed, loop=loop, n_threads=n_threads, raw=raw,
            cache_dir=cache_dir,
        )
    return ShardSampleStream(shards, shuffle=shuffle, seed=seed, loop=loop, raw=raw,
                             cache_dir=cache_dir)
