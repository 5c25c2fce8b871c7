"""The port's native shard reader against the JAX package's PIL path.

``deadtrees_tpu_torch.data.native`` builds its own copy of the C++ reader
with g++ at first use. Its TIFF decoder is held against the JAX package's
``image_decoder`` / ``mask_decoder`` (PIL, which needs no native library)
for every compression it reads, in strips and in tiles; its native stream
against the port's and JAX's PIL streams, sample for sample. The build is
checked for what a shared working tree needs: processes that build at
once all load, and another CPU gets another library.
"""

import io
import logging
import struct
import subprocess
import sys
import tarfile
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from deadtrees_tpu.data.tar import ShardSampleStream as JaxShardSampleStream
from deadtrees_tpu.data.tar import image_decoder, mask_decoder
from deadtrees_tpu_torch.data import native
from deadtrees_tpu_torch.data import tar as torch_tar
from deadtrees_tpu_torch.data.tar import (
    NativeShardSampleStream,
    ShardSampleStream,
    make_sample_stream,
)

REPO = Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------------------
# TIFF and shard fixtures
# ---------------------------------------------------------------------------


def pil_tiff(arr, mode, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="TIFF", **kw)
    return buf.getvalue()


def _packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as run packets, the rest as
    literal packets of at most 128 bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([(257 - (j - i)) & 0xFF, data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _lzw(block: np.ndarray) -> bytes:
    """TIFF LZW of one (rows, cols, c) block, by PIL: the payload of a
    one-strip LZW TIFF of the block."""
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[block.shape[2]]
    arr = block[..., 0] if block.shape[2] == 1 else block
    raw = pil_tiff(arr, mode, compression="tiff_lzw")
    im = Image.open(io.BytesIO(raw))
    offsets, counts = im.tag_v2[273], im.tag_v2[279]
    assert len(offsets) == 1, "the block must fit one strip"
    return raw[offsets[0]:offsets[0] + counts[0]]


def _encode(block: np.ndarray, compression: int, predictor: int) -> bytes:
    if predictor == 2:
        diff = block.astype(np.int16)
        diff[:, 1:] -= block[:, :-1].astype(np.int16)
        block = diff.astype(np.uint8)
    if compression == 1:
        return block.tobytes()
    if compression == 5:
        return _lzw(block)
    if compression == 8:
        return zlib.compress(block.tobytes(), 6)
    if compression == 32773:
        return _packbits(block.tobytes())
    raise ValueError(compression)


def build_tiff(img: np.ndarray, *, compression: int = 1, predictor: int = 1,
               tile=None, rows_per_strip=None, planar: int = 1, bits: int = 8,
               strip_payloads=None) -> bytes:
    """A little-endian baseline TIFF of ``img`` (H, W, C) uint8: strips of
    ``rows_per_strip`` rows, or tiles of ``tile`` = (w, h) padded at the
    edges; ``planar=2`` stores one plane after another (strips only);
    4 bands carry unassociated alpha (ExtraSamples = 2), as PIL writes RGBA."""
    h, w, c = img.shape
    segments = []
    if tile is not None:
        tw, th = tile
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                t = np.zeros((th, tw, c), np.uint8)
                part = img[y0:y0 + th, x0:x0 + tw]
                t[:part.shape[0], :part.shape[1]] = part
                segments.append(_encode(t, compression, predictor))
    else:
        rps = rows_per_strip or h
        planes = [img[..., k:k + 1] for k in range(c)] if planar == 2 else [img]
        for plane in planes:
            for y0 in range(0, h, rps):
                segments.append(_encode(plane[y0:y0 + rps], compression, predictor))
        if strip_payloads is not None:
            segments = strip_payloads
    n = len(segments)
    tags = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, c, None), (259, 3, 1, compression),
            (262, 3, 1, 1 if c == 1 else 2), (277, 3, 1, c), (284, 3, 1, planar),
            (317, 3, 1, predictor)]
    if c == 4:
        tags.append((338, 3, 1, 2))
    if tile is not None:
        tags += [(322, 3, 1, tile[0]), (323, 3, 1, tile[1]), (324, 4, n, None),
                 (325, 4, n, None)]
    else:
        tags += [(273, 4, n, None), (278, 3, 1, rows_per_strip or h), (279, 4, n, None)]
    tags.sort()
    ifd_off = 8
    arrays_off = ifd_off + 2 + 12 * len(tags) + 4
    bits_off = arrays_off
    offs_off = bits_off + 2 * c
    cnts_off = offs_off + 4 * n
    data_off = cnts_off + 4 * n
    offsets, pos = [], data_off
    for s in segments:
        offsets.append(pos)
        pos += len(s)
    ifd = struct.pack("<H", len(tags))
    for tag, typ, count, value in tags:
        if tag == 258:
            value = bits if c == 1 else bits_off
        elif tag in (273, 324):
            value = offsets[0] if n == 1 else offs_off
        elif tag in (279, 325):
            value = len(segments[0]) if n == 1 else cnts_off
        ifd += struct.pack("<HHII", tag, typ, count, value)
    ifd += struct.pack("<I", 0)
    blob = struct.pack("<2sHI", b"II", 42, ifd_off) + ifd
    blob += struct.pack(f"<{c}H", *([bits] * c))
    blob += struct.pack(f"<{n}I", *offsets) + struct.pack(f"<{n}I", *map(len, segments))
    return blob + b"".join(segments)


def write_shard(path: Path, n: int, *, size: int = 32, seed: int = 0, prefix: str = "tile",
                with_lu: bool = True, encode=None):
    """A wds-style shard of ``n`` samples (``{key}.rgbn.tif``, ``.mask.tif``,
    ``.lu.tif``, ``.txt``), TIFFs written by PIL uncompressed unless
    ``encode(arr, mode)`` says otherwise. Returns the keys."""
    encode = encode or pil_tiff
    rng = np.random.default_rng(seed)
    keys = []
    path.parent.mkdir(parents=True, exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            key = f"{prefix}_{i:04d}"
            keys.append(key)
            mask = rng.integers(0, 3, (size, size), dtype=np.uint8)
            members = [("rgbn.tif", encode(rng.integers(0, 256, (size, size, 4), np.uint8),
                                           "RGBA")),
                       ("mask.tif", encode(mask, "L"))]
            if with_lu:
                members.append(("lu.tif", encode(rng.integers(0, 2, (size, size), np.uint8),
                                                 "L")))
            members.append(("txt", f"{float(mask.astype(bool).mean() * 100):.2f}".encode()))
            for suffix, data in members:
                info = tarfile.TarInfo(f"{key}.{suffix}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return keys


def assert_same_samples(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["stats"] == w["stats"]
        assert sorted(g) == sorted(w)
        for k in ("image", "mask", "lu"):
            if k in w:
                assert g[k].dtype == np.uint8 and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{g['stats']} {k}")


# ---------------------------------------------------------------------------
# the TIFF decoder
# ---------------------------------------------------------------------------

COMPRESSIONS = {  # name: (tag, predictor)
    "none": (1, 1),
    "lzw": (5, 1),
    "packbits": (32773, 1),
    "deflate": (8, 1),
    "deflate-predictor2": (8, 2),
}


@pytest.mark.parametrize("bands", [4, 1], ids=["rgbn", "mask"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("compression", list(COMPRESSIONS))
def test_tiff_decode_matches_jax_pil(compression, layout, bands):
    """Every compression in strips (3 strips, the last short) and in tiles
    (a ragged 3 x 2 grid of 16² tiles) decodes to the pixels JAX's PIL
    decoders give."""
    tag, predictor = COMPRESSIONS[compression]
    rng = np.random.default_rng(zlib.crc32(f"{compression}/{layout}/{bands}".encode()))
    img = rng.integers(0, 256, (40, 36, bands), dtype=np.uint8)
    img[5:20, 3:30] = 7  # runs, for PackBits' run packets and LZW's table
    geometry = {"tile": (16, 16)} if layout == "tiles" else {"rows_per_strip": 16}
    blob = build_tiff(img, compression=tag, predictor=predictor, **geometry)
    got = native.tiff_decode(blob)
    if bands == 4:
        want = image_decoder(blob)
    else:
        want = mask_decoder(blob)[..., None]
        got = got[..., None]
    np.testing.assert_array_equal(want, img)  # the fixture is the TIFF it claims
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compression", [None, "tiff_lzw", "packbits", "tiff_adobe_deflate"])
def test_tiff_decode_of_pil_written_files(compression):
    """The files PIL writes (the shard writer's format, and its
    compressions) decode to JAX's pixels."""
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (48, 40, 4), dtype=np.uint8)
    gray = rng.integers(0, 3, (48, 40), dtype=np.uint8)
    kw = {"compression": compression} if compression else {}
    blob = pil_tiff(rgba, "RGBA", **kw)
    np.testing.assert_array_equal(native.tiff_decode(blob), image_decoder(blob))
    blob = pil_tiff(gray, "L", **kw)
    np.testing.assert_array_equal(native.tiff_decode(blob), mask_decoder(blob))


REJECTED = {
    "planar2-one-strip-per-plane": {"rows_per_strip": 8, "planar": 2},
    "planar2-multistrip": {"rows_per_strip": 4, "planar": 2},
    "strip-table-mismatch": {"rows_per_strip": 2, "strip_payloads": "double"},
    "16-bit-samples": {"bits": 16},
}


@pytest.mark.parametrize("case", list(REJECTED))
def test_rejected_layouts_raise(case):
    """Layouts the decoder refuses by design raise ``ValueError`` (the
    stream then reads the shard through PIL), and never write past the
    buffer."""
    img = np.random.default_rng(4).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    kw = dict(REJECTED[case])
    if kw.get("strip_payloads") == "double":
        rows = [img[y:y + 2].tobytes() for y in range(0, 8, 2)]
        kw["strip_payloads"] = rows + rows
    with pytest.raises(ValueError):
        native.tiff_decode(build_tiff(img, **kw))


# ---------------------------------------------------------------------------
# tar index, batch decode, threads
# ---------------------------------------------------------------------------


def test_tar_index_matches_tarfile(tmp_path):
    shard = tmp_path / "s-000000.tar"
    write_shard(shard, 5)
    with tarfile.open(shard) as tf:
        want = [(m.name, m.offset_data, m.size) for m in tf if m.isfile()]
    assert native.tar_index(str(shard)) == want
    # the buffer's default bound is exact: a smaller cap truncates the index
    assert native.tar_index(str(shard), max_entries=3) == want[:3]
    with pytest.raises(OSError):
        native.tar_index(str(tmp_path / "missing.tar"))
    groups = native.index_shard_samples(str(shard))
    assert list(groups) == [f"tile_{i:04d}" for i in range(5)]
    assert sorted(groups["tile_0000"]) == ["lu.tif", "mask.tif", "rgbn.tif", "txt"]


def test_decode_batch_matches_per_member_decode(tmp_path):
    shard = tmp_path / "s-000000.tar"
    write_shard(shard, 6, encode=lambda a, m: pil_tiff(a, m, compression="tiff_adobe_deflate"))
    groups = native.index_shard_samples(str(shard))
    extents = [g["rgbn.tif"] for g in groups.values()]
    got = native.decode_batch(str(shard), extents, (32, 32, 4), n_threads=3)
    data = shard.read_bytes()
    want = np.stack([image_decoder(data[o:o + n]) for o, n in extents])
    np.testing.assert_array_equal(got, want)
    # a member of other dims is refused, not written past its slot
    with pytest.raises(ValueError):
        native.decode_batch(str(shard), extents, (16, 32, 4))
    masks = [g["mask.tif"] for g in groups.values()]
    with pytest.raises(ValueError):
        native.decode_batch(str(shard), extents[:2] + masks[:1], (32, 32, 4))


def test_effective_threads_clamps_to_cores(monkeypatch):
    import os

    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    assert native.effective_threads(8) == 4
    assert native.effective_threads(2) == 2
    assert native.effective_threads(0) == 1
    monkeypatch.setattr(os, "cpu_count", lambda: None)
    assert native.effective_threads(8) == 1


# ---------------------------------------------------------------------------
# the native stream against the PIL streams
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    paths = []
    for i in range(3):
        p = d / f"train-{i:06d}.tar"
        write_shard(p, 7, seed=i, prefix=f"s{i}", with_lu=i != 1)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("shuffle", [0, 1, 5])
def test_native_stream_matches_the_pil_streams(shards, shuffle):
    """With one seed, the native stream, the port's PIL stream and JAX's PIL
    stream give the same samples in the same order: pixels bit-equal,
    stats equal, over two passes of a looping stream."""
    def take(stream, n=2 * 21):
        out = []
        for s in stream:
            out.append(s)
            if len(out) == n:
                return out
        return out

    kw = dict(shuffle=shuffle, seed=11, loop=True)
    torch_tar.NATIVE_FALLBACKS.clear()
    got = take(make_sample_stream(shards, prefer_native=True, n_threads=2, **kw))
    pil = take(make_sample_stream(shards, prefer_native=False, **kw))
    jax_pil = take(JaxShardSampleStream(shards, **kw))
    assert len(got) == 42
    assert_same_samples(got, jax_pil)
    assert_same_samples(pil, jax_pil)
    assert torch_tar.NATIVE_FALLBACKS == []


def test_make_sample_stream_picks_the_reader(shards):
    assert type(make_sample_stream(shards)) is NativeShardSampleStream
    assert type(make_sample_stream(shards, prefer_native=False)) is ShardSampleStream
    assert make_sample_stream(shards, n_threads=3).n_threads == 3
    with pytest.raises(ValueError, match="at least one shard"):
        make_sample_stream([], loop=True)


def test_undecodable_shard_falls_back_to_pil_counted(tmp_path, caplog):
    """A shard whose TIFFs the C++ decoder refuses (planar) gives the PIL
    stream's samples, with one warning and one counted fallback a read."""
    planar = tmp_path / "planar-000000.tar"
    plain = tmp_path / "plain-000001.tar"
    write_shard(planar, 3, encode=lambda a, m: build_tiff(
        a if a.ndim == 3 else a[..., None], planar=2 if a.ndim == 3 else 1,
        rows_per_strip=16))
    write_shard(plain, 3, seed=1, prefix="p")
    shards = [str(planar), str(plain)]
    torch_tar.NATIVE_FALLBACKS.clear()
    with caplog.at_level(logging.WARNING, logger="deadtrees_tpu_torch.data.tar"):
        got = list(make_sample_stream(shards, prefer_native=True))
    assert torch_tar.NATIVE_FALLBACKS == [str(planar)]
    assert sum("reading it through PIL" in r.message for r in caplog.records) == 1
    assert_same_samples(got, list(JaxShardSampleStream(shards)))
    list(make_sample_stream(shards, prefer_native=True))
    assert torch_tar.NATIVE_FALLBACKS == [str(planar)] * 2


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

_BUILD_AND_DECODE = """
import sys, time
from pathlib import Path
import numpy as np
from deadtrees_tpu_torch.data import native
native.BUILD_DIR = Path(sys.argv[1])
go = Path(sys.argv[2])
while not go.exists():
    time.sleep(0.005)
lib = native.load()
img = np.arange(12 * 10 * 4, dtype=np.uint8).reshape(12, 10, 4)
import io
from PIL import Image
buf = io.BytesIO()
Image.fromarray(img, "RGBA").save(buf, format="TIFF")
assert np.array_equal(native.tiff_decode(buf.getvalue()), img)
print(lib._name)
"""


def test_processes_building_at_once_all_load(tmp_path):
    """Six processes build into one empty directory at the same moment:
    each compiles into a temporary of its own and publishes it by rename,
    so every one loads a whole library and one file is left."""
    build_dir, go = tmp_path / "build", tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_DECODE, str(build_dir), str(go)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    time.sleep(1.0)  # let them reach the start line
    go.touch()
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert [p.name for p in build_dir.iterdir()] == [Path(names.pop()).name]


def test_library_name_keys_on_the_cpu_source_and_flags(monkeypatch, tmp_path):
    here = native.library_path(tmp_path)
    assert here == native.library_path(tmp_path, cpu=native.cpu_fingerprint())
    assert here.parent == tmp_path and here.name.startswith("libdeadtrees_io-")
    other = native.library_path(tmp_path, cpu=native.cpu_fingerprint(
        "processor\t: 0\nvendor_id\t: AuthenticAMD\nmodel name\t: AMD EPYC 9654\n"
        "flags\t\t: fpu sse2 avx2 avx512f\n\nprocessor\t: 1\n"))
    assert other != here
    # the first processor's model and feature flags make the fingerprint
    fp = native.cpu_fingerprint("model name\t: X\nflags\t\t: avx2\n\nmodel name\t: Y\n")
    assert "X" in fp and "avx2" in fp and "Y" not in fp
    assert fp != native.cpu_fingerprint("model name\t: X\nflags\t\t: avx2 avx512f\n")
    monkeypatch.setattr(native, "CXX_FLAGS", (*native.CXX_FLAGS, "-DOTHER"))
    assert native.library_path(tmp_path) != here


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "deadtrees_io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="error"):
        native.build(tmp_path / "build")
    assert list((tmp_path / "build").iterdir()) == []  # no torn or stale file
