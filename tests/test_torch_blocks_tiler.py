"""The port's scene plumbing against the JAX package's: block math, the
Tiler, GeoTIFF IO, and the mosaic and retile stages, on the same seeded
inputs. Everything here is data movement, so every comparison is exact."""

import numpy as np
import pytest
import torch
from PIL import Image, TiffImagePlugin

from deadtrees_tpu.geo.mosaic import merge_tiles as jax_merge_tiles
from deadtrees_tpu.geo.retile import retile as jax_retile
from deadtrees_tpu.infer import blocks as jblocks
from deadtrees_tpu.infer import geotiff as jgeo
from deadtrees_tpu.infer import tiler as jtiler
from deadtrees_tpu_torch.geo import merge_tiles, retile
from deadtrees_tpu_torch.infer import blocks as tblocks
from deadtrees_tpu_torch.infer import geotiff as tgeo
from deadtrees_tpu_torch.infer import tiler as ttiler

PX = 0.25
X0, Y0 = 500000.0, 5400000.0
GEO_FULL = {
    33550: (PX, PX, 0.0),
    33922: (0.0, 0.0, 0.0, X0, Y0, 0.0),
    34735: (1, 1, 0, 1, 1024, 0, 1, 1),
    34736: (6378137.0,),
    34737: "ETRS89 / UTM 32N|",
    42112: "<GDALMetadata></GDALMetadata>",
    42113: "0",
}


def _scene(h, w, c, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)


def _write_geo_scene(path, data, x0=X0, y0=Y0):
    info = TiffImagePlugin.ImageFileDirectory_v2()
    for t, v in {**GEO_FULL, 33922: (0.0, 0.0, 0.0, x0, y0, 0.0)}.items():
        info[t] = v
    Image.fromarray(data).save(str(path), format="TIFF", tiffinfo=info)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_block_functions_match_jax(kind):
    rng = np.random.default_rng(0)
    x_chw = rng.integers(0, 256, (3, 12, 16), np.uint8)
    x_nhwc = rng.integers(0, 256, (12, 16, 4), np.uint8)
    sub = rng.integers(0, 3, (12, 4, 4), np.uint8)
    sub_c = rng.integers(0, 256, (12, 4, 4, 2), np.uint8)
    wrap = torch.from_numpy if kind == "torch" else (lambda a: a)
    cases = [
        (tblocks.make_blocks_chw(wrap(x_chw), 4), jblocks.make_blocks_chw(x_chw, 4)),
        (tblocks.unmake_blocks_chw(wrap(sub), 4, 12, 16),
         jblocks.unmake_blocks_chw(sub, 4, 12, 16)),
        (tblocks.make_blocks_nhwc(wrap(x_nhwc), 4), jblocks.make_blocks_nhwc(x_nhwc, 4)),
        (tblocks.unmake_blocks_nhwc(wrap(sub), 12, 16),
         jblocks.unmake_blocks_nhwc(sub, 12, 16)),
        (tblocks.unmake_blocks_nhwc(wrap(sub_c), 12, 16),
         jblocks.unmake_blocks_nhwc(sub_c, 12, 16)),
    ]
    for got, want in cases:
        assert isinstance(got, torch.Tensor if kind == "torch" else np.ndarray)
        got = got.numpy() if kind == "torch" else got
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(want))
    # rows of subtiles first
    np.testing.assert_array_equal(
        np.asarray(cases[2][0])[1], x_nhwc[:4, 4:8]
    )


@pytest.mark.parametrize(
    "shape,tile,sub",
    [((8192, 8192), (8192, 8192), (512, 512)), ((2649, 8192), (8192, 8192), (512, 512)),
     ((100, 150, 4), (128, 192), (64, 64)), ((40, 3000), (8192, 8192), (512, 512))],
)
def test_inspect_tile_matches_jax(shape, tile, sub):
    arr = np.zeros(shape, np.uint8)
    got, want = ttiler.inspect_tile(arr, tile, sub), jtiler.inspect_tile(arr, tile, sub)
    assert (got.size, got.subtiles) == (want.size, want.subtiles)
    defaults = ttiler.inspect_tile(arr)
    assert defaults.subtiles == jtiler.inspect_tile(arr).subtiles


@pytest.mark.parametrize("tile,sub", [((8192, 8192), (513, 513)), ((100, 128), (64, 64)),
                                      ((128, 100), (64, 64))])
def test_inspect_tile_errors(tile, sub):
    arr = np.zeros((100, 100), np.uint8)
    with pytest.raises(ValueError) as want:
        jtiler.inspect_tile(arr, tile, sub)
    with pytest.raises(ValueError) as got:
        ttiler.inspect_tile(arr, tile, sub)
    assert str(got.value) == str(want.value)
    assert not ttiler.divisible_without_remainder(8192, 0)


def test_tiler_errors():
    with pytest.raises(ValueError, match="matching x/y"):
        ttiler.Tiler(subtile_shape=(64, 32))
    t = ttiler.Tiler(tile_shape=(128, 192), subtile_shape=(64, 64))
    with pytest.raises(ValueError, match="matching x/y"):
        t.load_array(_scene(100, 150, 4, 0), subtile_shape=(64, 32))
    with pytest.raises(ValueError, match="exceeds tile_shape"):
        t.load_array(_scene(129, 150, 4, 0))


@pytest.mark.parametrize("shape", [(100, 150, 4), (128, 192, 3), (64, 70, 1), (30, 20)])
def test_tiler_matches_jax(shape):
    rng = np.random.default_rng(len(shape) + shape[0])
    data = rng.integers(0, 256, shape, np.uint8)
    tiles = []
    for mod in (ttiler, jtiler):
        t = mod.Tiler(tile_shape=(128, 192), subtile_shape=(64, 64))
        t.load_array(data)
        tiles.append(t)
    got, want = tiles
    np.testing.assert_array_equal(got.subtiles_to_use, want.subtiles_to_use)
    np.testing.assert_array_equal(got.get_batches(), want.get_batches())
    np.testing.assert_array_equal(got.get_all_batches(), want.get_all_batches())
    if shape[:2] == (128, 192):
        assert got._indata is data  # exactly tile_shape: no copy
    n = int(want.subtiles_to_use.sum())
    preds = rng.integers(0, 3, (n, 64, 64), np.uint8)
    got.put_batches(preds)
    want.put_batches(preds)
    np.testing.assert_array_equal(got.prediction, want.prediction)
    assert got.prediction.shape == shape[:2] and got.prediction.dtype == np.uint8
    full = rng.integers(0, 3, (6, 64, 64), np.uint8)
    got.put_all_batches(full)
    want.put_all_batches(full)
    np.testing.assert_array_equal(got.prediction, want.prediction)


def test_tiler_file_roundtrip_matches_jax(tmp_path):
    data = _scene(100, 150, 4, 5)
    src = tmp_path / "ortho_a.tif"
    _write_geo_scene(src, data)
    outs = []
    for mod, name in ((ttiler, "port.tif"), (jtiler, "jax.tif")):
        t = mod.Tiler(tile_shape=(128, 192), subtile_shape=(64, 64))
        t.load_file(src)
        t.put_batches(t.get_batches()[..., 0] % 3)
        t.write_file(tmp_path / name)
        outs.append(jgeo.read_geotiff(tmp_path / name))
    np.testing.assert_array_equal(outs[0].data, outs[1].data)
    assert outs[0].geo["tags"] == outs[1].geo["tags"]
    assert outs[0].bounds == outs[1].bounds == (X0, Y0 - PX * 100, X0 + PX * 150, Y0)


@pytest.mark.parametrize("shape", [(40, 56, 4), (33, 17, 3), (24, 40)])
def test_geotiff_roundtrip_both_ways(tmp_path, shape):
    data = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    geo = {"backend": "pil", "tags": dict(GEO_FULL)}
    tgeo.write_geotiff(tmp_path / "port.tif", data, geo)
    jgeo.write_geotiff(tmp_path / "jax.tif", data, geo)
    want_px = data if data.ndim == 3 else data[..., None]
    for writer in ("port", "jax"):
        path = tmp_path / f"{writer}.tif"
        a, b = tgeo.read_geotiff(path), jgeo.read_geotiff(path)
        np.testing.assert_array_equal(a.data, want_px)
        np.testing.assert_array_equal(b.data, want_px)
        assert a.geo["tags"] == b.geo["tags"]
        assert set(a.geo["tags"]) == set(GEO_FULL)
        assert a.bounds == b.bounds
        assert a.bounds == (X0, Y0 - PX * shape[0], X0 + PX * shape[1], Y0)
        assert tgeo.geotiff_size(path) == jgeo.geotiff_size(path) == shape[:2]
    assert tgeo.GEO_TAGS == jgeo.GEO_TAGS
    assert tgeo.GeoImage(data).bounds is None


def test_retile_and_mosaic_match_jax(tmp_path):
    data = _scene(96, 80, 4, 7)
    src = tmp_path / "ortho_ms_2019.tif"
    _write_geo_scene(src, data)
    got = retile(src, tmp_path / "port", tile_size=32)
    want = jax_retile(src, tmp_path / "jax", tile_size=32)
    assert got == want and len(got) == 9
    assert (tmp_path / "port" / "locations.csv").read_bytes() == (
        tmp_path / "jax" / "locations.csv").read_bytes()
    for r in got:
        a = jgeo.read_geotiff(tmp_path / "port" / r["filename"])
        b = jgeo.read_geotiff(tmp_path / "jax" / r["filename"])
        np.testing.assert_array_equal(a.data, b.data)
        assert a.geo["tags"] == b.geo["tags"]
    # the tiles' mosaic is the scene again, in both packages
    s_got = merge_tiles([tmp_path / "port"], tmp_path / "m_port.tif")
    s_want = jax_merge_tiles([tmp_path / "jax"], tmp_path / "m_jax.tif")
    assert s_got == s_want
    assert s_got["bounds"] == (X0, Y0 - PX * 96, X0 + PX * 80, Y0)
    a = jgeo.read_geotiff(tmp_path / "m_port.tif")
    b = jgeo.read_geotiff(tmp_path / "m_jax.tif")
    np.testing.assert_array_equal(a.data, data)
    np.testing.assert_array_equal(b.data, data)
    assert a.geo["tags"] == b.geo["tags"]


def test_mosaic_of_offset_tiles_matches_jax(tmp_path):
    """Two single-band tiles with a gap and an overlap (later tiles win),
    given as files, not a directory."""
    rng = np.random.default_rng(9)
    paths = []
    for k, (x0, y0) in enumerate(((X0, Y0), (X0 + 20 * PX, Y0 - 8 * PX))):
        path = tmp_path / f"tile_{k}.tif"
        _write_geo_scene(path, rng.integers(0, 3, (24, 32), np.uint8), x0, y0)
        paths.append(path)
    s_got = merge_tiles(paths, tmp_path / "m_port.tif")
    s_want = jax_merge_tiles(paths, tmp_path / "m_jax.tif")
    assert s_got == s_want and (s_got["height"], s_got["width"]) == (32, 52)
    a = jgeo.read_geotiff(tmp_path / "m_port.tif")
    b = jgeo.read_geotiff(tmp_path / "m_jax.tif")
    np.testing.assert_array_equal(a.data, b.data)
    assert a.geo["tags"] == b.geo["tags"]
    with pytest.raises(ValueError, match="no input tiles"):
        merge_tiles([], tmp_path / "x.tif")
