"""The port's shapefile, rasterizer and GeoTIFF read against the JAX package.

``tests/test_geo.py``'s checks point for point (its synthetic shapefile:
a polygon with a hole and a triangle, with a DBF ``type`` column), each on
the port and held equal to the JAX package's answer: records and
attributes equal, rasterized masks bit-equal (with and without
``all_touched``), written files byte-equal and read back by the JAX
reader. ``read_geotiff`` decodes through the native reader with PIL's
pixels (LZW strips, deflate), and a 16-bit file it refuses falls back to
PIL with an entry in ``data.tar.NATIVE_FALLBACKS``. The createmasks
script of ``tests/test_geo.py`` is the JAX package's own and has no port.
"""

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from deadtrees_tpu.geo import raster as jax_raster
from deadtrees_tpu.geo import shapefile as jax_shapefile
from deadtrees_tpu.infer.geotiff import read_geotiff as jax_read_geotiff
from deadtrees_tpu_torch import geo
from deadtrees_tpu_torch.data import tar as tar_mod
from deadtrees_tpu_torch.geo import shapefile as port_shapefile
from deadtrees_tpu_torch.infer.geotiff import read_geotiff
from tests.test_geo import shapefile  # noqa: F401 - the fixture


def test_exports_are_the_jax_names():
    import deadtrees_tpu.geo as jax_geo

    assert sorted(geo.__all__) == sorted(jax_geo.__all__)


@pytest.mark.parametrize("ring", [
    [(0, 0), (0, 10), (10, 10), (10, 0)],
    [(0, 0), (10, 0), (10, 10), (0, 10)],
    [(60, 60), (60, 90), (90, 60), (60, 60)],
])
def test_ring_winding(ring):
    area = port_shapefile.ring_signed_area(ring)
    assert area == jax_shapefile.ring_signed_area(ring)
    assert (area < 0) == (port_shapefile.ring_signed_area(ring[::-1]) > 0)


def test_read_shapefile_and_dbf(shapefile):  # noqa: F811
    recs = geo.read_shapefile(shapefile)
    assert recs == jax_shapefile.read_shapefile(shapefile)
    assert len(recs) == 2 and len(recs[0]["rings"]) == 2  # outer + hole
    assert recs[0]["bbox"] == (10.0, 10.0, 40.0, 40.0)
    assert [r["attributes"]["type"] for r in recs] == ["1", "2"]
    assert geo.read_shp(shapefile) == jax_shapefile.read_shp(shapefile)
    dbf = shapefile.with_suffix(".dbf")
    assert geo.read_dbf(dbf) == jax_shapefile.read_dbf(dbf)


@pytest.mark.parametrize("all_touched", [True, False])
def test_rasterize_is_bit_equal(shapefile, all_touched):  # noqa: F811
    recs = geo.read_shapefile(shapefile)
    for polys, bounds, size in (([recs[0]], (0, 0, 100, 100), (100, 100)),
                                ([recs[1]], (0, 0, 100, 100), (100, 100)),
                                (recs, (5, 5, 95, 80), (37, 53))):
        got = geo.rasterize(polys, bounds=bounds, size=size, all_touched=all_touched,
                            burn_value=2)
        want = jax_raster.rasterize(polys, bounds=bounds, size=size, all_touched=all_touched,
                                    burn_value=2)
        np.testing.assert_array_equal(got, want)
    mask = geo.rasterize([recs[0]], bounds=(0, 0, 100, 100), size=(100, 100))
    assert mask[75, 15] == 1 and mask[75, 25] == 0 and mask[50, 50] == 0  # y flipped
    ring = recs[0]["rings"][0]
    assert geo.world_to_pixel(ring, (0, 0, 100, 100), (50, 70)) == \
        jax_raster.world_to_pixel(ring, (0, 0, 100, 100), (50, 70))


@pytest.mark.parametrize("a, b", [((0, 0, 10, 10), (5, 5, 15, 15)),
                                  ((0, 0, 10, 10), (11, 0, 20, 10)),
                                  ((0, 0, 10, 10), (10, 10, 20, 20))])
def test_bbox_intersects(a, b):
    assert geo.bbox_intersects(a, b) == jax_raster.bbox_intersects(a, b)


RECORDS = [
    {"rings": [[(0.0, 0.0), (0.0, 10.0), (10.0, 10.0), (10.0, 0.0)]],
     "attributes": {"conifer": 1.25, "broadleaf": 2.5, "total": 3.75}},
    {"rings": [[(20.0, 20.0), (20.0, 30.0), (30.0, 30.0), (30.0, 20.0)]],
     "attributes": {"conifer": None, "broadleaf": 0.0, "total": 0.0}},
]
# both rings counter-clockwise on purpose: the writer orients them
HOLES = [{"rings": [[(10.0, 10.0), (40.0, 10.0), (40.0, 40.0), (10.0, 40.0)],
                    [(20.0, 20.0), (30.0, 20.0), (30.0, 30.0), (20.0, 30.0)]],
          "attributes": {}}]


@pytest.mark.parametrize("case", ["attributes", "hole"])
def test_written_shapefiles_are_the_jax_bytes(tmp_path, case):
    records, kw = (RECORDS, {"crs_wkt": 'PROJCS["t"]'}) if case == "attributes" else (
        HOLES, {"fields": []})
    port_shapefile.write_shapefile(tmp_path / "port", records, **kw)
    jax_shapefile.write_shapefile(tmp_path / "jax", records, **kw)
    for suffix in (".shp", ".shx", ".dbf") + ((".prj",) if case == "attributes" else ()):
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            (tmp_path / f"jax{suffix}").read_bytes(), suffix
    out = jax_shapefile.read_shapefile(tmp_path / "port")  # read back by the JAX reader
    assert out == geo.read_shapefile(tmp_path / "port")
    assert all(port_shapefile.ring_signed_area(r["rings"][0]) <= 0 for r in out)
    if case == "attributes":
        assert abs(float(out[0]["attributes"]["conifer"]) - 1.25) < 1e-9
        assert out[1]["attributes"]["conifer"] == ""  # None: an empty DBF cell
        assert port_shapefile.read_prj(tmp_path / "port.shp") == 'PROJCS["t"]'
    else:
        assert port_shapefile.ring_signed_area(out[0]["rings"][1]) > 0  # hole: counter-cw
        mask = geo.rasterize(out, bounds=(0, 0, 50, 50), size=(50, 50))
        assert mask[25, 15] == 1 and mask[25, 25] == 0
        np.testing.assert_array_equal(
            mask, jax_raster.rasterize(out, bounds=(0, 0, 50, 50), size=(50, 50)))


def _geo_info():
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[33550] = (0.2, 0.2, 0.0)
    info[33922] = (0.0, 0.0, 0.0, 500000.0, 5400000.0, 0.0)
    return info


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate", None])
def test_read_geotiff_decodes_natively(tmp_path, monkeypatch, compression):
    monkeypatch.setattr(tar_mod, "NATIVE_FALLBACKS", [])
    data = np.random.default_rng(4).integers(0, 255, (40, 56, 4), dtype=np.uint8)
    p = tmp_path / "scene.tif"
    Image.fromarray(data, "RGBA").save(str(p), format="TIFF", tiffinfo=_geo_info(),
                                       compression=compression)
    img, ref = read_geotiff(p), jax_read_geotiff(p)
    np.testing.assert_array_equal(img.data, data)
    np.testing.assert_array_equal(img.data, ref.data)
    assert img.geo == {"backend": "pil", "tags": ref.geo["tags"], "decoder": "native"}
    assert img.bounds == ref.bounds
    assert not tar_mod.NATIVE_FALLBACKS


def test_read_geotiff_falls_back_to_pil_and_counts_it(tmp_path, monkeypatch):
    monkeypatch.setattr(tar_mod, "NATIVE_FALLBACKS", [])
    mask16 = np.random.default_rng(5).integers(0, 60000, (16, 16), dtype=np.uint16)
    p = tmp_path / "mask16.tif"
    Image.fromarray(mask16, "I;16").save(str(p), format="TIFF", tiffinfo=_geo_info())
    img = read_geotiff(p)
    assert img.geo["decoder"] == "pil"
    np.testing.assert_array_equal(np.squeeze(img.data), mask16)
    np.testing.assert_array_equal(img.data, jax_read_geotiff(p).data)
    assert tar_mod.NATIVE_FALLBACKS == [str(p)]
