"""Mosaic predicted tiles into one georeferenced raster.

Counterpart of ``deadtrees_tpu.geo.mosaic``: the first-party analogue of
the ``gdal_merge.py`` step that glues the predicted tiles of a year into
one GeoTIFF. Header-only scans place every tile on the union grid. The
backends mirror ``infer/geotiff.py``:

1. rasterio present (``HAVE_RASTERIO``): windowed writes into one open
   dataset (BigTIFF when needed), without the mosaic in memory;
2. otherwise PIL: the tiles are assembled into a disk-backed
   ``np.memmap`` and saved once, with the GeoTIFF tags synthesized (pixel
   scale from the tiles, tie point at the union's top-left). PIL cannot
   write BigTIFF, so outputs over 4 GB need rasterio.

Overlap semantics match gdal_merge: later tiles win.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from deadtrees_tpu_torch.infer.geotiff import GEO_TAGS, HAVE_RASTERIO

log = logging.getLogger(__name__)


@dataclass
class PixelGrid:
    """North-up pixel grid: (x0, y0) is the top-left corner in CRS units,
    (sx, sy) the positive pixel sizes (y decreases with row index)."""

    x0: float
    y0: float
    sx: float
    sy: float


class TileMeta:
    """Placement facts for one tile, read from the header only (no pixel
    decode: PIL is lazy until ``np.asarray``; rasterio ``open`` reads the
    IFD only)."""

    def __init__(
        self,
        path: Path,
        height: int,
        width: int,
        bands: int,
        grid: PixelGrid,
        dtype: np.dtype,
    ):
        self.path = path
        self.height = height
        self.width = width
        self.bands = bands
        self.grid = grid
        self.dtype = dtype

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        """(xmin, ymin, xmax, ymax) in CRS units."""
        g = self.grid
        return (
            g.x0,
            g.y0 - g.sy * self.height,
            g.x0 + g.sx * self.width,
            g.y0,
        )


def _meta_from_header(path: Union[str, Path]) -> TileMeta:
    path = Path(path)
    if HAVE_RASTERIO:
        import rasterio

        with rasterio.open(str(path)) as src:
            t = src.transform
            if t.b or t.d:
                raise ValueError(f"{path}: rotated rasters are unsupported")
            grid = PixelGrid(x0=t.c, y0=t.f, sx=t.a, sy=-t.e)
            return TileMeta(
                path, src.height, src.width, src.count, grid,
                np.dtype(src.dtypes[0]),
            )

    from PIL import Image

    _PIL_MODE_DTYPES = {
        "1": np.dtype("uint8"), "L": np.dtype("uint8"), "P": np.dtype("uint8"),
        "LA": np.dtype("uint8"), "RGB": np.dtype("uint8"),
        "RGBA": np.dtype("uint8"),
        "I": np.dtype("int32"), "F": np.dtype("float32"),
    }
    with Image.open(str(path)) as img:
        w, h = img.size
        tags = {t: img.tag_v2[t] for t in GEO_TAGS if t in img.tag_v2}
        bands = len(img.getbands())
        if img.mode.startswith("I;16"):
            dtype = np.dtype("uint16")
        elif img.mode in _PIL_MODE_DTYPES:
            dtype = _PIL_MODE_DTYPES[img.mode]
        else:
            raise ValueError(
                f"{path}: unsupported PIL mode {img.mode!r} for mosaicking"
            )
    scale, tie = tags.get(33550), tags.get(33922)
    if not scale or not tie or len(tie) < 6:
        raise ValueError(f"{path}: no GeoTIFF scale/tiepoint tags — cannot place tile")
    grid = PixelGrid(
        x0=float(tie[3]), y0=float(tie[4]),
        sx=float(scale[0]), sy=float(scale[1]),
    )
    meta = TileMeta(path, h, w, bands, grid, dtype)
    meta.tags = tags  # carried to synthesize the mosaic's tags
    return meta


def _union_grid(metas: Sequence[TileMeta]) -> Tuple[PixelGrid, int, int]:
    """Union extent of all tiles as (grid anchored at top-left, H, W).

    All tiles must share the pixel scale (gdal_merge resamples otherwise;
    predicted tiles never disagree, so a mismatch is an input error here).
    """
    sx, sy = metas[0].grid.sx, metas[0].grid.sy
    for m in metas[1:]:
        if not (
            np.isclose(m.grid.sx, sx, rtol=1e-6)
            and np.isclose(m.grid.sy, sy, rtol=1e-6)
        ):
            raise ValueError(
                f"{m.path}: pixel scale ({m.grid.sx}, {m.grid.sy}) differs "
                f"from first tile ({sx}, {sy})"
            )
    xmin = min(m.bounds[0] for m in metas)
    ymin = min(m.bounds[1] for m in metas)
    xmax = max(m.bounds[2] for m in metas)
    ymax = max(m.bounds[3] for m in metas)
    # Every origin must sit ON the shared grid: _placement round()s the
    # offset, so a misaligned tile would be silently snapped up to half a
    # pixel (and could overrun the union extent). Fail with the tile named.
    for m in metas:
        fx = abs((m.grid.x0 - xmin) / sx) % 1.0
        fy = abs((ymax - m.grid.y0) / sy) % 1.0
        if min(fx, 1.0 - fx) > 1e-3 or min(fy, 1.0 - fy) > 1e-3:
            raise ValueError(
                f"{m.path}: origin ({m.grid.x0}, {m.grid.y0}) is not on the "
                f"shared pixel grid (anchor ({xmin}, {ymax}), scale "
                f"({sx}, {sy})) — tiles must align to one grid to mosaic"
            )
    width = int(round((xmax - xmin) / sx))
    height = int(round((ymax - ymin) / sy))
    return PixelGrid(x0=xmin, y0=ymax, sx=sx, sy=sy), height, width


def _placement(meta: TileMeta, grid: PixelGrid) -> Tuple[int, int]:
    """(row_off, col_off) of the tile's top-left on the union grid."""
    col = int(round((meta.grid.x0 - grid.x0) / grid.sx))
    row = int(round((grid.y0 - meta.grid.y0) / grid.sy))
    return row, col


def merge_tiles(
    inputs: Sequence[Union[str, Path]],
    out_path: Union[str, Path],
    *,
    pattern: str = "*.tif",
    compress: str = "LZW",
    nodata: int = 0,
) -> Dict:
    """Mosaic georeferenced tiles into ``out_path``.

    ``inputs`` mixes files and directories (directories expand via
    ``pattern``, sorted, as a shell glob hands them to gdal_merge).
    Returns a summary dict {tiles, height, width, bounds}.
    """
    paths: List[Path] = []
    for item in inputs:
        p = Path(item)
        if p.is_dir():
            paths.extend(sorted(p.glob(pattern)))
        else:
            paths.append(p)
    if not paths:
        raise ValueError(f"no input tiles (inputs={list(map(str, inputs))!r})")

    metas = [_meta_from_header(p) for p in paths]
    bands = metas[0].bands
    dtype = metas[0].dtype
    for m in metas[1:]:
        if m.bands != bands:
            raise ValueError(f"{m.path}: band count {m.bands} != {bands}")
    grid, height, width = _union_grid(metas)
    log.info(
        "mosaic %s: %d tiles -> %dx%d px", out_path, len(metas), height, width
    )

    if HAVE_RASTERIO:
        _merge_rasterio(metas, out_path, grid, height, width, bands, dtype,
                        compress, nodata)
    else:
        _merge_pil(metas, out_path, grid, height, width, bands, dtype,
                   compress, nodata)
    return {
        "tiles": len(metas),
        "height": height,
        "width": width,
        "bounds": (grid.x0, grid.y0 - grid.sy * height,
                   grid.x0 + grid.sx * width, grid.y0),
    }


def _merge_rasterio(metas, out_path, grid, height, width, bands, dtype,
                    compress, nodata) -> None:
    import rasterio
    from rasterio.transform import Affine
    from rasterio.windows import Window

    crs = None
    with rasterio.open(str(metas[0].path)) as src:
        crs = src.crs
    transform = Affine(grid.sx, 0.0, grid.x0, 0.0, -grid.sy, grid.y0)
    with rasterio.open(
        str(out_path), "w", driver="GTiff",
        height=height, width=width, count=bands, dtype=dtype,
        crs=crs, transform=transform, nodata=nodata,
        compress=compress.lower(), tiled=True,
        bigtiff="IF_SAFER",
    ) as dst:
        for m in metas:
            row, col = _placement(m, grid)
            with rasterio.open(str(m.path)) as src:
                if crs is not None and src.crs is not None and src.crs != crs:
                    raise ValueError(
                        f"{m.path}: CRS {src.crs} differs from first tile "
                        f"({crs}) — reproject before mosaicking"
                    )
                data = src.read()
            dst.write(data, window=Window(col, row, m.width, m.height))


def _merge_pil(metas, out_path, grid, height, width, bands, dtype,
               compress, nodata) -> None:
    import tempfile

    from PIL import Image, TiffImagePlugin

    shape = (height, width) if bands == 1 else (height, width, bands)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if nbytes > (1 << 32) - (1 << 20):
        raise ValueError(
            f"mosaic would be {nbytes / 1e9:.1f} GB — beyond classic TIFF; "
            "the BigTIFF windowed-write path needs rasterio"
        )
    with tempfile.NamedTemporaryFile(suffix=".mosaic.raw") as tmp:
        canvas = np.memmap(tmp.name, dtype=dtype, mode="w+", shape=shape)
        canvas[:] = nodata
        for m in metas:
            row, col = _placement(m, grid)
            with Image.open(str(m.path)) as img:
                data = np.asarray(img)
            if data.ndim == 2 and bands > 1:
                raise ValueError(f"{m.path}: band count mismatch")
            canvas[row:row + m.height, col:col + m.width] = data
        canvas.flush()

        tags = dict(getattr(metas[0], "tags", {}))
        tags[33550] = (float(grid.sx), float(grid.sy), 0.0)
        tags[33922] = (0.0, 0.0, 0.0, float(grid.x0), float(grid.y0), 0.0)
        tiffinfo = TiffImagePlugin.ImageFileDirectory_v2()
        for t, v in tags.items():
            tiffinfo[t] = v
        img = Image.fromarray(np.asarray(canvas))
        img.save(
            str(out_path), format="TIFF",
            compression="tiff_lzw" if compress.upper() == "LZW" else None,
            tiffinfo=tiffinfo,
        )
