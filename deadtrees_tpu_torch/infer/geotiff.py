"""Minimal GeoTIFF IO for scene inference.

Counterpart of ``deadtrees_tpu.infer.geotiff``, with its layered backend:

1. rasterio, when it imports (``HAVE_RASTERIO``; full GDAL fidelity);
2. otherwise PIL reads the TIFF's tags and ROUND-TRIPS the GeoTIFF
   georeferencing tags (ModelPixelScale 33550, ModelTiepoint 33922,
   ModelTransformation 34264, GeoKeyDirectory 34735, GeoDoubleParams 34736,
   GeoAsciiParams 34737, GDAL metadata 42112 / nodata 42113) onto outputs
   so predictions stay geo-registered; the pixels are decoded by the
   native reader (``data/native.py``: strips and tiles, every compression
   GDAL writes), and a file it refuses (16-bit samples, planar layouts)
   through PIL, with a warning and an entry in
   ``data.tar.NATIVE_FALLBACKS``, the shard reader's record.

Arrays are exchanged as (H, W) or (H, W, C) numpy.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

log = logging.getLogger(__name__)

try:
    import rasterio  # type: ignore

    HAVE_RASTERIO = True
except Exception:  # pragma: no cover
    rasterio = None
    HAVE_RASTERIO = False

# GeoTIFF + GDAL private tags to preserve
GEO_TAGS = (33550, 33922, 34264, 34735, 34736, 34737, 42112, 42113)


class GeoImage:
    """An (H, W[, C]) array plus opaque georeferencing to round-trip."""

    def __init__(self, data: np.ndarray, geo: Optional[Dict] = None):
        self.data = data
        self.geo = geo or {}

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    @property
    def bounds(self) -> Optional[Tuple[float, float, float, float]]:
        """(xmin, ymin, xmax, ymax) in CRS units, or None when ungeoreferenced
        (rioxarray's ``ds.rio.bounds()``)."""
        h, w = self.data.shape[:2]
        if self.geo.get("backend") == "rasterio" and self.geo.get("transform"):
            t = self.geo["transform"]
            xs = [t.c, t.c + t.a * w]
            ys = [t.f, t.f + t.e * h]
            return (min(xs), min(ys), max(xs), max(ys))
        tags = self.geo.get("tags", {})
        scale, tie = tags.get(33550), tags.get(33922)
        if scale and tie and len(tie) >= 6:
            sx, sy = float(scale[0]), float(scale[1])
            x0, y0 = float(tie[3]), float(tie[4])
            return (x0, y0 - sy * h, x0 + sx * w, y0)
        return None


def geotiff_size(path: Union[str, Path]) -> Tuple[int, int]:
    """(H, W) from the TIFF header without decoding pixel data (the scene
    CLI sizes its tile shape from it)."""
    path = str(path)
    if HAVE_RASTERIO:
        with rasterio.open(path) as src:
            return (src.height, src.width)
    from PIL import Image

    with Image.open(path) as img:
        w, h = img.size
    return (h, w)


def read_geotiff(path: Union[str, Path]) -> GeoImage:
    """Read a scene as (H, W, C) uint8/uint16 + georeferencing blob
    (``geo["decoder"]``: ``"native"`` or ``"pil"`` on the PIL backend)."""
    path = str(path)
    if HAVE_RASTERIO:
        with rasterio.open(path) as src:
            data = src.read()  # (C, H, W)
            data = np.transpose(data, (1, 2, 0))
            geo = {
                "backend": "rasterio",
                "crs": src.crs,
                "transform": src.transform,
                "nodata": src.nodata,
            }
        return GeoImage(data, geo)

    from PIL import Image

    # PIL opens lazily: reading tag_v2 here parses the IFD only
    with Image.open(path) as img:
        tags = {}
        if hasattr(img, "tag_v2"):
            for t in GEO_TAGS:
                if t in img.tag_v2:
                    tags[t] = img.tag_v2[t]

    # pixels through the native reader; a file it refuses through PIL, counted
    try:
        from deadtrees_tpu_torch.data import native

        data = native.tiff_decode(Path(path).read_bytes())
        decoder = "native"
    except ValueError as e:
        from deadtrees_tpu_torch.data.tar import NATIVE_FALLBACKS

        log.warning(f"native decode of {path} failed ({e!r}); reading it through PIL")
        NATIVE_FALLBACKS.append(path)
        with Image.open(path) as img:
            data = np.asarray(img)
        decoder = "pil"
    if data.ndim == 2:
        data = data[..., None]
    return GeoImage(data, {"backend": "pil", "tags": tags, "decoder": decoder})


def write_geotiff(
    path: Union[str, Path],
    data: np.ndarray,
    geo: Optional[Dict] = None,
    *,
    compress: str = "LZW",
) -> None:
    """Write (H, W) or (H, W, C) with preserved georeferencing + LZW
    (tiled LZW through rasterio when the image came from it)."""
    path = str(path)
    geo = geo or {}
    if HAVE_RASTERIO and geo.get("backend") == "rasterio":
        arr = data[None] if data.ndim == 2 else np.transpose(data, (2, 0, 1))
        with rasterio.open(
            path,
            "w",
            driver="GTiff",
            height=arr.shape[1],
            width=arr.shape[2],
            count=arr.shape[0],
            dtype=arr.dtype,
            crs=geo.get("crs"),
            transform=geo.get("transform"),
            nodata=geo.get("nodata"),
            compress=compress.lower(),
            tiled=True,
        ) as dst:
            dst.write(arr)
        return

    from PIL import Image, TiffImagePlugin

    if data.ndim == 3 and data.shape[-1] == 1:
        data = data[..., 0]
    img = Image.fromarray(data)
    tiffinfo = TiffImagePlugin.ImageFileDirectory_v2()
    for t, v in geo.get("tags", {}).items():
        tiffinfo[t] = v
    img.save(
        path,
        format="TIFF",
        compression="tiff_lzw" if compress.upper() == "LZW" else None,
        tiffinfo=tiffinfo,
    )
