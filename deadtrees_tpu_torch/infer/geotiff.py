"""Minimal GeoTIFF IO for scene inference (PIL backend).

Counterpart of ``deadtrees_tpu.infer.geotiff``: reads any baseline TIFF
and ROUND-TRIPS the GeoTIFF georeferencing tags (ModelPixelScale 33550,
ModelTiepoint 33922, ModelTransformation 34264, GeoKeyDirectory 34735,
GeoDoubleParams 34736, GeoAsciiParams 34737, GDAL metadata 42112 / nodata
42113) onto outputs so predictions stay geo-registered. Pixels are
decoded by PIL.

The rasterio backend of the JAX package is not ported (ROADMAP.md):
``HAVE_RASTERIO`` stays ``False``. Arrays are exchanged as (H, W) or
(H, W, C) numpy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

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
        """(xmin, ymin, xmax, ymax) in CRS units, or None when
        ungeoreferenced."""
        h, w = self.data.shape[:2]
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
    from PIL import Image

    with Image.open(str(path)) as img:
        w, h = img.size
    return (h, w)


def read_geotiff(path: Union[str, Path]) -> GeoImage:
    """Read a scene as (H, W, C) uint8/uint16 + georeferencing blob."""
    from PIL import Image

    with Image.open(str(path)) as img:
        tags = {}
        if hasattr(img, "tag_v2"):
            for t in GEO_TAGS:
                if t in img.tag_v2:
                    tags[t] = img.tag_v2[t]
        data = np.asarray(img)
    if data.ndim == 2:
        data = data[..., None]
    return GeoImage(data, {"backend": "pil", "tags": tags})


def write_geotiff(
    path: Union[str, Path],
    data: np.ndarray,
    geo: Optional[Dict] = None,
    *,
    compress: str = "LZW",
) -> None:
    """Write (H, W) or (H, W, C) with preserved georeferencing + LZW."""
    from PIL import Image, TiffImagePlugin

    geo = geo or {}
    if data.ndim == 3 and data.shape[-1] == 1:
        data = data[..., 0]
    img = Image.fromarray(data)
    tiffinfo = TiffImagePlugin.ImageFileDirectory_v2()
    for t, v in geo.get("tags", {}).items():
        tiffinfo[t] = v
    img.save(
        str(path),
        format="TIFF",
        compression="tiff_lzw" if compress.upper() == "LZW" else None,
        tiffinfo=tiffinfo,
    )
