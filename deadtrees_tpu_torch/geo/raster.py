"""Polygon rasterization in world coordinates, pure Python (PIL ImageDraw).

Counterpart of ``deadtrees_tpu.geo.raster``, copied: it holds no JAX.
Replaces the reference's ``rio.clip(..., all_touched=True)`` rasterization
for mask creation: polygons
are transformed from world coordinates to pixel space via the tile's affine
bounds and burned with both fill and outline (the outline approximates
GDAL's ``all_touched=True``, which burns every pixel the boundary touches).
Holes (counter-clockwise rings in ESRI winding) are burned back to 0.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from deadtrees_tpu_torch.geo.shapefile import Ring, ring_signed_area

Bounds = Tuple[float, float, float, float]  # (xmin, ymin, xmax, ymax)


def world_to_pixel(
    ring: Ring, bounds: Bounds, size: Tuple[int, int]
) -> List[Tuple[float, float]]:
    """World coords → pixel coords (row 0 = ymax, north-up raster)."""
    xmin, ymin, xmax, ymax = bounds
    h, w = size
    sx = w / (xmax - xmin)
    sy = h / (ymax - ymin)
    return [((x - xmin) * sx, (ymax - y) * sy) for x, y in ring]


def rasterize(
    polygons: Iterable[Dict],
    bounds: Bounds,
    size: Tuple[int, int],
    *,
    burn_value: int = 1,
    all_touched: bool = True,
) -> np.ndarray:
    """Burn polygon records ({'rings': [...]}) into a (H, W) uint8 mask."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (size[1], size[0]), 0)
    draw = ImageDraw.Draw(img)
    outline = burn_value if all_touched else None

    for poly in polygons:
        rings = poly["rings"] if isinstance(poly, dict) else poly
        outers = [r for r in rings if ring_signed_area(r) <= 0]
        holes = [r for r in rings if ring_signed_area(r) > 0]
        for ring in outers:
            px = world_to_pixel(ring, bounds, size)
            if len(px) >= 3:
                draw.polygon(px, fill=burn_value, outline=outline)
        for ring in holes:
            px = world_to_pixel(ring, bounds, size)
            if len(px) >= 3:
                draw.polygon(px, fill=0)
    return np.asarray(img, dtype=np.uint8)


def bbox_intersects(a: Sequence[float], b: Sequence[float]) -> bool:
    """(x1, y1, x2, y2) boxes overlap test."""
    return not (a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1])
