"""Retile a large orthophoto into fixed-size tiles + locations.csv.

Counterpart of ``deadtrees_tpu.geo.retile`` (PIL backend): the first-party
analogue of the ``gdal_retile.py`` call that starts the pipeline. The
scene is read once and written as tiles; downstream stages consume the
tile files plus the ``locations.csv`` grid (``filename;x1;x2;y1;y2``).
The windowed rasterio backend is not ported (ROADMAP.md).

Ragged edge tiles keep their natural (smaller) size, like gdal_retile —
the Tiler's pad/mask logic handles them at inference (infer/tiler.py).
Tile names are ``{stem}_{row}_{col}.tif`` (1-indexed).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Union

from deadtrees_tpu_torch.infer.geotiff import GEO_TAGS, write_geotiff

log = logging.getLogger(__name__)


def retile(
    src: Union[str, Path],
    target_dir: Union[str, Path],
    *,
    tile_size: int = 2048,
    csv_name: str = "locations.csv",
    compress: str = "LZW",
    append_csv: bool = False,
) -> List[Dict]:
    """Split ``src`` into ``tile_size``² tiles under ``target_dir`` and
    write their world extents to ``target_dir/csv_name``.

    ``append_csv=False`` (default) truncates the CSV first, so rerunning
    into an existing directory never accumulates duplicate rows that a
    reader of the grid would double-count; pass ``append_csv=True`` for
    the 2nd..Nth source of a multi-source run.

    Returns the per-tile records [{'filename', 'bounds'}], bounds as
    (xmin, ymin, xmax, ymax).
    """
    src = Path(src)
    target_dir = Path(target_dir)
    target_dir.mkdir(parents=True, exist_ok=True)
    records = _retile_pil(src, target_dir, tile_size, compress)

    with open(target_dir / csv_name, "a" if append_csv else "w") as f:
        for r in records:
            xmin, ymin, xmax, ymax = r["bounds"]
            f.write(f"{r['filename']};{xmin};{xmax};{ymin};{ymax}\n")
    log.info("retiled %s -> %d tiles in %s", src.name, len(records), target_dir)
    return records


def _tile_spans(total: int, size: int) -> List[tuple]:
    """[(offset, length)] covering ``total``; the last span may be ragged."""
    return [(o, min(size, total - o)) for o in range(0, total, size)]


def _retile_pil(src, target_dir, tile_size, compress) -> List[Dict]:
    import numpy as np
    from PIL import Image

    with Image.open(str(src)) as img:
        tags = {t: img.tag_v2[t] for t in GEO_TAGS if t in img.tag_v2}
        data = np.asarray(img)
    scale, tie = tags.get(33550), tags.get(33922)
    if not scale or not tie or len(tie) < 6:
        raise ValueError(f"{src}: no GeoTIFF scale/tiepoint tags — cannot retile")
    sx, sy = float(scale[0]), float(scale[1])
    x0, y0 = float(tie[3]), float(tie[4])

    records = []
    h, w = data.shape[:2]
    for i, (roff, rlen) in enumerate(_tile_spans(h, tile_size), 1):
        for j, (coff, clen) in enumerate(_tile_spans(w, tile_size), 1):
            name = f"{src.stem}_{i}_{j}.tif"
            tx, ty = x0 + sx * coff, y0 - sy * roff
            tile_tags = dict(tags)
            tile_tags[33922] = (0.0, 0.0, 0.0, tx, ty, 0.0)
            write_geotiff(
                target_dir / name,
                data[roff:roff + rlen, coff:coff + clen],
                {"backend": "pil", "tags": tile_tags},
                compress=compress,
            )
            records.append({
                "filename": name,
                "bounds": (tx, ty - sy * rlen, tx + sx * clen, ty),
            })
    return records
