"""Minimal ESRI shapefile reader and writer (polygons + DBF attributes), pure Python.

Counterpart of ``deadtrees_tpu.geo.shapefile``, copied: it holds no JAX.
The reference reads ground-truth polygons with geopandas/GDAL; the subset
of the format the pipeline needs is parsed directly:

- ``.shp``: Polygon (5), PolygonZ (15), PolygonM (25) records — rings as
  coordinate lists; multi-part records are kept together (ring winding
  distinguishes outer rings from holes: ESRI outer rings are CLOCKWISE).
- ``.dbf``: dBASE III field table + fixed-width records for attributes
  (the pipeline uses the dead-tree ``type`` class column).

:func:`write_shapefile` writes the yearly polygon layers (``.shp``,
``.shx``, ``.dbf``, ``.prj``).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

Ring = List[Tuple[float, float]]

POLYGON_TYPES = {5, 15, 25}


def ring_signed_area(ring: Ring) -> float:
    """Shoelace area: negative = clockwise (ESRI outer ring)."""
    s = 0.0
    for (x1, y1), (x2, y2) in zip(ring, ring[1:] + ring[:1]):
        s += x1 * y2 - x2 * y1
    return s / 2.0


def read_shp(path: Union[str, Path]) -> List[Dict]:
    """Read polygon records: [{'rings': [...], 'bbox': (x1,y1,x2,y2)}]."""
    data = Path(path).read_bytes()
    if len(data) < 100:
        raise ValueError(f"Not a shapefile: {path}")
    file_len = struct.unpack(">i", data[24:28])[0] * 2
    shape_type = struct.unpack("<i", data[32:36])[0]
    if shape_type not in POLYGON_TYPES | {0}:
        raise ValueError(f"Unsupported shape type {shape_type} (need polygons)")

    records = []
    pos = 100
    while pos + 8 <= min(file_len, len(data)):
        _, content_len = struct.unpack(">ii", data[pos : pos + 8])
        pos += 8
        rec_end = pos + content_len * 2
        stype = struct.unpack("<i", data[pos : pos + 4])[0]
        if stype in POLYGON_TYPES:
            x1, y1, x2, y2 = struct.unpack("<4d", data[pos + 4 : pos + 36])
            nparts, npoints = struct.unpack("<ii", data[pos + 36 : pos + 44])
            parts = struct.unpack(
                f"<{nparts}i", data[pos + 44 : pos + 44 + 4 * nparts]
            )
            pts_off = pos + 44 + 4 * nparts
            pts = struct.unpack(
                f"<{2 * npoints}d", data[pts_off : pts_off + 16 * npoints]
            )
            points = [(pts[2 * i], pts[2 * i + 1]) for i in range(npoints)]
            rings = [
                points[parts[i] : (parts[i + 1] if i + 1 < nparts else npoints)]
                for i in range(nparts)
            ]
            records.append({"rings": rings, "bbox": (x1, y1, x2, y2)})
        else:  # null shape keeps record alignment
            records.append({"rings": [], "bbox": None})
        pos = rec_end
    return records


def read_dbf(path: Union[str, Path]) -> List[Dict[str, str]]:
    """Read DBF attribute records as string dicts (numeric parsing is the
    caller's concern, matching pandas' to_numeric usage downstream)."""
    data = Path(path).read_bytes()
    n_records = struct.unpack("<i", data[4:8])[0]
    header_size, record_size = struct.unpack("<hh", data[8:12])

    fields = []
    pos = 32
    while pos < header_size - 1 and data[pos] != 0x0D:
        name = data[pos : pos + 11].split(b"\x00")[0].decode("ascii", "replace")
        length = data[pos + 16]
        fields.append((name, length))
        pos += 32

    records = []
    pos = header_size
    for _ in range(n_records):
        if pos + record_size > len(data):
            break
        rec = data[pos : pos + record_size]
        pos += record_size
        if rec[:1] == b"*":  # deleted
            continue
        off = 1
        row = {}
        for name, length in fields:
            row[name] = rec[off : off + length].decode("latin-1").strip()
            off += length
        records.append(row)
    return records


def read_shapefile(path: Union[str, Path]) -> List[Dict]:
    """Geometry + attributes: [{'rings', 'bbox', 'attributes': {...}}].

    ``.explode()`` parity note: the reference explodes multi-polygons
    (createmasks.py:167); shapefile polygon records already carry one
    polygon (+holes) per record in this dataset, and the rasterizer handles
    multiple outer rings per record anyway, so no explosion is needed.
    """
    path = Path(path)
    shp = read_shp(path.with_suffix(".shp"))
    dbf_path = path.with_suffix(".dbf")
    attrs = read_dbf(dbf_path) if dbf_path.exists() else [{}] * len(shp)
    out = []
    for geom, attr in zip(shp, attrs):
        out.append({**geom, "attributes": attr})
    return out


def read_prj(path: Union[str, Path]) -> Optional[str]:
    prj = Path(path).with_suffix(".prj")
    return prj.read_text().strip() if prj.exists() else None


# ---------------------------------------------------------------------------
# Writing (polygon shapefiles)
# ---------------------------------------------------------------------------
# The reference's aggregate_results.py writes yearly shapefiles via
# geopandas.to_file; without GDAL, the subset needed — polygon records
# (type 5) with numeric/character DBF attributes — is emitted directly.


def _orient_ring(ring: Ring, *, hole: bool) -> Ring:
    """ESRI outer rings must be clockwise (negative shoelace area); holes
    (inner rings) must be counter-clockwise."""
    cw = ring_signed_area(ring) <= 0
    return ring if cw != hole else ring[::-1]


def _close_ring(ring: Ring) -> Ring:
    return ring if ring[0] == ring[-1] else ring + [ring[0]]


def _shp_polygon_record(rings: List[Ring]) -> bytes:
    # First ring = outer boundary, subsequent rings = holes (the convention
    # used throughout this package's rasterizer and the reference data).
    rings = [
        _close_ring(_orient_ring(r, hole=i > 0)) for i, r in enumerate(rings)
    ]
    points = [p for r in rings for p in r]
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    parts, off = [], 0
    for r in rings:
        parts.append(off)
        off += len(r)
    content = struct.pack("<i4d", 5, min(xs), min(ys), max(xs), max(ys))
    content += struct.pack("<ii", len(rings), len(points))
    content += struct.pack(f"<{len(parts)}i", *parts)
    content += struct.pack(f"<{2 * len(points)}d", *[c for p in points for c in p])
    return content


def _dbf_value(value, ftype: str, length: int, decimals: int) -> bytes:
    if value is None:
        text = ""
    elif ftype == "N":
        text = f"{float(value):.{decimals}f}" if decimals else str(int(value))
    else:
        text = str(value)
    raw = text.encode("latin-1", "replace")[:length]
    # numbers right-justified, text left-justified (dBASE III convention)
    return raw.rjust(length) if ftype == "N" else raw.ljust(length)


def write_shapefile(
    path: Union[str, Path],
    records: List[Dict],
    fields: Optional[List[Tuple[str, str, int, int]]] = None,
    crs_wkt: Optional[str] = None,
) -> None:
    """Write polygon records to ``path`` (.shp + .shx + .dbf [+ .prj]).

    ``records``: [{'rings': [[(x, y), ...], ...], 'attributes': {...}}]
    ``fields``: [(name<=10, 'N'|'C', length, decimals)]; inferred from the
    first record's attributes when omitted (floats → N 19.8, else C 64).
    """
    path = Path(path)
    if not records:
        raise ValueError("write_shapefile needs at least one record")

    if fields is None:
        fields = []
        for k, v in (records[0].get("attributes") or {}).items():
            if isinstance(v, (int, float)) or v is None:
                fields.append((k[:10], "N", 19, 8))
            else:
                fields.append((k[:10], "C", 64, 0))

    # --- .shp / .shx ------------------------------------------------------
    contents = [_shp_polygon_record(r["rings"]) for r in records]
    all_x = [p[0] for r in records for ring in r["rings"] for p in ring]
    all_y = [p[1] for r in records for ring in r["rings"] for p in ring]
    bbox = (min(all_x), min(all_y), max(all_x), max(all_y))

    def header(total_words: int, shape_type: int = 5) -> bytes:
        h = struct.pack(">i5i", 9994, 0, 0, 0, 0, 0)
        h += struct.pack(">i", total_words)
        h += struct.pack("<ii", 1000, shape_type)
        h += struct.pack("<4d", *bbox)
        h += struct.pack("<4d", 0.0, 0.0, 0.0, 0.0)  # z/m ranges
        return h

    shp_words = 50 + sum(4 + len(c) // 2 for c in contents)
    with open(path.with_suffix(".shp"), "wb") as f:
        f.write(header(shp_words))
        for i, c in enumerate(contents, start=1):
            f.write(struct.pack(">ii", i, len(c) // 2))
            f.write(c)

    with open(path.with_suffix(".shx"), "wb") as f:
        f.write(header(50 + 4 * len(contents)))
        offset = 50
        for c in contents:
            f.write(struct.pack(">ii", offset, len(c) // 2))
            offset += 4 + len(c) // 2

    # --- .dbf ---------------------------------------------------------------
    record_size = 1 + sum(ln for _, _, ln, _ in fields)
    header_size = 32 + 32 * len(fields) + 1
    with open(path.with_suffix(".dbf"), "wb") as f:
        f.write(struct.pack("<B3Bihh20x", 0x03, 95, 1, 1, len(records),
                            header_size, record_size))
        for name, ftype, length, decimals in fields:
            f.write(struct.pack("<11sc4xBB14x", name.encode("ascii"),
                                ftype.encode("ascii"), length, decimals))
        f.write(b"\x0d")
        for r in records:
            attrs = r.get("attributes") or {}
            f.write(b" ")
            for name, ftype, length, decimals in fields:
                f.write(_dbf_value(attrs.get(name), ftype, length, decimals))
        f.write(b"\x1a")

    if crs_wkt:
        path.with_suffix(".prj").write_text(crs_wkt)
