from deadtrees_tpu_torch.geo.mosaic import merge_tiles
from deadtrees_tpu_torch.geo.raster import bbox_intersects, rasterize, world_to_pixel
from deadtrees_tpu_torch.geo.retile import retile
from deadtrees_tpu_torch.geo.shapefile import (
    read_dbf,
    read_shapefile,
    read_shp,
    ring_signed_area,
)

__all__ = [
    "bbox_intersects",
    "merge_tiles",
    "rasterize",
    "read_dbf",
    "read_shapefile",
    "read_shp",
    "retile",
    "ring_signed_area",
    "world_to_pixel",
]
