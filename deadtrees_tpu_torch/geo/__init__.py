from deadtrees_tpu_torch.geo.mosaic import merge_tiles
from deadtrees_tpu_torch.geo.retile import retile

__all__ = ["merge_tiles", "retile"]
