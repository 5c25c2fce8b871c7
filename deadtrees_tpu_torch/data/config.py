"""Dataset constants (counterpart of ``deadtrees_tpu.data.config``).

4-band RGBN channel statistics (computed on the 2017-2020 train shards,
10% subsample), tile size, and split fractions.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    mean: Tuple[float, ...] = (0.3661029729, 0.3875165941, 0.3501133538, 0.5797285859)
    std: Tuple[float, ...] = (0.2388708549, 0.2103625723, 0.2050272174, 0.2025812523)
    tile_size: int = 256
    fractions: Tuple[float, ...] = (0.7, 0.2, 0.1)

    @property
    def mean_arr(self) -> np.ndarray:
        return np.asarray(self.mean, np.float32)

    @property
    def std_arr(self) -> np.ndarray:
        return np.asarray(self.std, np.float32)


DATASET_CONFIG = DatasetConfig()

# NIR channel stats mirrored from red
DATASET_CONFIG_IMAGENET = DatasetConfig(
    mean=(0.485, 0.456, 0.406, 0.485),
    std=(0.229, 0.224, 0.225, 0.229),
)
