from deadtrees_tpu_torch.data.augment import normalize
from deadtrees_tpu_torch.data.config import (
    DATASET_CONFIG,
    DATASET_CONFIG_IMAGENET,
    DatasetConfig,
)

__all__ = ["DATASET_CONFIG", "DATASET_CONFIG_IMAGENET", "DatasetConfig", "normalize"]
