from deadtrees_tpu_torch.losses.functional import (
    batch_one_hot2dist,
    class2one_hot,
    edt,
    one_hot2dist,
    probs2class,
    probs2one_hot,
)
from deadtrees_tpu_torch.losses.losses import (
    BoundaryLoss,
    CrossEntropy,
    DiceLoss,
    FocalLoss,
    GeneralizedDice,
    GeneralizedDiceLoss,
    GeneralizedWassersteinDiceLoss,
    SurfaceLoss,
)
from deadtrees_tpu_torch.losses.metrics import (
    confusion_matrix,
    dice_score,
    fscore,
    masked_confusion_matrix,
)

__all__ = [
    "batch_one_hot2dist",
    "class2one_hot",
    "edt",
    "one_hot2dist",
    "probs2class",
    "probs2one_hot",
    "BoundaryLoss",
    "CrossEntropy",
    "DiceLoss",
    "FocalLoss",
    "GeneralizedDice",
    "GeneralizedDiceLoss",
    "GeneralizedWassersteinDiceLoss",
    "SurfaceLoss",
    "confusion_matrix",
    "dice_score",
    "fscore",
    "masked_confusion_matrix",
]
