from deadtrees_tpu_torch.ops.augment import (
    augment_jitter_normalize,
    augment_jitter_normalize_reference,
)
from deadtrees_tpu_torch.ops.fused_decoder import (
    apply_head,
    encode_features,
    fold_effunetpp_decoder,
    folded_block,
    fused_decoder_chw,
    fused_forward,
)
from deadtrees_tpu_torch.ops.fused_mbconv import (
    FoldedBlockParams,
    fold_bn_into_conv,
    fold_inverted_residual,
    fused_inverted_residual_chw,
    fused_inverted_residual_chw_reference,
)
from deadtrees_tpu_torch.ops.launches import LAUNCHES, reset_launch_counts

__all__ = [
    "LAUNCHES",
    "FoldedBlockParams",
    "apply_head",
    "augment_jitter_normalize",
    "augment_jitter_normalize_reference",
    "encode_features",
    "fold_bn_into_conv",
    "fold_effunetpp_decoder",
    "fold_inverted_residual",
    "folded_block",
    "fused_decoder_chw",
    "fused_forward",
    "fused_inverted_residual_chw",
    "fused_inverted_residual_chw_reference",
    "reset_launch_counts",
]
