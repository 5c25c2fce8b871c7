from deadtrees_tpu_torch.ops.augment import (
    augment_jitter_normalize,
    augment_jitter_normalize_reference,
)
from deadtrees_tpu_torch.ops.depthwise import depthwise_conv2d, depthwise_conv2d_reference
from deadtrees_tpu_torch.ops.edt import signed_distance_maps
from deadtrees_tpu_torch.ops.fused_cell import fused_ir_fat, fused_ir_fat_reference
from deadtrees_tpu_torch.ops.fused_decoder import (
    apply_head,
    encode_features,
    encode_features_nhwc,
    fold_effunetpp_decoder,
    folded_block,
    folded_block_nhwc,
    fused_decoder_chw,
    fused_decoder_nhwc,
    fused_forward,
)
from deadtrees_tpu_torch.ops.fused_mbconv import (
    FoldedBlockParams,
    fold_bn_into_conv,
    fold_inverted_residual,
    fused_inverted_residual,
    fused_inverted_residual_chw,
    fused_inverted_residual_chw_reference,
    fused_inverted_residual_reference,
)
from deadtrees_tpu_torch.ops.launches import LAUNCHES, reset_launch_counts

__all__ = [
    "LAUNCHES",
    "FoldedBlockParams",
    "apply_head",
    "augment_jitter_normalize",
    "augment_jitter_normalize_reference",
    "depthwise_conv2d",
    "depthwise_conv2d_reference",
    "encode_features",
    "encode_features_nhwc",
    "fold_bn_into_conv",
    "fold_effunetpp_decoder",
    "fold_inverted_residual",
    "folded_block",
    "folded_block_nhwc",
    "fused_decoder_chw",
    "fused_decoder_nhwc",
    "fused_forward",
    "fused_inverted_residual",
    "fused_inverted_residual_chw",
    "fused_inverted_residual_chw_reference",
    "fused_inverted_residual_reference",
    "fused_ir_fat",
    "fused_ir_fat_reference",
    "reset_launch_counts",
    "signed_distance_maps",
]
