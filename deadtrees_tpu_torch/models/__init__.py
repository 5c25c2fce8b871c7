from deadtrees_tpu_torch.models.convert import (
    state_dict_from_inverted_residual,
    state_dict_from_variables,
    tensor_variables_from_state_dict,
    variables_from_state_dict,
)
from deadtrees_tpu_torch.models.encoders import ENCODERS, get_encoder
from deadtrees_tpu_torch.models.factory import (
    ARCHITECTURES,
    SegmentationModel,
    canonical_architecture,
    create_model,
    init_model,
)

__all__ = [
    "ARCHITECTURES",
    "ENCODERS",
    "SegmentationModel",
    "canonical_architecture",
    "create_model",
    "get_encoder",
    "init_model",
    "state_dict_from_inverted_residual",
    "state_dict_from_variables",
    "tensor_variables_from_state_dict",
    "variables_from_state_dict",
]
