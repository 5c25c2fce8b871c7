from deadtrees_tpu_torch.core.artifacts import (
    maybe_verify,
    pointer_path,
    verify_pointer,
    write_pointer,
)
from deadtrees_tpu_torch.core.checkpoint import (
    BestCheckpointKeeper,
    load_checkpoint,
    load_model,
    save_checkpoint,
)

__all__ = [
    "BestCheckpointKeeper",
    "load_checkpoint",
    "load_model",
    "maybe_verify",
    "pointer_path",
    "save_checkpoint",
    "verify_pointer",
    "write_pointer",
]
