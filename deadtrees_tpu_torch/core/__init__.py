from deadtrees_tpu_torch.core.artifacts import (
    maybe_verify,
    pointer_path,
    verify_pointer,
    write_pointer,
)
from deadtrees_tpu_torch.core.checkpoint import (
    AsyncCheckpointWriter,
    BestCheckpointKeeper,
    load_checkpoint,
    load_model,
    save_checkpoint,
    snapshot,
)

__all__ = [
    "AsyncCheckpointWriter",
    "BestCheckpointKeeper",
    "load_checkpoint",
    "load_model",
    "maybe_verify",
    "pointer_path",
    "save_checkpoint",
    "snapshot",
    "verify_pointer",
    "write_pointer",
]
