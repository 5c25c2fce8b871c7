from deadtrees_tpu_torch.infer.blocks import (
    make_blocks_chw,
    make_blocks_nhwc,
    unmake_blocks_chw,
    unmake_blocks_nhwc,
)
from deadtrees_tpu_torch.infer.engine import (
    EnsembleInference,
    Inference,
    TorchInference,
    resolve_device,
)
from deadtrees_tpu_torch.infer.packing import pack2, unpack2
from deadtrees_tpu_torch.infer.sliding import (
    make_scene_predictor,
    predict_scene,
    predict_scenes,
)
from deadtrees_tpu_torch.infer.tiler import (
    TileInfo,
    Tiler,
    divisible_without_remainder,
    inspect_tile,
)

__all__ = [
    "EnsembleInference",
    "Inference",
    "TileInfo",
    "Tiler",
    "TorchInference",
    "divisible_without_remainder",
    "inspect_tile",
    "make_blocks_chw",
    "make_blocks_nhwc",
    "make_scene_predictor",
    "pack2",
    "predict_scene",
    "predict_scenes",
    "resolve_device",
    "unmake_blocks_chw",
    "unmake_blocks_nhwc",
    "unpack2",
]
