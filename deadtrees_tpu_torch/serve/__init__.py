from deadtrees_tpu_torch.serve.models import PredictionStats, predictionstats_to_str
from deadtrees_tpu_torch.serve.server import (
    SegmentationService,
    create_app,
    serve_stdlib,
)

__all__ = [
    "PredictionStats",
    "SegmentationService",
    "create_app",
    "predictionstats_to_str",
    "serve_stdlib",
]
