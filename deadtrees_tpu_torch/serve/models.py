"""API response models (reference deadtrees/deployment/models.py:6-14)."""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class PredictionStats:
    fraction: float
    model_name: str
    model_type: str
    elapsed: float


def predictionstats_to_str(stats: PredictionStats) -> Dict[str, str]:
    """Serialize stats into HTTP headers (reference models.py:13-14)."""
    return {f"X-{k.replace('_', '-')}": str(v) for k, v in dataclasses.asdict(stats).items()}
