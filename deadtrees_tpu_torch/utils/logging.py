"""Process-zero-guarded logging.

Counterpart of ``deadtrees_tpu.utils.logging``: when ``torch.distributed``
runs several processes only rank 0 emits; a single process always does.
"""

from __future__ import annotations

import logging


class _ProcessZeroFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        try:
            import torch.distributed as dist

            return not dist.is_initialized() or dist.get_rank() == 0
        except Exception:
            return True


def get_logger(name: str = __name__, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not any(isinstance(f, _ProcessZeroFilter) for f in logger.filters):
        logger.addFilter(_ProcessZeroFilter())
    return logger
