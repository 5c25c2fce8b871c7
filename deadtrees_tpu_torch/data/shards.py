"""Shard discovery and train/val/test splitting.

A copy of ``deadtrees_tpu.data.shards`` (the reference's ``split_shards``,
with its small-shard-count fixups and the two-fraction variant used for
extra datasets), and shard discovery in a local directory or from a
remote spec (``pipe:`` / http, with a brace range).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def split_shards(
    original_list: Sequence, split_fractions: Sequence[float]
) -> List[Optional[List[str]]]:
    """Distribute shards into train/val(/test) lists by fractions: sort,
    round-to-nearest contiguous spans, then a fixup when a span lands empty
    (3-way: train gets all-but-2, val 1, test 1; 2-way: all-but-1 / 1),
    and a trailing ``None`` when only two fractions are given."""
    if not np.isclose(sum(split_fractions), 1.0):
        raise ValueError(f"Split fractions do not sum to 1: {sum(split_fractions)}")

    items = [str(x) for x in sorted(original_list)]
    sublists: List[List[str]] = []
    prev = 0
    for weight in split_fractions:
        nxt = prev + int(round(len(items) * weight, 0))
        sublists.append(items[prev:nxt])
        prev = nxt
    if sum(len(x) for x in sublists) != len(items):
        raise ValueError("Split size mismatch")

    if not all(len(x) > 0 for x in sublists):
        logger.warning("Unexpected shard distribution encountered - trying to fix this")
        if len(split_fractions) == 3:
            if len(sublists[0]) > 2:
                sublists[0] = items[:-2]
                sublists[1] = items[-2:-1]
                sublists[2] = items[-1:]
            else:
                raise ValueError(f"Not enough shards (#{len(items)}) for new distribution")
        elif len(split_fractions) == 2:
            sublists[0] = items[:-1]
            sublists[1] = items[-1:]
        else:
            raise ValueError(f"cannot fix a {len(split_fractions)}-way split")
        logger.warning(f"New shard split: {sublists}")

    out: List[Optional[List[str]]] = list(sublists)
    if len(out) != 3:
        logger.warning("No test shards specified")
        out.append(None)
    return out


def discover_shards(data_dir, pattern: str) -> List:
    """Sorted shard paths matching ``pattern`` in a local directory; or, when
    ``data_dir`` is a remote shard spec (``pipe:CMD`` or an http(s) URL,
    optionally with a WebDataset brace range such as
    ``...-{000000..000123}.tar``), the expanded URL list, ``pattern``
    ignored."""
    from deadtrees_tpu_torch.data.tar import expand_shard_urls, is_remote_shard

    if isinstance(data_dir, str) and is_remote_shard(data_dir):
        return expand_shard_urls(data_dir)
    return sorted(Path(data_dir).glob(pattern))
