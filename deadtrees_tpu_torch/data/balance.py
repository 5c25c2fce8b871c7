"""Shard balancing: a greedy bin-pack that keeps each shard's mean
dead-pixel fraction near the whole set's.

A copy of ``deadtrees_tpu.data.balance`` (the reference's ``split_df``,
deadtrees/utils/data_handling.py:37-72): sort the tiles by dead fraction,
largest first, and deal them round-robin into ceil(n/size) buckets by
ascending fill (the reference's status counter gives exactly round-robin
for equal fractions), so every shard gets a similar fraction profile.
Returns the tile names of each shard. Takes a pandas DataFrame; nothing
here imports pandas.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


def split_df(
    df,
    size: int,
    refcol: str = "frac",
    require_deadtrees: bool = True,
) -> List[List[str]]:
    """``df`` is a pandas DataFrame with columns ['tile', refcol]."""
    df = df.sort_values(by=refcol, ascending=False).reset_index(drop=True)

    if require_deadtrees and not all(df[refcol] > 0):
        raise ValueError("All source tiles must include classified deadtrees")
    if size not in range(1, len(df) + 1):
        raise ValueError("Shard size must be between 1 and len(data)")

    n_fractions = math.ceil(len(df) / size)
    fractions = [1 / n_fractions] * n_fractions
    all_fractions = sum(fractions)
    status = [0.0] * n_fractions

    assignment = []
    for _ in range(len(df)):
        idx = int(np.argmin(status))
        status[idx] += all_fractions / fractions[idx]
        assignment.append(idx)
    df = df.assign(**{"class": assignment})

    gdf = df.groupby("class")
    return [list(gdf.get_group(x)["tile"]) for x in gdf.groups]
