"""Tar shard writer (the wds.ShardWriter analogue).

A copy of ``deadtrees_tpu.data.shardwriter``: samples — dicts of
``{suffix: bytes}`` plus ``__key__`` — go into numbered tar shards of at
most ``maxcount`` samples, the format the reference writes with
webdataset's ShardWriter.
"""

from __future__ import annotations

import io
import tarfile
from pathlib import Path
from typing import Dict, List, Optional

from deadtrees_tpu_torch.core.artifacts import write_pointer


class ShardWriter:
    """``ShardWriter("out/train-%06d.tar", maxcount=32)``; use as a context
    manager, call :meth:`write` per sample."""

    def __init__(self, pattern: str, maxcount: int = 32, write_pointers: bool = True):
        """``write_pointers`` drops a ``.dtpu`` content-hash pointer next to
        every finished shard."""
        self.pattern = str(pattern)
        self.maxcount = maxcount
        self.write_pointers = write_pointers
        self.shard_idx = 0
        self.count = 0
        self.total = 0
        self._tar: Optional[tarfile.TarFile] = None
        self.shards: List[str] = []

    def _next_shard(self) -> None:
        self._close_shard()
        path = self.pattern % self.shard_idx
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._tar = tarfile.open(path, "w")
        self.shards.append(path)
        self.shard_idx += 1
        self.count = 0

    def _close_shard(self) -> None:
        if self._tar is not None:
            self._tar.close()
            self._tar = None
            if self.write_pointers and self.shards:
                write_pointer(self.shards[-1])

    def write(self, sample: Dict) -> None:
        if self._tar is None or self.count >= self.maxcount:
            self._next_shard()
        key = sample["__key__"]
        if isinstance(key, bytes):
            key = key.decode()
        # suffixes in sorted order, for reproducible shards
        for suffix in sorted(k for k in sample if k != "__key__"):
            data = sample[suffix]
            if isinstance(data, str):
                data = data.encode()
            info = tarfile.TarInfo(f"{key}.{suffix}")
            info.size = len(data)
            self._tar.addfile(info, io.BytesIO(data))
        self.count += 1
        self.total += 1

    def close(self) -> None:
        self._close_shard()

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
