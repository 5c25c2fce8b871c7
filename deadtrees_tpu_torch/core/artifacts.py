"""Content-hash pointers next to artifacts (the ``.dvc`` file analogue).

A copy of the pointer half of ``deadtrees_tpu.core.artifacts``:
``<artifact>.dtpu`` JSON pointers (sha256 + size). :func:`maybe_verify`
checks an artifact against its pointer when one sits next to it, so a
corrupted or swapped checkpoint fails loudly instead of producing
silently-wrong predictions. The content-addressed cache is not ported.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional, Union

POINTER_SUFFIX = ".dtpu"
_CHUNK = 1 << 20


def hash_file(path: Union[str, Path]) -> str:
    """Streaming sha256 of a file (constant memory)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def pointer_path(artifact: Union[str, Path]) -> Path:
    """``x.ckpt`` → ``x.ckpt.dtpu`` (sits next to the artifact)."""
    artifact = Path(artifact)
    return artifact.with_name(artifact.name + POINTER_SUFFIX)


def write_pointer(artifact: Union[str, Path],
                  pointer: Optional[Union[str, Path]] = None) -> Path:
    """Write the content-hash pointer for ``artifact``. Returns its path."""
    artifact = Path(artifact)
    pointer = Path(pointer) if pointer else pointer_path(artifact)
    record = {
        "sha256": hash_file(artifact),
        "size": artifact.stat().st_size,
        "path": artifact.name,
        "written": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    tmp = pointer.with_suffix(pointer.suffix + ".tmp")
    tmp.write_text(json.dumps(record, indent=1) + "\n")
    tmp.replace(pointer)
    return pointer


def read_pointer(pointer: Union[str, Path]) -> Dict:
    record = json.loads(Path(pointer).read_text())
    for field in ("sha256", "size"):
        if field not in record:
            raise ValueError(f"{pointer}: malformed pointer (no {field!r})")
    return record


def verify_pointer(
    artifact: Union[str, Path],
    pointer: Optional[Union[str, Path]] = None,
    *,
    full: bool = True,
) -> Dict:
    """Check ``artifact`` against its pointer; raise ``ValueError`` on any
    mismatch. ``full=False`` stops at the size check (cheap pre-flight).

    Returns the pointer record on success.
    """
    artifact = Path(artifact)
    pointer = Path(pointer) if pointer else pointer_path(artifact)
    record = read_pointer(pointer)
    size = artifact.stat().st_size
    if size != record["size"]:
        raise ValueError(
            f"{artifact}: size {size} != {record['size']} recorded in "
            f"{pointer.name} — artifact corrupted or replaced"
        )
    if full:
        digest = hash_file(artifact)
        if digest != record["sha256"]:
            raise ValueError(
                f"{artifact}: sha256 {digest[:12]}… != {record['sha256'][:12]}… "
                f"recorded in {pointer.name} — artifact corrupted or replaced"
            )
    return record


def maybe_verify(artifact: Union[str, Path], *, full: bool = True) -> bool:
    """Verify when a pointer exists next to ``artifact``; no-op otherwise.

    Returns True when a pointer was present and checked. Controlled by
    ``DEADTREES_VERIFY_ARTIFACTS`` (default on; set to ``0`` to skip the
    full hash on very large artifacts — the size check always runs).
    """
    p = pointer_path(artifact)
    if not p.exists():
        return False
    env = os.environ.get("DEADTREES_VERIFY_ARTIFACTS", "1")
    verify_pointer(artifact, p, full=full and env not in ("0", "false"))
    return True
