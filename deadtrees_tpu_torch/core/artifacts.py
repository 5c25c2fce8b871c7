"""Content-addressed artifact versioning (the ``.dvc`` analogue).

A copy of ``deadtrees_tpu.core.artifacts`` (it holds no JAX):

- ``<artifact>.dtpu`` JSON pointers (sha256 + size): :func:`maybe_verify`
  checks an artifact against its pointer when one sits next to it, so a
  corrupted or swapped checkpoint fails loudly instead of producing
  silently-wrong predictions;
- :class:`ArtifactCache`, a content-addressed store
  (``cache_dir/sha256[:2]/sha256``, DVC's cache layout with sha256 in
  place of md5) with ``push`` / ``pull``, on any directory (a mounted
  bucket plays DVC's remote), and :func:`find_pointers`. The two
  packages' pointers and caches are the same files.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

log = logging.getLogger(__name__)

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


class ArtifactCache:
    """Content-addressed blob store (DVC-cache layout, sha256 keyed).

    ``root`` is any directory: local disk, or a mounted bucket in the role
    of DVC's S3 remote.
    """

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)

    def _blob(self, digest: str) -> Path:
        return self.root / digest[:2] / digest[2:]

    def has(self, digest: str) -> bool:
        return self._blob(digest).exists()

    def push(self, artifacts: Iterable[Union[str, Path]]) -> List[Dict]:
        """Upload artifacts (pointers written/refreshed as needed).

        Skips blobs already in the cache (content addressing makes the
        copy idempotent). Returns one summary record per artifact.
        """
        results = []
        for artifact in artifacts:
            artifact = Path(artifact)
            ptr = pointer_path(artifact)
            if ptr.exists():
                # FULL verification before trusting the recorded hash: a
                # same-size edit would otherwise store the NEW content
                # under the OLD hash — silent cache poisoning
                try:
                    record = verify_pointer(artifact, ptr)
                except ValueError:
                    write_pointer(artifact)
                    record = read_pointer(ptr)
            else:
                write_pointer(artifact)
                record = read_pointer(ptr)
            blob = self._blob(record["sha256"])
            uploaded = False
            if not blob.exists():
                blob.parent.mkdir(parents=True, exist_ok=True)
                tmp = blob.with_suffix(".tmp")
                shutil.copyfile(artifact, tmp)
                tmp.replace(blob)
                uploaded = True
            results.append({
                "path": str(artifact), "sha256": record["sha256"],
                "size": record["size"], "uploaded": uploaded,
            })
            log.info("push %s -> %s%s", artifact.name, record["sha256"][:12],
                     "" if uploaded else " (cached)")
        return results

    def pull(self, pointers: Iterable[Union[str, Path]]) -> List[Dict]:
        """Restore artifacts from their ``.dtpu`` pointers.

        Each pointer's artifact is materialized next to it (the DVC
        checkout semantic), verified against the recorded hash. Artifacts
        already present and matching are left untouched.
        """
        results = []
        for ptr in pointers:
            ptr = Path(ptr)
            record = read_pointer(ptr)
            artifact = ptr.parent / record.get(
                "path", ptr.name[: -len(POINTER_SUFFIX)]
            )
            restored = False
            ok = False
            if artifact.exists():
                try:
                    verify_pointer(artifact, ptr)
                    ok = True
                except ValueError:
                    ok = False
            if not ok:
                blob = self._blob(record["sha256"])
                if not blob.exists():
                    raise FileNotFoundError(
                        f"{ptr}: blob {record['sha256'][:12]}… not in cache "
                        f"{self.root} — push it from the producing host first"
                    )
                tmp = artifact.with_suffix(artifact.suffix + ".tmp")
                shutil.copyfile(blob, tmp)
                tmp.replace(artifact)
                verify_pointer(artifact, ptr)
                restored = True
            results.append({
                "path": str(artifact), "sha256": record["sha256"],
                "restored": restored,
            })
            log.info("pull %s%s", artifact.name,
                     " (restored)" if restored else " (up to date)")
        return results


def find_pointers(root: Union[str, Path]) -> List[Path]:
    """All ``.dtpu`` pointers under ``root`` (recursive, sorted)."""
    return sorted(Path(root).rglob(f"*{POINTER_SUFFIX}"))
