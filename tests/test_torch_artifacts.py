"""The port's content-addressed artifact cache against the JAX package's.

``core.artifacts.ArtifactCache`` and ``find_pointers`` are copies of the
JAX package's: a blob pushed by either package's cache is pulled by the
other's into a verified artifact, the cache layout
(``root/sha256[:2]/sha256[2:]``) and the pointers are the same files, a
same-size edit is re-hashed before a push (no blob under a stale hash),
and a pointer whose blob is absent raises.
"""

import pytest

from deadtrees_tpu.core import artifacts as jax_artifacts
from deadtrees_tpu_torch.core import artifacts


@pytest.mark.parametrize("pusher, puller", [(artifacts, jax_artifacts),
                                            (jax_artifacts, artifacts)])
def test_a_push_by_one_package_pulls_in_the_other(tmp_path, pusher, puller):
    work = tmp_path / "work"
    work.mkdir()
    for name, data in (("a.ckpt", b"weights" * 100), ("b.tar", b"shard" * 50)):
        (work / name).write_bytes(data)
    pushed = pusher.ArtifactCache(tmp_path / "cache").push([work / "a.ckpt", work / "b.tar"])
    assert [r["uploaded"] for r in pushed] == [True, True]
    digest = pushed[0]["sha256"]
    assert (tmp_path / "cache" / digest[:2] / digest[2:]).read_bytes() == b"weights" * 100
    assert artifacts.find_pointers(work) == jax_artifacts.find_pointers(work)
    (work / "a.ckpt").unlink()
    pulled = puller.ArtifactCache(tmp_path / "cache").pull(puller.find_pointers(work))
    assert [r["restored"] for r in pulled] == [True, False]
    assert (work / "a.ckpt").read_bytes() == b"weights" * 100
    assert artifacts.maybe_verify(work / "a.ckpt")


def test_a_same_size_edit_is_rehashed_and_a_missing_blob_raises(tmp_path):
    art = tmp_path / "m.ckpt"
    art.write_bytes(b"x" * 64)
    cache = artifacts.ArtifactCache(tmp_path / "cache")
    first = cache.push([art])[0]
    art.write_bytes(b"y" * 64)  # same size, new content
    second = cache.push([art])[0]
    assert second["sha256"] != first["sha256"] and second["uploaded"]
    assert second["sha256"] == jax_artifacts.hash_file(art)
    art.unlink()
    with pytest.raises(FileNotFoundError, match="not in cache"):
        artifacts.ArtifactCache(tmp_path / "empty").pull([artifacts.pointer_path(art)])
