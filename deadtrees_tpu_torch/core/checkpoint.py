"""Checkpoint files in the JAX package's own format.

Counterpart of ``deadtrees_tpu.core.checkpoint``: a checkpoint is the
magic line ``DTPU1\\n`` followed by ONE msgpack map (flax serialization)
holding ``{hparams, step, epoch, params, batch_stats, [opt_state],
[extra]}``, with the flax ``{"params", "batch_stats"}`` trees as numpy
arrays. Files written here load in ``deadtrees_tpu.core.load_checkpoint``
and the reverse (first-party codec: ``core/msgpack_codec.py``).

- :func:`load_model` rebuilds the port's model from the embedded hparams
  and carries the weights across (``models/convert.py``);
- a ``.dtpu`` pointer is written next to every checkpoint and verified on
  load when present, so a corrupted file fails loudly;
- ``opt_state`` is the flax bytes of an optax state; it is written from
  bytes or from the state-dict tree of ``train.optim.optimizer_state_dict``
  (encoded to the same bytes) and read back as bytes;
- every save first takes a :func:`snapshot`: a host copy of the trees
  that shares no storage with the live tensors, so a write that finishes
  later never sees a later step;
- :class:`AsyncCheckpointWriter` takes the snapshot on the calling thread
  and encodes and writes on one worker thread;
- :class:`BestCheckpointKeeper` keeps the best checkpoint on a monitored
  metric and always the last one (a copy of the JAX package's keeper).
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deadtrees_tpu_torch.core.artifacts import maybe_verify, pointer_path, write_pointer
from deadtrees_tpu_torch.core.msgpack_codec import PackedBin, pack_chunks, unpackb

log = logging.getLogger(__name__)

_MAGIC = b"DTPU1\n"


def snapshot(tree: Any) -> Any:
    """A host copy of ``tree`` (nested dicts of tensors, numpy arrays and
    scalars) with numpy leaves that share no storage with the input, on
    every device: ``.cpu()`` copies a CUDA tensor but returns a CPU tensor
    itself, and ``.numpy()`` is then a view of the live parameter."""
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.clone() if t.device.type == "cpu" else t.cpu()).numpy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return np.asarray(tree)


def _build_payload(
    *,
    params: Any,
    batch_stats: Any,
    hparams: Dict[str, Any],
    opt_state: Union[bytes, Dict[str, Any], None] = None,
    step: int = 0,
    epoch: int = 0,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The checkpoint's map with every tree snapshotted; ``opt_state`` stays
    a tree until :func:`_encode`."""
    payload = {
        "hparams": json.dumps(hparams).encode(),
        "step": np.int64(step),
        "epoch": np.int64(epoch),
        "params": snapshot(params),
        "batch_stats": snapshot(batch_stats),
    }
    if opt_state is not None:
        payload["opt_state"] = (
            snapshot(opt_state) if isinstance(opt_state, dict) else bytes(opt_state)
        )
    if extra:
        payload["extra"] = json.dumps(extra).encode()
    return payload


def _encode(payload: Dict[str, Any]) -> List:
    """The file's msgpack map as buffers that view the snapshot's arrays
    (``msgpack_codec.pack_chunks``): nothing of the size of the file is
    copied under the GIL, which the train loop's thread needs."""
    if isinstance(payload.get("opt_state"), dict):
        payload = dict(payload, opt_state=PackedBin(pack_chunks(payload["opt_state"])))
    return pack_chunks(payload)


def _write_blob(path: Union[str, Path], chunks: List) -> None:
    """Write atomically, then the ``.dtpu`` pointer."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        for chunk in chunks:
            f.write(chunk)
    tmp.replace(path)  # atomic
    write_pointer(path)


def save_checkpoint(
    path: Union[str, Path],
    *,
    params: Any,
    batch_stats: Any,
    hparams: Dict[str, Any],
    opt_state: Union[bytes, Dict[str, Any], None] = None,
    step: int = 0,
    epoch: int = 0,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a checkpoint atomically, then its ``.dtpu`` pointer.

    ``params`` / ``batch_stats`` are flax-layout trees (numpy arrays or
    tensors as leaves): ``models.variables_from_state_dict`` makes them
    from a port model's ``state_dict()``. ``opt_state``: flax bytes of an
    optax state, or the tree of ``train.optim.optimizer_state_dict``."""
    _write_blob(path, _encode(_build_payload(
        params=params, batch_stats=batch_stats, hparams=hparams, opt_state=opt_state,
        step=step, epoch=epoch, extra=extra,
    )))


class AsyncCheckpointWriter:
    """Checkpoint encoding and file writes off the calling thread.

    ``save()`` takes the :func:`snapshot` on the calling thread (the one
    device-to-host copy that cannot be deferred: the next step updates the
    parameters in place) and hands the msgpack encode and the atomic write
    to ONE worker thread, so writes apply in submission order. Call
    :meth:`wait` before reading the files back; it raises the first failure
    again.
    """

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer"
        )
        self._pending: List[concurrent.futures.Future] = []

    def save(self, path: Union[str, Path], **kwargs) -> None:
        """Asynchronous :func:`save_checkpoint` (the same keywords)."""
        self.save_many([path], **kwargs)

    def save_many(self, paths: Sequence[Union[str, Path]], **kwargs) -> None:
        """One snapshot written to several paths (last.ckpt and a new
        best): the copy and the encode happen once."""
        payload = _build_payload(**kwargs)
        self._pending.append(self._pool.submit(self._write_all, list(paths), payload))

    @staticmethod
    def _write_all(paths, payload) -> None:
        chunks = _encode(payload)
        for p in paths:
            _write_blob(p, chunks)

    def delete(self, path: Union[str, Path]) -> None:
        """Remove a file and its pointer ON THE WORKER, ordered after every
        write queued before it: an unlink from the calling thread could
        run before the file's own queued write, which would then land a
        stale checkpoint."""

        def unlink(p=Path(path)):
            p.unlink(missing_ok=True)
            pointer_path(p).unlink(missing_ok=True)

        self._pending.append(self._pool.submit(unlink))

    def wait(self) -> None:
        """Block until every queued write is on disk; raise the first
        failure again (later ones are logged)."""
        pending, self._pending = self._pending, []
        first: Optional[BaseException] = None
        for fut in pending:
            try:
                fut.result()
            except BaseException as e:  # noqa: BLE001 - raised again below
                if first is None:
                    first = e
                else:
                    log.error(f"additional checkpoint write failed: {e!r}")
        if first is not None:
            raise first

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)


def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """Read a checkpoint (verifying its pointer when one is present)."""
    maybe_verify(path)
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"Not a deadtrees-tpu checkpoint: {path}")
        payload = unpackb(f.read())
    payload["hparams"] = json.loads(payload["hparams"])
    if "extra" in payload:
        payload["extra"] = json.loads(payload["extra"])
    return payload


def load_model(
    path: Union[str, Path], *, device: Union[str, torch.device] = "cuda"
) -> Tuple[torch.nn.Module, Dict[str, Any], Dict[str, Any]]:
    """Rebuild ``(model, variables, hparams)`` from a checkpoint file: the
    port's model in eval mode on ``device`` with the checkpoint's weights,
    the flax-layout variables as read, and the hparams."""
    from deadtrees_tpu_torch.models import create_model, state_dict_from_variables

    ckpt = load_checkpoint(path)
    hp = ckpt["hparams"]
    model = create_model(**hp)
    variables = {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
    model.load_state_dict(
        state_dict_from_variables(variables, encoder_name=model.encoder_name)
    )
    return model.to(device).eval(), variables, hp


class BestCheckpointKeeper:
    """Monitor-metric retention: top-1 best + always-last
    (``ModelCheckpoint(monitor='val/dice', mode='max', save_top_k=1,
    save_last=True)``)."""

    def __init__(
        self,
        directory: Union[str, Path],
        *,
        monitor: str = "val/dice",
        mode: str = "max",
        filename: str = "epoch_{epoch:03d}.ckpt",
    ):
        if mode not in ("max", "min"):
            raise ValueError(f"mode={mode!r}; expected 'max' or 'min'")
        self.directory = Path(directory)
        self.monitor = monitor
        self.mode = mode
        self.filename = filename
        self.best_value: Optional[float] = None
        self.best_path: Optional[Path] = None

    def is_improvement(self, value: float) -> bool:
        if self.best_value is None:
            return True
        return value > self.best_value if self.mode == "max" else value < self.best_value

    def update(
        self, value: float, epoch: int, save_fn, save_many_fn=None, delete_fn=None,
    ) -> Optional[Path]:
        """``save_fn(path)`` writes the checkpoint; returns the new best
        path, if any. ``save_many_fn(paths)``, when given, writes one
        snapshot to several paths; ``delete_fn(path)`` removes the
        superseded best (default: unlink it and its pointer)."""
        last = self.directory / "last.ckpt"
        if self.is_improvement(value):
            new_best = self.directory / self.filename.format(epoch=epoch)
            if save_many_fn is not None:
                save_many_fn([last, new_best])
            else:
                save_fn(last)
                save_fn(new_best)
            if self.best_path is not None and self.best_path != new_best:
                if delete_fn is not None:
                    delete_fn(self.best_path)
                elif self.best_path.exists():
                    self.best_path.unlink()
                    pointer_path(self.best_path).unlink(missing_ok=True)
            self.best_path = new_best
            self.best_value = value
            log.info(f"New best {self.monitor}={value:.4f} at {new_best}")
            return new_best
        save_fn(last)
        return None
