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
- ``opt_state`` (the flax bytes of an optax state) is read and written as
  opaque bytes;
- :class:`BestCheckpointKeeper` keeps the best checkpoint on a monitored
  metric and always the last one (a copy of the JAX package's keeper).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from deadtrees_tpu_torch.core.artifacts import maybe_verify, pointer_path, write_pointer
from deadtrees_tpu_torch.core.msgpack_codec import packb, unpackb

log = logging.getLogger(__name__)

_MAGIC = b"DTPU1\n"


def _to_numpy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(
    path: Union[str, Path],
    *,
    params: Any,
    batch_stats: Any,
    hparams: Dict[str, Any],
    opt_state: Optional[bytes] = None,
    step: int = 0,
    epoch: int = 0,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a checkpoint atomically, then its ``.dtpu`` pointer.

    ``params`` / ``batch_stats`` are flax-layout trees (numpy arrays or
    tensors as leaves): ``models.variables_from_state_dict`` makes them
    from a port model's ``state_dict()``."""
    payload = {
        "hparams": json.dumps(hparams).encode(),
        "step": np.int64(step),
        "epoch": np.int64(epoch),
        "params": _to_numpy_tree(params),
        "batch_stats": _to_numpy_tree(batch_stats),
    }
    if opt_state is not None:
        payload["opt_state"] = bytes(opt_state)
    if extra:
        payload["extra"] = json.dumps(extra).encode()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(packb(payload))
    tmp.replace(path)  # atomic
    write_pointer(path)


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
