"""Input pipeline: shards → host decode → pinned upload → augment on the card.

Counterpart of ``deadtrees_tpu.data.pipeline`` for one process:

- a background producer thread streams and decodes tar samples
  (``data/tar.py``) into uint8 numpy batches (``_stack_samples``, with the
  2-class collapse), and copies them into pinned memory when the batches
  go to a CUDA device;
- ``_finish_batch`` uploads a batch (non-blocking from pinned memory), runs
  ``augment_batch`` on the device (the fused jitter + normalize kernel for
  every CUDA training batch) and then the boundary-loss distance maps
  (``batch_one_hot2dist``) from the augmented mask;
- the epoch length is ``len(train_shards) * shard_size // batch_size``;
  ``train_batches`` takes a fresh stream seed from its generator every
  epoch.

- ``val_batches`` and ``test_batches`` stream their shards once, unshuffled,
  in eval mode (normalize only).

Not ported yet, each raising ``NotImplementedError``: ``pattern_extra``
mixing, ``process_count > 1``, the eval slicing of several processes,
remote and cached shards, and the native reader.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from deadtrees_tpu_torch.data.augment import augment_batch
from deadtrees_tpu_torch.data.config import DATASET_CONFIG
from deadtrees_tpu_torch.data.shards import discover_shards, split_shards
from deadtrees_tpu_torch.data.tar import count_shard_samples, make_sample_stream
from deadtrees_tpu_torch.losses.functional import batch_one_hot2dist, class2one_hot

_QUEUED = "(ROADMAP.md, slice A queue)"


@dataclasses.dataclass
class DataConfig:
    data_dir: Union[str, List[str]]  # one dir (split by fractions) or [train, val, test]
    pattern: str = "*.tar"
    batch_size: int = 32
    pattern_extra: Optional[List[str]] = None
    shuffle_buffer: int = 128
    prefetch: int = 2  # host batches queued ahead
    in_channels: int = 4
    classes: int = 3
    distmap: bool = True
    split_fractions: Sequence[float] = DATASET_CONFIG.fractions
    seed: int = 0
    use_native: bool = False
    cache_dir: Optional[str] = None
    process_count: Optional[int] = None
    device: Union[str, torch.device, None] = None  # CUDA unless asked otherwise


def _stack_samples(samples: List[Dict], *, in_channels: int, classes: int) -> Dict:
    """Assemble decoded samples into one uint8 host batch."""
    batch: Dict = {"image": np.stack([s["image"][..., :in_channels] for s in samples])}
    if "mask" in samples[0]:
        masks = np.stack([s["mask"] for s in samples]).astype(np.int32)
        if classes == 2:
            masks[masks > 1] = 1
        batch["mask"] = masks
    if "lu" in samples[0]:
        batch["lu"] = np.stack([s["lu"] for s in samples]).astype(np.int32)
    batch["files"] = [s.get("stats", {}).get("file", "") for s in samples]
    return batch


class _BatchProducer:
    """Background thread turning a sample stream into a queue of host
    batches (torch tensors, pinned when ``pin``)."""

    def __init__(self, stream, batch_size: int, cfg: DataConfig, pin: bool):
        self.stream = stream
        self.batch_size = batch_size
        self.cfg = cfg
        self.pin = pin
        self.q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch + 1)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _make_batch(self, buf: List[Dict]) -> Dict:
        batch = _stack_samples(buf, in_channels=self.cfg.in_channels, classes=self.cfg.classes)
        for k in ("image", "mask", "lu"):
            if k in batch:
                t = torch.from_numpy(batch[k])
                batch[k] = t.pin_memory() if self.pin else t
        return batch

    def _put(self, item) -> bool:
        """Queue ``item`` unless asked to stop; False once stopped."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        buf: List[Dict] = []
        try:
            for sample in self.stream:
                if self._stop.is_set():
                    return
                buf.append(sample)
                if len(buf) == self.batch_size:
                    if not self._put(self._make_batch(buf)):
                        return
                    buf = []
            # partial batches are dropped (.batched(bs, partial=False))
        except BaseException as e:  # surfaced on the consumer thread
            self._put(e)
        finally:
            self._put(None)

    def __iter__(self) -> Iterator[Dict]:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)


class DeadtreesDataModule:
    """Shards → ready-to-train device batches, in one process."""

    def __init__(self, config: DataConfig):
        from deadtrees_tpu_torch.infer.engine import resolve_device

        if config.pattern_extra:
            raise NotImplementedError(f"pattern_extra mixing is not ported yet {_QUEUED}")
        if (config.process_count or 1) > 1:
            raise NotImplementedError(
                f"process_count={config.process_count}: several processes are not ported "
                f"yet {_QUEUED}"
            )
        if config.use_native:
            raise NotImplementedError(f"the native C++ shard reader is not ported yet {_QUEUED}")
        if config.cache_dir is not None:
            raise NotImplementedError(f"cache_dir is not ported yet {_QUEUED}")
        self.cfg = config
        self.device = resolve_device(config.device)
        if isinstance(config.data_dir, (list, tuple)):
            self.data_shards = [
                [str(p) for p in discover_shards(d, config.pattern)] for d in config.data_dir
            ]
            self.layout = "train/val/test"
        else:
            self.data_shards = [str(p) for p in discover_shards(config.data_dir, config.pattern)]
            self.layout = "single_directory"
        self._setup_done = False

    def setup(self) -> None:
        if self.layout == "single_directory":
            train, valid, test = split_shards(self.data_shards, list(self.cfg.split_fractions))
        else:
            train, valid, test = self.data_shards
        if not train:
            raise ValueError(f"no train shards matching {self.cfg.pattern!r}")
        self.train_shards, self.valid_shards, self.test_shards = train, valid, test
        self.shard_size = count_shard_samples(train[0])
        self._setup_done = True

    @property
    def steps_per_epoch(self) -> int:
        return len(self.train_shards) * self.shard_size // self.cfg.batch_size

    def _finish_batch(
        self, generator: Optional[torch.Generator], host_batch: Dict, *, train: bool
    ) -> Dict:
        dev = self.device

        def up(name):
            t = host_batch.get(name)
            return None if t is None else t.to(dev, non_blocking=True)

        out = augment_batch(generator, up("image"), up("mask"), up("lu"), train=train)
        if self.cfg.distmap and "mask" in out:
            out["distmap"] = batch_one_hot2dist(class2one_hot(out["mask"], self.cfg.classes))
        out["files"] = host_batch["files"]
        return out

    def _stream(
        self, shards: List[str], *, shuffle: int, train: bool, loop: bool,
        generator: Optional[torch.Generator], stream_seed: int,
    ) -> Iterator[Dict]:
        producer = _BatchProducer(
            make_sample_stream(shards, shuffle=shuffle, seed=stream_seed, loop=loop),
            self.cfg.batch_size, self.cfg, pin=self.device.type == "cuda",
        )
        try:
            for host_batch in producer:
                yield self._finish_batch(generator, host_batch, train=train)
        finally:
            producer.stop()

    def train_batches(
        self, generator: Optional[torch.Generator] = None, *, loop: bool = False
    ) -> Iterator[Dict]:
        """One epoch of augmented training batches; the stream seed and the
        augmentation parameters come from ``generator`` (a CPU generator),
        so every epoch shuffles anew."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        stream_seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        return self._stream(
            self.train_shards, shuffle=max(self.cfg.shuffle_buffer, self.shard_size),
            train=True, loop=loop, generator=generator, stream_seed=stream_seed,
        )

    def val_batches(self) -> Iterator[Dict]:
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        return self._stream(
            self.valid_shards, shuffle=0, train=False, loop=False,
            generator=None, stream_seed=self.cfg.seed,
        )

    def test_batches(self) -> Iterator[Dict]:
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if not self.test_shards:
            return iter(())
        return self._stream(
            self.test_shards, shuffle=0, train=False, loop=False,
            generator=None, stream_seed=self.cfg.seed,
        )
