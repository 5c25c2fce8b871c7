"""Input pipeline: shards → host decode → pinned upload → augment on the card.

Counterpart of ``deadtrees_tpu.data.pipeline``:

- background producer threads stream and decode tar samples
  (``data/tar.py``; by default through the native C++ reader on
  ``num_workers`` threads, ``data/native.py``) into uint8 batches
  (``_stack_samples``, with the 2-class collapse), pinned when the batches
  go to a CUDA device;
- ``pattern_extra`` datasets each get a producer of their own, looping
  forever, seeded ``stream_seed + 1 + i``; every batch is the main part of
  ``batch_size - sum(batch_size_extra)`` samples followed by
  ``batch_size_extra[i]`` samples of extra ``i`` (the reference's
  ``create_combined_batch``). Their shards split into train and val by the
  main set's train fraction; evaluation sees the extra val shards, test
  sees none;
- ``_finish_batch`` uploads a batch (non-blocking from pinned memory), runs
  ``augment_batch`` on the device (the fused jitter + normalize kernel for
  every CUDA training batch) and then the boundary-loss distance maps
  (``batch_one_hot2dist``) from the augmented mask;
- the epoch length is ``len(train_shards) * shard_size // batch_size``;
  ``train_batches`` takes a fresh stream seed from its generator every
  epoch; ``val_batches`` and ``test_batches`` stream their shards once,
  unshuffled, in eval mode (normalize only);
- shards may be local, ``pipe:`` commands or http(s) URLs; with
  ``cache_dir`` a remote shard is copied there on first touch (``setup``
  primes the cache with the probe shard) and later epochs read the copy.

Spans (``core/trace.py``, off unless enabled; ``spans.json`` of a profiled
fit), keyed by the batch's sequence number from its producer:
``data.decode`` on the producer thread (materialize, stack, pin); on the
thread that calls ``next()``, ``data.wait`` (blocked on the producer's
queue; the counter ``data.queue_depth`` takes the batches ready just
before), then ``data.upload``, ``data.augment`` (kernel 4's program) and
``data.edt`` (the distance maps) in ``_finish_batch``.

Several processes (the ranks of a data-parallel run, ``parallel/mesh.py``):
``process_index`` / ``process_count`` come from the config's override,
else from the process group, else 0 and 1 (the override needs no group,
so one process can play any rank). Each rank yields its LOCAL slice of
every global batch (``local_batch_size = batch_size // process_count``;
the count must divide the batch size and each part of it):

- train shards go round-robin and disjoint, ``train_shards[pi::pc]`` (a
  rank with none raises), the extra datasets' ``[pi::pc]`` (or all of
  them when there are fewer shards than ranks); each part of a batch is
  its size over ``pc``; the rank is folded into the stream seed and the
  augmentation generator, so the ranks' streams differ;
- ``steps_per_epoch`` is the minimum over the ranks, so that no rank
  waits in a collective for one whose stream ran dry;
- every rank streams the same raw eval and test batches (the same order
  and end) and decodes only its slice of each, which may span the main
  and extra parts (``tar.materialize_samples``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deadtrees_tpu_torch.core import trace
from deadtrees_tpu_torch.data.augment import augment_batch
from deadtrees_tpu_torch.data.config import DATASET_CONFIG
from deadtrees_tpu_torch.data.shards import discover_shards, split_shards
from deadtrees_tpu_torch.data.tar import (
    cache_shard,
    count_shard_samples,
    is_remote_shard,
    make_sample_stream,
    materialize_samples,
)
from deadtrees_tpu_torch.losses.functional import batch_one_hot2dist, class2one_hot


@dataclasses.dataclass
class DataConfig:
    data_dir: Union[str, List[str]]  # one dir or remote spec (split by fractions), or [train, val, test]
    pattern: str = "*.tar"
    batch_size: int = 32
    pattern_extra: Optional[List[str]] = None
    batch_size_extra: Optional[List[int]] = None
    shuffle_buffer: int = 128
    num_workers: int = 2  # native decode threads per stream
    prefetch: int = 2  # host batches queued ahead
    in_channels: int = 4
    classes: int = 3
    distmap: bool = True
    split_fractions: Sequence[float] = DATASET_CONFIG.fractions
    seed: int = 0
    use_native: bool = True  # the C++ tar/TIFF reader, built at first use
    # local copies of REMOTE shards (pipe:/http): epoch 1 streams them into
    # the cache, later epochs (and the native reader) read the copy
    cache_dir: Optional[str] = None
    # the ranks of a data-parallel run; None: the process group's (0 and 1 without one)
    process_index: Optional[int] = None
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


def _concat_parts(parts: List[Dict], pin: bool) -> Dict:
    """One host batch from its parts [main, *extras], in that order, into
    pinned memory when ``pin``; ``lu`` (when the main part has it) is zero
    for a part without it."""
    parts = [p for p in parts if p]  # {}: a part whose samples are all other ranks'
    keys = ["image", "mask"] + (["lu"] if "lu" in parts[0] else [])
    out: Dict = {"files": [f for p in parts for f in p["files"]]}
    for k in keys:
        ts = [p[k] if k in p else torch.zeros_like(p["mask"]) for p in parts]
        shape = (sum(t.shape[0] for t in ts), *ts[0].shape[1:])
        out[k] = torch.cat(ts, out=torch.empty(shape, dtype=ts[0].dtype, pin_memory=pin))
    return out


class _BatchProducer:
    """Background thread turning a sample stream into a queue of host
    batches (torch tensors, pinned when ``pin``).

    ``slice_range=(a, b)``: the stream is raw (``tar.materialize_samples``);
    the producer still takes ``batch_size`` samples a batch, as every rank
    does, but decodes and emits positions [a, b) only; ``{}`` when a == b
    (this rank's slice lies in another part of the batch)."""

    def __init__(self, stream, batch_size: int, cfg: DataConfig, pin: bool,
                 slice_range: Optional[Tuple[int, int]] = None):
        self.stream = stream
        self.batch_size = batch_size
        self.cfg = cfg
        self.pin = pin
        self.slice_range = slice_range
        self.q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch + 1)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.seq = -1  # the sequence number of the batch last yielded

    def _make_batch(self, buf: List[Dict]) -> Dict:
        if self.slice_range is not None:
            a, b = self.slice_range
            buf = materialize_samples(buf[a:b], n_threads=self.cfg.num_workers)
            if not buf:
                return {}
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
        samples = iter(self.stream)
        seq = 0
        try:
            for sample in samples:
                if self._stop.is_set():
                    return
                buf.append(sample)
                if len(buf) == self.batch_size:
                    with trace.span("data.decode", key=seq):
                        batch = self._make_batch(buf)
                    if not self._put(batch):
                        return
                    buf = []
                    seq += 1
            # partial batches are dropped (.batched(bs, partial=False))
        except BaseException as e:  # surfaced on the consumer thread
            self._put(e)
        finally:
            # an abandoned shard stream kills its pipe: child here
            close = getattr(samples, "close", None)
            if close is not None:
                close()
            self._put(None)

    def __iter__(self) -> Iterator[Dict]:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        seq = 0
        while True:
            if trace.ENABLED:
                # batches ready, of at most prefetch + 1, and the wait for the next
                trace.add("data.queue_depth", self.q.qsize())
                t0 = time.time_ns()
                item = self.q.get()
                trace.record("data.wait", t0, time.time_ns(), key=seq)
            else:
                item = self.q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            self.seq = seq  # FIFO from one thread: the producer's number of this batch
            seq += 1
            yield item

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)


class DeadtreesDataModule:
    """Shards → ready-to-train device batches: a rank's local slices."""

    def __init__(self, config: DataConfig):
        from deadtrees_tpu_torch.infer.engine import resolve_device

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

        self.data_shards_extra: List[List[str]] = []
        if config.pattern_extra:
            if self.layout == "train/val/test":
                raise ValueError("Combining pattern_extra with train/val/test layout not allowed")
            if not config.batch_size_extra or len(config.batch_size_extra) != len(
                config.pattern_extra
            ):
                raise ValueError("Len of <pattern_extra> and <batch_size_extra> don't match")
            if self.main_batch_size < 1:
                raise ValueError(
                    f"batch_size {config.batch_size} leaves no main samples beside "
                    f"batch_size_extra {config.batch_size_extra}"
                )
            for p in config.pattern_extra:
                if is_remote_shard(p):  # an extra dataset may be a remote spec of its own
                    self.data_shards_extra.append([str(x) for x in discover_shards(p, "")])
                elif is_remote_shard(config.data_dir):
                    raise ValueError(
                        "with a remote data_dir, pattern_extra entries must be full remote "
                        "shard specs (pipe:/http), not glob patterns"
                    )
                else:
                    self.data_shards_extra.append(
                        [str(x) for x in discover_shards(config.data_dir, p)]
                    )
        self._setup_done = False

    def setup(self) -> None:
        cfg = self.cfg
        if self.layout == "single_directory":
            train, valid, test = split_shards(self.data_shards, list(cfg.split_fractions))
        else:
            train, valid, test = self.data_shards
        if not train:
            raise ValueError(f"no train shards matching {cfg.pattern!r}")
        self.train_shards, self.valid_shards, self.test_shards = train, valid, test
        pi, pc = self.process_index, self.process_count
        self.train_shards_local = list(train[pi::pc])
        if not self.train_shards_local:
            raise ValueError(f"process {pi} of {pc} got no train shard ({len(train)} in all): "
                             "a data-parallel run needs one a process at least")

        probe = train[0]
        if cfg.cache_dir is not None:  # prime the cache: epoch 1 reuses the probe's copy
            probe = cache_shard(probe, cfg.cache_dir)
        self.shard_size = count_shard_samples(probe)

        self.extra_train_shards: List[List[str]] = []
        self.extra_valid_shards: List[List[str]] = []
        train_frac = len(train) / (len(train) + len(valid))
        for pattern, shards in zip(cfg.pattern_extra or [], self.data_shards_extra):
            ex_train, ex_val, _ = split_shards(shards, [train_frac, 1 - train_frac])
            if not ex_train or not ex_val:
                # an extra stream loops forever: with no shards it would spin
                raise ValueError(
                    f"pattern_extra {pattern!r} matched {len(shards)} shard(s): its train "
                    "and val parts each need one"
                )
            self.extra_train_shards.append(ex_train)
            self.extra_valid_shards.append(ex_val)
        self._setup_done = True

    @property
    def process_index(self) -> int:
        if self.cfg.process_index is not None:
            return int(self.cfg.process_index)
        return _group()[0]

    @property
    def process_count(self) -> int:
        if self.cfg.process_count is not None:
            return int(self.cfg.process_count)
        return _group()[1]

    @property
    def local_batch_size(self) -> int:
        """This rank's share of a batch; raises unless the process count
        divides the batch size."""
        pc = self.process_count
        if self.cfg.batch_size % pc:
            raise ValueError(f"batch_size {self.cfg.batch_size} not divisible by "
                             f"process_count {pc}")
        return self.cfg.batch_size // pc

    @property
    def main_batch_size(self) -> int:
        """The main dataset's share of a batch: the batch size less the extras'."""
        return self.cfg.batch_size - sum(self.cfg.batch_size_extra or [])

    @property
    def steps_per_epoch(self) -> int:
        """Steps every rank can take: the smallest rank's shards bound it."""
        pc = self.process_count
        if pc == 1:
            return len(self.train_shards) * self.shard_size // self.cfg.batch_size
        fewest = min(len(self.train_shards[p::pc]) for p in range(pc))
        return fewest * self.shard_size // self.local_batch_size

    def _finish_batch(
        self, generator: Optional[torch.Generator], host_batch: Dict, *, train: bool,
        key: Optional[int] = None,
    ) -> Dict:
        dev = self.device

        def up(name):
            t = host_batch.get(name)
            return None if t is None else t.to(dev, non_blocking=True)

        with trace.span("data.upload", key=key):
            image, mask, lu = up("image"), up("mask"), up("lu")
        with trace.span("data.augment", key=key):
            out = augment_batch(generator, image, mask, lu, train=train)
        if self.cfg.distmap and "mask" in out:
            with trace.span("data.edt", key=key):
                out["distmap"] = batch_one_hot2dist(class2one_hot(out["mask"], self.cfg.classes))
        out["files"] = host_batch["files"]
        return out

    def _part_sizes(self, n_extra: int, divisor: int) -> List[int]:
        """The sizes of a batch's parts [main, *extras], each over
        ``divisor`` (raises unless it divides each)."""
        cfg = self.cfg
        sizes = [self.main_batch_size if n_extra else cfg.batch_size]
        sizes += list(cfg.batch_size_extra or [])[:n_extra]
        for n in sizes:
            if n % divisor:
                raise ValueError(f"batch component {n} not divisible by process_count "
                                 f"{divisor}")
        return [n // divisor for n in sizes]

    def _local_ranges(self, sizes: List[int]) -> List[Tuple[int, int]]:
        """This rank's [a, b) in each part of the global batch: its slice
        ``[pi·n, (pi+1)·n)`` of the concatenated parts, ``n`` the local
        batch size."""
        n = self.local_batch_size
        lo, hi = self.process_index * n, (self.process_index + 1) * n
        ranges, off = [], 0
        for size in sizes:
            a = min(max(lo - off, 0), size)
            b = min(max(hi - off, 0), size)
            ranges.append((a, max(a, b)))
            off += size
        return ranges

    def _stream(
        self, shards: List[str], extra_shards: List[List[str]], *, shuffle: int, train: bool,
        loop: bool, generator: Optional[torch.Generator], stream_seed: int,
        local_slice: bool = False,
    ) -> Iterator[Dict]:
        """Finished batches of ``shards``, each followed by its extra parts
        from ``extra_shards`` (none: the main part is the whole batch).
        Training (several processes): each part is its size over the
        process count. ``local_slice``: raw streams of the global batches,
        of which this rank decodes its slice."""
        cfg = self.cfg
        pin = self.device.type == "cuda"
        sizes = self._part_sizes(len(extra_shards), self.process_count if train else 1)
        ranges = self._local_ranges(sizes) if local_slice else [None] * len(sizes)

        def producer(k, part_shards, seed, part_loop, part_pin):
            stream = make_sample_stream(
                part_shards, shuffle=shuffle, seed=seed, loop=part_loop,
                prefer_native=cfg.use_native, n_threads=cfg.num_workers, raw=local_slice,
                cache_dir=cfg.cache_dir,
            )
            return _BatchProducer(stream, sizes[k], cfg, pin=part_pin, slice_range=ranges[k])

        main = producer(0, shards, stream_seed, loop, pin and not extra_shards)
        extras = [producer(1 + i, s, stream_seed + 1 + i, True, False)
                  for i, s in enumerate(extra_shards)]
        extra_iters = [iter(e) for e in extras]
        try:
            for host_batch in main:
                if extra_iters:
                    parts = [host_batch] + [next(it) for it in extra_iters]
                    host_batch = _concat_parts(parts, pin)
                yield self._finish_batch(generator, host_batch, train=train, key=main.seq)
        finally:
            for p in [main, *extras]:
                p.stop()

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
        pi, pc = self.process_index, self.process_count
        if pc > 1:  # the rank folded in, as JAX folds process_index into its key
            base = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
            generator = torch.Generator().manual_seed(base * pc + pi)
        stream_seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        return self._stream(
            self.train_shards_local, [s[pi::pc] or s for s in self.extra_train_shards],
            shuffle=max(self.cfg.shuffle_buffer, self.shard_size), train=True, loop=loop,
            generator=generator, stream_seed=stream_seed,
        )

    def val_batches(self) -> Iterator[Dict]:
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        return self._stream(
            self.valid_shards, self.extra_valid_shards, shuffle=0, train=False, loop=False,
            generator=None, stream_seed=self.cfg.seed, local_slice=self.process_count > 1,
        )

    def test_batches(self) -> Iterator[Dict]:
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if not self.test_shards:
            return iter(())
        return self._stream(
            self.test_shards, [], shuffle=0, train=False, loop=False,
            generator=None, stream_seed=self.cfg.seed, local_slice=self.process_count > 1,
        )


def _group() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
