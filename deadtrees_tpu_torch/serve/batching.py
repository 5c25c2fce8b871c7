"""Dynamic request batching for the serving layer.

A copy of ``deadtrees_tpu.serve.batching`` (it holds no JAX). The
reference backend runs one model call per HTTP request; a GPU, like the
TPU, serves batches more cheaply per image. ``MicroBatcher`` coalesces
requests that arrive within a small window into one device dispatch:

- requests are grouped by image shape (H, W, C) — only identical shapes
  can be stacked into one batch;
- a group is flushed when it reaches ``max_batch`` or its oldest request
  has waited ``max_wait_ms``;
- the stacked batch is padded up to the next power of two (capped at
  ``max_batch``) so concurrency levels 1..max_batch give at most
  log2(max_batch)+1 distinct batch shapes per image size;
- results are fanned back out to the waiting handler threads via
  per-request events. An exception in the model call propagates to every
  request of that flush, never to later ones.

Purely host-side machinery (threads + condition variable): the device
sees bigger batches, callers see at most ``max_wait_ms`` extra latency.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["MicroBatcher", "bucket_size"]


def bucket_size(n: int, max_batch: int) -> int:
    """Next power of two ≥ n, capped at max_batch (≥ n by contract)."""
    if n >= max_batch:
        return max_batch
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


class _Pending:
    __slots__ = ("image", "event", "result", "error")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Coalesce single-image ``run`` calls into batched device dispatches.

    ``run_batch`` is the underlying engine call: (B, H, W, C) uint8 →
    (B, H', W') class maps (any array-like). ``submit`` blocks the
    calling thread until its image's result is ready.
    """

    def __init__(
        self,
        run_batch: Callable[[np.ndarray], Sequence[np.ndarray]],
        *,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be ≥ 1, got {max_batch}")
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.max_wait = max(0.0, float(max_wait_ms)) / 1000.0
        self._lock = threading.Condition()
        self._queues: Dict[Tuple[int, ...], List[_Pending]] = {}
        self._oldest: Dict[Tuple[int, ...], float] = {}
        self._closed = False
        self.dispatches = 0  # observability: device calls made
        self.requests = 0  # observability: images served
        self._worker = threading.Thread(
            target=self._loop, name="microbatcher", daemon=True
        )
        self._worker.start()

    # -- caller side -----------------------------------------------------

    def submit(self, image: np.ndarray) -> np.ndarray:
        """One (H, W, C) image → its (H', W') prediction. Blocks."""
        if image.ndim != 3:
            raise ValueError(f"submit takes one (H, W, C) image, got {image.shape}")
        entry = _Pending(image)
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            key = image.shape
            q = self._queues.setdefault(key, [])
            if not q:
                self._oldest[key] = time.monotonic()
            q.append(entry)
            self.requests += 1
            self._lock.notify_all()
        entry.event.wait()
        if entry.error is not None:
            raise entry.error
        return entry.result

    def close(self) -> None:
        """Stop the worker; pending requests are failed, not dropped."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._worker.join(timeout=5)

    # -- worker side -----------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._lock:
                batch = self._next_batch_locked()
                if batch is None:  # closed and drained
                    for q in self._queues.values():
                        for e in q:
                            e.error = RuntimeError("MicroBatcher closed")
                            e.event.set()
                    self._queues.clear()
                    return
                if not batch:  # nothing ripe yet; wait for work/ripeness
                    timeout = self._time_to_ripe_locked()
                    self._lock.wait(timeout=timeout)
                    continue
            self._dispatch(batch)

    def _time_to_ripe_locked(self) -> Optional[float]:
        if not self._oldest:
            return None
        now = time.monotonic()
        return max(
            0.0, min(t + self.max_wait - now for t in self._oldest.values())
        )

    def _next_batch_locked(self) -> Optional[List[_Pending]]:
        """Pop a ripe group, [] if none ripe, None if closed+empty."""
        now = time.monotonic()
        ready_key = None
        for key, q in self._queues.items():
            if not q:
                continue
            if (
                len(q) >= self.max_batch
                or now - self._oldest[key] >= self.max_wait
                or self._closed  # drain immediately on close
            ):
                # oldest ripe group first
                if ready_key is None or self._oldest[key] < self._oldest[ready_key]:
                    ready_key = key
        if ready_key is None:
            if self._closed and not any(self._queues.values()):
                return None
            return []
        q = self._queues[ready_key]
        batch, rest = q[: self.max_batch], q[self.max_batch :]
        if rest:
            self._queues[ready_key] = rest
            self._oldest[ready_key] = now
        else:
            del self._queues[ready_key]
            del self._oldest[ready_key]
        return batch

    def _dispatch(self, batch: List[_Pending]) -> None:
        n = len(batch)
        size = bucket_size(n, self.max_batch)
        stacked = np.stack([e.image for e in batch])
        if size > n:  # pad with the last image; outputs beyond n are dropped
            pad = np.broadcast_to(
                stacked[-1:], (size - n,) + stacked.shape[1:]
            )
            stacked = np.concatenate([stacked, pad])
        try:
            out = self._run_batch(stacked)
            self.dispatches += 1
            for i, e in enumerate(batch):
                e.result = np.asarray(out[i])
                e.event.set()
        except BaseException as err:  # fan the failure out, keep serving
            for e in batch:
                e.error = err
                e.event.set()
