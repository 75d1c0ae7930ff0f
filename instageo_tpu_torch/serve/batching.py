"""Dynamic micro-batching for online inference (the port's own copy of
``instageo_tpu/serve/batching.py``).

Concurrent single-chip requests from any number of threads ride one device
call:

- requests queue up; a worker drains the queue up to ``max_batch`` or
  ``max_wait_ms`` (first-come request never waits longer than that);
- the batch is padded up to a fixed bucket size (powers of two by default),
  so the device sees a few fixed shapes;
- results are scattered back to per-request futures.

Usage::

    batcher = DynamicBatcher(predict_fn, max_batch=64, max_wait_ms=5)
    fut = batcher.submit(chip)          # (C, T, H, W) -> Future
    pred = fut.result()                 # (H, W)
    batcher.close()

``predict_fn`` takes a stacked ``(B, C, T, H, W)`` numpy array and returns
an array whose leading dim is B.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


class DynamicBatcher:
    """Coalesce concurrent single-chip requests into bucketed batches."""

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray], Any],
        max_batch: Optional[int] = None,
        max_wait_ms: float = 5.0,
        buckets: Optional[Sequence[int]] = None,
    ) -> None:
        if buckets is None:
            mb = 64 if max_batch is None else int(max_batch)
            buckets = [1 << i for i in range(mb.bit_length())
                       if (1 << i) <= mb]
            if buckets[-1] != mb:
                buckets.append(mb)
        elif max_batch is not None and max(buckets) != int(max_batch):
            # Explicit buckets define the padded shapes AND the cap
            # (max_batch = buckets[-1]); a conflicting max_batch would be
            # silently ignored — make the caller pick one.
            raise ValueError(
                f"buckets[-1]={max(buckets)} conflicts with "
                f"max_batch={max_batch}; the largest bucket IS the cap")
        self.buckets = sorted(set(int(b) for b in buckets))
        self.max_batch = self.buckets[-1]
        self.max_wait_s = max_wait_ms / 1e3
        self.predict_fn = predict_fn
        self._q: "queue.Queue" = queue.Queue()
        self._closed = threading.Event()
        self.batches_run = 0
        self.requests_served = 0
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="dynamic-batcher")
        self._worker.start()

    # -- public API --------------------------------------------------------

    def submit(self, x: np.ndarray) -> Future:
        """Enqueue one example (no batch dim); returns a Future of its
        prediction (batch dim stripped)."""
        if self._closed.is_set():
            raise RuntimeError("batcher is closed")
        fut: Future = Future()
        self._q.put((np.asarray(x), fut))
        # close() may have drained between the check and the put — sweep
        # again so this request cannot be stranded unresolved.
        if self._closed.is_set():
            self._fail_pending()
        return fut

    def predict(self, x: np.ndarray) -> Any:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(x).result()

    def close(self, timeout: float = 5.0) -> None:
        self._closed.set()
        self._worker.join(timeout)
        self._fail_pending()

    def _fail_pending(self) -> None:
        """Fail anything still queued so callers don't hang."""
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("batcher closed"))

    # -- worker ------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _collect(self) -> List:
        """Block for the first request, then drain up to max_batch or
        until max_wait_ms has passed since the first arrival."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # One free non-blocking sweep: take whatever is already
                # queued (arrived while the previous batch computed).
                try:
                    while len(batch) < self.max_batch:
                        batch.append(self._q.get_nowait())
                except queue.Empty:
                    pass
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self) -> None:
        while not self._closed.is_set():
            batch = self._collect()
            if not batch:
                continue
            xs = [x for x, _ in batch]
            futs = [f for _, f in batch]
            n = len(xs)
            try:
                # Stacking/padding stays inside the guard: ONE
                # shape-mismatched request must fail its batch, not kill
                # the worker thread and strand every later caller.
                b = self._bucket(n)
                stacked = np.stack(xs)
                if b > n:
                    pad = np.zeros((b - n,) + stacked.shape[1:],
                                   stacked.dtype)
                    stacked = np.concatenate([stacked, pad])
                preds = np.asarray(self.predict_fn(stacked))
            except Exception as e:  # propagate to every waiter
                for f in futs:
                    if not f.done():
                        f.set_exception(e)
                continue
            self.batches_run += 1
            self.requests_served += n
            for i, f in enumerate(futs):
                if not f.done():
                    f.set_result(preds[i])
