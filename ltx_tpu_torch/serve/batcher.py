"""Dynamic request-level micro-batching for the latency-bound decode.

Port of ltx_tpu/serve/batcher.py. Concurrent callers submit single
payloads; a worker thread coalesces compatible payloads (same `group_key`:
the sampling parameters must match for the rows to share one batched
decode) into batches of up to `max_batch` and runs them through
`run_batch` together. B rows read every weight once a forward, so a batch
costs close to a single request.

Why not slot-level continuous batching: see ltx_tpu_torch/serve/__init__.py.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Hashable, List, Optional, Sequence


class MicroBatcher:
    """Coalesce concurrent submissions into device batches.

    run_batch(payloads) -> results: called on the worker thread with
        1 <= len(payloads) <= max_batch payloads sharing one group_key;
        must return one result per payload (same order). An exception
        fails every request in that batch (and only that batch).
    max_batch: memory-bound rows a batch (io/cli.py derives it from the
        device's memory, pipeline/enhance.py::enhance_max_batch).
    batch_window_s: after the first payload arrives, wait this long for
        more to coalesce before dispatching (0 = dispatch immediately).
        While the device is busy with a previous batch the queue keeps
        filling, so under load the window rarely matters.
    group_key(payload) -> Hashable: payloads may only share a batch when
        their keys are equal (e.g. (max_tokens, temperature, seed, i2v)).
    device_lock: optional lock shared with other device users (the
        generation JobQueue) — one device runs one workload at a time.
    """

    def __init__(
        self,
        run_batch: Callable[[List[Any]], Sequence[Any]],
        max_batch: int = 4,
        batch_window_s: float = 0.05,
        group_key: Callable[[Any], Hashable] = lambda p: None,
        device_lock: Optional[threading.Lock] = None,
        name: str = "batcher",
        on_batch: Optional[Callable[[float, int, bool], None]] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._run_batch = run_batch
        self._max_batch = max_batch
        self._window = batch_window_s
        self._group_key = group_key
        self._device_lock = device_lock
        self._name = name
        self._on_batch = on_batch  # (seconds, rows, ok) — metrics hook
        self._pending: deque = deque()  # (payload, key, Future)
        self._lock = threading.Lock()
        self._has_work = threading.Condition(self._lock)
        self._closed = False
        # stats (under self._lock)
        self._batches_run = 0
        self._requests_done = 0
        self._requests_failed = 0
        self._batch_sizes: deque = deque(maxlen=64)  # recent only (stats)
        self._worker = threading.Thread(
            target=self._loop, name=f"ltx-{name}", daemon=True)
        self._worker.start()

    def submit(self, payload) -> Future:
        """Enqueue one payload; resolve via the returned Future."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError(f"{self._name} is closed")
            self._pending.append((payload, self._group_key(payload), fut))
            self._has_work.notify()
        return fut

    def submit_many(self, payloads) -> List[Future]:
        """Enqueue several payloads atomically (they land adjacent, so a
        multi-prompt HTTP request coalesces with itself first)."""
        futs = [Future() for _ in payloads]
        with self._lock:
            if self._closed:
                raise RuntimeError(f"{self._name} is closed")
            for p, f in zip(payloads, futs):
                self._pending.append((p, self._group_key(p), f))
            self._has_work.notify()
        return futs

    def stats(self) -> dict:
        with self._lock:
            sizes = list(self._batch_sizes)
            return {
                "pending": len(self._pending),
                "batches_run": self._batches_run,
                "requests_done": self._requests_done,
                "requests_failed": self._requests_failed,
                "recent_batch_sizes": sizes,
                "max_batch": self._max_batch,
            }

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting work; drain what's queued, then join the worker."""
        with self._lock:
            self._closed = True
            self._has_work.notify()
        self._worker.join(timeout)

    # --- worker ---

    def _take_batch(self):
        """Pop the oldest payload plus every queued payload sharing its
        group_key, up to max_batch (non-matching payloads keep their
        order for the next batch). Caller holds self._lock."""
        first = self._pending.popleft()
        batch = [first]
        rest = deque()
        while self._pending and len(batch) < self._max_batch:
            item = self._pending.popleft()
            if item[1] == first[1]:
                batch.append(item)
            else:
                rest.append(item)
        rest.extend(self._pending)
        self._pending = rest
        return batch

    def _loop(self):
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._has_work.wait()
                if not self._pending:
                    return  # closed and drained
            if self._window > 0:
                # let concurrent arrivals coalesce; bounded, and skipped
                # entirely once the queue already holds a full batch
                deadline = time.monotonic() + self._window
                while time.monotonic() < deadline:
                    with self._lock:
                        if len(self._pending) >= self._max_batch:
                            break
                    time.sleep(min(0.005, self._window))
            with self._lock:
                if not self._pending:
                    continue
                batch = self._take_batch()
            payloads = [p for p, _k, _f in batch]
            futs = [f for _p, _k, f in batch]
            # t0 restarts AFTER the device lock is held so the batch
            # histogram records device time, not lock-queue wait behind a
            # minutes-long generation job
            t0 = time.monotonic()
            try:
                if self._device_lock is not None:
                    with self._device_lock:
                        t0 = time.monotonic()
                        results = self._run_batch(payloads)
                else:
                    results = self._run_batch(payloads)
                if len(results) != len(payloads):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"{len(payloads)} payloads")
            except Exception as e:  # noqa: BLE001 — fail THIS batch only
                with self._lock:
                    self._batches_run += 1
                    self._batch_sizes.append(len(batch))
                    self._requests_failed += len(batch)
                self._notify(time.monotonic() - t0, len(batch), False)
                for f in futs:
                    f.set_exception(e)
                continue
            with self._lock:
                self._batches_run += 1
                self._batch_sizes.append(len(batch))
                self._requests_done += len(batch)
            self._notify(time.monotonic() - t0, len(batch), True)
            for f, r in zip(futs, results):
                f.set_result(r)

    def _notify(self, seconds: float, rows: int, ok: bool) -> None:
        if self._on_batch is None:
            return
        try:
            self._on_batch(seconds, rows, ok)
        except Exception:  # noqa: BLE001 — metrics must never fail work
            logging.getLogger("ltx_tpu_torch").debug(
                "on_batch hook failed", exc_info=True)
