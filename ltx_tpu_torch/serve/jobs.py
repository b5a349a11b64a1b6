"""Asynchronous generation job queue.

Port of ltx_tpu/serve/jobs.py. A generation holds the device for seconds
to minutes, so generation requests are JOBS: submit returns an id at once,
one worker drains the queue FIFO (one device, one generation at a time),
and clients poll the status. The worker shares `device_lock` with the
enhancement MicroBatcher so that short enhance batches run between jobs
instead of racing them for device memory.
"""

from __future__ import annotations

import threading
import time
import traceback
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional

PENDING = "pending"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"


class Job:
    __slots__ = ("job_id", "kind", "request", "state", "result", "error",
                 "submitted_at", "started_at", "finished_at")

    def __init__(self, kind: str, request: dict):
        self.job_id = uuid.uuid4().hex[:16]
        self.kind = kind
        self.request = request
        self.state = PENDING
        self.result: Optional[dict] = None
        self.error: Optional[str] = None
        self.submitted_at = time.time()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None

    def to_dict(self) -> dict:
        d = {
            "job_id": self.job_id,
            "kind": self.kind,
            "state": self.state,
            "request": self.request,
            "submitted_at": self.submitted_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
        }
        if self.result is not None:
            d["result"] = self.result
        if self.error is not None:
            d["error"] = self.error
        return d


class JobQueue:
    """FIFO job queue with one worker thread.

    run_job(job) -> result dict: executes on the worker thread; raising
        marks the job FAILED with the exception text (full traceback goes
        to the job record's error field — a serving front-end must never
        take the process down with one bad request).
    device_lock: optional shared single-device execution lock.
    keep: completed-job records retained (oldest evicted beyond this).
    run_batch/batch_key/max_batch: pending jobs whose batch_key matches
        the head job's coalesce into ONE run_batch([jobs]) -> [result, ...]
        call — same-shape T2V prompts share one batched denoise
        (pipeline.generate_videos). batch_key returning
        None (or raising) keeps a job solo; per-job isolation (seed,
        output, failure) is preserved — a batch failure fails exactly its
        own jobs.
    """

    def __init__(
        self,
        run_job: Callable[[Job], dict],
        device_lock: Optional[threading.Lock] = None,
        keep: int = 256,
        on_job: Optional[Callable[[str, str, float], None]] = None,
        run_batch: Optional[Callable[[List[Job]], List[dict]]] = None,
        batch_key: Optional[Callable[[Job], Any]] = None,
        max_batch: int = 4,
    ):
        self._run_job = run_job
        self._device_lock = device_lock
        self._keep = keep
        self._on_job = on_job  # (kind, final_state, seconds) — metrics hook
        # batched drain: when batch_key(job) is not None, pending jobs with
        # the SAME key coalesce (up to max_batch) into one run_batch call —
        # queued same-shape T2V prompts stack on the denoise batch axis
        # (pipeline.generate_videos).
        self._run_batch = run_batch
        self._batch_key = batch_key
        self._max_batch = max(1, int(max_batch))
        self._jobs: Dict[str, Job] = {}
        self._order: deque = deque()  # job ids, submission order
        self._queue: deque = deque()  # pending job ids
        self._lock = threading.Lock()
        self._has_work = threading.Condition(self._lock)
        self._closed = False
        self._worker = threading.Thread(
            target=self._loop, name="ltx-jobs", daemon=True)
        self._worker.start()

    def submit(self, kind: str, request: dict) -> str:
        job = Job(kind, request)
        with self._lock:
            if self._closed:
                raise RuntimeError("job queue is closed")
            self._jobs[job.job_id] = job
            self._order.append(job.job_id)
            self._queue.append(job.job_id)
            self._evict()
            self._has_work.notify()
        return job.job_id

    def get(self, job_id: str) -> Optional[dict]:
        with self._lock:
            job = self._jobs.get(job_id)
            return job.to_dict() if job else None

    def cancel(self, job_id: str) -> bool:
        """Cancel a still-pending job (running jobs finish: a generation
        has no safe preemption point)."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.state != PENDING:
                return False
            job.state = CANCELLED
            job.finished_at = time.time()
            try:
                self._queue.remove(job_id)
            except ValueError:
                pass
            return True

    def list_jobs(self, limit: int = 64) -> List[dict]:
        with self._lock:
            ids = list(self._order)[-limit:]
            return [self._jobs[i].to_dict() for i in reversed(ids)]

    def stats(self) -> dict:
        with self._lock:
            by_state: Dict[str, int] = {}
            for j in self._jobs.values():
                by_state[j.state] = by_state.get(j.state, 0) + 1
            return {"jobs": by_state, "queued": len(self._queue)}

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._closed = True
            self._has_work.notify()
        self._worker.join(timeout)

    # --- worker ---

    def _evict(self):
        while len(self._order) > self._keep:
            jid = self._order[0]
            job = self._jobs.get(jid)
            if job is not None and job.state in (PENDING, RUNNING):
                break  # never evict live work
            self._order.popleft()
            self._jobs.pop(jid, None)

    def _collect_batch(self, first: Job) -> List[Job]:
        """Under self._lock: pop pending jobs sharing first's batch key
        (submission order preserved for the rest of the queue)."""
        batch = [first]
        if self._run_batch is None or self._batch_key is None:
            return batch
        try:
            key = self._batch_key(first)
        except Exception:  # noqa: BLE001 — an unkeyable job runs solo
            return batch
        if key is None:
            return batch
        kept = deque()
        while self._queue and len(batch) < self._max_batch:
            jid = self._queue.popleft()
            job = self._jobs[jid]
            try:
                match = self._batch_key(job) == key
            except Exception:  # noqa: BLE001
                match = False
            if match:
                batch.append(job)
            else:
                kept.append(jid)
        self._queue.extendleft(reversed(kept))
        return batch

    def _loop(self):
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._has_work.wait()
                if not self._queue:
                    return
                first = self._jobs[self._queue.popleft()]
                batch = self._collect_batch(first)
                now = time.time()
                for job in batch:
                    job.state = RUNNING
                    job.started_at = now
            try:
                def _run():
                    if len(batch) == 1:
                        return [self._run_job(batch[0])]
                    return self._run_batch(batch)

                if self._device_lock is not None:
                    with self._device_lock:
                        results = _run()
                else:
                    results = _run()
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"{len(batch)} jobs")
                with self._lock:
                    for job, result in zip(batch, results):
                        job.result = result if isinstance(result, dict) \
                            else {"value": result}
                        job.state = DONE
                        job.finished_at = time.time()
            except Exception as e:  # noqa: BLE001 — record, keep serving
                with self._lock:
                    err = "".join(traceback.format_exception_only(
                        type(e), e)).strip()
                    for job in batch:
                        job.error = err
                        job.state = FAILED
                        job.finished_at = time.time()
            if self._on_job is not None:
                for job in batch:
                    try:
                        self._on_job(job.kind, job.state,
                                     job.finished_at - job.started_at)
                    except Exception:  # noqa: BLE001 — metrics never fail
                        pass

    def wait(self, job_id: str, timeout: float = 60.0,
             poll_s: float = 0.01) -> dict:
        """Test/CLI helper: block until the job leaves PENDING/RUNNING."""
        deadline = time.monotonic() + timeout
        d = self.get(job_id)
        if d is None:
            raise KeyError(job_id)
        while time.monotonic() < deadline:
            d = self.get(job_id)
            if d is None:
                raise KeyError(job_id)
            if d["state"] not in (PENDING, RUNNING):
                return d
            time.sleep(poll_s)
        raise TimeoutError(f"job {job_id} still {d['state']}")
