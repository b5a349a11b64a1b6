"""Observability: [DIAG] stat lines, spans, profiler traces and the denoise
loop's resume.

Port of ltx_tpu/utils/diagnostics.py. `diag_stats` logs the reference's
[DIAG] line, character for character, when LTX_DIAG=1, so that two runs'
latents can be diffed line by line. `span` times a piece of host work into
the active recorder (`recording`; the pipeline's is its call's
GenerationTimings) and names it as a torch.profiler range. `profile_trace`
wraps torch.profiler (CPU and CUDA activities) and writes a Chrome trace.
`DenoiseCheckpoint` pickles the loop's state as numpy arrays under the
reference's keys with an atomic replace: a file written by either package
resumes in the other.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import logging
import os
import pickle
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

log = logging.getLogger("ltx_tpu_torch")

DIAG_ENABLED = os.environ.get("LTX_DIAG", "0") == "1"


def _host(array) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        return array.detach().float().cpu().numpy()
    return np.asarray(array)


def diag_stats(name: str, array, first_n: int = 5) -> Optional[str]:
    """Log '[DIAG] name: shape=[...] mean=... std=... firstN=[...]' (f32
    statistics) when LTX_DIAG=1 and return it; None otherwise. Copies the
    array to the host."""
    if not DIAG_ENABLED:
        return None
    arr = np.asarray(_host(array), np.float32)
    flat = arr.reshape(-1)
    msg = (f"[DIAG] {name}: shape={list(arr.shape)} mean={flat.mean():.6f} "
           f"std={flat.std():.6f} first{first_n}="
           f"{[round(float(v), 6) for v in flat[:first_n]]}")
    log.info(msg)
    return msg


_active = contextvars.ContextVar("ltx_tpu_torch.recorder", default=None)
_clip_ids = itertools.count(1)

# the recorders of the last generate_* calls that returned, oldest first:
# a benchmark reads its window's clips here after the window
recent_clips = collections.deque(maxlen=256)


def next_clip_id() -> int:
    """A process-wide id, one higher each call: a clip's, carried by the
    names of its profiler ranges."""
    return next(_clip_ids)


def active():
    """The active recorder (`recording`), or None."""
    return _active.get()


@contextlib.contextmanager
def recording(recorder):
    """Make `recorder` the active recorder over the block, in this thread or
    task: every `span` inside it calls recorder.record(name, start_ns,
    end_ns). The one active before is active again after, raised or not."""
    token = _active.set(recorder)
    try:
        yield recorder
    finally:
        _active.reset(token)


@contextlib.contextmanager
def span(name: str):
    """Time the block on the host's realtime clock (time.time_ns, the clock
    Kineto stamps device events with, so a span lines up with the kernels
    of a trace) into the active recorder, and name it as the profiler range
    `ltx/clip<id>/<name>` (`ltx/<name>` with no recorder active). A block
    that raises records nothing. It waits for nothing on the device."""
    recorder = _active.get()
    label = f"ltx/{name}" if recorder is None else f"ltx/clip{recorder.clip_id}/{name}"
    with torch.profiler.record_function(label):
        start = time.time_ns()
        yield
        end = time.time_ns()
    if recorder is not None:
        recorder.record(name, start, end)


@contextlib.contextmanager
def profile_trace(log_dir: str = "ltx_trace"):
    """torch.profiler over the block (CPU, and CUDA when available): on
    exit a Chrome trace `log_dir`/trace_<time>.json (chrome://tracing,
    Perfetto) is written and its path logged. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        path = Path(log_dir) / f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
        prof.export_chrome_trace(str(path))
        prof.trace_path = str(path)
        log.info("profiler trace written to %s", path)


@dataclasses.dataclass
class DenoiseCheckpoint:
    """The denoise loop's state saved every `every_n_steps` steps, so that
    an interrupted run resumes where it stopped: the step index, the latent
    and the carried velocity (numpy), the sigma schedule (a resume needs the
    same one) and the seed."""

    path: str
    every_n_steps: int = 2

    def save(self, step: int, latent, velocity, sigmas, seed: int,
             extra: Optional[dict] = None) -> None:
        if self.every_n_steps <= 0 or (step + 1) % self.every_n_steps:
            return
        state = {
            "step": step,
            "latent": _host(latent),
            "velocity": _host(velocity),
            "sigmas": np.asarray(sigmas),
            "seed": seed,
            "extra": extra or {},
        }
        tmp = self.path + ".tmp"
        Path(tmp).parent.mkdir(parents=True, exist_ok=True)
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, self.path)  # atomic
        log.debug("denoise checkpoint saved at step %d -> %s", step, self.path)

    def load(self) -> Optional[dict]:
        if not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            state = pickle.load(f)
        log.info("resuming denoise from step %d (%s)", state["step"] + 1, self.path)
        return state

    def clear(self) -> None:
        Path(self.path).unlink(missing_ok=True)
