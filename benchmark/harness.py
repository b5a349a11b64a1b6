"""One run of one cell: set-up, the closed-loop window, the reference check
and the metrics.

Set-up builds (or finds built) the port's kernels, draws the weights on the
device from the seed, builds the pipeline with every component resident and
runs one warm-up clip of the cell's own shapes. What belongs to one pipeline
(its components, its call, its draws, its counted work and its reference)
is in its pair of files, found by the configuration's `pipeline`
(benchmark.paths). The window then drives
clips back to back from one client, each with its own prompt and draws,
until `seconds` have passed; it closes when the clip in flight ends. With
`trace` the device's kernels are profiled over the whole window. After the
window the peak memory is read, the program is freed, and one clip drawn
from the seed is generated again by the plain reference: the numbers
compared, each beside its limit, decide `correct`.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import paths, program, spans, weights
from benchmark.metrics import reader
from benchmark.seeds import rng
from benchmark.trace import DeviceTrace, summarize

CHECKS_DIR = Path(__file__).resolve().parent / "checks"


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read: each clip's latency and phases, the
    window's wall seconds, set-up seconds, the device's peak bytes, one
    clip's counted work (benchmark.flops.work) and, in a traced run,
    the trace's summary (benchmark.trace.summarize)."""

    clips: list
    wall_s: float
    setup_s: float
    peak_bytes: int
    work: dict
    trace: dict = None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def compare(out: dict, ref: dict) -> dict:
    """The numbers compared: the worst frame's mean absolute difference of
    the frames (in [0, 1]) and, with audio, the waveform's relative RMS
    difference. A shape that differs or a value that is not finite reads inf."""
    nums = {}
    p, r = np.asarray(out["frames"], np.float32), np.asarray(ref["frames"], np.float32)
    if p.shape != r.shape or not np.isfinite(p).all():
        nums["frames_worst_mae"] = math.inf
    else:
        nums["frames_worst_mae"] = float(np.abs(p - r).reshape(p.shape[0], -1).mean(1).max())
    if ref.get("audio") is not None:
        a = None if out.get("audio") is None else np.asarray(out["audio"], np.float64)
        b = np.asarray(ref["audio"], np.float64)
        if a is None or a.shape != b.shape or not np.isfinite(a).all():
            nums["audio_rel_rms"] = math.inf
        else:
            nums["audio_rel_rms"] = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    return nums


def limits_of(workload: str) -> dict:
    return json.loads((CHECKS_DIR / f"{workload}.json").read_text())["limits"]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(config: dict, seed: int, device):
    """(pipeline, weights): the port's pipeline resident on `device` over
    weights drawn from `seed`."""
    path = paths.program_side(config)
    modules = path.meta_modules(config)
    drawn = weights.draw(weights.inventory(modules), config["init"], seed, device)
    return path.build_pipeline(config, modules, drawn, device), drawn


def reference_output(config: dict, traffic, drawn: dict, clip: dict,
                     precision: str = "f32") -> dict:
    """The plain reference's output for `clip`, on the weights `drawn`."""
    ref = paths.reference_side(config)
    return ref.generate(ref.build(config, drawn, precision), config, traffic.params, clip)


def run_cell(config: dict, traffic, seed: int, seconds: float, trace: bool, device,
             t_start: float, limits: dict) -> tuple:
    """(RunRecord, checks {name: (value, limit)}, extras) of one run."""
    device = torch.device(device)
    if device.type == "cuda":
        built = program.build_kernels()
        log(f"[setup] kernels: {json.dumps(built)} s built (0: found built)")
    t0 = time.perf_counter()
    pipe, drawn = build(config, seed, device)
    sync(device)
    log(f"[setup] weights drawn and pipeline built: {time.perf_counter() - t0:.3f} s")
    path = paths.program_side(config)
    gen_config = path.generation_config(traffic)
    shapes = paths.reference_side(config).clip_shapes(config, traffic.params)
    t0 = time.perf_counter()
    path.run_clip(pipe, gen_config, traffic.clip(seed, -1, shapes, device))
    sync(device)
    log(f"[setup] warm-up clip: {time.perf_counter() - t0:.3f} s")
    setup_s = time.perf_counter() - t_start

    clips, marks = [], []
    attempted = failed = 0
    # one finished clip kept for the check, drawn uniformly from the seed
    # as the window goes (reservoir sampling): the others' frames are freed
    sampler, kept = rng(seed, "sample"), None
    program.reset_counters()
    tracer = DeviceTrace() if trace else None
    if tracer is not None:
        tracer.__enter__()
    w0 = time.perf_counter()
    while True:
        clip = traffic.clip(seed, attempted, shapes, device)
        attempted += 1
        step_ends = []
        call_ns = time.time_ns()
        t0 = time.perf_counter()
        try:
            frames, audio, timings = path.run_clip(
                pipe, gen_config, clip, on_progress=lambda i, n, s: step_ends.append(
                    time.time_ns()))
        except Exception as exc:  # a failed clip is counted; the window goes on
            failed += 1
            log(f"[window] clip {clip['index']} failed: {type(exc).__name__}: {exc}")
            frames = None
        t1 = time.perf_counter()
        if frames is not None:
            phases = program.phase_seconds(timings)
            clips.append({"index": clip["index"], "latency_s": t1 - t0, **phases})
            if sampler.random() * len(clips) < 1.0:
                kept = (clip["index"], frames, audio)
            del frames, audio
            # the gaps named by the innermost program span, then by the coarse marks
            marks += spans.marks(getattr(timings, "spans", ()))
            if step_ends:
                text_end = step_ends[0] - int(phases["steps"][0] * 1e9)
                marks += [(call_ns, text_end, "text"), (text_end, step_ends[-1], "denoise"),
                          (step_ends[-1], time.time_ns(), "decode")]
        del clip
        if t1 - w0 >= seconds:
            break
    wall_s = t1 - w0
    if tracer is not None:
        sync(device)
        tracer.__exit__(None, None, None)
    counts = program.read_counters() if device.type == "cuda" else {}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"[window] {len(clips)} clips of {attempted} in {wall_s:.3f} s")
    for c in clips:
        steps = c["steps"]
        log(f"[clip {c['index']}] latency {c['latency_s']:.4f} s: text {c['text']:.4f}, "
            f"steps {sum(steps):.4f} ({min(steps):.4f}-{max(steps):.4f}), decode "
            f"{c['decode']:.4f}, total {c['total']:.4f}")
    work = path.clip_work(config, traffic.params)
    log(f"[window] launches: {json.dumps(counts)}; counted from the shapes: "
        f"{work['attentions'] * len(clips)} attentions, {work['norms'] * len(clips)} RMSNorms, "
        f"{work['rope_tables'] * len(clips)} rope_tables")

    summary = None
    if tracer is not None:
        t0 = time.perf_counter()
        summary = summarize(tracer.kernels(), tracer.start_ns, tracer.end_ns, marks)
        del tracer
        log(f"[trace] {summary['kernels']} kernels reduced in {time.perf_counter() - t0:.2f} s;"
            f" seconds by group {json.dumps(summary['group_seconds'])}")
    record = RunRecord(clips=clips, wall_s=wall_s, setup_s=setup_s, peak_bytes=peak,
                       work=work, trace=summary)

    checks = {}
    if kept is not None:
        index, frames, audio = kept
        del kept, pipe
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = reference_output(config, traffic, drawn, traffic.clip(seed, index, shapes, device))
        log(f"[check] clip {index}: the reference in {time.perf_counter() - t0:.3f} s")
        checks = {k: (v, limits[k]) for k, v in compare(
            {"frames": frames, "audio": audio}, ref).items()}
    extras = {"attempted": attempted, "failed": failed, "counts": counts}
    return record, checks, extras


def result_line(record: RunRecord, checks: dict, extras: dict, metrics: list, device_info: dict,
                trace: bool) -> dict:
    """The last line: correct, attempted, failed, the metrics (each reader's
    value, those that read nothing left out), the device, the breakdown of a
    traced run, and the checks last."""
    values = {}
    for name, unit in metrics:
        value = reader(name)(record)
        if value is not None:
            values[name] = {"value": value, "unit": unit}
    correct = (bool(checks) and extras["failed"] == 0
               and all(v <= limit for v, limit in checks.values()))
    line = {"correct": correct, "attempted": extras["attempted"], "failed": extras["failed"],
            "metrics": values, "device": device_info}
    if trace and record.trace is not None:
        line["device"] = {**device_info, "busy_s": record.trace["busy_s"],
                          "window_s": record.trace["window_s"]}
        line["breakdown"] = record.trace["breakdown"]
    line["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    return line
