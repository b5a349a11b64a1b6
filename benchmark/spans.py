"""The program's own spans in a run: each window clip's spans, for the
readers of rope_ms, decode_host_ms and step_launch_ms; the spans as marks
that name the device's idle gaps; and the clock check of a traced run.

The port's LTXPipeline records every generate_* call's spans, (name,
start_ns, end_ns) on time.time_ns, into the call's GenerationTimings and
keeps the last calls' in `ltx_tpu_torch.utils.diagnostics.recent_clips`.
A program without them (one before spans) gives the readers nothing.

    python3 -m benchmark.spans --workload <name> --seed <n> --seconds <s>

runs one traced run of the cell as `python3 -m benchmark.run ... --trace 1`
does (whose idle gaps the harness names by the innermost program span each
falls in, its coarse marks after the spans), and logs the clock check (for
every `denoise.step` span, its end minus the end of the last kernel that
starts inside it) and the device's idle time inside the steps.
"""

from __future__ import annotations

import bisect
import statistics
import sys


def window_spans(run):
    """Each clip of the run's window, in order: its spans [(name, start_ns,
    end_ns)], read from the program's recent clips, the last len(run.clips)
    of them, each matched to its clip by `total`. None where the program
    keeps no spans or they do not match."""
    from ltx_tpu_torch.utils import diagnostics

    recent = list(getattr(diagnostics, "recent_clips", ()))
    n = len(run.clips)
    if n == 0 or len(recent) < n:
        return None
    recent = recent[-n:]
    if [t.total for t in recent] != [c["total"] for c in run.clips]:
        return None
    return [t.spans for t in recent]


def per_clip_ms(run, *names: str):
    """Milliseconds a clip of the spans named `names`, summed; None where
    no clip has one."""
    clips = window_spans(run)
    if not clips or not any(n in names for spans in clips for n, _, _ in spans):
        return None
    return 1e3 * sum((e - s) / 1e9 for spans in clips for n, s, e in spans
                     if n in names) / len(clips)


def per_span_ms(run, name: str):
    """Mean milliseconds of the window's spans named `name`; None without one."""
    clips = window_spans(run)
    seconds = [(e - s) / 1e9 for spans in clips or () for n, s, e in spans if n == name]
    return 1e3 * sum(seconds) / len(seconds) if seconds else None


def marks(spans) -> list:
    """The spans as the trace's marks [(start_ns, end_ns, name)], the
    shortest first, so that `trace.phase_at`'s first match is the innermost
    span around an instant."""
    return sorted(((s, e, n) for n, s, e in spans), key=lambda m: m[1] - m[0])


def step_end_lags_ms(kernels, spans) -> list:
    """For each `denoise.step` span with a kernel starting inside it: the
    span's end minus the latest end of those kernels, in ms. kernels:
    [(start_ns, end_ns, name)] sorted by start (DeviceTrace.kernels)."""
    starts = [k[0] for k in kernels]
    lags = []
    for name, s, e in spans:
        lo, hi = bisect.bisect_left(starts, s), bisect.bisect_left(starts, e)
        if name == "denoise.step" and hi > lo:
            lags.append((e - max(k[1] for k in kernels[lo:hi])) / 1e6)
    return lags


def step_idle_ms(kernels, spans) -> list:
    """For each `denoise.step` span: the ms inside it that no kernel covers.
    kernels as `step_end_lags_ms`'."""
    starts = [k[0] for k in kernels]
    idle = []
    for name, s, e in spans:
        if name != "denoise.step":
            continue
        busy, cursor = 0, s
        for start, end, _ in kernels[max(bisect.bisect_left(starts, s) - 1, 0):
                                     bisect.bisect_left(starts, e)]:
            start, end = max(start, cursor), min(end, e)
            if end > start:
                busy += end - start
                cursor = end
        idle.append((e - s - busy) / 1e6)
    return idle


def _quartiles(values) -> str:
    q1, median, q3 = statistics.quantiles(values, n=4)
    return (f"{len(values)} steps, ms min {min(values):.4f} q1 {q1:.4f} median {median:.4f} "
            f"q3 {q3:.4f} max {max(values):.4f}")


def main(argv=None) -> int:
    from unittest import mock

    from benchmark import harness, run, trace
    from ltx_tpu_torch.utils import diagnostics

    lags, idle = [], []

    def summarize(kernels, start_ns, end_ns, window_marks, top=10):
        spans = [sp for t in diagnostics.recent_clips for sp in t.spans
                 if start_ns <= sp[1] and sp[2] <= end_ns]
        lags.extend(step_end_lags_ms(kernels, spans))
        idle.extend(step_idle_ms(kernels, spans))
        return trace.summarize(kernels, start_ns, end_ns, window_marks, top)

    args = list(sys.argv[1:] if argv is None else argv)
    with mock.patch.object(harness, "summarize", summarize):
        rc = run.main(args + ["--trace", "1"])
    if len(lags) >= 2:
        harness.log(f"[spans] clock check, each denoise.step's end minus its last kernel's "
                    f"end: {_quartiles(lags)}; below 0: {sum(x < 0 for x in lags)}, over "
                    f"1 ms: {sum(x > 1 for x in lags)}; in window order: "
                    f"{[round(x, 3) for x in lags]}")
        harness.log(f"[spans] the device idle inside each denoise.step: {_quartiles(idle)}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
