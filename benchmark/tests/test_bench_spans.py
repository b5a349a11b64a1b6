"""The readers of the program's spans (rope_ms, decode_host_ms,
step_launch_ms) on hand-made runs and on a whole tiny run on the CPU, the
spans as marks naming the idle gaps, and the clock check."""

from __future__ import annotations

import collections
import time

import pytest

from benchmark import harness, spans
from benchmark.metrics import reader
from benchmark.tests.tiny import tiny_config, tiny_traffic
from benchmark.trace import summarize
from ltx_tpu_torch.pipeline.generate import GenerationTimings
from ltx_tpu_torch.utils import diagnostics

MS = 1_000_000
READERS = ("rope_ms", "decode_host_ms", "step_launch_ms")


def timings(total: float, **spans_ms) -> GenerationTimings:
    """A clip's recorder: each name's spans of the given milliseconds, laid
    end to end (names with a dot given with a double underscore)."""
    t, at = GenerationTimings(total=total), 0
    for name, lengths in spans_ms.items():
        for ms in lengths:
            t.spans.append((name.replace("__", "."), at, at + int(ms * MS)))
            at += int(ms * MS)
    return t


def record(*totals) -> harness.RunRecord:
    clips = [{"index": i, "latency_s": x, "total": x, "text": 0.0, "steps": [],
              "decode": 0.0, "other_phases": 0.0} for i, x in enumerate(totals)]
    return harness.RunRecord(clips=clips, wall_s=sum(totals), setup_s=1.0, peak_bytes=0,
                             work={})


def test_readers_on_a_hand_made_run(monkeypatch):
    warm = timings(9.0, denoise__rope=[500], denoise__launch=[90])
    a = timings(1.0, denoise__rope=[200], denoise__launch=[10, 20],
                decode__stitch=[5, 5], decode__widen=[30], decode__wait=[100])
    b = timings(2.0, denoise__rope=[100], denoise__launch=[30, 40],
                decode__copy=[20], decode__wait=[50])
    monkeypatch.setattr(diagnostics, "recent_clips", collections.deque([warm, a, b]))
    run = record(1.0, 2.0)
    assert reader("rope_ms")(run) == pytest.approx(150.0)
    assert reader("decode_host_ms")(run) == pytest.approx(30.0)  # (40 + 20) / 2, no waits
    assert reader("step_launch_ms")(run) == pytest.approx(25.0)  # per launch


@pytest.mark.parametrize("recent", [None, [], "mismatched"])
def test_readers_read_nothing_without_the_window_s_spans(monkeypatch, recent):
    """A program that keeps no spans (the attribute absent), none kept, or
    clips that are not the window's: every reader returns None."""
    if recent is None:
        monkeypatch.delattr(diagnostics, "recent_clips")
    else:
        kept = [timings(3.0, denoise__rope=[1])] if recent == "mismatched" else []
        monkeypatch.setattr(diagnostics, "recent_clips", collections.deque(kept))
    run = record(1.0)
    assert all(reader(name)(run) is None for name in READERS)


def test_a_gap_inside_a_span_is_named_by_it():
    """A gap inside `denoise.rope` (itself inside `clip`) is named
    denoise.rope, not text, the harness's coarse mark there; a gap outside
    every span keeps the coarse name."""
    clip_spans = [("denoise.rope", 20 * MS, 40 * MS), ("clip", 0, 60 * MS)]
    coarse = [(0, 50 * MS, "text"), (50 * MS, 60 * MS, "denoise")]
    kernels = [(0, 20 * MS, "gemm_a"), (40 * MS, 50 * MS, "gemm_a"),
               (58 * MS, 80 * MS, "gemm_a")]
    gaps = summarize(kernels, 0, 80 * MS, spans.marks(clip_spans) + coarse)["breakdown"][
        "idle_gaps"]
    assert gaps[0] == ["denoise.rope", pytest.approx(0.02)]
    assert ["clip", pytest.approx(0.008)] in gaps
    gaps = summarize(kernels, 0, 80 * MS, coarse)["breakdown"]["idle_gaps"]
    assert gaps[0] == ["text", pytest.approx(0.02)]


def test_step_end_lags():
    steps = [("denoise.step", 0, 10 * MS), ("denoise.launch", 0, 2 * MS),
             ("denoise.step", 10 * MS, 30 * MS), ("denoise.step", 40 * MS, 45 * MS)]
    kernels = [(1 * MS, 4 * MS, "a"), (3 * MS, 9 * MS, "b"), (12 * MS, 29 * MS, "c")]
    assert spans.step_end_lags_ms(kernels, steps) == pytest.approx([1.0, 1.0])


@pytest.mark.parametrize("name", ["ltx2-video", "ltx2-av"])
def test_a_tiny_run_reports_the_span_metrics(name):
    """A whole run of the harness on the CPU: the three readers find the
    window's clip and read it."""
    rec, _, extras = harness.run_cell(tiny_config(name), tiny_traffic(), 12, 0.0, False, "cpu",
                                      time.perf_counter(), {"frames_worst_mae": 1.0,
                                                            "audio_rel_rms": 1.0})
    assert extras["failed"] == 0 and len(rec.clips) == 1
    values = {m: reader(m)(rec) for m in READERS}
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert values["decode_host_ms"] <= 1e3 * rec.clips[0]["decode"]


def test_step_idle():
    steps = [("denoise.step", 0, 10 * MS), ("denoise.step", 10 * MS, 30 * MS)]
    kernels = [(-2 * MS, 1 * MS, "a"), (3 * MS, 9 * MS, "b"), (4 * MS, 5 * MS, "c"),
               (12 * MS, 29 * MS, "d")]
    assert spans.step_idle_ms(kernels, steps) == pytest.approx([3.0, 3.0])
