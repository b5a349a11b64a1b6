"""The pipelines' pairs of files (benchmark.paths): each configuration's
inventory, draws, counted work and check numbers held bit for bit to the
values the harness gave before its pipelines moved into files of their own;
a pipeline that exists only as two new files runs a tiny cell to `correct`;
an unknown pipeline is refused by name."""

from __future__ import annotations

import hashlib
import shutil
import time

import pytest
import torch

from benchmark import flops, harness, paths, weights
from benchmark.metrics import reader
from benchmark.tests.test_bench_reference import TINY_LIMITS, one_clip
from benchmark.tests.tiny import tiny_config, tiny_traffic

# Taken from the harness before the move, at the tiny sizes, on one CPU thread:
# (parameter count, sha256 of "component.name shape dtype" lines in order),
# each draw's shape, clip_work (floats as float.hex) and the check numbers of
# clip 0 by seed.
BEFORE = {
    "ltx2-video": {
        "inventory": (241, "018c971a38a258e5a69a1432e3937d0dfef8b072b42df6c1d309f91f44761d48"),
        "shapes": {"noise": (1, 16, 5, 2, 2)},
        "work": {"dit_step_flops": "0x1.4340000000000p+24", "steps": 8, "attentions": 34,
                 "norms": 105, "attention_seconds": "0x1.9a43f9f456e1fp-23"},
        "checks": {3: {"frames_worst_mae": "0x1.6dcc8a0000000p-9"},
                   2**31 + 7: {"frames_worst_mae": "0x1.5b6dc00000000p-9"}},
    },
    "ltx2-av": {
        "inventory": (477, "40c2e61dbe449e6367aef4ebb4caab2a073fdd374ff71cefdbaa2ee7ef887a92"),
        "shapes": {"noise": (1, 16, 5, 2, 2), "audio_noise": (1, 8, 34, 2)},
        "work": {"dit_step_flops": "0x1.1214000000000p+25", "steps": 8, "attentions": 100,
                 "norms": 338, "attention_seconds": "0x1.fb6a99e7bf6cap-22"},
        "checks": {3: {"frames_worst_mae": "0x1.7ba4d00000000p-9",
                       "audio_rel_rms": "0x1.8c74b6d40195ep-8"},
                   2**31 + 7: {"frames_worst_mae": "0x1.61f0260000000p-9",
                               "audio_rel_rms": "0x1.0c808fb7fbd9bp-7"}},
    },
}
ROPE_TABLES = {"ltx2-video": 1, "ltx2-av": 4}  # tables a denoise loop builds


@pytest.fixture
def one_thread():
    """One CPU thread: the check numbers' last bits follow the thread count."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def hexed(work: dict) -> dict:
    return {k: v.hex() if isinstance(v, float) else v for k, v in work.items()}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_inventory_draws_and_work_are_as_before(name):
    cfg, tr = tiny_config(name), tiny_traffic()
    inv = weights.inventory(paths.program_side(cfg).meta_modules(cfg))
    text = "\n".join(f"{c}.{n} {tuple(s)} {d}" for c, n, s, d in inv)
    assert (len(inv), hashlib.sha256(text.encode()).hexdigest()) == BEFORE[name]["inventory"]
    assert paths.reference_side(cfg).clip_shapes(cfg, tr.params) == BEFORE[name]["shapes"]
    work = flops.clip_work(cfg, tr.params)
    assert hexed(work) == {**BEFORE[name]["work"], "rope_tables": ROPE_TABLES[name],
                           "denoise_flops": (work["dit_step_flops"] * 8).hex()}


@pytest.mark.parametrize("name", sorted(BEFORE))
@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_check_numbers_are_as_before(name, seed, one_thread):
    out, ref = one_clip(name, seed)
    assert {k: v.hex() for k, v in harness.compare(out, ref).items()} == \
        BEFORE[name]["checks"][seed]


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_step_mfu_reads_as_before(name):
    """The reader over a clip's `denoise_flops` against the one it replaced,
    `dit_step_flops` times the window's steps."""
    cfg, tr = tiny_config(name), tiny_traffic()
    work = flops.clip_work(cfg, tr.params)
    clips = [{"steps": [0.011 + 0.001 * i * j for j in range(8)]} for i in range(5)]
    run = harness.RunRecord(clips=clips, wall_s=1.0, setup_s=1.0, peak_bytes=0, work=work)
    steps = [s for c in clips for s in c["steps"]]
    before = 100.0 * work["dit_step_flops"] * len(steps) / sum(steps) / flops.PEAK_BF16_FLOPS
    assert reader("step_mfu")(run) == pytest.approx(before, rel=1e-12, abs=0)


def test_a_pipeline_added_as_two_files_runs_a_cell(tmp_path, monkeypatch):
    """The video pipeline's pair copied under a new name into directories the
    loader is pointed at, and a configuration that names it: a whole tiny run
    on the CPU reads correct, with no other file changed."""
    program_dir, reference_dir = tmp_path / "paths", tmp_path / "reference_paths"
    program_dir.mkdir()
    reference_dir.mkdir()
    shutil.copy(paths.PROGRAM_DIR / "video.py", program_dir / "plugged.py")
    shutil.copy(paths.REFERENCE_DIR / "video.py", reference_dir / "plugged.py")
    monkeypatch.setattr(paths, "PROGRAM_DIR", program_dir)
    monkeypatch.setattr(paths, "REFERENCE_DIR", reference_dir)
    cfg = {**tiny_config("ltx2-video"), "pipeline": "plugged"}
    record, checks, extras = harness.run_cell(cfg, tiny_traffic(), 11, 0.0, False, "cpu",
                                              time.perf_counter(), TINY_LIMITS)
    line = harness.result_line(record, checks, extras, [("clip_s", "s")], {"platform": "cpu"},
                               False)
    assert line["correct"] and line["attempted"] == 1 and set(line["checks"]) == {
        "frames_worst_mae"}


@pytest.mark.parametrize("missing", ["both", "reference"])
def test_an_unknown_pipeline_names_both_files(tmp_path, monkeypatch, missing):
    cfg = {**tiny_config("ltx2-video"), "pipeline": "nonesuch"}
    if missing == "reference":
        monkeypatch.setattr(paths, "PROGRAM_DIR", tmp_path)
        (tmp_path / "nonesuch.py").write_text("")
    with pytest.raises(paths.UnknownPipeline) as err:
        harness.build(cfg, 1, "cpu")
    assert str(paths.PROGRAM_DIR / "nonesuch.py") in str(err.value)
    assert str(paths.REFERENCE_DIR / "nonesuch.py") in str(err.value)
