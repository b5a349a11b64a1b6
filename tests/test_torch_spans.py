"""The clip's spans (utils.diagnostics.span into the call's GenerationTimings)
on the tiny pipelines of generate.tiny_configs(), on the CPU: where each span
is recorded, that spans nest inside their call and their parents, that each
phase field is the sum of its spans, the clip ids, that nothing leaks out of
a call that raised, and a resumed loop's launches."""

import time

import numpy as np
import pytest
import torch

from ltx_tpu_torch.config import GenerationConfig, MemoryConfig
from ltx_tpu_torch.pipeline.generate import GenerationTimings, LTXPipeline
from ltx_tpu_torch.utils import diagnostics
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CONFIG = GenerationConfig(width=64, height=64, num_frames=17, seed=3)
# each phase field and the span it sums
PHASES = {"clip": "total", "staging": "staging", "text.gemma": "gemma",
          "text.connector": "connector", "decode.vae": "vae_decode",
          "decode.audio": "audio_decode"}
# each part and the span it lies in
PARENT = {"denoise.launch": "denoise.step", "decode.stitch": "decode.vae",
          "decode.widen": "decode.vae", "decode.copy": "decode.vae",
          "decode.wait": "decode.vae"}


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def pipes():
    """T2V decoding in two tiles, T2V untiled, and audio-video untiled; the
    text encoder kept for the next call."""
    kept = MemoryConfig(offload_text_encoder=False)
    tiled = MemoryConfig(vae_tile_size=2, vae_tile_overlap=1, offload_text_encoder=False)
    return {"t2v-tiled": LTXPipeline.random_tiny(device="cpu", seed=1, memory=tiled),
            "t2v": LTXPipeline.random_tiny(device="cpu", seed=1, memory=kept),
            "av": LTXPipeline.random_tiny(device="cpu", seed=1, memory=kept,
                                          include_audio=True)}


def _generate(pipe, **kwargs):
    gen = torch.Generator().manual_seed(5)
    noise = torch.randn(pipe._shape(CONFIG).shape, generator=gen)
    if pipe.av_transformer is not None:
        audio = torch.randn(pipe.audio_noise_shape(CONFIG), generator=gen)
        return pipe.generate_video_with_audio("a heron", CONFIG, noise, audio, **kwargs)
    return pipe.generate_video("a heron", CONFIG, noise, **kwargs)


def _timed(pipe, **kwargs):
    """(result, the call's time.time_ns window)."""
    start = time.time_ns()
    result = _generate(pipe, **kwargs)
    return result, (start, time.time_ns())


def _names(timings) -> list:
    return [n for n, _, _ in timings.spans]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("case", ["t2v-tiled", "t2v", "av"])
def test_spans_where_the_work_happens(pipes, case):
    pipe = pipes[case]
    result, window = _timed(pipe)
    t = result.timings
    names = _names(t)
    steps = names.count("denoise.step")
    assert steps == len(t.denoise_steps) == 8
    assert names.count("denoise.launch") == steps and names.count("denoise.rope") == 1
    assert names.count("clip") == 1 and names[-1] == "clip"
    tiles = len(pipe.decode_tile_frames(pipe._shape(CONFIG).frames))
    if case == "t2v-tiled":
        assert tiles == 2 and names.count("decode.stitch") == tiles
        assert names.count("decode.widen") == 1 and "decode.copy" not in names
    else:
        assert tiles == 1 and names.count("decode.copy") == 1
        assert "decode.stitch" not in names and "decode.widen" not in names
    assert names.count("decode.audio") == (case == "av")
    assert "decode.wait" not in names  # the CPU waits for nothing

    # every span inside the call's window, each part inside its parent
    assert all(window[0] <= s <= e <= window[1] for _, s, e in t.spans)
    clip = t.spans[-1]
    assert all(_inside(sp, clip) for sp in t.spans)
    for sp in t.spans:
        if sp[0] in PARENT:
            assert any(p[0] == PARENT[sp[0]] and _inside(sp, p) for p in t.spans), sp
    rope = next(sp for sp in t.spans if sp[0] == "denoise.rope")
    first_step = next(sp for sp in t.spans if sp[0] == "denoise.step")
    assert rope[2] <= first_step[1]

    # each phase field the sum of its spans (sum() compensates its rounding)
    for name, field in PHASES.items():
        want = sum((e - s) / 1e9 for n, s, e in t.spans if n == name)
        assert getattr(t, field) == pytest.approx(want, rel=1e-12, abs=0)
    assert t.denoise_steps == [(e - s) / 1e9 for n, s, e in t.spans if n == "denoise.step"]
    assert t.span_seconds("denoise.rope") == (rope[2] - rope[1]) / 1e9
    assert "RoPE build:" in t.report() and "launch avg" in t.report()


def test_clip_ids_rise_and_a_call_that_raised_leaves_nothing(pipes, tmp_path):
    """Clip ids rise by one a call, the one that raised too; the raised
    call's spans reach neither the next call nor recent_clips, and the
    loop resumed from its checkpoint records only the steps it runs."""
    pipe = pipes["t2v"]
    first = _generate(pipe).timings
    assert diagnostics.recent_clips[-1] is first
    ckpt = diagnostics.DenoiseCheckpoint(str(tmp_path / "ckpt.pkl"), every_n_steps=1)

    def stop_after_3(i, n, sigma):
        if i == 3:
            raise _Stop

    with pytest.raises(_Stop):
        _generate(pipe, on_progress=stop_after_3, checkpoint=ckpt)
    assert diagnostics.active() is None and diagnostics.recent_clips[-1] is first
    resumed, window = _timed(pipe, checkpoint=ckpt)
    t = resumed.timings
    assert t.clip_id == first.clip_id + 2
    assert diagnostics.recent_clips[-1] is t
    assert all(window[0] <= s for _, s, _ in t.spans)
    names = _names(t)
    assert names.count("denoise.launch") == names.count("denoise.step") == 8 - 4
    assert len(t.denoise_steps) == 4 and names.count("denoise.rope") == 1


def test_spans_outside_a_call_and_the_profiler_ranges(pipes):
    """Outside a call a span records nothing; inside, its profiler range
    carries the clip id; a recorder made active by hand takes the spans of
    a bare encode."""
    with diagnostics.span("staging"):
        pass
    assert diagnostics.active() is None

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = _generate(pipes["t2v"]).timings
    ranges = {e.name for e in prof.events() if e.name.startswith("ltx/")}
    assert {f"ltx/clip{t.clip_id}/{n}" for n in set(_names(t))} <= ranges

    with diagnostics.recording(GenerationTimings()) as enc:
        pipes["t2v"].encode_image(np.zeros((1, 3, 1, 64, 64), np.float32))
    assert _names(enc) == ["staging", "image_encode"] and enc.image_encode > 0
