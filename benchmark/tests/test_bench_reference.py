"""The plain reference against the port's pipeline at tiny sizes on the CPU,
the control that has to fail the check, and the faults that have to.

The port runs in bf16 as on the card (its kernels' plain versions), the
reference in f32 on the same weights and draws. The limit here is the tiny
size's own, set from its readings (program 2.3e-3 to 2.9e-3 of the worst
frame, 3.1e-3 to 6.0e-3 of the waveform; the fp8 control 2.4e-2 and 0.11
to 0.17): the cells' limits are in checks/ and PERF.md.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import harness, paths, weights
from benchmark.tests.tiny import tiny_config, tiny_traffic

TINY_LIMITS = {"frames_worst_mae": 8e-3, "audio_rel_rms": 3e-2}
CONFIGS = ("ltx2-video", "ltx2-av")


def one_clip(name: str, seed: int, precision=None):
    """(program output, reference output[, control output]) of clip 0."""
    cfg, tr = tiny_config(name), tiny_traffic()
    path = paths.program_side(cfg)
    pipe, drawn = harness.build(cfg, seed, "cpu")
    clip = tr.clip(seed, 0, paths.reference_side(cfg).clip_shapes(cfg, tr.params), "cpu")
    frames, audio, _ = path.run_clip(pipe, path.generation_config(tr), clip)
    ref = harness.reference_output(cfg, tr, drawn, clip)
    out = [{"frames": frames, "audio": audio}, ref]
    if precision:
        out.append(harness.reference_output(cfg, tr, drawn, clip, precision))
    return out


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_program_agrees_with_the_reference_and_the_control_does_not(name, seed):
    out, ref, ctl = one_clip(name, seed, "fp8")
    program_nums, control_nums = harness.compare(out, ref), harness.compare(ctl, ref)
    assert set(program_nums) == ({"frames_worst_mae", "audio_rel_rms"} if name == "ltx2-av"
                                 else {"frames_worst_mae"})
    assert all(v <= TINY_LIMITS[k] for k, v in program_nums.items()), program_nums
    # the control fails one of the numbers, by three times the program's reading
    assert any(control_nums[k] > TINY_LIMITS[k] and control_nums[k] > 3 * program_nums[k]
               for k in control_nums), control_nums


def test_weights_and_traffic_come_from_the_seed():
    cfg, tr = tiny_config("ltx2-video"), tiny_traffic()
    items = weights.inventory(paths.program_side(cfg).meta_modules(cfg))
    a = weights.draw(items, cfg["init"], 5, "cpu")
    b = weights.draw(items, cfg["init"], 5, "cpu")
    c = weights.draw(items, cfg["init"], 6, "cpu")
    name = "blocks.0.attn1.to_q.weight"
    assert torch.equal(a["transformer"][name], b["transformer"][name])
    assert not torch.equal(a["transformer"][name], c["transformer"][name])
    std = a["transformer"][name].float().std().item()
    assert std == pytest.approx(128 ** -0.5, rel=0.1)
    assert a["gemma"]["norm.weight"].float().abs().mean().item() < 0.1
    assert a["transformer"]["blocks.0.attn1.q_norm.weight"].float().mean().item() == \
        pytest.approx(1.0, abs=0.01)
    shapes = paths.reference_side(cfg).clip_shapes(cfg, tr.params)
    x, y = tr.clip(2**40 + 3, 4, shapes, "cpu"), tr.clip(2**40 + 3, 4, shapes, "cpu")
    assert x["prompt"] == y["prompt"] and torch.equal(x["noise"], y["noise"])
    assert not torch.equal(x["noise"], tr.clip(2**40 + 3, 5, shapes, "cpu")["noise"])


def run_tiny(name: str, seed: int = 11):
    """A whole run of the harness on the CPU (the chip's look skipped): one
    clip in the window, then the check."""
    record, checks, extras = harness.run_cell(
        tiny_config(name), tiny_traffic(), seed, 0.0, False, "cpu", time.perf_counter(),
        TINY_LIMITS)
    return harness.result_line(record, checks, extras, [("clip_s", "s"), ("setup_s", "s")],
                               {"platform": "cpu"}, False)


@pytest.mark.parametrize("name", CONFIGS)
def test_a_sound_run_is_correct(name):
    line = run_tiny(name)
    assert line["correct"] and line["attempted"] == 1 and line["failed"] == 0
    assert list(line)[-1] == "checks" and set(line["metrics"]) == {"clip_s", "setup_s"}


@pytest.mark.parametrize("name", CONFIGS)
def test_a_step_that_returns_its_state_unchanged_fails(name, monkeypatch):
    from ltx_tpu_torch.pipeline import denoise, generate

    if name == "ltx2-av":
        real = denoise.make_av_denoise_step

        def frozen(*args, **kwargs):
            step = real(*args, **kwargs)

            def unchanged(video, audio, *a, **k):
                step(video, audio, *a, **k)
                return video, audio

            return unchanged

        monkeypatch.setattr(generate, "make_av_denoise_step", frozen)
    else:
        real = denoise.make_denoise_step

        def frozen(*args, **kwargs):
            step = real(*args, **kwargs)

            def unchanged(latent, *a, **k):
                _, velocity = step(latent, *a, **k)
                return latent, velocity

            return unchanged

        monkeypatch.setattr(generate, "make_denoise_step", frozen)
    assert not run_tiny(name)["correct"]


@pytest.mark.parametrize("name", CONFIGS)
def test_an_answer_altered_where_it_is_produced_fails(name, monkeypatch):
    from ltx_tpu_torch.pipeline import generate

    real = generate.decode_video

    def altered(*args, **kwargs):
        frames = real(*args, **kwargs)
        if isinstance(frames, np.ndarray):
            frames = frames.copy()
        frames[3] = 1.0 - frames[3]  # one frame inverted
        return frames

    monkeypatch.setattr(generate, "decode_video", altered)
    assert not run_tiny(name)["correct"]


def test_an_altered_waveform_fails(monkeypatch):
    from ltx_tpu_torch.pipeline import generate

    real = generate.decode_audio
    monkeypatch.setattr(generate, "decode_audio", lambda *a, **k: -real(*a, **k))
    assert not run_tiny("ltx2-av")["correct"]
