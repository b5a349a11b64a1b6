"""Port parity for the latent-carry chains: ltx_tpu_torch's
generate_video_chain against a live run of the reference's on its
random_tiny(seed=0, include_audio=True) pipeline (weights converted, every
draw taken from jax.random as the reference derives it from seed +
segment), the identities that tie it to the single-clip entry points bit
for bit on the port, its phase order, and both chains' argument and draw
checks against the reference's and their prompt enhancement. The audio path's long-video modes are
test_torch_chain_audio's, on the same pipeline (two files, so that neither
is a long pole of the test run).

Tolerances, absolute, as test_torch_audio_pipeline's: frames in [0, 1]
2e-2 (one guidance row); the waveform in [-1, 1] 5e-2 on the largest
sample and 1e-2 on the mean (the dual DiT's bf16 differences carried
through the f32 audio VAE and vocoder)."""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

from ltx_tpu.core import config as jconfig
from ltx_tpu.core.errors import InvalidConfigurationError as JInvalid
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import GenerationConfig
from ltx_tpu_torch.errors import InvalidConfigurationError
from ltx_tpu_torch.ops.latents import VideoLatentShape
from torch_parity import (
    jax_normal,
    loop_draws,
    one_torch_thread,  # noqa: F401 (autouse)
    reference_and_port,
    torch_threads,
    video_keys,
)

FRAME_ATOL = 2e-2
AUDIO_ATOL, AUDIO_MEAN_ATOL = 5e-2, 1e-2
CONFIG = GenerationConfig(width=64, height=64, num_frames=17, num_steps=2, seed=31,
                          image_cond_noise_scale=0.15)


def _jcfg(config):
    return convert.port_config(config, jconfig.GenerationConfig)


def _shape(port, config):
    return VideoLatentShape.from_pixels(1, config.num_frames, config.height, config.width,
                                        channels=port.tcfg.in_channels)


def _steps(port, config):
    return len(port._sigmas(config, _shape(port, config))) - 1


def _pixels(seed, frames=1, size=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (1, 3, frames, size, size)).astype(np.float32)


def _check(got, want, what, audio=False):
    frames, wf = np.asarray(got.frames, np.float32), np.asarray(want.frames, np.float32)
    assert frames.shape == wf.shape and np.isfinite(frames).all()
    assert frames.min() >= 0.0 and frames.max() <= 1.0
    err, mean = float(np.abs(frames - wf).max()), float(np.abs(frames - wf).mean())
    print(f"[parity] {what} frames: max abs {err:.3e}, mean abs {mean:.3e} (tol "
          f"{FRAME_ATOL:.0e})")
    assert err <= FRAME_ATOL
    if not audio:
        return
    wave, wa = got.audio, np.asarray(want.audio, np.float32)
    assert wave.dtype == np.float32 and wave.shape == wa.shape and np.isfinite(wave).all()
    err, mean = float(np.abs(wave - wa).max()), float(np.abs(wave - wa).mean())
    print(f"[parity] {what} waveform {wave.shape}: max abs {err:.3e}, mean abs {mean:.3e} "
          f"(tol {AUDIO_ATOL:.0e}, mean {AUDIO_MEAN_ATOL:.0e})")
    assert err <= AUDIO_ATOL and mean <= AUDIO_MEAN_ATOL


@pytest.fixture(scope="module")
def pipes():
    return reference_and_port(include_audio=True)


def _chain_draws(port, config, segments, cond_frames=(None, 2, 3)):
    """generate_video_chain's draws: segment i's as generate_video's at seed
    + i; the re-noise draws of each conditioned segment's latent of
    `cond_frames[i]` latent frames (None: unconditioned)."""
    shape, steps, c = _shape(port, config), _steps(port, config), port.tcfg.in_channels
    noise, cond = [], []
    for i in range(segments):
        nkey, dkey, _ = video_keys(config.seed + i)
        noise.append(jax_normal(nkey, shape.shape))
        k = cond_frames[i]
        cond.append(None if k is None else loop_draws(dkey, steps, (1, c, k, 2, 2)))
    return noise, cond


def test_chain_matches_live_reference(pipes):
    """Three segments with their own prompts through the batched text pass,
    an anchor in segment 2 (the carried tail's 2 latent frames plus latent
    frame 2 at pixel 16), tail renormalisation at 0.5, every conditioned
    frame re-noised: 17 + 2 * 8 frames."""
    ref, port = pipes
    prompts = ["a road at dawn", "the road climbs", "a summit at noon"]
    anchor = _pixels(6)
    want = ref.generate_video_chain("unused", _jcfg(CONFIG), 3, cond_frames=9,
                                    prompts=prompts, anchors={2: [(16, anchor)]},
                                    tail_renorm=0.5)
    noise, cond = _chain_draws(port, CONFIG, 3)
    got = port.generate_video_chain("unused", CONFIG, 3, noise, cond_frames=9,
                                    prompts=prompts, cond_noise=cond,
                                    anchors={2: [(16, anchor)]}, tail_renorm=0.5)
    assert got.frames.shape == (33, 64, 64, 3)
    _check(got, want, "generate_video_chain 3 segments, anchor, tail_renorm 0.5")
    assert len(got.timings.denoise_steps) == 3 * _steps(port, CONFIG)


def test_chain_identities_and_phase_order(pipes):
    """On the port: segments=1 is generate_video; two segments keep it as
    their first 17 frames; anchors={0: kfs} with segments=1 is
    generate_video_keyframes; precomputed embeddings are the text pass's
    rows. Every segment denoises before any decodes, the DiT and the VAE
    each placed once; on_progress counts the chain's steps."""
    _, port = pipes
    config = dataclasses.replace(CONFIG, image_cond_noise_scale=0.0)
    noise, _ = _chain_draws(port, config, 2)
    t2v = port.generate_video("a tide pool", config, noise[0])
    one = port.generate_video_chain("a tide pool", config, 1, noise[:1])
    np.testing.assert_array_equal(one.frames, t2v.frames)

    events, progress = [], []
    on_device, release = port._on_device, port._release

    def place_spy(name):
        events.append(("place", name))
        return on_device(name)

    def release_spy(name):
        events.append(("release", name))
        return release(name)

    port._on_device, port._release = place_spy, release_spy
    try:
        two = port.generate_video_chain("a tide pool", config, 2, noise,
                                        on_progress=lambda i, n, s: progress.append((i, n)))
    finally:
        del port._on_device, port._release
    np.testing.assert_array_equal(two.frames[:17], t2v.frames)
    steps = _steps(port, config)
    assert progress == [(i, 2 * steps) for i in range(2 * steps)]
    dit = [i for i, e in enumerate(events) if e == ("place", "transformer")]
    vae = [i for i, e in enumerate(events) if e == ("place", "vae_decoder")]
    assert len(dit) == len(vae) == 2 and max(dit) < min(vae)
    # the DiT leaves once, before the first decode; the VAE once, after the last
    assert [i for i, e in enumerate(events) if e == ("release", "transformer")][0] < min(vae)
    assert [i for i, e in enumerate(events) if e == ("release", "vae_decoder")] == \
        [len(events) - 1]

    lat = port.encode_image(_pixels(7))
    kfs = [(0, lat), (16, _pixels(8))]
    kf = port.generate_video_keyframes("a tide pool", config, kfs, noise[0])
    anchored = port.generate_video_chain("a tide pool", config, 1, noise[:1],
                                         anchors={0: kfs})
    np.testing.assert_array_equal(anchored.frames, kf.frames)

    pre = port.generate_video_chain("ignored", config, 2, noise,
                                    precomputed_embeddings=port.encode_prompt("a tide pool"))
    np.testing.assert_array_equal(pre.frames, two.frames)


def test_chain_with_cfg_and_precomputed_embeddings(pipes):
    """CFG on every segment with the negative's rows from the hook, against
    the reference's chain on its own rows."""
    ref, port = pipes
    config = dataclasses.replace(CONFIG, cfg_scale=2.0, image_cond_noise_scale=0.0)
    jpos, jneg = ref.encode_prompt("a harbour"), ref.encode_prompt("blurry")
    want = ref.generate_video_chain("x", _jcfg(config), 2, precomputed_embeddings={
        "video": jpos["video"], "mask": jpos["mask"], "neg_video": jneg["video"],
        "neg_mask": jneg["mask"]})
    pos, neg = port.encode_prompt("a harbour"), port.encode_prompt("blurry")
    noise, _ = _chain_draws(port, config, 2)
    got = port.generate_video_chain("x", config, 2, noise, precomputed_embeddings={
        "video": pos["video"], "mask": pos["mask"], "neg_video": neg["video"],
        "neg_mask": neg["mask"]})
    # two guidance rows: test_torch_two_stage's guided tolerance
    frames, wf = got.frames, np.asarray(want.frames, np.float32)
    err, mean = float(np.abs(frames - wf).max()), float(np.abs(frames - wf).mean())
    print(f"[parity] generate_video_chain CFG 2 precomputed: max abs {err:.3e}, "
          f"mean abs {mean:.3e} (tol 8e-2, mean 1e-2)")
    assert frames.shape == wf.shape and err <= 8e-2 and mean <= 1e-2


CHAIN_BAD = {
    "segments_0": dict(segments=0),
    "cond_frames_8": dict(segments=2, cond_frames=8),
    "cond_frames_whole_clip": dict(segments=2, cond_frames=17),
    "prompt_count": dict(segments=2, prompts=["a"]),
    "anchor_segment": dict(segments=2, anchors={2: [(16, _pixels(0))]}),
    "anchor_over_tail": dict(segments=2, anchors={1: [(8, _pixels(0))]}),
    "anchor_unaligned": dict(segments=1, anchors={0: [(3, _pixels(0))]}),
    "precomputed_prompts": dict(segments=2, prompts=["a", "b"], precomputed=True),
    # 17 frames at 400 fps: one audio latent frame, which the overlap takes
    "audio_overlap": dict(segments=2, audio=True, audio_cond=True, fps=400.0),
}


@pytest.mark.parametrize("name", CHAIN_BAD)
def test_chain_argument_checks_match_reference(pipes, name):
    ref, port = pipes
    kw = dict(CHAIN_BAD[name])
    audio = kw.pop("audio", False)
    config = dataclasses.replace(CONFIG, fps=kw.pop("fps", CONFIG.fps))
    segments = kw.pop("segments")
    if kw.pop("precomputed", False):
        kw["precomputed_embeddings"] = {"video": None, "mask": None}
    with pytest.raises(JInvalid) as want:
        if audio:
            ref.generate_video_chain_with_audio("x", _jcfg(config), segments, **kw)
        else:
            ref.generate_video_chain("x", _jcfg(config), segments, **kw)
    draws = [None] * max(segments, 1)
    with pytest.raises(InvalidConfigurationError) as got:
        if audio:
            port.generate_video_chain_with_audio("x", config, segments, draws, draws, **kw)
        else:
            port.generate_video_chain("x", config, segments, draws, **kw)
    assert str(got.value) == str(want.value)


def test_chain_draws_are_checked_by_name(pipes):
    _, port = pipes
    noise, cond = _chain_draws(port, CONFIG, 2)
    with pytest.raises(ValueError, match="initial_noise: one entry per segment, 2, got 1"):
        port.generate_video_chain("x", CONFIG, 2, noise[:1])
    with pytest.raises(ValueError, match=r"cond_noise\[1\]: the conditioned frames' re-noise"):
        port.generate_video_chain("x", CONFIG, 2, noise, cond_noise=[None, cond[1][:3]])
    with pytest.raises(ValueError, match=r"initial_noise\[1\] \(1, 16, 2, 2, 2\)"):
        port.generate_video_chain("x", CONFIG, 2, [noise[0], noise[1][:, :, :2]],
                                  cond_noise=cond)
    with pytest.raises(ValueError, match=r"audio_cond_noise\[1\]: the conditioned"):
        port.generate_video_chain_with_audio(
            "x", CONFIG, 2, noise, [torch.zeros(port.audio_noise_shape(CONFIG))] * 2,
            cond_noise=cond, audio_cond=True)


def test_chains_enhance_their_prompts(pipes, caplog):
    """enhance_prompt=True: one prompt through `_maybe_enhance` (the text
    of generate_video's enhancement), several through `enhance_prompts` in
    one batch (the reference's generate.py:2354 and :2376)."""
    from ltx_tpu_torch.tokenizer import Tokenizer
    from ltx_tpu_torch.weights.synthetic import default_cycle, make_cycle_gemma
    from test_torch_enhance import tokenizer_spec

    _, port = pipes
    gcfg = dataclasses.replace(port.gcfg, vocab_size=2048)
    saved = (port.gemma, port.gcfg, port.tokenizer)
    port.gemma = make_cycle_gemma(gcfg, torch.Generator().manual_seed(2),
                                  cycle=default_cycle(gcfg, period=11)).to(torch.bfloat16)
    port.gcfg = gcfg
    port.tokenizer = Tokenizer.from_str(json.dumps(tokenizer_spec(gcfg.vocab_size)))
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=3,
                              enhance_prompt=True)
    shape = _shape(port, config)
    noise = [torch.zeros(shape.shape)] * 2
    audio_noise = [torch.zeros(port.audio_noise_shape(config))] * 2
    try:
        with caplog.at_level(logging.INFO, logger="ltx_tpu_torch"), torch_threads(1):
            single = port.generate_video_chain("a beaver", config, 2, noise, cond_frames=1)
            several = port.generate_video_chain_with_audio(
                "x", config, 2, noise, audio_noise, cond_frames=1,
                prompts=["a beaver", "a dam"])
    finally:
        port.gemma, port.gcfg, port.tokenizer = saved
    texts = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Enhanced prompt: ")]
    assert len(texts) == 1 and texts[0] != "Enhanced prompt: a beaver"
    assert "enhancement failed" not in caplog.text
    for result in (single, several):
        assert result.timings.enhancement > 0
