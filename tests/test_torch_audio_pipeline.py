"""Port parity end to end for joint audio: ltx_tpu_torch's
generate_video_with_audio and generate_video_with_audio_two_stage against a
live run of the reference's on its random_tiny(seed=0, include_audio=True)
pipeline, weights converted and every draw taken from jax.random exactly as
the reference derives it from the seed; and against tests/goldens/tiny_av.npz
at the port's own tolerance (the reference's agreement with its golden is
tests/test_goldens.py's to check, not this file's).

Tolerances, absolute. Frames in [0, 1]: 2e-2 with one guidance row, as the
video paths (test_torch_two_stage); guided, 8e-2 on the largest pixel and
1e-2 on the mean. The waveform in [-1, 1]: it comes from the same bf16 dual
DiT through the audio VAE and the vocoder in f32, so it carries the DiT's
bf16 differences; 5e-2 on the largest sample, 1e-2 on the mean (the
measured values are in PERF.md's parity table), and the golden's waveform
statistics (mean, std, min, max) within 5e-2 with its sample count equal."""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.core import config as jconfig
from ltx_tpu.ops import schedule as jsched
from ltx_tpu.ops.latents import VideoLatentShape as JShape
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import GenerationConfig, MemoryConfig
from ltx_tpu_torch.errors import (
    InvalidConfigurationError,
    ModelNotLoadedError,
    TextEncodingFailedError,
)
from ltx_tpu_torch.pipeline.generate import LTXPipeline
from torch_parity import jax_normal, loop_draws, reference_and_port
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

GOLDENS = pathlib.Path(__file__).parent / "goldens"
FRAME_ATOL = 2e-2
GUIDED_ATOL, GUIDED_MEAN_ATOL = 8e-2, 1e-2
AUDIO_ATOL, AUDIO_MEAN_ATOL = 5e-2, 1e-2
AUDIO_STATS_ATOL = 5e-2


def _jcfg(config):
    return convert.port_config(config, jconfig.GenerationConfig)


@pytest.fixture(scope="module")
def pipes():
    """The reference's random_tiny(seed=0, include_audio=True) components
    (the tiny_av golden's pipeline: the same keys) and the port built from
    its trees. The bf16 components init eagerly as random_tiny does; the f32
    ones (VAE, upscaler, audio VAE, vocoder) init jitted, within 2e-8 of
    eager, in a fraction of the time."""
    return reference_and_port(include_audio=True)


def _draws(port, config, cond_shape=None):
    """generate_video_with_audio's draws from config.seed: the video and
    audio noise, and the loop's re-noise draws (one split a step)."""
    key = jax.random.key(config.seed)
    key, vkey, akey, dkey = jax.random.split(key, 4)
    shape = JShape.from_pixels(1, config.num_frames, config.height, config.width,
                               channels=port.tcfg.in_channels)
    out = dict(initial_noise=jax_normal(vkey, shape.shape),
               audio_noise=jax_normal(akey, port.audio_noise_shape(config)))
    if cond_shape is not None and config.image_cond_noise_scale > 0:
        steps = len(port._sigmas(config, shape)) - 1
        out["cond_noise"] = loop_draws(dkey, steps, cond_shape)
    return out


def _check(got, want, what, guided=False):
    """Frames and waveform against the live reference's."""
    frames, wf = np.asarray(got.frames, np.float32), np.asarray(want.frames, np.float32)
    assert frames.shape == wf.shape and np.isfinite(frames).all()
    assert frames.min() >= 0.0 and frames.max() <= 1.0
    err, mean = float(np.abs(frames - wf).max()), float(np.abs(frames - wf).mean())
    tol = GUIDED_ATOL if guided else FRAME_ATOL
    print(f"[parity] {what} frames: max abs {err:.3e}, mean abs {mean:.3e} (tol {tol:.0e})")
    assert err <= tol
    if guided:
        assert mean <= GUIDED_MEAN_ATOL
    audio, wa = got.audio, np.asarray(want.audio, np.float32)
    assert audio.dtype == np.float32 and audio.shape == wa.shape and audio.shape[0] == 2
    assert np.isfinite(audio).all() and np.abs(audio).max() <= 1.0
    err, mean = float(np.abs(audio - wa).max()), float(np.abs(audio - wa).mean())
    print(f"[parity] {what} waveform: max abs {err:.3e}, mean abs {mean:.3e} (tol "
          f"{AUDIO_ATOL:.0e}, mean {AUDIO_MEAN_ATOL:.0e}); reference's largest "
          f"{np.abs(wa).max():.3e}")
    assert err <= AUDIO_ATOL and mean <= AUDIO_MEAN_ATOL


def test_t2v_with_audio_matches_live_reference_and_golden(pipes):
    """The tiny_av golden's run: T2V, one row, 9 frames at 64x64, 2 steps."""
    ref, port = pipes
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=42)
    prompt = "golden av prompt"
    want = ref.generate_video_with_audio(prompt, _jcfg(config))
    got = port.generate_video_with_audio(prompt, config, **_draws(port, config))
    _check(got, want, "generate_video_with_audio T2V")
    shape = JShape.from_pixels(1, 9, 64, 64, channels=port.tcfg.in_channels)
    assert got.seed == 42
    assert len(got.timings.denoise_steps) == len(port._sigmas(config, shape)) - 1
    assert got.timings.audio_decode > 0
    with np.load(GOLDENS / "tiny_av.npz") as z:
        first, stats, audio_stats = z["first_frame"], z["stats"], z["audio_stats"]
    frames, audio = got.frames, got.audio
    e_first = float(np.abs(frames[0] - first).max())
    e_stats = float(np.abs(np.array([frames.mean(), frames.std(), frames.min(),
                                     frames.max()]) - stats).max())
    a_stats = np.array([audio.mean(), audio.std(), audio.min(), audio.max()])
    e_audio = float(np.abs(a_stats - audio_stats[:4]).max())
    print(f"[parity] tiny_av golden: first frame {e_first:.3e}, stats {e_stats:.3e} (tol "
          f"{FRAME_ATOL:.0e}), waveform stats {e_audio:.3e} (tol {AUDIO_STATS_ATOL:.0e})")
    assert e_first <= FRAME_ATOL and e_stats <= FRAME_ATOL
    assert e_audio <= AUDIO_STATS_ATOL and audio.shape[-1] == int(audio_stats[4])


def test_t2v_with_audio_cfg_and_gain_matches_live_reference(pipes):
    """CFG on both streams (the negative prompt's audio context too) and
    guidance rescale on the video only; an audio gain that clips."""
    ref, port = pipes
    config = GenerationConfig(width=64, height=64, num_frames=17, num_steps=3, seed=7,
                              cfg_scale=3.0, guidance_rescale=0.5,
                              negative_prompt="silence, static")
    want = ref.generate_video_with_audio("a drum solo", _jcfg(config), audio_gain=4.0)
    got = port.generate_video_with_audio("a drum solo", config, audio_gain=4.0,
                                         **_draws(port, config))
    _check(got, want, "generate_video_with_audio CFG 3 gain 4", guided=True)
    assert got.audio.shape == (2, 4 * (4 * port.audio_frames(config) - 3))


def test_i2v_with_audio_matches_live_reference(pipes):
    """I2V through the image_latent hook, the conditioned frame re-noised
    every step from the reference's draws."""
    ref, port = pipes
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=3, seed=11,
                              image_cond_noise_scale=0.15)
    px = np.random.default_rng(0).uniform(-1, 1, (1, 3, 1, 64, 64)).astype(np.float32)
    jl = ref.encode_image(jnp.asarray(px))
    tl = port.encode_image(px)
    want = ref.generate_video_with_audio("an image sings", _jcfg(config), image_latent=jl)
    got = port.generate_video_with_audio("an image sings", config, image_latent=tl,
                                         **_draws(port, config, tuple(tl.shape)))
    _check(got, want, "generate_video_with_audio I2V")
    with pytest.raises(ValueError, match="draws"):
        port.generate_video_with_audio("x", config, image_latent=tl,
                                       **{k: v for k, v in _draws(port, config).items()})


@pytest.mark.parametrize("i2v", [False, True], ids=["t2v", "i2v_file"])
def test_two_stage_with_audio_matches_live_reference(pipes, i2v, tmp_path):
    """Distilled stage 1 at half resolution, the upscaler and AdaIN, both
    streams re-noised, 3 plain-Euler video steps at full resolution; I2V from
    an image file encoded per stage, the frame re-noised every step."""
    ref, port = pipes
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=13)
    if i2v:
        Image = pytest.importorskip("PIL.Image")  # load_image needs Pillow
        path = str(tmp_path / "cond.png")
        Image.fromarray(np.random.default_rng(3).integers(0, 256, (48, 80, 3),
                                                          dtype=np.uint8)).save(path)
        config = dataclasses.replace(config, image_path=path, image_cond_noise_scale=0.1)
    prompt = "two stages of sound"
    want = ref.generate_video_with_audio_two_stage(prompt, _jcfg(config))
    key = jax.random.key(config.seed)
    key, vkey, akey, dkey = jax.random.split(key, 4)
    key, nkey2, akey2, dkey2 = jax.random.split(key, 4)
    c = port.tcfg.in_channels
    s1 = JShape.from_pixels(1, config.num_frames, 32, 32, channels=c)
    s2 = JShape.from_pixels(1, config.num_frames, 64, 64, channels=c)
    n1 = len(jsched.get_sigmas(config.num_steps, distilled=True,
                               token_count=s1.token_count)) - 1
    draws = {}
    if i2v:
        draws = dict(stage1_cond_noise=loop_draws(dkey, n1, (1, c, 1, 1, 1)),
                     stage2_cond_noise=loop_draws(dkey2, 3, (1, c, 1, 2, 2)))
    af = port.audio_frames(config)
    got = port.generate_video_with_audio_two_stage(
        prompt, config, stage1_noise=jax_normal(vkey, s1.shape),
        stage1_audio_noise=jax_normal(akey, port.audio_noise_shape(config)),
        stage2_noise=jax_normal(nkey2, s2.shape),
        stage2_audio_noise=jax_normal(akey2, (1, af, port.tcfg.audio_in_channels)), **draws)
    _check(got, want, f"generate_video_with_audio_two_stage {'I2V' if i2v else 'T2V'}")
    assert len(got.timings.denoise_steps) == n1 + 3 and got.timings.upscale > 0
    assert (got.timings.image_encode > 0) == i2v


def test_audio_paths_refuse_what_they_lack():
    """Missing components raise ModelNotLoadedError, a text encoder without
    the audio connector TextEncodingFailedError, the clip extension the
    reference's InvalidConfigurationError for a wrong-shaped clip and for a
    clip together with an image; phase staging brings every audio component
    back to its host tensors."""
    port = LTXPipeline.random_tiny(device="cpu", seed=2, include_audio=True,
                                   memory=MemoryConfig(phase_staging=True))
    assert port.text_encoder.has_audio and port.audio_vae_config.mel_latent_bins == 2
    names = ("av_transformer", "audio_vae", "vocoder", "text_encoder", "vae_decoder")
    before = {n: {k: p.data_ptr() for k, p in getattr(port, n).named_parameters()}
              for n in names}
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=1)
    gen = torch.Generator().manual_seed(0)
    shape = (1, port.tcfg.in_channels, 2, 2, 2)
    result = port.generate_video_with_audio(
        "staged", config, torch.randn(shape, generator=gen),
        torch.randn(port.audio_noise_shape(config), generator=gen))
    assert result.frames.shape == (9, 64, 64, 3) and result.audio.shape == (2, 132)
    assert not port._host_store
    for n, ptrs in before.items():
        assert {k: p.data_ptr() for k, p in getattr(port, n).named_parameters()} == ptrs, n
    with pytest.raises(InvalidConfigurationError,
                       match=r"video_frames \(1,\) != \(1, 3, 1, 64, 64\)"):
        port.generate_video_with_audio("x", config, None, None, video_frames=np.zeros(1),
                                       cond_frames=1)
    with pytest.raises(InvalidConfigurationError, match="mutually exclusive"):
        port.generate_video_with_audio("x", config, None, None, video_frames=np.zeros(1),
                                       image_latent=torch.zeros(1, port.tcfg.in_channels,
                                                                1, 2, 2))
    with pytest.raises(ValueError, match="audio_noise"):
        port.generate_video_with_audio("x", config, torch.randn(shape), torch.randn(1, 8, 3, 2))
    port.text_encoder.audio_embeddings_connector = None
    with pytest.raises(TextEncodingFailedError, match="audio connector"):
        port.generate_video_with_audio("x", config, torch.randn(shape),
                                       torch.randn(port.audio_noise_shape(config)))
    port.vocoder = None
    with pytest.raises(ModelNotLoadedError, match="vocoder"):
        port.generate_video_with_audio("x", config, None, None)
    video_only = LTXPipeline.random_tiny(device="cpu", seed=2)
    assert video_only.av_transformer is None and not video_only.text_encoder.has_audio
    with pytest.raises(ModelNotLoadedError, match="av_transformer"):
        video_only.generate_video_with_audio_two_stage("x", config, *[None] * 4)


def test_audio_entry_points_enhance_their_prompt(pipes, caplog):
    """enhance_prompt=True on both audio entry points (the reference's
    `_maybe_enhance` calls, generate.py:2727 and :2899): the port's tiny
    pipeline with its cycle Gemma (a vocabulary of 2048 for
    test_torch_enhance's Gemma-style tokenizer) gives each the prompt that
    generate_video's enhancement gives, timed, with no fallback."""
    import logging

    from ltx_tpu_torch.tokenizer import Tokenizer
    from ltx_tpu_torch.weights.synthetic import default_cycle, make_cycle_gemma
    from test_torch_enhance import tokenizer_spec
    from torch_parity import torch_threads

    _, port = pipes
    gcfg = dataclasses.replace(port.gcfg, vocab_size=2048)
    saved = (port.gemma, port.gcfg, port.tokenizer)
    port.gemma = make_cycle_gemma(gcfg, torch.Generator().manual_seed(2),
                                  cycle=default_cycle(gcfg, period=11)).to(torch.bfloat16)
    port.gcfg = gcfg
    port.tokenizer = Tokenizer.from_str(json.dumps(tokenizer_spec(gcfg.vocab_size)))
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=3,
                              enhance_prompt=True)
    gen = torch.Generator().manual_seed(0)
    c, af = port.tcfg.in_channels, port.audio_frames(config)
    try:
        with caplog.at_level(logging.INFO, logger="ltx_tpu_torch"), torch_threads(1):
            video = port.generate_video("a beaver", config, torch.randn(1, c, 2, 2, 2,
                                                                         generator=gen))
            single = port.generate_video_with_audio(
                "a beaver", config, torch.randn(1, c, 2, 2, 2, generator=gen),
                torch.randn(port.audio_noise_shape(config), generator=gen))
            two = port.generate_video_with_audio_two_stage(
                "a beaver", config, torch.randn(1, c, 2, 1, 1, generator=gen),
                torch.randn(port.audio_noise_shape(config), generator=gen),
                torch.randn(1, c, 2, 2, 2, generator=gen),
                torch.randn(1, af, port.tcfg.audio_in_channels, generator=gen))
    finally:
        port.gemma, port.gcfg, port.tokenizer = saved
    texts = [r.getMessage().removeprefix("Enhanced prompt: ") for r in caplog.records
             if r.getMessage().startswith("Enhanced prompt: ")]
    assert len(texts) == 3 and texts[0] != "a beaver" and len(set(texts)) == 1
    assert "enhancement" not in caplog.text.replace("Enhanced prompt", "")
    for result in (video, single, two):
        assert result.timings.enhancement > 0 and result.timings.enhancement_tokens > 0
