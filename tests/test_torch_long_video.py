"""Port parity for the long-video modes on one clip: ltx_tpu_torch's
load_video, generate_video_from_video, generate_video_extension and
generate_video_keyframes against a live run of the reference's on its
random_tiny(seed=0) pipeline (weights converted, every draw taken from
jax.random as the reference derives it from the seed), the identities that
tie them to the single-clip entry points bit for bit on the port, their
argument checks against the reference's, and their prompt enhancement.

Tolerance: 2e-2 absolute on frames in [0, 1], the single-row tolerance of
test_torch_two_stage (bf16 Gemma, connector and DiT, whose roundings fall
at other places in the two frameworks); the VAE encoder's latents, in f32,
1e-5 relative. load_video reads with the same decoder and resizes with the
same PIL call as the reference: equal."""

import dataclasses
import json
import logging

import jax.numpy as jnp
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
    assert_rel,
    jax_normal,
    loop_draws,
    one_torch_thread,  # noqa: F401 (autouse)
    reference_and_port,
    torch_threads,
    video_keys,
)

FRAME_ATOL = 2e-2


def _jcfg(config):
    return convert.port_config(config, jconfig.GenerationConfig)


def _shape(port, config):
    return VideoLatentShape.from_pixels(1, config.num_frames, config.height, config.width,
                                        channels=port.tcfg.in_channels)


def _steps(port, config):
    return len(port._sigmas(config, _shape(port, config))) - 1


def _pixels(seed, frames, size=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (1, 3, frames, size, size)).astype(np.float32)


def _check(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    err, mean = float(np.abs(got - want).max()), float(np.abs(got - want).mean())
    print(f"[parity] {what}: max abs {err:.3e}, mean abs {mean:.3e} (tol {FRAME_ATOL:.0e})")
    assert err <= FRAME_ATOL


@pytest.fixture(scope="module")
def pipes():
    return reference_and_port()


def _write_clip(path, frames: int, seed: int = 0):
    """A seeded MJPG clip of `frames` 80x48 frames, written by OpenCV."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 24.0, (80, 48))
    base = rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)
    for i in range(frames):
        writer.write(np.roll(base, 3 * i, axis=1))
    writer.release()
    return str(path)


@pytest.mark.parametrize("sample,frames", [("even", 9), ("tail", 5)])
def test_load_video_matches_reference(tmp_path, sample, frames):
    """Even sampling (linspace, rounded) of 9 frames from a 20-frame clip and
    its last 5 frames, Lanczos-resized to 64x64: equal to the reference's;
    a short clip's tail and an unknown mode raise as there."""
    pytest.importorskip("PIL.Image")
    from ltx_tpu.io.video import load_video as j_load_video
    from ltx_tpu_torch.io.video import load_video

    path = _write_clip(tmp_path / "clip.avi", 20)
    got = load_video(path, 64, 64, frames, sample=sample)
    assert got.shape == (1, 3, frames, 64, 64) and got.dtype == np.float32
    np.testing.assert_array_equal(got, j_load_video(path, 64, 64, frames, sample=sample))
    assert -1.0 <= got.min() and got.max() <= 1.0
    with pytest.raises(IOError, match="20 frames < 21"):
        load_video(path, 64, 64, 21, sample="tail")
    with pytest.raises(ValueError, match="unknown sample mode"):
        load_video(path, 64, 64, 4, sample="first")


def test_encode_video_matches_reference(pipes):
    ref, port = pipes
    px = _pixels(1, 17)
    got = port.encode_video(px)
    assert got.shape == (1, port.tcfg.in_channels, 3, 2, 2) and got.dtype == torch.float32
    assert_rel(got, ref.encode_video(jnp.asarray(px)), 1e-5, "encode_video 17 frames")


@pytest.mark.parametrize("strength", [0.6, 0.3], ids=["s06", "s03"])
def test_video_to_video_matches_live_reference(pipes, strength):
    """The partial schedule from step round((1 - strength) * n), the clip's
    latent noised by the flow-matching forward; strength 1.0 is
    generate_video bit for bit on the port."""
    ref, port = pipes
    config = GenerationConfig(width=64, height=64, num_frames=17, num_steps=2, seed=21)
    clip = _pixels(2, 17)
    want = ref.generate_video_from_video("a restyled clip", _jcfg(config),
                                         video_frames=clip, strength=strength)
    noise = jax_normal(video_keys(config.seed)[0], _shape(port, config).shape)
    got = port.generate_video_from_video("a restyled clip", config, noise,
                                         video_frames=clip, strength=strength)
    _check(got.frames, want.frames, f"generate_video_from_video strength {strength}")
    n = _steps(port, config)
    k = min(max(int(round((1.0 - strength) * n)), 0), n - 1)
    assert len(got.timings.denoise_steps) == n - k and got.timings.image_encode > 0
    full = port.generate_video_from_video("a restyled clip", config, noise,
                                          video_frames=clip, strength=1.0)
    t2v = port.generate_video("a restyled clip", config, noise)
    np.testing.assert_array_equal(full.frames, t2v.frames)


def test_extension_matches_live_reference(pipes):
    """The clip's last 9 frames condition the first 2 latent frames,
    re-noised every step from the reference's draws; cond_frames=1 on a
    one-frame clip is I2V bit for bit on the port."""
    ref, port = pipes
    config = GenerationConfig(width=64, height=64, num_frames=17, num_steps=2, seed=22,
                              image_cond_noise_scale=0.15)
    clip = _pixels(3, 9)
    want = ref.generate_video_extension("the clip goes on", _jcfg(config), video_frames=clip,
                                        cond_frames=9)
    nkey, dkey, _ = video_keys(config.seed)
    shape = _shape(port, config)
    c = port.tcfg.in_channels
    steps = _steps(port, config)
    noise = jax_normal(nkey, shape.shape)
    got = port.generate_video_extension(
        "the clip goes on", config, noise, video_frames=clip, cond_frames=9,
        cond_noise=loop_draws(dkey, steps, (1, c, 2, 2, 2)))
    _check(got.frames, want.frames, "generate_video_extension cond_frames 9")

    draws = loop_draws(dkey, steps, (1, c, 1, 2, 2))
    one = port.generate_video_extension("the clip goes on", config, noise,
                                        video_frames=clip[:, :, -1:], cond_frames=1,
                                        cond_noise=draws)
    i2v = port.generate_video("the clip goes on", config, noise,
                              image_latent=port.encode_image(clip[:, :, -1:]), cond_noise=draws)
    np.testing.assert_array_equal(one.frames, i2v.frames)


def test_keyframes_match_live_reference(pipes):
    """A first and a last keyframe (pixel frames 0 and 16, latent frames 0
    and 2) re-noised every step; keyframes=[(0, latent)] is I2V bit for bit
    on the port, and a pixel source is its encoded latent."""
    ref, port = pipes
    config = GenerationConfig(width=64, height=64, num_frames=17, num_steps=2, seed=23,
                              image_cond_noise_scale=0.1)
    first, last = _pixels(4, 1), _pixels(5, 1)
    want = ref.generate_video_keyframes("from here to there", _jcfg(config),
                                        [(16, last), (0, first)])
    nkey, dkey, _ = video_keys(config.seed)
    c = port.tcfg.in_channels
    steps = _steps(port, config)
    noise = jax_normal(nkey, _shape(port, config).shape)
    got = port.generate_video_keyframes("from here to there", config, [(16, last), (0, first)],
                                        noise, cond_noise=loop_draws(dkey, steps,
                                                                     (1, c, 2, 2, 2)))
    _check(got.frames, want.frames, "generate_video_keyframes [(0, px), (16, px)]")

    lat = port.encode_image(first)
    draws = loop_draws(dkey, steps, (1, c, 1, 2, 2))
    kf = port.generate_video_keyframes("x", config, [(0, lat)], noise, cond_noise=draws)
    kf_px = port.generate_video_keyframes("x", config, [(0, first)], noise, cond_noise=draws)
    i2v = port.generate_video("x", config, noise, image_latent=lat, cond_noise=draws)
    np.testing.assert_array_equal(kf.frames, i2v.frames)
    np.testing.assert_array_equal(kf_px.frames, i2v.frames)


def _noise(port, config):
    return torch.zeros(_shape(port, config).shape)


CONFIG = GenerationConfig(width=64, height=64, num_frames=17, num_steps=2, seed=1)
# (name, the reference's call, the port's call): each raises the reference's
# InvalidConfigurationError with its message, before any model work
BAD_CALLS = {
    "v2v_strength_0": (
        lambda r, c: r.generate_video_from_video("x", c, video_frames=_pixels(0, 17),
                                                 strength=0.0),
        lambda p, c: p.generate_video_from_video("x", c, None, video_frames=_pixels(0, 17),
                                                 strength=0.0)),
    "v2v_strength_above_1": (
        lambda r, c: r.generate_video_from_video("x", c, video_frames=_pixels(0, 17),
                                                 strength=1.5),
        lambda p, c: p.generate_video_from_video("x", c, None, video_frames=_pixels(0, 17),
                                                 strength=1.5)),
    "v2v_no_source": (
        lambda r, c: r.generate_video_from_video("x", c),
        lambda p, c: p.generate_video_from_video("x", c, None)),
    "v2v_two_sources": (
        lambda r, c: r.generate_video_from_video("x", c, video_path="a.mp4",
                                                 video_frames=_pixels(0, 17)),
        lambda p, c: p.generate_video_from_video("x", c, None, video_path="a.mp4",
                                                 video_frames=_pixels(0, 17))),
    "v2v_frame_count": (
        lambda r, c: r.generate_video_from_video("x", c, video_frames=_pixels(0, 9)),
        lambda p, c: p.generate_video_from_video("x", c, None, video_frames=_pixels(0, 9))),
    "extension_not_8k1": (
        lambda r, c: r.generate_video_extension("x", c, video_frames=_pixels(0, 8),
                                                cond_frames=8),
        lambda p, c: p.generate_video_extension("x", c, None, video_frames=_pixels(0, 8),
                                                cond_frames=8)),
    "extension_whole_clip": (
        lambda r, c: r.generate_video_extension("x", c, video_frames=_pixels(0, 17),
                                                cond_frames=17),
        lambda p, c: p.generate_video_extension("x", c, None, video_frames=_pixels(0, 17),
                                                cond_frames=17)),
    "extension_frame_count": (
        lambda r, c: r.generate_video_extension("x", c, video_frames=_pixels(0, 1),
                                                cond_frames=9),
        lambda p, c: p.generate_video_extension("x", c, None, video_frames=_pixels(0, 1),
                                                cond_frames=9)),
    "keyframes_empty": (
        lambda r, c: r.generate_video_keyframes("x", c, []),
        lambda p, c: p.generate_video_keyframes("x", c, [], None)),
    "keyframes_unaligned": (
        lambda r, c: r.generate_video_keyframes("x", c, [(4, _pixels(0, 1))]),
        lambda p, c: p.generate_video_keyframes("x", c, [(4, _pixels(0, 1))], None)),
    "keyframes_outside": (
        lambda r, c: r.generate_video_keyframes("x", c, [(24, _pixels(0, 1))]),
        lambda p, c: p.generate_video_keyframes("x", c, [(24, _pixels(0, 1))], None)),
    "keyframes_duplicate": (
        lambda r, c: r.generate_video_keyframes("x", c, [(8, _pixels(0, 1)),
                                                         (8, _pixels(1, 1))]),
        lambda p, c: p.generate_video_keyframes("x", c, [(8, _pixels(0, 1)),
                                                         (8, _pixels(1, 1))], None)),
    "keyframes_two_frames": (
        lambda r, c: r.generate_video_keyframes("x", c, [(0, _pixels(0, 2))]),
        lambda p, c: p.generate_video_keyframes("x", c, [(0, _pixels(0, 2))], None)),
    "keyframes_channels": (
        lambda r, c: r.generate_video_keyframes("x", c, [(0, np.zeros((1, 5, 1, 2, 2)))]),
        lambda p, c: p.generate_video_keyframes("x", c, [(0, np.zeros((1, 5, 1, 2, 2)))],
                                                None)),
}


@pytest.mark.parametrize("name", BAD_CALLS)
def test_argument_checks_match_reference(pipes, name):
    ref, port = pipes
    ref_call, port_call = BAD_CALLS[name]
    with pytest.raises(JInvalid) as want:
        ref_call(ref, _jcfg(CONFIG))
    with pytest.raises(InvalidConfigurationError) as got:
        port_call(port, CONFIG)
    assert str(got.value) == str(want.value)


def test_draws_are_checked_by_name(pipes):
    """A missing or wrong draw raises ValueError naming its argument."""
    _, port = pipes
    config = dataclasses.replace(CONFIG, image_cond_noise_scale=0.1)
    c = port.tcfg.in_channels
    steps = _steps(port, config)
    noise = _noise(port, config)
    with pytest.raises(ValueError, match=r"initial_noise \(1, 16, 2, 2, 2\) != \(1, 16, 3"):
        port.generate_video_from_video("x", config, noise[:, :, :2],
                                       video_frames=_pixels(0, 17))
    with pytest.raises(ValueError, match="cond_noise: the conditioned frames' re-noise needs"):
        port.generate_video_extension("x", config, noise, video_frames=_pixels(0, 9))
    with pytest.raises(ValueError, match=r"cond_noise: a re-noise draw \(1, 16, 1, 2, 2\)"):
        port.generate_video_keyframes("x", config, [(0, _pixels(0, 1)), (8, _pixels(1, 1))],
                                      noise, cond_noise=[torch.zeros(1, c, 1, 2, 2)] * steps)


def test_long_video_entry_points_enhance_their_prompt(pipes, caplog):
    """enhance_prompt=True on video-to-video, extension and keyframes (the
    reference's `_maybe_enhance` calls, generate.py:1274, 1399, 1566): the
    port's tiny pipeline with the cycle Gemma of test_torch_enhance gives
    each the prompt that generate_video's enhancement gives, timed."""
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
    noise = _noise(port, config)
    try:
        with caplog.at_level(logging.INFO, logger="ltx_tpu_torch"), torch_threads(1):
            results = [
                port.generate_video("a beaver", config, noise),
                port.generate_video_from_video("a beaver", config, noise,
                                               video_frames=_pixels(0, 9)),
                port.generate_video_extension("a beaver", config, noise,
                                              video_frames=_pixels(0, 1), cond_frames=1),
                port.generate_video_keyframes("a beaver", config, [(8, _pixels(0, 1))], noise)]
    finally:
        port.gemma, port.gcfg, port.tokenizer = saved
    texts = [r.getMessage().removeprefix("Enhanced prompt: ") for r in caplog.records
             if r.getMessage().startswith("Enhanced prompt: ")]
    # keyframes enhance as I2V (the reference's is_i2v=True): its own system prompt
    assert len(texts) == 4 and texts[0] != "a beaver" and len(set(texts[:3])) == 1
    assert texts[3] != "a beaver"
    for result in results:
        assert result.timings.enhancement > 0 and result.timings.enhancement_tokens > 0
