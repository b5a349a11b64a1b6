"""Port parity for the audio path's long-video modes:
ltx_tpu_torch's generate_video_chain_with_audio, generate_video_keyframes(
audio=True) and generate_video_with_audio's clip extension against a live
run of the reference's on its random_tiny(seed=0, include_audio=True)
pipeline (test_torch_chain's fixture and helpers), the identities that tie
them to the single-clip entry points bit for bit on the port, the
waveforms' crossfade, and both chains' prompt enhancement.

Tolerances, absolute, as test_torch_audio_pipeline's: frames in [0, 1]
2e-2 (one guidance row); the waveform in [-1, 1] 5e-2 on the largest
sample and 1e-2 on the mean (the dual DiT's bf16 differences carried
through the f32 audio VAE and vocoder)."""


import numpy as np
import pytest
import torch

from ltx_tpu_torch.pipeline.generate import crossfade
from test_torch_chain import CONFIG, _check, _jcfg, _pixels, _shape, _steps, pipes  # noqa: F401
from torch_parity import (
    av_keys,
    av_loop_draws,
    jax_normal,
    loop_draws,
    one_torch_thread,  # noqa: F401 (autouse)
)


@pytest.mark.parametrize("audio_cond", [True, False], ids=["audio_cond", "anchored"])
def test_av_chain_matches_live_reference(pipes, audio_cond):
    """Two dual-DiT segments at seed and seed + 1: with the audio tail
    carried (its 9 audio latent frames re-noised every step from the
    reference's fold_in draws), or with an anchor in segment 1 and the
    waveforms crossfaded only."""
    ref, port = pipes
    anchors = None if audio_cond else {1: [(16, _pixels(9))]}
    want = ref.generate_video_chain_with_audio("a rolling drum", _jcfg(CONFIG), 2,
                                               cond_frames=9, audio_cond=audio_cond,
                                               anchors=anchors)
    shape, steps, c = _shape(port, CONFIG), _steps(port, CONFIG), port.tcfg.in_channels
    af = port.audio_frames(CONFIG)
    k_a = max(1, round(af * 9 / 17)) if audio_cond else 0
    noise, audio_noise, cond, audio_cond_noise = [], [], [None], [None]
    for i in range(2):
        vkey, akey, dkey, _ = av_keys(CONFIG.seed + i)
        noise.append(jax_normal(vkey, shape.shape))
        audio_noise.append(jax_normal(akey, port.audio_noise_shape(CONFIG)))
        if i:
            v, a = av_loop_draws(dkey, steps, (1, c, 2 if audio_cond else 3, 2, 2),
                                 (1, k_a, port.tcfg.audio_in_channels) if audio_cond else None)
            cond.append(v)
            audio_cond_noise.append(a)
    got = port.generate_video_chain_with_audio(
        "a rolling drum", CONFIG, 2, noise, audio_noise, cond_frames=9, cond_noise=cond,
        audio_cond_noise=audio_cond_noise, audio_cond=audio_cond, anchors=anchors)
    one = (2, 4 * (4 * af - 3))
    k = round(one[1] * 9 / 17)
    assert got.frames.shape == (25, 64, 64, 3) and got.audio.shape == (2, 2 * one[1] - k)
    what = "audio_cond" if audio_cond else "anchored"
    _check(got, want, f"generate_video_chain_with_audio {what}", audio=True)


def test_av_keyframes_and_extension_match_live_reference(pipes):
    """generate_video_keyframes(audio=True) at pixel frames 0 and 16, and
    generate_video_with_audio extending a 9-frame clip, each re-noised from
    the reference's draws, with an audio gain."""
    ref, port = pipes
    shape, steps, c = _shape(port, CONFIG), _steps(port, CONFIG), port.tcfg.in_channels
    vkey, akey, dkey, _ = av_keys(CONFIG.seed)
    draws = dict(initial_noise=jax_normal(vkey, shape.shape),
                 audio_noise=jax_normal(akey, port.audio_noise_shape(CONFIG)))
    kfs = [(0, _pixels(10)), (16, _pixels(11))]
    want = ref.generate_video_keyframes("a bell", _jcfg(CONFIG), kfs, audio=True,
                                        audio_gain=2.0)
    got = port.generate_video_keyframes("a bell", CONFIG, kfs, audio=True, audio_gain=2.0,
                                        cond_noise=loop_draws(dkey, steps, (1, c, 2, 2, 2)),
                                        **draws)
    _check(got, want, "generate_video_keyframes audio", audio=True)

    clip = _pixels(12, 9)
    want = ref.generate_video_with_audio("a bell", _jcfg(CONFIG), video_frames=clip,
                                         cond_frames=9)
    got = port.generate_video_with_audio("a bell", CONFIG, video_frames=clip, cond_frames=9,
                                         cond_noise=loop_draws(dkey, steps, (1, c, 2, 2, 2)),
                                         **draws)
    _check(got, want, "generate_video_with_audio extension cond_frames 9", audio=True)


def test_av_identities(pipes):
    """On the port: the AV chain at segments=1 is generate_video_with_audio,
    AV keyframes [(0, latent)] and the AV extension of a one-frame clip are
    its I2V, the AV chain with anchors={0: kfs} is AV keyframes."""
    _, port = pipes
    shape, steps, c = _shape(port, CONFIG), _steps(port, CONFIG), port.tcfg.in_channels
    gen = torch.Generator().manual_seed(3)
    noise = torch.randn(shape.shape, generator=gen)
    audio_noise = torch.randn(port.audio_noise_shape(CONFIG), generator=gen)
    t2v = port.generate_video_with_audio("x", CONFIG, noise, audio_noise)
    one = port.generate_video_chain_with_audio("x", CONFIG, 1, [noise], [audio_noise],
                                               audio_cond=True)
    np.testing.assert_array_equal(one.frames, t2v.frames)
    np.testing.assert_array_equal(one.audio, t2v.audio)

    px = _pixels(13)
    lat = port.encode_image(px)
    draws = [torch.randn(1, c, 1, 2, 2, generator=gen) for _ in range(steps)]
    i2v = port.generate_video_with_audio("x", CONFIG, noise, audio_noise, image_latent=lat,
                                         cond_noise=draws)
    kf = port.generate_video_keyframes("x", CONFIG, [(0, lat)], noise, audio_noise,
                                       cond_noise=draws, audio=True)
    ext = port.generate_video_with_audio("x", CONFIG, noise, audio_noise, video_frames=px,
                                         cond_frames=1, cond_noise=draws)
    for other in (kf, ext):
        np.testing.assert_array_equal(other.frames, i2v.frames)
        np.testing.assert_array_equal(other.audio, i2v.audio)

    kfs = [(0, lat), (8, _pixels(14))]
    draws2 = [torch.randn(1, c, 2, 2, 2, generator=gen) for _ in range(steps)]
    kf2 = port.generate_video_keyframes("x", CONFIG, kfs, noise, audio_noise,
                                        cond_noise=draws2, audio=True)
    anchored = port.generate_video_chain_with_audio("x", CONFIG, 1, [noise], [audio_noise],
                                                    cond_noise=[draws2], anchors={0: kfs})
    np.testing.assert_array_equal(anchored.frames, kf2.frames)
    np.testing.assert_array_equal(anchored.audio, kf2.audio)


def test_crossfade_joins_as_the_reference():
    """A linear float32 ramp over round(samples * cond / frames) samples,
    clamped to either waveform's length."""
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 100)).astype(np.float32), \
        rng.standard_normal((2, 100)).astype(np.float32)
    k = round(100 * 9 / 17)
    ramp = np.linspace(0.0, 1.0, k, endpoint=False, dtype=np.float32)
    want = np.concatenate([a[:, :-k], a[:, -k:] * (1 - ramp) + b[:, :k] * ramp, b[:, k:]], -1)
    got = crossfade([a, b], 9, 17)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    short = crossfade([a[:, :10], b], 9, 17)
    assert short.shape == (2, 100) and np.array_equal(short[:, 10:], b[:, 10:])
