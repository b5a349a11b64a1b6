"""Port parity for the export half of io/video.py: `frames_to_uint8`
against the reference's bit for bit (numpy, a CPU tensor, and the
reference's device path), `export_video` and `export_frames_png` writing
files whose decoded pixels equal the reference's from the same frames, the
side WAV an export with audio leaves without imageio-ffmpeg, and
`VideoExportConfig`'s checks and errors, message for message. Both packages
write through the same encoders (imageio-ffmpeg, else OpenCV's mp4v), so
the decoded pixels are equal, not close."""

import wave

import numpy as np
import pytest
import torch

from ltx_tpu.core.errors import ExportFailedError as JExportFailed
from ltx_tpu.io import video as jvideo
from ltx_tpu_torch.errors import ExportFailedError
from ltx_tpu_torch.io import video as pvideo


def _frames(n=5, h=32, w=48, seed=0):
    """Frames in [0, 1] with values past both ends and exact half steps."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (n, h, w, 3)).astype(np.float32)
    x[0, 0, :8, 0] = np.arange(8, dtype=np.float32) / 255.0 + 0.5 / 255.0
    return x


def _decode(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames)


def test_frames_to_uint8_matches_reference():
    import jax.numpy as jnp

    x = _frames()
    want = jvideo.frames_to_uint8(x)
    np.testing.assert_array_equal(pvideo.frames_to_uint8(x), want)
    np.testing.assert_array_equal(pvideo.frames_to_uint8(torch.from_numpy(x)), want)
    # the reference's device path quantizes the same way
    np.testing.assert_array_equal(jvideo.frames_to_uint8(jnp.asarray(x)), want)
    assert pvideo.frames_to_uint8(x).dtype == np.uint8


def test_export_video_decodes_to_the_reference_pixels(tmp_path):
    x = _frames()
    got = pvideo.export_video(x, str(tmp_path / "port" / "a.mp4"), fps=12.0)
    want = jvideo.export_video(x, str(tmp_path / "ref" / "a.mp4"), fps=12.0)
    assert got == str(tmp_path / "port" / "a.mp4")
    g, w = _decode(got), _decode(want)
    assert g.shape == (5, 32, 48, 3)
    np.testing.assert_array_equal(g, w)


def test_export_frames_png_matches_reference(tmp_path):
    from PIL import Image

    x = _frames(n=3)
    got = pvideo.export_frames_png(x, str(tmp_path / "p"), prefix="f")
    want = jvideo.export_frames_png(x, str(tmp_path / "r"), prefix="f")
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(Image.open(g)), np.asarray(Image.open(w)))


def test_audio_export_leaves_the_reference_side_wav(tmp_path):
    """Without imageio-ffmpeg's binary the mux fails: the silent video at
    the path, the WAV beside it, byte for byte the reference's."""
    pytest.importorskip("cv2")
    try:
        import imageio_ffmpeg  # noqa: F401
        has_ffmpeg = True
    except ImportError:
        has_ffmpeg = False
    x = _frames(n=3)
    audio = np.random.default_rng(1).uniform(-1.2, 1.2, (2, 1000)).astype(np.float32)
    got = pvideo.export_video(x, str(tmp_path / "p.mp4"), audio=audio, audio_sample_rate=8000)
    want = jvideo.export_video(x, str(tmp_path / "r.mp4"), audio=audio, audio_sample_rate=8000)
    for path in (got, want):
        assert (tmp_path / path.split("/")[-1]).stat().st_size > 0
    if not has_ffmpeg:
        side_p, side_r = tmp_path / "p.mp4.audio.wav", tmp_path / "r.mp4.audio.wav"
        assert side_p.read_bytes() == side_r.read_bytes()
        with wave.open(str(side_p)) as w:
            assert (w.getnchannels(), w.getframerate(), w.getnframes()) == (2, 8000, 1000)
        assert not (tmp_path / "p.mp4.video.mp4").exists()
    np.testing.assert_array_equal(_decode(got), _decode(want))


@pytest.mark.parametrize("kwargs", [dict(quality=8.0), dict(quality=-0.1)],
                         ids=["quality_0_10_scale", "quality_negative"])
def test_export_config_errors_match_reference(kwargs):
    with pytest.raises(ValueError) as want:
        jvideo.VideoExportConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        pvideo.VideoExportConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_export_config_fields_match_reference():
    for make in (lambda m: m.VideoExportConfig(), lambda m: m.VideoExportConfig.high_quality(),
                 lambda m: m.VideoExportConfig(fps=30.0, quality=0.5)):
        got, want = make(pvideo), make(jvideo)
        assert (got.fps, got.codec, got.quality, got.pixel_format) == \
            (want.fps, want.codec, want.quality, want.pixel_format)
        assert got.ffmpeg_codec == want.ffmpeg_codec
        assert got.requires_ffmpeg() == want.requires_ffmpeg()
    with pytest.raises(ValueError) as want:
        _ = jvideo.VideoExportConfig(codec="vp9").ffmpeg_codec
    with pytest.raises(ValueError) as got:
        _ = pvideo.VideoExportConfig(codec="vp9").ffmpeg_codec
    assert str(got.value) == str(want.value)


def test_non_default_settings_fail_as_the_reference(tmp_path, monkeypatch):
    """A codec or quality the OpenCV fallback cannot honour raises the
    reference's ExportFailedError when the ffmpeg writer fails."""
    import imageio

    def broken(*args, **kwargs):
        raise RuntimeError("no ffmpeg backend")

    monkeypatch.setattr(imageio, "get_writer", broken)
    x = _frames(n=2)
    cfg = dict(codec="hevc", quality=0.95)
    with pytest.raises(JExportFailed) as want:
        jvideo.export_video(x, str(tmp_path / "r.mp4"), config=jvideo.VideoExportConfig(**cfg))
    with pytest.raises(ExportFailedError) as got:
        pvideo.export_video(x, str(tmp_path / "p.mp4"), config=pvideo.VideoExportConfig(**cfg))
    assert str(got.value) == str(want.value)
    # the defaults fall back to OpenCV on both sides
    g = pvideo.export_video(x, str(tmp_path / "d_p.mp4"))
    w = jvideo.export_video(x, str(tmp_path / "d_r.mp4"))
    np.testing.assert_array_equal(_decode(g), _decode(w))
