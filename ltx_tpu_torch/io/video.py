"""Host-side media IO: MP4, PNG and WAV export, image and clip input.

Port of ltx_tpu/io/video.py: `VideoExportConfig`, `frames_to_uint8`,
`export_video` (MP4 through imageio-ffmpeg, else OpenCV's mp4v; with audio a
side WAV muxed by imageio-ffmpeg's ffmpeg), `export_frames_png`,
`export_wav`, `load_image` and `load_video`. PIL, OpenCV and imageio are
imported inside the functions, as there: the package imports without them.
"""

from __future__ import annotations

import dataclasses
import logging
import wave
from pathlib import Path
from typing import Optional

import numpy as np
import torch

log = logging.getLogger("ltx_tpu_torch.io")


@dataclasses.dataclass(frozen=True)
class VideoExportConfig:
    """Codec, quality, fps and pixel format of an MP4 export: fps 24, h264,
    quality 0.8 on a 0..1 scale (imageio-ffmpeg's 0..10 quantizer times
    10), yuv420p."""

    fps: float = 24.0
    codec: str = "h264"          # "h264" | "hevc"
    quality: float = 0.8
    pixel_format: str = "yuv420p"

    _CODECS = {"h264": "libx264", "hevc": "libx265"}

    def __post_init__(self):
        if not 0.0 <= self.quality <= 1.0:
            # out of range would fail inside imageio and fall to the cv2 writer
            raise ValueError(f"export quality {self.quality} must be in [0, 1]")

    @property
    def ffmpeg_codec(self) -> str:
        try:
            return self._CODECS[self.codec]
        except KeyError:
            raise ValueError(f"unknown codec {self.codec!r}; pick from "
                             f"{sorted(self._CODECS)}") from None

    def requires_ffmpeg(self) -> bool:
        """True for a codec, quality or pixel format other than the
        defaults: settings the OpenCV mp4v fallback cannot honour (it
        honours fps)."""
        return (self.codec != "h264" or self.quality != 0.8
                or self.pixel_format != "yuv420p")

    @classmethod
    def high_quality(cls) -> "VideoExportConfig":
        return cls(fps=24.0, codec="hevc", quality=0.95)


def frames_to_uint8(frames) -> np.ndarray:
    """(F, H, W, 3) floats in [0, 1] -> uint8 on the host, clip(x * 255 +
    0.5) truncated. A CUDA tensor is quantized on the card before its one
    copy to the host (a quarter of f32's bytes); host input (numpy, or a
    CPU tensor) is quantized in numpy, the same formula."""
    if isinstance(frames, torch.Tensor) and frames.is_cuda:
        q = torch.clamp(frames.float() * 255.0 + 0.5, 0, 255).to(torch.uint8)
        return q.cpu().numpy()
    if isinstance(frames, torch.Tensor):
        frames = frames.detach().numpy()
    arr = np.asarray(frames, dtype=np.float32)
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def export_video(frames, path: str, fps: float = 24.0, audio: Optional[np.ndarray] = None,
                 audio_sample_rate: int = 24000,
                 config: Optional[VideoExportConfig] = None) -> str:
    """Write (F, H, W, 3) frames in [0, 1] to an MP4 (H.264 when available).

    `config` picks codec and quality (its fps wins over `fps`). With audio
    (2, samples) in [-1, 1]: the video and a temporary WAV are written, then
    muxed with imageio-ffmpeg's ffmpeg (AAC); without that binary the silent
    video stays at `path` beside `path` + ".audio.wav". Returns the path."""
    if config is None:
        config = VideoExportConfig(fps=fps)
    pixels = frames_to_uint8(frames)
    path = str(path)
    Path(path).parent.mkdir(parents=True, exist_ok=True)

    video_path = path
    if audio is not None:
        video_path = path + ".video.mp4"

    _write_mp4(pixels, video_path, config)

    if audio is not None:
        wav_path = path + ".audio.wav"
        export_wav(audio, wav_path, sample_rate=audio_sample_rate)
        try:
            _mux_av(video_path, wav_path, path)
            for p in (video_path, wav_path):
                Path(p).unlink(missing_ok=True)
        except (ImportError, ModuleNotFoundError, OSError) as e:
            # no ffmpeg binary: the silent video at `path` and the side WAV
            log.warning("AAC mux unavailable (%s); wrote side WAV %s", e, wav_path)
            Path(video_path).rename(path)
    return path


def _write_mp4(pixels: np.ndarray, path: str, config: VideoExportConfig) -> None:
    """uint8 (F, H, W, 3) -> MP4: imageio-ffmpeg with the config's codec,
    quality and pixel format; else OpenCV's mp4v at its own quality, only
    for the default settings (others raise ExportFailedError)."""
    codec = config.ffmpeg_codec  # validate before the fallback chain
    try:
        import imageio

        with imageio.get_writer(path, fps=config.fps, codec=codec,
                                quality=config.quality * 10.0,
                                pixelformat=config.pixel_format) as writer:
            for frame in pixels:
                writer.append_data(frame)
        return
    except Exception as e:  # imageio-ffmpeg missing or codec unavailable
        # mp4v cannot honour an explicit codec, quality or pixel format: a
        # request that asked for them fails rather than ships another encoding
        if config.requires_ffmpeg():
            from ltx_tpu_torch.errors import ExportFailedError

            raise ExportFailedError(
                f"ffmpeg mp4 writer failed ({e}) and the requested "
                f"codec={config.codec} quality={config.quality} "
                f"pixel_format={config.pixel_format} cannot be honored by "
                "the OpenCV fallback (mp4v, fixed quality)") from e
        log.warning("imageio mp4 writer failed (%s); falling back to OpenCV mp4v at "
                    "default quality", e)

    import cv2

    f, h, w, _ = pixels.shape
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    vw = cv2.VideoWriter(path, fourcc, config.fps, (w, h))
    if not vw.isOpened():
        from ltx_tpu_torch.errors import ExportFailedError

        raise ExportFailedError(f"cannot open video writer for {path}")
    for frame in pixels:
        vw.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    vw.release()


def _mux_av(video_path: str, wav_path: str, out_path: str) -> None:
    """Mux the video with the WAV as AAC through imageio-ffmpeg's binary."""
    import subprocess

    import imageio_ffmpeg

    ffmpeg = imageio_ffmpeg.get_ffmpeg_exe()
    subprocess.run([ffmpeg, "-y", "-i", video_path, "-i", wav_path, "-c:v", "copy",
                    "-c:a", "aac", "-shortest", out_path], check=True, capture_output=True)


def export_frames_png(frames, directory: str, prefix: str = "frame") -> list:
    """Each frame as `directory`/`prefix`_NNNN.png; returns the paths."""
    from PIL import Image

    pixels = frames_to_uint8(frames)
    Path(directory).mkdir(parents=True, exist_ok=True)
    paths = []
    for i, frame in enumerate(pixels):
        p = Path(directory) / f"{prefix}_{i:04d}.png"
        Image.fromarray(frame).save(p)
        paths.append(str(p))
    return paths


def load_image(path: str, width: int, height: int) -> np.ndarray:
    """Image file -> (1, 3, 1, H, W) float32 in [-1, 1] for I2V conditioning
    (/ 127.5 - 1 after a Lanczos resize to width x height)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((width, height), Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 127.5 - 1.0  # (H, W, 3)
    return arr.transpose(2, 0, 1)[None, :, None]  # (1, 3, 1, H, W)


def load_video(path: str, width: int, height: int, num_frames: int,
               sample: str = "even") -> np.ndarray:
    """Video file -> (1, 3, F, H, W) float32 in [-1, 1]: `num_frames` frames,
    each Lanczos-resized to width x height, then / 127.5 - 1. sample="even":
    frames at np.linspace over the clip, rounded; "tail": the clip's last
    num_frames consecutive frames (IOError on a shorter clip). Frames are
    read with OpenCV, or imageio without it."""
    frames = _read_frames(str(path))
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    if sample == "tail":
        if len(frames) < num_frames:
            raise IOError(f"clip has {len(frames)} frames < {num_frames} requested "
                          "tail frames")
        idx = np.arange(len(frames) - num_frames, len(frames))
    elif sample == "even":
        idx = np.linspace(0, len(frames) - 1, num_frames).round().astype(int)
    else:
        raise ValueError(f"unknown sample mode {sample!r}")
    from PIL import Image

    out = np.empty((num_frames, height, width, 3), np.float32)
    for j, i in enumerate(idx):
        img = Image.fromarray(frames[i]).resize((width, height), Image.LANCZOS)
        out[j] = np.asarray(img, np.float32) / 127.5 - 1.0
    return out.transpose(3, 0, 1, 2)[None]  # (1, 3, F, H, W)


def _read_frames(path: str) -> list:
    """Every frame of a clip as (H, W, 3) uint8 RGB."""
    try:
        import cv2

        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        cap.release()
        if frames:
            return frames
    except ImportError:
        pass
    import imageio.v2 as iio

    return [np.asarray(f)[..., :3] for f in iio.mimread(path, memtest=False)]


def export_wav(audio, path: str, sample_rate: int = 24000) -> str:
    """(C, samples) or (samples,) floats in [-1, 1] -> a 16-bit PCM WAV of
    C interleaved channels (x 32767, clipped, truncated toward zero).
    Returns the path."""
    arr = np.asarray(audio, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    channels, _ = arr.shape
    pcm = np.clip(arr * 32767.0, -32768, 32767).astype(np.int16)
    interleaved = pcm.T.reshape(-1)  # (samples, C) interleaved

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(interleaved.tobytes())
    return str(path)
