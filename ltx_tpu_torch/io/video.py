"""Image and clip input for conditioning, and WAV output of the audio paths.

Port of ltx_tpu/io/video.py::load_image, load_video and export_wav. PIL,
OpenCV and imageio are imported inside the functions, as there: the package
imports without them.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


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
