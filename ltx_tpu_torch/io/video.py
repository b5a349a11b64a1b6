"""Image input for conditioning, and WAV output of the audio paths.

Port of ltx_tpu/io/video.py::load_image and export_wav. PIL is imported
inside the function, as there: the package imports without it.
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
