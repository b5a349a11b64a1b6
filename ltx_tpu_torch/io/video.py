"""Image input for conditioning.

Port of ltx_tpu/io/video.py::load_image. PIL is imported inside the
function, as there: the package imports without it.
"""

from __future__ import annotations

import numpy as np


def load_image(path: str, width: int, height: int) -> np.ndarray:
    """Image file -> (1, 3, 1, H, W) float32 in [-1, 1] for I2V conditioning
    (/ 127.5 - 1 after a Lanczos resize to width x height)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((width, height), Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 127.5 - 1.0  # (H, W, 3)
    return arr.transpose(2, 0, 1)[None, :, None]  # (1, 3, 1, H, W)
