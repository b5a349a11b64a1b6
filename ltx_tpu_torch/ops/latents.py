"""Latent-space utilities: geometry, patchify, CFG combine, noise.

Port of ltx_tpu/ops/latents.py (the parts on the text-to-video path).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ltx_tpu_torch.config import LATENT_CHANNELS, SPATIAL_SCALE, TEMPORAL_SCALE


@dataclasses.dataclass(frozen=True)
class VideoLatentShape:
    """Latent geometry (B, C, F, H, W)."""

    batch: int
    channels: int
    frames: int
    height: int
    width: int

    @classmethod
    def from_pixels(cls, batch: int, num_frames: int, height: int, width: int,
                    channels: int = LATENT_CHANNELS) -> "VideoLatentShape":
        return cls(
            batch=batch,
            channels=channels,
            frames=(num_frames - 1) // TEMPORAL_SCALE + 1,
            height=height // SPATIAL_SCALE,
            width=width // SPATIAL_SCALE,
        )

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        return (self.batch, self.channels, self.frames, self.height, self.width)

    @property
    def token_count(self) -> int:
        return self.frames * self.height * self.width

    @property
    def pixel_frames(self) -> int:
        return TEMPORAL_SCALE * (self.frames - 1) + 1


def patchify(latent):
    """(B, C, F, H, W) -> (B, T, C), tokens in row-major (F, H, W) order."""
    b, c, f, h, w = latent.shape
    return latent.permute(0, 2, 3, 4, 1).reshape(b, f * h * w, c)


def unpatchify(x, shape: VideoLatentShape):
    """(B, T, C) -> (B, C, F, H, W)."""
    b, c, f, h, w = shape.shape
    return x.reshape(b, f, h, w, c).permute(0, 4, 1, 2, 3)


def generate_noise(shape: VideoLatentShape, generator: torch.Generator):
    """Initial latent noise, float32 standard normal on the generator's
    device. A torch generator does not give jax.random's numbers: parity
    runs draw with jax and pass the array in instead."""
    return torch.randn(shape.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)


def apply_cfg(uncond, cond, guidance_scale: float):
    """cond + (scale - 1) * (cond - uncond), in this exact algebraic form."""
    scale_m1 = torch.tensor(guidance_scale - 1.0, dtype=cond.dtype,
                            device=cond.device)
    return cond + scale_m1 * (cond - uncond)
