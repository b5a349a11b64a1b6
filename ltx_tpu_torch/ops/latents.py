"""Latent-space utilities: geometry, patchify, guidance combines, AdaIN,
per-channel statistics, noise.

Port of ltx_tpu/ops/latents.py (all but its TPU memory estimates). Variances
are the population's (jnp.var's default), not torch's sample variance.
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


def _var(x, dims):
    return torch.var(x, dim=dims, keepdim=True, correction=0)


def apply_guidance_rescale(cfg_output, cond_output, phi: float):
    """Rescale the CFG output's std toward the conditional output's, blended
    by phi; std over all non-batch axes."""
    if phi <= 0.0:
        return cfg_output
    eps = 1e-8
    dims = tuple(range(1, cfg_output.ndim))
    cfg_std = torch.sqrt(_var(cfg_output, dims) + eps)
    cond_std = torch.sqrt(_var(cond_output, dims) + eps)
    rescaled = cfg_output * (cond_std / cfg_std)
    return phi * rescaled + (1.0 - phi) * cfg_output


def adain_filter_latent(latent, reference, factor: float = 1.0):
    """Per-channel AdaIN toward the reference latent's statistics. Shapes
    (B, C, F, H, W); the spatial dims of the two may differ."""
    if factor <= 0:
        return latent
    dims = (2, 3, 4)
    l_mean = torch.mean(latent, dim=dims, keepdim=True)
    l_std = torch.sqrt(_var(latent, dims))
    r_mean = torch.mean(reference, dim=dims, keepdim=True)
    r_std = torch.sqrt(_var(reference, dims))
    result = (latent - l_mean) / (l_std + 1e-8) * r_std + r_mean
    if factor >= 1.0:
        return result
    return factor * result + (1.0 - factor) * latent


def normalize_latent(latent, eps: float = 1e-6):
    """Zero mean and unit variance per channel."""
    dims = (2, 3, 4)
    mean = torch.mean(latent, dim=dims, keepdim=True)
    std = torch.sqrt(_var(latent, dims) + eps)
    return (latent - mean) / std


def denormalize_latent(latent, mean, std):
    """latent * std + mean with (C,) statistics."""
    return latent * std.reshape(1, -1, 1, 1, 1) + mean.reshape(1, -1, 1, 1, 1)
