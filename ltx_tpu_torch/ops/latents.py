"""Latent-space utilities: geometry, patchify, guidance combines, AdaIN,
per-channel statistics, noise.

Port of ltx_tpu/ops/latents.py, with its memory estimate against one CUDA
device's memory (`device_memory_gb`) in place of a TPU chip's. Variances are
the population's (jnp.var's default), not torch's sample variance.
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


# ---------------------------------------------------------------------------
# Memory estimation
# ---------------------------------------------------------------------------

# parameter counts of the checkpoint's inventories (tests/weight_fixtures.py):
# the video-only DiT and the dual audio-video DiT
_DIT_PARAMS = 13.04e9
_AV_DIT_PARAMS = 18.88e9


def device_memory_gb(device=0) -> float:
    """A CUDA device's total memory in GB (1e9 bytes): the budget the
    estimates below are held to unless the caller passes one."""
    return torch.cuda.get_device_properties(device).total_memory / 1e9


def estimate_memory_gb(shape: VideoLatentShape, guidance_rows: int = 1, dit_bits=None,
                       vae_tile_size: int = 0, audio: bool = False) -> float:
    """A rough, conservative peak device memory (GB) of one denoise and
    decode: the larger of the denoise phase (the DiT's weights at `dit_bits`
    (None: bf16) and a few live (rows, tokens, 16384) f32 activations) and
    the decode phase (~1 GB of decoder weights and its largest intermediate,
    two tiles of it when the decode is tiled). For warnings and presets,
    never a hard limit."""
    bytes_per_param = {4: 0.625, 8: 1.125, None: 2.0}[dit_bits]
    n_params = _AV_DIT_PARAMS if audio else _DIT_PARAMS
    params_gb = n_params * bytes_per_param / 1e9
    tokens = shape.token_count
    act_gb = guidance_rows * tokens * 16384 * 4 * 6 / 1e9
    denoise_gb = params_gb + act_gb

    tiled = vae_tile_size > 0 and shape.frames > vae_tile_size
    frames = min(shape.frames, vae_tile_size + 1) if tiled else shape.frames
    px = 8 * (frames - 1) + 1
    spatial = (shape.height * 8) * (shape.width * 8)  # quarter-resolution grid
    tile_copies = 2 if tiled else 1
    decode_gb = 1.0 + tile_copies * px * spatial * 128 * 2 * 4 / 1e9
    return round(max(denoise_gb, decode_gb), 2)


def recommended_memory_preset(shape: VideoLatentShape, guidance_rows: int = 1,
                              dit_bits=None, audio: bool = False,
                              budget_gb=None) -> str:
    """The lightest MemoryConfig preset ("light", "moderate", "aggressive")
    whose estimate fits `budget_gb` (default: CUDA device 0's memory)."""
    if budget_gb is None:
        budget_gb = device_memory_gb()
    for preset, tile in (("light", 0), ("moderate", 8), ("aggressive", 6)):
        if estimate_memory_gb(shape, guidance_rows, dit_bits, vae_tile_size=tile,
                              audio=audio) <= budget_gb:
            return preset
    return "aggressive"
