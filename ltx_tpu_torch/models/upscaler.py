"""Spatial latent upscaler (2x) of the two-stage pipeline.

Port of ltx_tpu/models/upscaler.py. The reference runs channels-last with
DHWIO / HWIO weights; this port runs torch's channels-first with
(O, I, D, H, W) / (O, I, H, W) weights, converted once in convert.py. The
public layout is the same: (B, C, F, H, W) -> (B, C, F, 2H, 2W).
Convolutions are cuDNN's (the reference's were XLA's, not Pallas).

  initial Conv3d 128 -> 1024, GroupNorm(32, f32 statistics), SiLU;
  4 res blocks (conv-norm-silu-conv-norm, SiLU AFTER the residual add);
  per-frame Conv2d 1024 -> 4096 and a pixel shuffle by 2;
  4 res blocks; final Conv3d 1024 -> 128.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ltx_tpu_torch.models.common import Conv2d, Conv3d, NormAffine, silu
from ltx_tpu_torch.ops.normalization import group_norm_f32


@dataclasses.dataclass(frozen=True)
class UpscalerConfig:
    """The same fields as the reference's UpscalerConfig."""

    in_channels: int = 128
    mid_channels: int = 1024
    blocks_per_stage: int = 4
    num_groups: int = 32
    eps: float = 1e-5

    def tiny(self) -> "UpscalerConfig":
        return dataclasses.replace(self, in_channels=8, mid_channels=64,
                                   blocks_per_stage=1, num_groups=4)


def _conv(conv, x):
    """Same-padded (zeros) conv in x's dtype; the bias adds after, in x's
    dtype, as in the reference."""
    w = conv.weight.to(x.dtype)
    if w.ndim == 5:
        out = F.conv3d(x, w, padding=1)
        return out + conv.bias.to(x.dtype)[None, :, None, None, None]
    out = F.conv2d(x, w, padding=1)
    return out + conv.bias.to(x.dtype)[None, :, None, None]


def pixel_shuffle_2d(x, r: int = 2):
    """(N, C*r*r, H, W) -> (N, C, H*r, W*r), channel order (c, rh, rw):
    that of F.pixel_shuffle (the tests hold both against the reference)."""
    return F.pixel_shuffle(x, r)


class ResBlock3D(nn.Module):
    def __init__(self, cfg: UpscalerConfig, device, dtype):
        super().__init__()
        mid = cfg.mid_channels
        self.groups, self.eps = cfg.num_groups, cfg.eps
        self.conv1 = Conv3d(mid, mid, device=device, dtype=dtype)
        self.norm1 = NormAffine(mid, device=device, dtype=dtype)
        self.conv2 = Conv3d(mid, mid, device=device, dtype=dtype)
        self.norm2 = NormAffine(mid, device=device, dtype=dtype)

    def forward(self, x):
        h = _conv(self.conv1, x)
        h = group_norm_f32(h, self.norm1.weight, self.norm1.bias, self.groups, self.eps)
        h = _conv(self.conv2, silu(h))
        h = group_norm_f32(h, self.norm2.weight, self.norm2.bias, self.groups, self.eps)
        return silu(h + x)


class Upsampler(nn.Module):
    """The per-frame Conv2d before the pixel shuffle (tree key `upsampler`)."""

    def __init__(self, mid: int, device, dtype):
        super().__init__()
        self.conv = Conv2d(mid, 4 * mid, device=device, dtype=dtype)


class LatentUpscaler(nn.Module):
    """Parameter names follow ltx_tpu.models.upscaler.init_params."""

    def __init__(self, cfg: UpscalerConfig = UpscalerConfig(), device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        mid = cfg.mid_channels
        self.initial_conv = Conv3d(cfg.in_channels, mid, device=device, dtype=dtype)
        self.initial_norm = NormAffine(mid, device=device, dtype=dtype)
        self.res_blocks = nn.ModuleList(
            ResBlock3D(cfg, device, dtype) for _ in range(cfg.blocks_per_stage))
        self.upsampler = Upsampler(mid, device, dtype)
        self.post_upsample_res_blocks = nn.ModuleList(
            ResBlock3D(cfg, device, dtype) for _ in range(cfg.blocks_per_stage))
        self.final_conv = Conv3d(mid, cfg.in_channels, device=device, dtype=dtype)

    def forward(self, latent):
        """(B, C, F, H, W) -> (B, C, F, 2H, 2W) (upscaler_forward)."""
        cfg = self.cfg
        x = _conv(self.initial_conv, latent)
        x = silu(group_norm_f32(x, self.initial_norm.weight, self.initial_norm.bias,
                                cfg.num_groups, cfg.eps))
        for block in self.res_blocks:
            x = block(x)
        b, c, f, h, w = x.shape
        frames = x.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, w)
        frames = pixel_shuffle_2d(_conv(self.upsampler.conv, frames), 2)
        x = frames.reshape(b, f, c, h * 2, w * 2).permute(0, 2, 1, 3, 4)
        for block in self.post_upsample_res_blocks:
            x = block(x)
        return _conv(self.final_conv, x)


def load_params(tensors: dict) -> dict:
    """Checkpoint tensors -> the LatentUpscaler state dict: the checkpoint's
    names and torch layouts are the module's, every tensor float32; the
    fixed `blur_down` kernel is skipped (the reference does not read it)."""
    return {k: v.to(torch.float32) for k, v in tensors.items()
            if not k.startswith("blur_down")}


def upsample_latents(upscaler: LatentUpscaler, latent, mean, std):
    """Denormalize with the VAE's (C,) per-channel statistics, upscale, and
    normalize again; f32 in and out."""
    m = mean.reshape(1, -1, 1, 1, 1).float()
    s = std.reshape(1, -1, 1, 1, 1).float()
    x = upscaler(latent.float() * s + m)
    return (x.float() - m) / s
