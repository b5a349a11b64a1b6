"""The audio VAE decoder and the HiFi-GAN vocoder.

Port of ltx_tpu/models/audio_vae.py. The decoder takes a latent (B, 8, T,
16) to a stereo mel (B, 2, 4T - 3, 64); the vocoder takes the mel to a 24
kHz stereo waveform (240x upsampling by strides 6*5*2*2*2, tanh output).
The reference runs channels-last (NHWC, NTC); this port runs torch's NCHW
and NCT, the weights converted once (convert.py) or read in the
checkpoint's own layout (`load_audio_vae_params`, `load_vocoder_params`).
Convolutions are cuDNN's: no Pallas kernel computes them in the reference.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ltx_tpu_torch.config import AudioVAEConfig, VocoderConfig
from ltx_tpu_torch.models.common import Conv1d, Conv2d, ConvTranspose1d, param, silu

__all__ = ["AudioVAEConfig", "VocoderConfig", "AudioVAE", "Vocoder", "audio_vae_decode",
           "vocoder_forward", "decode_audio", "load_audio_vae_params",
           "load_vocoder_params"]


# ---------------------------------------------------------------------------
# Audio VAE decoder (NCHW; H = time is the causal axis)
# ---------------------------------------------------------------------------


def audio_pixel_norm(x, eps: float = 1e-6):
    """Channel RMS norm over dim 1, f32 statistics."""
    dtype = x.dtype
    xf = x.float()
    ms = torch.mean(xf * xf, dim=1, keepdim=True)
    return (xf / torch.sqrt(ms + eps)).to(dtype)


def causal_conv2d(conv: Conv2d, x, stride: int = 1):
    """Height-causal 2D conv: all the H padding at the top (zeros), the W
    padding symmetric; the bias added after the product's rounding."""
    kh, kw = conv.weight.shape[2], conv.weight.shape[3]
    pad_w = kw - 1
    x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2, kh - 1, 0))
    out = F.conv2d(x, conv.weight.to(x.dtype), stride=stride)
    return out + conv.bias.to(x.dtype)[:, None, None]


class ResBlock(nn.Module):
    """PixelNorm -> SiLU -> conv, twice, plus the (projected) input."""

    def __init__(self, c_in: int, c_out: int, device, dtype):
        super().__init__()
        self.conv1 = Conv2d(c_in, c_out, 3, device=device, dtype=dtype)
        self.conv2 = Conv2d(c_out, c_out, 3, device=device, dtype=dtype)
        self.nin_shortcut = (Conv2d(c_in, c_out, 1, device=device, dtype=dtype)
                             if c_in != c_out else None)

    def forward(self, x):
        h = causal_conv2d(self.conv1, silu(audio_pixel_norm(x)))
        h = causal_conv2d(self.conv2, silu(audio_pixel_norm(h)))
        res = x if self.nin_shortcut is None else causal_conv2d(self.nin_shortcut, x)
        return h + res


class Upsample(nn.Module):
    """Nearest 2x in H and W, a causal conv, the first row trimmed."""

    def __init__(self, c: int, device, dtype):
        super().__init__()
        self.conv = Conv2d(c, c, 3, device=device, dtype=dtype)

    def forward(self, x):
        up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return causal_conv2d(self.conv, up)[:, :, 1:]


class _Level(nn.Module):
    def __init__(self, c_in: int, c_out: int, blocks: int, upsample: bool, device, dtype):
        super().__init__()
        self.block = nn.ModuleList([ResBlock(c_in, c_out, device, dtype)] + [
            ResBlock(c_out, c_out, device, dtype) for _ in range(blocks)])
        self.upsample = Upsample(c_out, device, dtype) if upsample else None


class _Mid(nn.Module):
    def __init__(self, c: int, device, dtype):
        super().__init__()
        self.block_1 = ResBlock(c, c, device, dtype)
        self.block_2 = ResBlock(c, c, device, dtype)


class AudioDecoder(nn.Module):
    """conv_in -> two mid res blocks -> the levels from the top down (res
    blocks, a 2x upsample but at the lowest) -> PixelNorm + SiLU -> conv_out."""

    def __init__(self, cfg: AudioVAEConfig, device, dtype):
        super().__init__()
        top = cfg.base_channels * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.latent_channels, top, 3, device=device, dtype=dtype)
        self.mid = _Mid(top, device, dtype)
        specs, block_in = [], top
        for i in reversed(range(len(cfg.ch_mult))):
            block_out = cfg.base_channels * cfg.ch_mult[i]
            specs.append((block_in, block_out, i != 0))
            block_in = block_out
        self.up = nn.ModuleList(_Level(ci, co, cfg.num_res_blocks, has_up, device, dtype)
                                for ci, co, has_up in reversed(specs))
        self.conv_out = Conv2d(cfg.base_channels, cfg.output_channels, 3, device=device,
                               dtype=dtype)

    def forward(self, latents):
        """(B, 8, T, 16) -> (B, 2, H_out, W_out), before the crop."""
        x = causal_conv2d(self.conv_in, latents)
        x = self.mid.block_2(self.mid.block_1(x))
        for level in reversed(self.up):
            for blk in level.block:
                x = blk(x)
            if level.upsample is not None:
                x = level.upsample(x)
        return causal_conv2d(self.conv_out, silu(audio_pixel_norm(x)))


class AudioVAE(nn.Module):
    """The decoder and the packed latents' (8 * mel_latent_bins,) statistics.
    Parameter names follow ltx_tpu.models.audio_vae.init_audio_vae_params."""

    def __init__(self, cfg: AudioVAEConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        pack = cfg.latent_channels * cfg.mel_latent_bins
        self.decoder = AudioDecoder(cfg, device, dtype)
        self.latents_mean = param(pack, device=device)
        self.latents_std = param(pack, device=device)

    def reset_parameters(self, gen):
        self.latents_mean.zero_()
        self.latents_std.fill_(1.0)


def audio_vae_decode(vae: AudioVAE, latents):
    """Denormalize the packed latents, decode, crop causally: (B, 8, T, 16)
    -> mel (B, 2, 4T - 3, 64)."""
    cfg = vae.cfg
    b, c, t, m = latents.shape
    target = max(t * cfg.latent_downsample - (cfg.latent_downsample - 1), 1)
    packed = latents.transpose(1, 2).reshape(b, t, c * m)
    mean = vae.latents_mean.reshape(1, 1, -1).float()
    std = vae.latents_std.reshape(1, 1, -1).float()
    packed = (packed.float() * std + mean).to(latents.dtype)
    sample = packed.reshape(b, t, c, m).transpose(1, 2)
    out = vae.decoder(sample)
    return out[:, :, :target, :cfg.mel_bins]


# ---------------------------------------------------------------------------
# HiFi-GAN vocoder (NCT)
# ---------------------------------------------------------------------------


def _conv1d(conv: Conv1d, x, dilation: int = 1):
    """Same-padded 1D conv; the bias added after the product's rounding."""
    k = conv.weight.shape[2]
    pad = dilation * (k - 1) // 2
    out = F.conv1d(x, conv.weight.to(x.dtype), padding=pad, dilation=dilation)
    return out + conv.bias.to(x.dtype)[:, None]


def _conv_transpose1d(conv: ConvTranspose1d, x, stride: int, padding: int):
    """out_len = (T - 1) * stride - 2 * padding + k."""
    out = F.conv_transpose1d(x, conv.weight.to(x.dtype), stride=stride, padding=padding)
    return out + conv.bias.to(x.dtype)[:, None]


def _leaky(x, slope: float):
    return torch.where(x >= 0, x, slope * x)


class VocoderResBlock(nn.Module):
    """Per dilation: leaky -> dilated conv -> leaky -> conv, added to the
    input."""

    def __init__(self, c: int, kernel: int, dilations, device, dtype):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(Conv1d(c, c, kernel, device=device, dtype=dtype)
                                    for _ in dilations)
        self.convs2 = nn.ModuleList(Conv1d(c, c, kernel, device=device, dtype=dtype)
                                    for _ in dilations)

    def forward(self, x, slope: float):
        h = x
        for c1, c2, dil in zip(self.convs1, self.convs2, self.dilations):
            xt = _conv1d(c1, _leaky(h, slope), dilation=dil)
            h = h + _conv1d(c2, _leaky(xt, slope))
        return h


class Vocoder(nn.Module):
    """Parameter names follow ltx_tpu.models.audio_vae.init_vocoder_params."""

    def __init__(self, cfg: VocoderConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.conv_in = Conv1d(cfg.in_channels, cfg.hidden_channels, 7, device=device,
                              dtype=dtype)
        ups, resnets = [], []
        ch = cfg.hidden_channels
        for ksize in cfg.upsample_kernels:
            out_ch = ch // 2
            ups.append(ConvTranspose1d(ch, out_ch, ksize, device=device, dtype=dtype))
            resnets += [VocoderResBlock(out_ch, kern, dils, device, dtype)
                        for kern, dils in zip(cfg.resnet_kernels, cfg.resnet_dilations)]
            ch = out_ch
        self.upsamplers = nn.ModuleList(ups)
        self.resnets = nn.ModuleList(resnets)
        self.conv_out = Conv1d(ch, cfg.out_channels, 7, device=device, dtype=dtype)


def vocoder_forward(vocoder: Vocoder, mel):
    """(B, 2, T_mel, 64) stereo mel -> (B, 2, samples) waveform in (-1, 1)."""
    cfg = vocoder.cfg
    b, t = mel.shape[0], mel.shape[2]
    x = mel.transpose(2, 3).reshape(b, -1, t)  # channel = stereo channel * 64 + mel bin
    x = _conv1d(vocoder.conv_in, x)
    n_res = len(cfg.resnet_kernels)
    for i, (factor, ksize) in enumerate(zip(cfg.upsample_factors, cfg.upsample_kernels)):
        x = _leaky(x, cfg.leaky_slope)
        x = _conv_transpose1d(vocoder.upsamplers[i], x, factor, (ksize - factor) // 2)
        outs = [vocoder.resnets[i * n_res + j](x, cfg.leaky_slope) for j in range(n_res)]
        x = torch.stack(outs).mean(dim=0)
    x = _leaky(x, 0.01)  # the last one at the default slope, not cfg.leaky_slope
    return torch.tanh(_conv1d(vocoder.conv_out, x))


def decode_audio(vae: AudioVAE, vocoder: Vocoder, latents):
    """latents (B, 8, T, 16) or (8, T, 16) -> stereo waveform (B, 2,
    samples) at the vocoder's rate. No normalization: the tanh bounds it."""
    if latents.ndim == 3:
        latents = latents[None]
    return vocoder_forward(vocoder, audio_vae_decode(vae, latents))


# ---------------------------------------------------------------------------
# Checkpoint files -> state dicts (the checkpoint's own names and layouts)
# ---------------------------------------------------------------------------


def load_audio_vae_params(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The audio VAE file's decoder.* and latents_mean / latents_std -> the
    AudioVAE state dict, every tensor float32. A causal conv nests its Conv2d
    as `.conv.`; a conv without a bias in the file gets a zero one (the
    reference adds none). Encoder keys are not read, as the reference's."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tensors.items():
        if not key.startswith("decoder.") or not key.endswith((".conv.weight", ".conv.bias")):
            continue
        out[key.replace(".conv.weight", ".weight").replace(".conv.bias", ".bias")] = \
            value.to(torch.float32)
    for key in [k for k in out if k.endswith(".weight")]:
        bias = key[:-len(".weight")] + ".bias"
        if bias not in out:
            out[bias] = torch.zeros(out[key].shape[0])
    out["latents_mean"] = tensors["latents_mean"].to(torch.float32).reshape(-1)
    out["latents_std"] = tensors["latents_std"].to(torch.float32).reshape(-1)
    return out


def load_vocoder_params(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The vocoder file's conv_in, upsamplers, resnets and conv_out -> the
    Vocoder state dict: their names and torch layouts (Conv1d (O, I, k),
    ConvTranspose1d (I, O, k)) are the module's, every tensor float32."""
    return {k: v.to(torch.float32) for k, v in tensors.items()
            if k.startswith(("conv_in.", "conv_out.", "upsamplers.", "resnets."))}
