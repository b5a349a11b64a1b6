"""The decoders, plain: the video VAE decoder with its temporal tiling, the
audio VAE decoder and the HiFi-GAN vocoder.

Video: per-channel denormalisation, conv_in, [5 res blocks (PixelNorm,
scale/shift, SiLU, conv, twice, plus the input), depth-to-space x2 upsample
with a channel-tiled residual] x3, PixelNorm + table scale/shift + SiLU,
conv_out, 4x4 unpatchify; time replicates at the edges, space reflects.
Tiles of `tile` latent frames overlapping by `overlap` stitch frame-aligned,
each later tile's first pixel frame dropped and 8 (overlap - 1) frames
blended linearly; the reference keeps every frame in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import ConvTransposeWeights, ConvWeights, Linear, empty, silu


def conv3d(conv: ConvWeights, x, causal: bool = False):
    kt, kh, kw = conv.weight.shape[2:]
    if kt > 1:
        front = kt - 1 if causal else (kt - 1) // 2
        x = F.pad(x, (0, 0, 0, 0, front, kt - 1 - front), mode="replicate")
    if kh > 1 or kw > 1:
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, 0, 0), mode="reflect")
    out = F.conv3d(conv.input_for(x, per_row=False), conv.weight_for(x))
    return out + conv.bias.to(x.dtype)[None, :, None, None, None]


def pixel_norm(x, eps: float = 1e-8):
    return x / torch.sqrt(torch.mean(x * x, dim=1, keepdim=True) + eps)


class Conv3d(ConvWeights):
    def __init__(self, c_in, c_out, k=3):
        super().__init__(c_out, c_in, k, k, k)


class TimeEmbedder(nn.Module):
    """The decoder's timestep MLP (unused without timestep conditioning)."""

    def __init__(self, d_out):
        super().__init__()
        self.timestep_embedder = nn.Module()
        self.timestep_embedder.linear_1 = Linear(256, 256)
        self.timestep_embedder.linear_2 = Linear(256, d_out)


class ResBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1, self.conv2 = Conv3d(c, c), Conv3d(c, c)
        self.scale_shift_table = empty(4, c)

    def forward(self, x):
        t = self.scale_shift_table.float()
        ss = [t[i][None, :, None, None, None] for i in range(4)]
        h = conv3d(self.conv1, silu(pixel_norm(x) * (ss[1] + 1) + ss[0]))
        h = conv3d(self.conv2, silu(pixel_norm(h) * (ss[3] + 1) + ss[2]))
        return h + x


class ResBlockGroup(nn.Module):
    def __init__(self, c, blocks):
        super().__init__()
        self.res_blocks = nn.ModuleList(ResBlock(c) for _ in range(blocks))
        self.time_embedder = TimeEmbedder(4 * c)

    def forward(self, x):
        for block in self.res_blocks:
            x = block(x)
        return x


def depth_to_space(x, factor, c_out):
    ft, fh, fw = factor
    b, _, t, h, w = x.shape
    out = x.reshape(b, c_out, ft, fh, fw, t, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return out.reshape(b, c_out, t * ft, h * fh, w * fw)


class Upsample(nn.Module):
    def __init__(self, c_in):
        super().__init__()
        self.conv = Conv3d(c_in, (c_in // 2) * 8)

    def forward(self, x):
        c = x.shape[1]
        res = depth_to_space(x, (2, 2, 2), c // 8)[:, :, 1:]
        res = torch.cat([res] * 4, dim=1)
        h = depth_to_space(conv3d(self.conv, x), (2, 2, 2), c // 2)[:, :, 1:]
        return h + res


class VideoDecoder(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        lc, bc, g = v["latent_channels"], v["base_channels"], v["blocks_per_group"]
        self.patch = v["patch_size"]
        self.conv_in = Conv3d(lc, bc)
        self.up_blocks_0 = ResBlockGroup(bc, g)
        self.up_blocks_1 = Upsample(bc)
        self.up_blocks_2 = ResBlockGroup(bc // 2, g)
        self.up_blocks_3 = Upsample(bc // 2)
        self.up_blocks_4 = ResBlockGroup(bc // 4, g)
        self.up_blocks_5 = Upsample(bc // 4)
        self.up_blocks_6 = ResBlockGroup(bc // 8, g)
        self.conv_out = Conv3d(bc // 8, 3 * self.patch ** 2)
        self.last_time_embedder = TimeEmbedder(2 * (bc // 8))
        self.last_scale_shift_table = empty(2, bc // 8)
        self.mean_of_means = empty(lc)
        self.std_of_means = empty(lc)

    def forward(self, latent):
        """(1, C, F', H', W') -> pixels (1, 3, 8(F'-1)+1, 32H', 32W') in [-1, 1]."""
        x = latent * self.std_of_means.float()[None, :, None, None, None] \
            + self.mean_of_means.float()[None, :, None, None, None]
        x = conv3d(self.conv_in, x)
        for name in ("up_blocks_0", "up_blocks_1", "up_blocks_2", "up_blocks_3",
                     "up_blocks_4", "up_blocks_5", "up_blocks_6"):
            x = getattr(self, name)(x)
        t = self.last_scale_shift_table.float()
        x = silu(pixel_norm(x) * (t[1] + 1)[None, :, None, None, None]
                 + t[0][None, :, None, None, None])
        x = conv3d(self.conv_out, x)
        b, cp, f, h, w = x.shape
        p = self.patch
        x = x.reshape(b, cp // (p * p), p, p, f, h, w).permute(0, 1, 4, 5, 3, 6, 2)
        return x.reshape(b, cp // (p * p), f, h * p, w * p)


def decode_frames(decoder: VideoDecoder, latent, tile: int, overlap: int) -> np.ndarray:
    """latent (1, C, F', H', W') -> frames (F, H, W, 3) in [0, 1], float32 on
    the host, the decode tiled in time as configured."""
    f = latent.shape[2]
    if tile <= 0 or f <= tile:
        px = decoder(latent)
        return torch.clamp((px + 1.0) / 2.0, 0.0, 1.0)[0].permute(1, 2, 3, 0).cpu().numpy()
    overlap = max(overlap, 1)
    stride = tile - overlap
    starts, s = [], 0
    while s < f:
        starts.append(s)
        if s + tile >= f:
            break
        s += stride
    blend = 8 * (overlap - 1)
    out, filled = None, 0
    for i, s in enumerate(starts):
        px = torch.clamp((decoder(latent[:, :, s:s + tile]) + 1.0) / 2.0, 0.0, 1.0)
        chunk = px.cpu().numpy()
        if i == 0:
            out = np.empty(chunk.shape[:2] + (8 * (f - 1) + 1,) + chunk.shape[3:], np.float32)
            out[:, :, :chunk.shape[2]] = chunk
            filled = chunk.shape[2]
            continue
        nxt = chunk[:, :, 1:]
        if 0 < blend < filled and blend < nxt.shape[2]:
            wts = (np.arange(1, blend + 1, dtype=np.float32) / (blend + 1)).reshape(
                1, 1, -1, 1, 1)
            out[:, :, filled - blend:filled] = (out[:, :, filled - blend:filled] * (1 - wts)
                                                + nxt[:, :, :blend] * wts)
            nxt = nxt[:, :, blend:]
        out[:, :, filled:filled + nxt.shape[2]] = nxt
        filled += nxt.shape[2]
    if filled != out.shape[2]:
        raise AssertionError(f"tiled decode filled {filled} of {out.shape[2]} frames")
    return out[0].transpose(1, 2, 3, 0)


# ---------------------------------------------------------------------------
# Audio: the VAE decoder (height-causal 2D convs) and the vocoder
# ---------------------------------------------------------------------------

class Conv2d(ConvWeights):
    def __init__(self, c_in, c_out, k):
        super().__init__(c_out, c_in, k, k)


def causal_conv2d(conv: Conv2d, x):
    kh, kw = conv.weight.shape[2:]
    x = F.pad(x, ((kw - 1) // 2, kw - 1 - (kw - 1) // 2, kh - 1, 0))
    out = F.conv2d(conv.input_for(x, per_row=False), conv.weight_for(x))
    return out + conv.bias.to(x.dtype)[:, None, None]


def audio_norm(x, eps: float = 1e-6):
    return x / torch.sqrt(torch.mean(x * x, dim=1, keepdim=True) + eps)


class AudioResBlock(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.conv1, self.conv2 = Conv2d(c_in, c_out, 3), Conv2d(c_out, c_out, 3)
        self.nin_shortcut = Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x):
        h = causal_conv2d(self.conv1, silu(audio_norm(x)))
        h = causal_conv2d(self.conv2, silu(audio_norm(h)))
        return h + (x if self.nin_shortcut is None else causal_conv2d(self.nin_shortcut, x))


class AudioUpsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv2d(c, c, 3)

    def forward(self, x):
        up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return causal_conv2d(self.conv, up)[:, :, 1:]


class AudioDecoder(nn.Module):
    def __init__(self, a: dict):
        super().__init__()
        base, mult = a["base_channels"], a["ch_mult"]
        top = base * mult[-1]
        self.conv_in = Conv2d(a["latent_channels"], top, 3)
        self.mid = nn.Module()
        self.mid.block_1, self.mid.block_2 = AudioResBlock(top, top), AudioResBlock(top, top)
        specs, c_in = [], top
        for i in reversed(range(len(mult))):
            specs.append((c_in, base * mult[i], i != 0))
            c_in = base * mult[i]
        self.up = nn.ModuleList()
        for ci, co, has_up in reversed(specs):
            level = nn.Module()
            level.block = nn.ModuleList([AudioResBlock(ci, co)] + [
                AudioResBlock(co, co) for _ in range(a["num_res_blocks"])])
            level.upsample = AudioUpsample(co) if has_up else None
            self.up.append(level)
        self.conv_out = Conv2d(base, a["output_channels"], 3)

    def forward(self, x):
        x = causal_conv2d(self.conv_in, x)
        x = self.mid.block_2(self.mid.block_1(x))
        for level in reversed(self.up):
            for blk in level.block:
                x = blk(x)
            if level.upsample is not None:
                x = level.upsample(x)
        return causal_conv2d(self.conv_out, silu(audio_norm(x)))


class AudioVAE(nn.Module):
    def __init__(self, a: dict):
        super().__init__()
        self.a = a
        self.decoder = AudioDecoder(a)
        pack = a["latent_channels"] * a["mel_latent_bins"]
        self.latents_mean, self.latents_std = empty(pack), empty(pack)

    def forward(self, packed):
        """Packed latent (1, T, 128) -> stereo mel (1, 2, 4T - 3, mel bins)."""
        a = self.a
        b, t, _ = packed.shape
        x = packed * self.latents_std.float()[None, None] + self.latents_mean.float()[None, None]
        x = x.reshape(b, t, a["latent_channels"], a["mel_latent_bins"]).transpose(1, 2)
        out = self.decoder(x)
        down = a["latent_downsample"]
        return out[:, :, :max(t * down - (down - 1), 1), :a["mel_bins"]]


class Conv1d(ConvWeights):
    def __init__(self, c_in, c_out, k):
        super().__init__(c_out, c_in, k)

    def forward(self, x, dilation: int = 1):
        pad = dilation * (self.weight.shape[2] - 1) // 2
        out = F.conv1d(self.input_for(x, per_row=False), self.weight_for(x), padding=pad,
                       dilation=dilation)
        return out + self.bias.to(x.dtype)[:, None]


class ConvTranspose1d(ConvTransposeWeights):
    def __init__(self, c_in, c_out, k):
        super().__init__(c_in, c_out, k, bias_dim=1)

    def forward(self, x, stride: int, padding: int):
        out = F.conv_transpose1d(self.input_for(x, per_row=False), self.weight_for(x),
                                 stride=stride, padding=padding)
        return out + self.bias.to(x.dtype)[:, None]


def leaky(x, slope):
    return torch.where(x >= 0, x, slope * x)


class VocoderResBlock(nn.Module):
    def __init__(self, c, kernel, dilations):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(Conv1d(c, c, kernel) for _ in dilations)
        self.convs2 = nn.ModuleList(Conv1d(c, c, kernel) for _ in dilations)

    def forward(self, x, slope):
        for c1, c2, dil in zip(self.convs1, self.convs2, self.dilations):
            x = x + c2(leaky(c1(leaky(x, slope), dil), slope))
        return x


class Vocoder(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        self.v = v
        self.conv_in = Conv1d(v["in_channels"], v["hidden_channels"], 7)
        ups, resnets, ch = [], [], v["hidden_channels"]
        for k in v["upsample_kernels"]:
            ups.append(ConvTranspose1d(ch, ch // 2, k))
            ch //= 2
            resnets += [VocoderResBlock(ch, rk, dils)
                        for rk, dils in zip(v["resnet_kernels"], v["resnet_dilations"])]
        self.upsamplers, self.resnets = nn.ModuleList(ups), nn.ModuleList(resnets)
        self.conv_out = Conv1d(ch, v["out_channels"], 7)

    def forward(self, mel):
        """(1, 2, T_mel, bins) -> (1, 2, samples) in (-1, 1)."""
        v = self.v
        b, t = mel.shape[0], mel.shape[2]
        x = self.conv_in(mel.transpose(2, 3).reshape(b, -1, t))
        n = len(v["resnet_kernels"])
        for i, (factor, k) in enumerate(zip(v["upsample_factors"], v["upsample_kernels"])):
            x = self.upsamplers[i](leaky(x, v["leaky_slope"]), factor, (k - factor) // 2)
            x = torch.stack([self.resnets[i * n + j](x, v["leaky_slope"])
                             for j in range(n)]).mean(dim=0)
        return torch.tanh(self.conv_out(leaky(x, 0.01)))
