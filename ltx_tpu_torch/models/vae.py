"""Video VAE: causal-3D-conv decoder to pixels, and the encoder for image
and video conditioning.

Port of ltx_tpu/models/vae.py, with the tiled decode's uint8 and yuv420
transfers and the decode sharded over a mesh axis (`decode_video_sharded`). The reference runs
channels-last (NDHWC, DHWIO weights); this port runs torch's NCDHW with
(O, I, D, H, W) weights, converted once in convert.py. The public layout is
the same in both: latents (B, C, F, H, W) in, pixels (B, 3, T, H, W) out.
Convolutions are cuDNN's (the reference's were XLA convolutions, not Pallas).

Decoder: conv_in 128 -> 1024, then [5 res blocks, depth-to-space x2
upsample] x3 (1024 -> 512 -> 256 -> 128), PixelNorm + AdaLN out, conv_out
128 -> 48, spatial unpatchify 4x4. Output frames = 8 * (latent_frames - 1) + 1.
Padding: time replicates (causally or symmetrically), space reflects.
`decode_video` tiles long clips in time, frame-aligned, as the reference.

Encoder: spatial patchify 4x4 (3 -> 48), conv_in 48 -> 128, then per stage
[res blocks, space-to-depth downsample] over 128 -> 256 -> 512 -> 1024 ->
2048, a 2-block mid stage, PixelNorm + SiLU, conv_out to 128 + 1 channels of
which the 128 means are kept. Causal in time, zero padding in space.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ltx_tpu_torch.models.common import Conv3d, Linear, param, silu
from ltx_tpu_torch.ops.embeddings import get_timestep_embedding
from ltx_tpu_torch.utils.diagnostics import span


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """The same fields as the reference's VAEConfig."""

    latent_channels: int = 128
    base_channels: int = 1024  # decoder conv_in output
    patch_size: int = 4
    blocks_per_group: int = 5
    causal: bool = False  # the pipeline builds the decoder non-causal
    timestep_conditioning: bool = False
    decode_noise_scale: float = 0.025
    timestep_scale_multiplier: float = 1000.0
    # encoder
    encoder_causal: bool = True
    encoder_channels: Tuple[int, ...] = (128, 256, 512, 1024, 2048)
    encoder_resnets: Tuple[int, ...] = (4, 6, 6, 2)
    encoder_factors: Tuple[Tuple[int, int, int], ...] = (
        (1, 2, 2), (2, 1, 1), (2, 2, 2), (2, 2, 2))

    def tiny(self) -> "VAEConfig":
        return dataclasses.replace(
            self, latent_channels=8, base_channels=64, blocks_per_group=1,
            encoder_channels=(8, 16, 32, 64, 128), encoder_resnets=(1, 1, 1, 1))


_PAD_MODES = {"reflect": "reflect", "zeros": "constant", "replicate": "replicate"}


def causal_conv3d(conv: Conv3d, x, causal: bool, spatial_mode: str = "reflect"):
    """3D conv on NCDHW input. Time replicates the edge frames ((kt - 1)
    at the front when causal, else split front/back); space pads
    symmetrically in `spatial_mode`. The conv rounds once to x's dtype and
    the bias adds after, in x's dtype, as in the reference."""
    w = conv.weight
    kt, kh, kw = w.shape[2], w.shape[3], w.shape[4]
    if kt > 1:
        front = kt - 1 if causal else (kt - 1) // 2
        x = F.pad(x, (0, 0, 0, 0, front, kt - 1 - front), mode="replicate")
    if kh > 1 or kw > 1:
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, 0, 0),
                  mode=_PAD_MODES[spatial_mode])
    out = F.conv3d(x, w.to(x.dtype))
    return out + conv.bias.to(x.dtype)[None, :, None, None, None]


def vae_pixel_norm(x, eps: float = 1e-8):
    """Channel RMS norm over dim 1, f32 statistics."""
    dtype = x.dtype
    xf = x.float()
    ms = torch.mean(xf * xf, dim=1, keepdim=True)
    return (xf / torch.sqrt(ms + eps)).to(dtype)


def _bcast(v):
    """(B, C) -> (B, C, 1, 1, 1)."""
    return v[:, :, None, None, None]


class TimestepEmbedder(nn.Module):
    """256 -> 256 -> out MLP with SiLU, f32 (`timestep_embedder`)."""

    def __init__(self, d_out: int, device):
        super().__init__()
        self.linear_1 = Linear(256, 256, device=device, dtype=torch.float32)
        self.linear_2 = Linear(256, d_out, device=device, dtype=torch.float32)

    def forward(self, t_emb):
        return self.linear_2(silu(self.linear_1(t_emb)))


class TimeEmbedder(nn.Module):
    """Wrapper whose only child matches the tree key `timestep_embedder`."""

    def __init__(self, d_out: int, device):
        super().__init__()
        self.timestep_embedder = TimestepEmbedder(d_out, device)

    def forward(self, scaled_timestep):
        t_emb = get_timestep_embedding(scaled_timestep, 256)
        return self.timestep_embedder(t_emb.float())


class ResBlock(nn.Module):
    def __init__(self, c: int, device, dtype):
        super().__init__()
        self.conv1 = Conv3d(c, c, device=device, dtype=dtype)
        self.conv2 = Conv3d(c, c, device=device, dtype=dtype)
        self.scale_shift_table = param(4, c, device=device)

    def reset_parameters(self, gen):
        self.scale_shift_table.zero_()

    def forward(self, x, causal: bool, spatial_mode: str, time_emb=None):
        """PixelNorm -> scale/shift -> SiLU -> conv, twice, plus the residual.
        Table rows: shift1, scale1, shift2, scale2; time_emb (B, 4C) adds."""
        table = self.scale_shift_table.float()
        c = table.shape[1]
        ss = table[None]
        if time_emb is not None:
            ss = ss + time_emb.reshape(time_emb.shape[0], 4, c).float()
        dt = x.dtype
        shift1, scale1 = _bcast(ss[:, 0]).to(dt), _bcast(ss[:, 1] + 1).to(dt)
        shift2, scale2 = _bcast(ss[:, 2]).to(dt), _bcast(ss[:, 3] + 1).to(dt)
        h = vae_pixel_norm(x) * scale1 + shift1
        h = causal_conv3d(self.conv1, silu(h), causal, spatial_mode)
        h = vae_pixel_norm(h) * scale2 + shift2
        h = causal_conv3d(self.conv2, silu(h), causal, spatial_mode)
        return h + x


class ResBlockGroup(nn.Module):
    """Res blocks sharing one timestep embedding."""

    def __init__(self, c: int, blocks: int, device, dtype):
        super().__init__()
        self.res_blocks = nn.ModuleList(ResBlock(c, device, dtype) for _ in range(blocks))
        self.time_embedder = TimeEmbedder(4 * c, device)

    def forward(self, x, causal: bool, spatial_mode: str, scaled_timestep=None):
        time_emb = None
        if scaled_timestep is not None:
            time_emb = self.time_embedder(scaled_timestep)
        for block in self.res_blocks:
            x = block(x, causal, spatial_mode, time_emb)
        return x


def depth_to_space(x, factor, c_out: int):
    """NCDHW depth-to-space with channel order (c_out, ft, fh, fw)."""
    ft, fh, fw = factor
    b, _, t, h, w = x.shape
    out = x.reshape(b, c_out, ft, fh, fw, t, h, w)
    out = out.permute(0, 1, 5, 2, 6, 3, 7, 4)  # (b, c, t, ft, h, fh, w, fw)
    return out.reshape(b, c_out, t * ft, h * fh, w * fw)


class D2SUpsample(nn.Module):
    """Conv -> depth-to-space plus a channel-tiled depth-to-space residual;
    the first output frame is trimmed when the temporal factor is > 1."""

    def __init__(self, c_in: int, device, dtype, factor=(2, 2, 2)):
        super().__init__()
        self.factor = factor
        prod = factor[0] * factor[1] * factor[2]
        self.conv = Conv3d(c_in, (c_in // 2) * prod, device=device, dtype=dtype)

    def forward(self, x, causal: bool, spatial_mode: str):
        ft, fh, fw = self.factor
        prod = ft * fh * fw
        c_in = x.shape[1]
        res = depth_to_space(x, self.factor, c_in // prod)
        if ft > 1:
            res = res[:, :, 1:]
        res = torch.cat([res] * (prod // 2), dim=1)
        h = causal_conv3d(self.conv, x, causal, spatial_mode)
        h = depth_to_space(h, self.factor, c_in // 2)
        if ft > 1:
            h = h[:, :, 1:]
        return h + res


def decoder_unpatchify(x, p: int = 4):
    """(B, 48, T, H, W) -> (B, 3, T, 4H, 4W); channel order (c, i1, i2),
    i1 the width offset and i2 the height offset."""
    b, cp, t, h, w = x.shape
    c = cp // (p * p)
    out = x.reshape(b, c, p, p, t, h, w)       # (b, c, i1, i2, t, h, w)
    out = out.permute(0, 1, 4, 5, 3, 6, 2)     # (b, c, t, h, i2, w, i1)
    return out.reshape(b, c, t, h * p, w * p)


class VideoDecoder(nn.Module):
    """Parameter names follow ltx_tpu.models.vae.init_decoder_params. Conv
    weights take `dtype`; tables, time embedders and latent stats are f32."""

    def __init__(self, cfg: VAEConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        lc, bc, g = cfg.latent_channels, cfg.base_channels, cfg.blocks_per_group
        self.conv_in = Conv3d(lc, bc, device=device, dtype=dtype)
        self.up_blocks_0 = ResBlockGroup(bc, g, device, dtype)
        self.up_blocks_1 = D2SUpsample(bc, device, dtype)
        self.up_blocks_2 = ResBlockGroup(bc // 2, g, device, dtype)
        self.up_blocks_3 = D2SUpsample(bc // 2, device, dtype)
        self.up_blocks_4 = ResBlockGroup(bc // 4, g, device, dtype)
        self.up_blocks_5 = D2SUpsample(bc // 4, device, dtype)
        self.up_blocks_6 = ResBlockGroup(bc // 8, g, device, dtype)
        self.conv_out = Conv3d(bc // 8, 3 * cfg.patch_size**2, device=device, dtype=dtype)
        self.last_time_embedder = TimeEmbedder(2 * (bc // 8), device)
        self.last_scale_shift_table = param(2, bc // 8, device=device)
        self.mean_of_means = param(lc, device=device)
        self.std_of_means = param(lc, device=device)

    @property
    def dtype(self):
        return self.conv_in.weight.dtype

    def reset_parameters(self, gen):
        self.last_scale_shift_table.zero_()
        self.mean_of_means.zero_()
        self.std_of_means.fill_(1.0)

    def forward(self, sample, timestep: Optional[float] = None, noise=None):
        """Latent (B, C, F', H', W') -> pixels (B, 3, 8(F'-1)+1, 32H', 32W')
        in [-1, 1] (decoder_forward). With a timestep (configs with timestep
        conditioning), `noise` (the latent's shape) is mixed in at
        decode_noise_scale in normalized latent space, before the per-channel
        denormalisation."""
        cfg = self.cfg
        causal, mode = cfg.causal, "reflect"
        x = sample
        b = x.shape[0]

        scaled_ts = None
        if timestep is not None:
            if noise is not None:
                x = noise * cfg.decode_noise_scale + (1.0 - cfg.decode_noise_scale) * x
            scaled_ts = torch.full((b,), timestep, dtype=torch.float32,
                                   device=x.device) * cfg.timestep_scale_multiplier

        std = self.std_of_means.float()[None, :, None, None, None]
        mean = self.mean_of_means.float()[None, :, None, None, None]
        x = (x.float() * std + mean).to(x.dtype)

        x = causal_conv3d(self.conv_in, x, causal, mode)
        x = self.up_blocks_0(x, causal, mode, scaled_ts)
        x = self.up_blocks_1(x, causal, mode)
        x = self.up_blocks_2(x, causal, mode, scaled_ts)
        x = self.up_blocks_3(x, causal, mode)
        x = self.up_blocks_4(x, causal, mode, scaled_ts)
        x = self.up_blocks_5(x, causal, mode)
        x = self.up_blocks_6(x, causal, mode, scaled_ts)

        x = vae_pixel_norm(x)
        table = self.last_scale_shift_table.float()
        if scaled_ts is not None:
            te = self.last_time_embedder(scaled_ts)
            ss = table[None] + te.reshape(b, 2, -1)
            shift, scale = _bcast(ss[:, 0]), _bcast(ss[:, 1] + 1)
        else:
            shift, scale = _bcast(table[None, 0]), _bcast(table[None, 1] + 1)
        x = x * scale.to(x.dtype) + shift.to(x.dtype)
        x = silu(x)
        x = causal_conv3d(self.conv_out, x, causal, mode)
        return decoder_unpatchify(x, cfg.patch_size)


def without_time_embedders(decoder: "VideoDecoder", present) -> "VideoDecoder":
    """Remove each time embedder of `decoder` (the four groups' and the
    last one) whose module name `present(name)` denies: a checkpoint in the
    diffusers layout carries none for the groups. A decoder without them
    cannot decode with timestep conditioning. Returns `decoder`."""
    for name in ("up_blocks_0", "up_blocks_2", "up_blocks_4", "up_blocks_6"):
        if not present(f"{name}.time_embedder"):
            getattr(decoder, name).time_embedder = None
    if not present("last_time_embedder"):
        decoder.last_time_embedder = None
    return decoder


def rgb_to_yuv420_u8(px):
    """(B, 3, F, H, W) pixels in [-1, 1] -> one packed uint8 (B, F, 3H/2, W)
    on their device: the planar I420 frame, BT.601 Y at full resolution on
    top, then the 2x2-averaged U and V planes each reshaped to (H/4, W)
    rows, all in f32 and rounded half to even once. 1.5 bytes a pixel
    instead of uint8 RGB's 3 for the copy to the host, in one contiguous
    tensor (the reference's `_rgb_to_yuv420_u8`)."""
    rgb = torch.clamp((px.float() + 1.0) / 2.0, 0.0, 1.0)
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 0.5
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 0.5
    bb, ff, hh, ww = u.shape
    u = u.reshape(bb, ff, hh // 2, 2, ww // 2, 2).mean(dim=(3, 5))
    v = v.reshape(bb, ff, hh // 2, 2, ww // 2, 2).mean(dim=(3, 5))

    def q(x):
        return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)

    return torch.cat([q(y), q(u).reshape(bb, ff, hh // 4, ww),
                      q(v).reshape(bb, ff, hh // 4, ww)], dim=2)


def yuv420_to_rgb_np(packed: np.ndarray) -> np.ndarray:
    """The host inverse of `rgb_to_yuv420_u8`: packed (B, F, 3H/2, W) uint8
    -> (B, 3, F, H, W) float32 in [0, 1], chroma upsampled by repetition
    (the reference's `_yuv420_to_rgb_np`)."""
    bb, ff, rows, ww = packed.shape
    hh = rows * 2 // 3
    y = packed[:, :, :hh].astype(np.float32) / 255.0
    u = packed[:, :, hh: hh + hh // 4].reshape(bb, ff, hh // 2, ww // 2)
    v = packed[:, :, hh + hh // 4:].reshape(bb, ff, hh // 2, ww // 2)
    u = u.astype(np.float32) / 255.0 - 0.5
    v = v.astype(np.float32) / 255.0 - 0.5
    u = u.repeat(2, axis=-2).repeat(2, axis=-1)
    v = v.repeat(2, axis=-2).repeat(2, axis=-1)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return np.clip(np.stack([r, g, b], axis=1), 0.0, 1.0)


def _stitch_tiled_yuv(launch, starts, f: int, pixel_blend: int) -> np.ndarray:
    """The tiled decode's host stitch for the yuv420 transfer: the uint8
    path's frame-aligned loop on the packed I420 frames (B, F_tile, 3H/2,
    W), one copy a tile. Seam blending weighs every packed row of a frame
    alike, which blends each plane: blending commutes with the packing.
    Returns frames (F, H, W, 3) float32 in [0, 1]. Spans as
    `decode_video`'s; `decode.widen` is the conversion to RGB."""
    total = 8 * (f - 1) + 1
    out = None
    filled = 0
    pending = launch(0)
    for idx in range(len(starts)):
        wait = pending
        if idx + 1 < len(starts):
            pending = launch(idx + 1)
        chunk = wait()  # (B, F_tile, 3H/2, W) uint8
        with span("decode.stitch"):
            if idx == 0:
                b, _, rows, ww = chunk.shape
                out = np.empty((b, total, rows, ww), np.uint8)
                out[:, :chunk.shape[1]] = chunk
                filled = chunk.shape[1]
                continue
            nxt = chunk[:, 1:]  # drop the re-anchored first pixel frame
            n_new = nxt.shape[1]
            blend = pixel_blend if 0 < pixel_blend < filled and pixel_blend < n_new else 0
            if blend:
                wts = (np.arange(1, blend + 1, dtype=np.float32)
                       / (blend + 1)).reshape(1, -1, 1, 1)
                out[:, filled - blend:filled] = np.round(
                    out[:, filled - blend:filled] * (1 - wts) + nxt[:, :blend] * wts)
            out[:, filled:filled + n_new - blend] = nxt[:, blend:]
            filled += n_new - blend
    if filled != total:
        raise AssertionError(f"tiled decode filled {filled} of {total} frames")
    with span("decode.widen"):
        return yuv420_to_rgb_np(out)[0].transpose(1, 2, 3, 0)


def _tile_starts(frames: int, tile_size: int, stride: int):
    starts, s = [], 0
    while s < frames:
        starts.append(s)
        if s + tile_size >= frames:
            break
        s += stride
    return starts


def _pull(t):
    """Start the device -> host copy of `t`; returns wait() -> numpy array
    (bf16 widened to f32 on the host, a `decode.widen` span). On CUDA the
    copy is asynchronous into pinned memory, so what is launched after it
    overlaps the host's work; wait() blocks on it in a `decode.wait` span."""
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
    else:
        host, done = t, None

    def wait():
        if done is not None:
            with span("decode.wait"):
                done.synchronize()
        if host.dtype == torch.uint8:
            return host.numpy()
        with span("decode.widen"):
            return host.float().numpy()

    return wait


def decode_video(decoder: VideoDecoder, latent, timestep: Optional[float] = None,
                 noise=None, tile_size: int = 0, tile_overlap: int = 1,
                 transfer_uint8=False):
    """Decode with optional temporal tiling -> frames (F, H, W, 3) in [0, 1].

    Untiled (tile_size <= 0 or no more latent frames than one tile): one
    decoder call; `noise` is a tensor of the latent's shape (or None); the
    frames are a tensor on the latent's device, in the decoder's dtype.

    Tiled: tiles of `tile_size` latent frames overlapping by `tile_overlap`,
    stitched frame-aligned on the host (pixel p >= 1 of a tile starting at
    latent s is global pixel 8s + p): each later tile drops its re-anchored
    first pixel frame, 8 * (tile_overlap - 1) coincident frames blend
    linearly, and exactly 8 * (F - 1) + 1 frames come out, as a float32
    numpy array on the host. The next tile is launched before the current
    one is waited for, so at most two decoded tiles are on the device.
    `noise` is a sequence with one tensor per tile, each of its tile's
    latent shape (the reference folds the tile index into its key).
    transfer_uint8=True rounds each tile to uint8 on the device before the
    copy (a quarter of f32's bytes) and blends in uint8 with f32 weights,
    rounded: at most 1/255 off. transfer_uint8="yuv420" packs each tile as
    I420 on the device (`rgb_to_yuv420_u8`, an eighth of f32's bytes),
    blends the packed frames as the uint8 path does and converts to RGB on
    the host (`yuv420_to_rgb_np`). Untiled, every mode decodes to the exact
    frames, as the reference's.

    Spans of a tiled decode (utils.diagnostics.span): `decode.wait` where
    the host blocks on a tile's copy (CUDA only), one `decode.stitch` a
    tile (its blend and copy into the clip), and `decode.widen` (the
    clip's conversion to f32)."""
    if latent.ndim == 4:
        latent = latent[None]
    f = latent.shape[2]
    if tile_size <= 0 or f <= tile_size:
        if isinstance(noise, (list, tuple)):
            (noise,) = noise
        x = decoder(latent, timestep, noise)
        frames = torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
        return frames[0].permute(1, 2, 3, 0)

    tile_overlap = max(tile_overlap, 1)
    if tile_overlap >= tile_size:
        raise ValueError(f"vae_tile_overlap ({tile_overlap}) must be < vae_tile_size "
                         f"({tile_size}); stride would be <= 0")
    starts = _tile_starts(f, tile_size, tile_size - tile_overlap)
    pixel_blend = 8 * (tile_overlap - 1)
    if noise is not None and (not isinstance(noise, (list, tuple))
                              or len(noise) != len(starts)):
        raise ValueError(f"a tiled decode takes one noise tensor per tile: "
                         f"{len(starts)} tiles")

    def launch(i):
        tile = latent[:, :, starts[i]:starts[i] + tile_size]
        px = decoder(tile, timestep, None if noise is None else noise[i])
        if transfer_uint8 == "yuv420":
            px = rgb_to_yuv420_u8(px)
        elif transfer_uint8:
            px = torch.round(torch.clamp((px.float() + 1.0) / 2.0, 0.0, 1.0)
                             * 255.0).to(torch.uint8)
        return _pull(px)

    if transfer_uint8 == "yuv420":
        return _stitch_tiled_yuv(launch, starts, f, pixel_blend)

    out = None  # host (B, 3, 8(f-1)+1, H, W), allocated on the first tile
    filled = 0
    pending = launch(0)
    for idx in range(len(starts)):
        wait = pending
        if idx + 1 < len(starts):
            pending = launch(idx + 1)
        chunk = wait()
        with span("decode.stitch"):
            if idx == 0:
                b, _, _, hh, ww = chunk.shape
                out = np.empty((b, 3, 8 * (f - 1) + 1, hh, ww), chunk.dtype)
                out[:, :, :chunk.shape[2]] = chunk
                filled = chunk.shape[2]
                continue
            nxt = chunk[:, :, 1:]  # drop the re-anchored first pixel frame
            if 0 < pixel_blend < filled and pixel_blend < nxt.shape[2]:
                wts = (np.arange(1, pixel_blend + 1, dtype=np.float32)
                       / (pixel_blend + 1)).reshape(1, 1, -1, 1, 1)
                blended = (out[:, :, filled - pixel_blend:filled] * (1 - wts)
                           + nxt[:, :, :pixel_blend] * wts)
                if transfer_uint8:
                    blended = np.round(blended)
                out[:, :, filled - pixel_blend:filled] = blended
                rest = nxt[:, :, pixel_blend:]
            else:
                rest = nxt
            out[:, :, filled:filled + rest.shape[2]] = rest
            filled += rest.shape[2]
    if filled != out.shape[2]:
        raise AssertionError(f"tiled decode filled {filled} of {out.shape[2]} frames")
    with span("decode.widen"):
        if transfer_uint8:
            frames = out.astype(np.float32) / 255.0
        else:
            frames = np.clip((out + 1.0) / 2.0, 0.0, 1.0)
    return frames[0].transpose(1, 2, 3, 0)


def sharded_tiles(latent_frames: int, ranks: int, tile_overlap: int = 1):
    """(stride, overlap) of `decode_video_sharded` over `ranks`: each rank
    owns stride = ceil(F / ranks) latent frames and decodes stride + overlap
    of them (its own and a right halo)."""
    return -(-latent_frames // ranks), max(tile_overlap, 1)


def decode_video_sharded(decoder: VideoDecoder, latent, mesh, timestep: Optional[float] = None,
                         noise=None, tile_overlap: int = 1, axis: str = "model",
                         transfer_uint8=False) -> np.ndarray:
    """The temporal tiled decode with its tiles spread over a mesh axis, all
    decoding at once (the reference's `decode_video_sharded`) -> frames
    (F, H, W, 3) in [0, 1], a float32 numpy array, the same on every rank.

    Rank i of the n ranks along `axis` decodes latent frames
    [i * stride, i * stride + stride + overlap) of the latent edge-padded
    (last frame repeated) to n * stride + overlap frames: its own stride
    frames and a right halo of `overlap` frames, its right neighbour's
    first ones. The latent is whole on every rank (the denoise replicates
    it), so the halo is read from it and no bytes move for it. Rank i then
    sends the 8 * (overlap - 1) seam pixel frames its right neighbour
    blends to that neighbour (one ring hop) and blends the ones it receives
    from its left with its own, linearly, as the host loop does; rank 0
    keeps its own. Each rank's 8 * stride + 1 pixel frames are gathered on
    every rank and stitched (every rank after the first drops its
    re-anchored first frame), cut to 8 * (F - 1) + 1 frames.

    Equal to `decode_video(tile_size=stride + overlap, tile_overlap=overlap)`
    of the edge-padded latent cut to the true frame count, bit for bit with
    timestep None. `noise`: with a timestep, one tensor per rank of its
    tile's latent shape (the reference folds the rank into its key).
    transfer_uint8: True rounds each rank's blended pixels to uint8 before
    the gather, "yuv420" packs them as I420 (`rgb_to_yuv420_u8`) and the
    host converts after the stitch."""
    from ltx_tpu_torch.parallel import collectives as col

    if latent.ndim == 4:
        latent = latent[None]
    f = latent.shape[2]
    n = mesh.shape[axis]
    stride, ov = sharded_tiles(f, n, tile_overlap)
    ext = torch.cat([latent, latent[:, :, -1:].expand(-1, -1, n * stride + ov - f, -1, -1)],
                    dim=2)
    i = mesh.index(axis)
    if noise is not None and (not isinstance(noise, (list, tuple)) or len(noise) != n):
        raise ValueError(f"a sharded decode takes one noise tensor per rank: {n} ranks")
    pixels = decoder(ext[:, :, i * stride:i * stride + stride + ov], timestep,
                     None if noise is None else noise[i])
    own = 8 * stride + 1
    pb = 8 * (ov - 1)
    out = pixels[:, :, :own]
    if pb > 0:
        seam = pixels[:, :, own:own + pb]  # what the right neighbour blends
        (prev_tail,) = col.ring_shift([seam], mesh, axis)
        w = (torch.arange(1, pb + 1, dtype=torch.float32, device=out.device)
             / (pb + 1)).reshape(1, 1, -1, 1, 1)
        mine = out[:, :, 1:1 + pb].float()
        blended = mine if i == 0 else prev_tail.float() * (1 - w) + mine * w
        out = torch.cat([out[:, :, :1].float(), blended, out[:, :, 1 + pb:].float()], dim=2)
    if transfer_uint8 == "yuv420":
        out = rgb_to_yuv420_u8(out)  # (B, F, 3H/2, W)
    elif transfer_uint8:
        out = torch.round(torch.clamp((out.float() + 1.0) / 2.0, 0.0, 1.0)
                          * 255.0).to(torch.uint8)
    chunks = col.all_gather(out[None].contiguous(), mesh, axis, dim=0)
    chunks = chunks.numpy(force=True) if chunks.dtype == torch.uint8 \
        else chunks.float().numpy(force=True)
    total = 8 * (f - 1) + 1
    frame_axis = 1 if transfer_uint8 == "yuv420" else 2
    parts = [chunks[0]] + [np.take(chunks[r], np.arange(1, chunks.shape[frame_axis + 1]),
                                   axis=frame_axis) for r in range(1, n)]
    full = np.take(np.concatenate(parts, axis=frame_axis), np.arange(total), axis=frame_axis)
    if transfer_uint8 == "yuv420":
        return yuv420_to_rgb_np(full)[0].transpose(1, 2, 3, 0)
    if transfer_uint8:
        frames = full.astype(np.float32) / 255.0
    else:
        frames = np.clip((full + 1.0) / 2.0, 0.0, 1.0)
    return frames[0].transpose(1, 2, 3, 0)


def tile_latent_frames(latent_frames: int, tile_size: int, tile_overlap: int = 1):
    """The latent frame count of each tile decode_video cuts `latent_frames`
    into, in order (one entry when it does not tile): one decode-noise
    tensor is needed per tile."""
    if tile_size <= 0 or latent_frames <= tile_size:
        return [latent_frames]
    tile_overlap = max(tile_overlap, 1)
    return [min(tile_size, latent_frames - s)
            for s in _tile_starts(latent_frames, tile_size, tile_size - tile_overlap)]


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encoder_patchify(x, p: int = 4):
    """(B, 3, T, H, W) -> (B, 48, T, H/4, W/4); channel order (c, pw, ph)."""
    b, c, t, h, w = x.shape
    out = x.reshape(b, c, t, h // p, p, w // p, p)   # (b, c, t, h', ph, w', pw)
    out = out.permute(0, 1, 6, 4, 2, 3, 5)           # (b, c, pw, ph, t, h', w')
    return out.reshape(b, c * p * p, t, h // p, w // p)


def space_to_depth(x, factor):
    """NCDHW inverse of depth_to_space, channel order (c, ft, fh, fw); the
    front of the time axis is padded with the first frame when the temporal
    factor does not divide it."""
    ft, fh, fw = factor
    if x.shape[2] % ft != 0:
        x = F.pad(x, (0, 0, 0, 0, ft - x.shape[2] % ft, 0), mode="replicate")
    b, c, t, h, w = x.shape
    out = x.reshape(b, c, t // ft, ft, h // fh, fh, w // fw, fw)
    out = out.permute(0, 1, 3, 5, 7, 2, 4, 6)  # (b, c, ft, fh, fw, t', h', w')
    return out.reshape(b, c * ft * fh * fw, t // ft, h // fh, w // fw)


class EncoderResBlock(nn.Module):
    """PixelNorm -> SiLU -> conv, twice, plus the residual; no conditioning."""

    def __init__(self, c: int, device, dtype):
        super().__init__()
        self.conv1 = Conv3d(c, c, device=device, dtype=dtype)
        self.conv2 = Conv3d(c, c, device=device, dtype=dtype)

    def forward(self, x, causal: bool, mode: str):
        h = causal_conv3d(self.conv1, silu(vae_pixel_norm(x)), causal, mode)
        h = causal_conv3d(self.conv2, silu(vae_pixel_norm(h)), causal, mode)
        return h + x


class S2DDownsample(nn.Module):
    """Conv -> space-to-depth, plus a group-averaged space-to-depth
    residual of the input."""

    def __init__(self, c_in: int, c_out: int, factor, device, dtype):
        super().__init__()
        self.factor, self.c_out = tuple(factor), c_out
        prod = factor[0] * factor[1] * factor[2]
        self.conv = Conv3d(c_in, c_out // prod, device=device, dtype=dtype)

    def forward(self, x, causal: bool, mode: str):
        main = space_to_depth(causal_conv3d(self.conv, x, causal, mode), self.factor)
        res = space_to_depth(x, self.factor)
        b, c, t, h, w = res.shape
        res = res.reshape(b, self.c_out, c // self.c_out, t, h, w).mean(dim=2)
        return main + res


class EncoderStage(nn.Module):
    """`resnets`, then (but for the mid stage) `downsamplers`."""

    def __init__(self, c: int, blocks: int, device, dtype, c_out=None, factor=None):
        super().__init__()
        self.resnets = nn.ModuleList(EncoderResBlock(c, device, dtype)
                                     for _ in range(blocks))
        if c_out is not None:
            self.downsamplers = S2DDownsample(c, c_out, factor, device, dtype)

    def forward(self, x, causal: bool, mode: str):
        for block in self.resnets:
            x = block(x, causal, mode)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers(x, causal, mode)
        return x


class VideoEncoder(nn.Module):
    """Parameter names follow ltx_tpu.models.vae.init_encoder_params."""

    def __init__(self, cfg: VAEConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        chans = cfg.encoder_channels
        self.conv_in = Conv3d(3 * cfg.patch_size**2, chans[0], device=device, dtype=dtype)
        self.down_blocks = nn.ModuleList(
            EncoderStage(chans[i], n, device, dtype, chans[i + 1], cfg.encoder_factors[i])
            for i, n in enumerate(cfg.encoder_resnets))
        self.mid_block = EncoderStage(chans[-1], 2, device, dtype)
        self.conv_out = Conv3d(chans[-1], cfg.latent_channels + 1, device=device,
                               dtype=dtype)

    @property
    def dtype(self):
        return self.conv_in.weight.dtype

    def forward(self, pixels):
        """(B, 3, T, H, W) in [-1, 1] -> the latent mean (B, C, T', H/32,
        W/32), T' = (T - 1) / 8 + 1, not yet normalized (encoder_forward)."""
        cfg = self.cfg
        causal, mode = cfg.encoder_causal, "zeros"
        x = encoder_patchify(pixels, cfg.patch_size)
        x = causal_conv3d(self.conv_in, x, causal, mode)
        for stage in self.down_blocks:
            x = stage(x, causal, mode)
        x = self.mid_block(x, causal, mode)
        x = silu(vae_pixel_norm(x))
        x = causal_conv3d(self.conv_out, x, causal, mode)
        return x[:, :cfg.latent_channels]  # the mean; the logvar channel dropped
