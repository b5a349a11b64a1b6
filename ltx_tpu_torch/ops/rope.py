"""3D fractional-position rotary embeddings.

Port of ltx_tpu/ops/rope.py. The tables' frequency math is float64 (the
reference shows float32 frequency math degrades quality over 48 blocks) and
the tables are float32. `precompute_freqs_cis` computes them in host numpy;
the denoise loops take `kernels.rope.rope_tables`, which builds the same
tables on the card, every loop. Applying them is torch, in float32, cast
back to the input dtype.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def create_position_grid(frames: int, height: int, width: int,
                         temporal_scale: int = 8, spatial_scale: int = 32,
                         fps: float = 24.0, causal_fix: bool = True) -> np.ndarray:
    """Pixel-space middle coordinates per latent token, (3, T) float32.
    Temporal bounds [i*ts, (i+1)*ts] shift by (1 - ts) clamped at 0 and are
    divided by fps; spatial coordinates are patch middles."""
    i = np.arange(frames, dtype=np.float32)
    ts = np.float32(temporal_scale)
    start = i * ts
    end = (i + 1) * ts
    if causal_fix:
        start = np.maximum(start + (1 - ts), 0)
        end = np.maximum(end + (1 - ts), 0)
    t_coords = ((start + end) / 2.0) / np.float32(fps)

    ss = np.float32(spatial_scale)
    h_coords = np.arange(height, dtype=np.float32) * ss + ss / 2
    w_coords = np.arange(width, dtype=np.float32) * ss + ss / 2

    t_grid = np.broadcast_to(t_coords[:, None, None], (frames, height, width))
    h_grid = np.broadcast_to(h_coords[None, :, None], (frames, height, width))
    w_grid = np.broadcast_to(w_coords[None, None, :], (frames, height, width))
    return np.stack(
        [t_grid.reshape(-1), h_grid.reshape(-1), w_grid.reshape(-1)], axis=0
    ).astype(np.float32)


def create_audio_position_grid(audio_frames: int, hop_length: int = 160,
                               sample_rate: int = 16000, temporal_scale: int = 4,
                               causal_offset: int = 1) -> np.ndarray:
    """1D temporal positions of the audio tokens, (1, T) float32: the middle,
    in seconds, of each latent frame's mel span."""
    i = np.arange(audio_frames, dtype=np.float32)
    scale = np.float32(temporal_scale)
    off = np.float32(causal_offset)
    start_mel = np.maximum(i * scale + off - scale, 0)
    end_mel = np.maximum((i + 1) * scale + off - scale, 0)
    mid_s = (start_mel + end_mel) / 2.0 * np.float32(hop_length) / np.float32(sample_rate)
    return mid_s[None, :].astype(np.float32)


def _freq_indices_f64(dim: int, n_pos_dims: int, theta: float) -> np.ndarray:
    """theta^t_k * pi/2 with t_k evenly spaced over [0, 1], float64."""
    num_indices = max(1, dim // (2 * n_pos_dims))
    if num_indices > 1:
        t = np.arange(num_indices, dtype=np.float64) / np.float64(num_indices - 1)
    else:
        t = np.zeros((1,), dtype=np.float64)
    return np.power(np.float64(theta), t) * (np.pi / 2.0)


def precompute_freqs_cis(grid: np.ndarray, dim: int, theta: float = 10000.0,
                         max_pos: Sequence[int] = (20, 2048, 2048),
                         num_heads: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Split-RoPE cos/sin tables (num_heads, T, dim // 2 // num_heads),
    computed in float64 and returned as float32. The front of each table is
    padded with (cos=1, sin=0) up to dim / 2."""
    grid64 = grid.astype(np.float64)
    n_pos_dims, seq_len = grid64.shape
    indices = _freq_indices_f64(dim, n_pos_dims, theta)
    num_indices = indices.shape[0]

    max_pos_arr = np.asarray(max_pos, dtype=np.float64)[:, None]
    scaled = (grid64 / max_pos_arr) * 2.0 - 1.0

    freqs = indices[None, :, None] * scaled.T[:, None, :]
    freq_dim = num_indices * n_pos_dims
    freqs = freqs.reshape(seq_len, freq_dim)
    cos = np.cos(freqs)
    sin = np.sin(freqs)

    pad = max(0, dim // 2 - freq_dim)
    if pad:
        cos = np.concatenate([np.ones((seq_len, pad)), cos], axis=-1)
        sin = np.concatenate([np.zeros((seq_len, pad)), sin], axis=-1)
    per_head = (pad + freq_dim) // num_heads
    cos = cos.reshape(seq_len, num_heads, per_head).transpose(1, 0, 2)
    sin = sin.reshape(seq_len, num_heads, per_head).transpose(1, 0, 2)
    return cos.astype(np.float32), sin.astype(np.float32)


def video_rope(frames: int, height: int, width: int, dim: int, num_heads: int,
               theta: float = 10000.0, max_pos: Sequence[int] = (20, 2048, 2048),
               fps: float = 24.0) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables (H, T, head_dim / 2) for the DiT's 3D split RoPE."""
    grid = create_position_grid(frames, height, width, fps=fps)
    return precompute_freqs_cis(grid, dim, theta=theta, max_pos=max_pos,
                                num_heads=num_heads)


def apply_rope_split(x, cos, sin):
    """Split RoPE in float32: the two contiguous halves of each head rotate
    against each other.

    x: (B, T, H*D) flat (the DiT, before the head split) or (B, H, T, D)
    (the connector, after it). cos/sin: (H, T, D/2).
    """
    dtype = x.dtype
    h, t = cos.shape[0], cos.shape[1]

    flat = x.ndim == 3
    xf = x.float()
    if flat:
        xf = xf.reshape(x.shape[0], t, h, -1).transpose(1, 2)  # (B, H, T, D)

    d = xf.shape[-1]
    first, second = xf[..., : d // 2], xf[..., d // 2:]
    cosf = cos.float()
    sinf = sin.float()
    out = torch.cat(
        [first * cosf - second * sinf, second * cosf + first * sinf], dim=-1)
    if flat:
        out = out.transpose(1, 2).reshape(x.shape)
    return out.to(dtype)
