"""Timestep sinusoidal embeddings. Port of ltx_tpu/ops/embeddings.py."""

from __future__ import annotations

import numpy as np
import torch


def get_timestep_embedding(timesteps, embedding_dim: int,
                           max_period: float = 10000.0):
    """freq_k = exp(-log(P) * k / half) for k = arange(half) (not linspace);
    output concat(cos, sin) in float32, shape (..., embedding_dim)."""
    half = embedding_dim // 2
    device = timesteps.device
    freq_idx = torch.arange(half, dtype=torch.float32, device=device) / float(np.float32(half))
    neg_log = float(-np.log(max_period).astype(np.float32))
    freqs = torch.exp(neg_log * freq_idx)

    shape = timesteps.shape
    args = timesteps.float().reshape(-1, 1) * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = torch.cat([emb, emb.new_zeros((emb.shape[0], 1))], dim=-1)
    return emb.reshape(*shape, embedding_dim)
