"""LTX text encoding: Gemma feature extractor and the 1D embeddings connectors.

Port of ltx_tpu/models/text_encoder.py. 49 Gemma states -> masked norm &
concat (f32) -> Linear 188160 -> 3840 (f32) -> a 2-layer 1D transformer with
learnable registers in place of pad tokens -> weightless RMSNorm. The video
connector always; with `include_audio` a second connector of the same shape
gives the audio stream's context from the same features.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ltx_tpu_torch.models.common import Linear, NormWeight, param, uniform_
from ltx_tpu_torch.models.dit import FeedForward
from ltx_tpu_torch.ops.attention import sdpa
from ltx_tpu_torch.ops.normalization import rms_norm
from ltx_tpu_torch.ops.rope import apply_rope_split, precompute_freqs_cis


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    """The same fields as the reference's TextEncoderConfig."""

    hidden_dim: int = 3840
    num_gemma_layers: int = 49  # 48 layers + embedding
    connector_heads: int = 30
    connector_head_dim: int = 128
    connector_layers: int = 2
    num_registers: int = 128
    rope_theta: float = 10000.0
    rope_max_pos: Tuple[int, ...] = (4096,)
    norm_eps: float = 1e-6
    max_length: int = 1024  # token budget, left padding, pad_id 0

    @property
    def inner_dim(self) -> int:
        return self.connector_heads * self.connector_head_dim

    def tiny(self) -> "TextEncoderConfig":
        return dataclasses.replace(
            self, hidden_dim=32, num_gemma_layers=3, connector_heads=2,
            connector_head_dim=16, num_registers=4, max_length=16)


def norm_and_concat(hidden_states, attention_mask):
    """Masked per-sample 8 * (x - mean) / (max - min + eps) over (T, D) of
    all layers jointly, in f32, then the layers concatenated (left padding).

    hidden_states: (L, B, T, D); attention_mask: (B, T) {0, 1}. Returns
    (B, T, D*L) in the input dtype with pad rows zeroed."""
    num_layers, b, t, d = hidden_states.shape
    dtype = hidden_states.dtype
    x32 = hidden_states.float().permute(1, 2, 3, 0)  # (B, T, D, L)

    seq_lens = attention_mask.sum(dim=-1).to(torch.int32)
    token_idx = torch.arange(t, device=hidden_states.device)[None, :]
    mask = token_idx >= (t - seq_lens)[:, None]
    m = mask[:, :, None, None]

    eps = 1e-6
    masked = torch.where(m, x32, 0.0)
    denom = (seq_lens * d).reshape(b, 1, 1, 1).float() + eps
    mean = masked.sum(dim=(1, 2), keepdim=True) / denom
    x_min = torch.where(m, x32, float("inf")).amin(dim=(1, 2), keepdim=True)
    x_max = torch.where(m, x32, float("-inf")).amax(dim=(1, 2), keepdim=True)

    normed = 8.0 * (x32 - mean) / (x_max - x_min + eps)
    normed = normed.to(dtype).reshape(b, t, d * num_layers)
    return torch.where(mask[:, :, None], normed, torch.zeros((), dtype=dtype,
                                                             device=normed.device))


def replace_padded_with_registers(hidden_states, valid_mask, registers):
    """Compact valid tokens to the front (stable sort), fill the tail with
    tiled learnable registers. hidden_states (B, T, D); valid_mask (B, T)
    bool; registers (R, D) with T % R == 0."""
    b, t, d = hidden_states.shape
    r = registers.shape[0]
    if t % r:
        raise ValueError(f"seq len {t} must be divisible by num registers {r}")
    tiled = registers[None].repeat(b, t // r, 1)

    idx = torch.arange(t, device=hidden_states.device)[None, :]
    sort_key = (1 - valid_mask.to(torch.int32)) * t + idx
    order = torch.argsort(sort_key, dim=1, stable=True)
    compacted = torch.gather(hidden_states, 1, order[:, :, None].expand(b, t, d))

    # a real token sits at j iff j < seq_len: the reversed mask (left padding)
    flipped = valid_mask.flip(1).to(hidden_states.dtype)[:, :, None]
    return flipped * compacted + (1 - flipped) * tiled


class ConnectorAttention(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, device, dtype):
        super().__init__()
        d = cfg.inner_dim
        self.num_heads, self.head_dim = cfg.connector_heads, cfg.connector_head_dim
        self.eps = cfg.norm_eps
        self.to_q = Linear(d, d, device=device, dtype=dtype)
        self.to_k = Linear(d, d, device=device, dtype=dtype)
        self.to_v = Linear(d, d, device=device, dtype=dtype)
        self.to_out = Linear(d, d, device=device, dtype=dtype)
        self.q_norm = NormWeight(d, 1.0, device=device, dtype=dtype)
        self.k_norm = NormWeight(d, 1.0, device=device, dtype=dtype)

    def forward(self, x, pe):
        """QK norm on the flat tensor, RoPE AFTER the head split (the
        opposite order from the DiT's attention)."""
        b, t, _ = x.shape
        h, hd = self.num_heads, self.head_dim
        q = rms_norm(self.to_q(x), self.q_norm.weight, eps=self.eps)
        k = rms_norm(self.to_k(x), self.k_norm.weight, eps=self.eps)
        v = self.to_v(x)
        q = q.reshape(b, t, h, hd).transpose(1, 2)
        k = k.reshape(b, t, h, hd).transpose(1, 2)
        v = v.reshape(b, t, h, hd).transpose(1, 2).contiguous()
        cos, sin = pe
        q = apply_rope_split(q, cos, sin).contiguous()
        k = apply_rope_split(k, cos, sin).contiguous()
        out = sdpa(q, k, v, scale=hd**-0.5)
        out = out.transpose(1, 2).reshape(b, t, h * hd)
        return self.to_out(out)


class ConnectorBlock(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, device, dtype):
        super().__init__()
        self.attn1 = ConnectorAttention(cfg, device, dtype)
        self.ff = FeedForward(cfg.inner_dim, 4 * cfg.inner_dim, device, dtype)


class Connector(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.transformer_1d_blocks = nn.ModuleList(
            ConnectorBlock(cfg, device, dtype) for _ in range(cfg.connector_layers))
        self.learnable_registers = param(cfg.num_registers, cfg.inner_dim,
                                         device=device, dtype=dtype)

    def reset_parameters(self, gen):
        uniform_(self.learnable_registers, gen, -1.0, 1.0)

    def forward(self, hidden_states, attention_mask):
        """Registers replace pads -> 2x (RMSNorm + attention, RMSNorm + FF)
        with 1D split RoPE -> weightless RMSNorm. Every position is valid
        afterwards, so attention runs unmasked. Returns (x, ones mask)."""
        cfg = self.cfg
        x = hidden_states
        b, t, _ = x.shape
        if attention_mask is not None:
            x = replace_padded_with_registers(x, attention_mask.bool(),
                                              self.learnable_registers)
        grid = np.arange(t, dtype=np.float32)[None, :]
        cos, sin = precompute_freqs_cis(grid, cfg.inner_dim, theta=cfg.rope_theta,
                                        max_pos=cfg.rope_max_pos,
                                        num_heads=cfg.connector_heads)
        # f64 -> f32 tables, then cast to the activation dtype (the reference)
        pe = (torch.from_numpy(cos).to(x.device, x.dtype),
              torch.from_numpy(sin).to(x.device, x.dtype))
        for block in self.transformer_1d_blocks:
            x = x + block.attn1(rms_norm(x, eps=cfg.norm_eps), pe)
            x = x + block.ff(rms_norm(x, eps=cfg.norm_eps))
        x = rms_norm(x, eps=cfg.norm_eps)
        return x, torch.ones((b, t), dtype=torch.int32, device=x.device)


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, device, dtype):
        super().__init__()
        self.aggregate_embed = Linear(cfg.hidden_dim * cfg.num_gemma_layers,
                                      cfg.hidden_dim, bias=False,
                                      device=device, dtype=dtype)

    def forward(self, hidden_states, attention_mask):
        """norm & concat, then the 188160 -> 3840 projection, both in f32
        (full f32: TF32 is off, see the package init)."""
        dtype = hidden_states.dtype
        nc = norm_and_concat(hidden_states, attention_mask)
        out = torch.nn.functional.linear(nc.float(), self.aggregate_embed.weight.float())
        return out.to(dtype)


class TextEncoder(nn.Module):
    """Parameter names follow ltx_tpu.models.text_encoder.init_params, the
    audio connector with include_audio."""

    def __init__(self, cfg: TextEncoderConfig, device=None, dtype=torch.bfloat16,
                 include_audio: bool = False):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg, device, dtype)
        self.embeddings_connector = Connector(cfg, device, dtype)
        self.audio_embeddings_connector = (Connector(cfg, device, dtype) if include_audio
                                           else None)

    @property
    def has_audio(self) -> bool:
        return self.audio_embeddings_connector is not None

    def encode_from_hidden_states(self, hidden_states, attention_mask):
        """49 Gemma states (L, B, T, D) + mask (B, T) -> {"video": (B, T,
        3840), "mask": (B, T)}, and "audio": (B, T, 3840) with the audio
        connector."""
        encoded = self.feature_extractor(hidden_states, attention_mask)
        video, out_mask = self.embeddings_connector(encoded, attention_mask)
        video = video * out_mask[:, :, None].to(video.dtype)
        result = {"video": video, "mask": out_mask}
        if self.has_audio:
            audio, audio_mask = self.audio_embeddings_connector(encoded, attention_mask)
            result["audio"] = audio * audio_mask[:, :, None].to(audio.dtype)
        return result
