"""The text path, plain: byte tokens, the Gemma-3 tower's 49 hidden states,
the feature extractor and the 1D connector(s).

Gemma-3: the embedding scaled by sqrt(hidden) (the scale rounded to the
table's dtype, as a bf16 checkpoint computes it), then per layer the
sandwich norms ((1 + w) RMSNorm) around grouped-query attention with QK
norms and rotate-half RoPE (global or local base by layer) under a causal,
pad-aware mask, and the GELU-gated MLP; the last state is the final norm.
The connector: masked min-max norm of all states, concatenated, projected
188160 -> 3840, pads replaced by learnable registers, two pre-norm blocks
(attention with flat QK norms, RoPE after the head split; feed-forward) and
a weightless RMSNorm.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from benchmark.reference.dit import FeedForward
from benchmark.reference.layers import (
    Embedding,
    Linear,
    Module,
    NormWeight,
    apply_split_rope,
    attention,
    empty,
    gelu_tanh,
    rms_norm,
    split_rope_tables,
)


def byte_tokens(prompt: str, vocab_size: int, max_length: int):
    """Left-padded ids and mask (1, max_length): each UTF-8 byte b is token
    (b mod (vocab - 2)) + 2, the last max_length kept, pad id 0."""
    ids = [(b % (vocab_size - 2)) + 2 for b in prompt.encode()][-max_length:]
    pad = max_length - len(ids)
    input_ids = np.zeros((1, max_length), np.int64)
    mask = np.zeros((1, max_length), np.int64)
    input_ids[0, pad:] = ids
    mask[0, pad:] = 1
    return torch.from_numpy(input_ids), torch.from_numpy(mask)


def gemma_norm(x, weight, eps):
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * (1.0 + weight.float())).to(x.dtype)


def rotate_half_tables(t: int, head_dim: int, base: float):
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    freqs = np.arange(t, dtype=np.float32)[:, None] * inv_freq[None, :]
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def rotate_half(x, cos, sin):
    d = x.shape[-1]
    a, b = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


class GemmaLayer(nn.Module):
    def __init__(self, g: dict):
        super().__init__()
        d, hd = g["hidden_size"], g["head_dim"]
        self.g = g
        self.q_proj = Linear(d, g["attention_heads"] * hd, bias=False)
        self.k_proj = Linear(d, g["kv_heads"] * hd, bias=False)
        self.v_proj = Linear(d, g["kv_heads"] * hd, bias=False)
        self.o_proj = Linear(g["attention_heads"] * hd, d, bias=False)
        self.q_norm, self.k_norm = NormWeight(hd), NormWeight(hd)
        self.gate_proj = Linear(d, g["intermediate_size"], bias=False)
        self.up_proj = Linear(d, g["intermediate_size"], bias=False)
        self.down_proj = Linear(g["intermediate_size"], d, bias=False)
        self.input_layernorm = NormWeight(d)
        self.post_attention_layernorm = NormWeight(d)
        self.pre_feedforward_layernorm = NormWeight(d)
        self.post_feedforward_layernorm = NormWeight(d)

    def forward(self, x, bias, cos, sin):
        g = self.g
        eps = g["rms_norm_eps"]
        b, t, _ = x.shape
        hd = g["head_dim"]
        h = gemma_norm(x, self.input_layernorm.weight, eps)
        q = self.q_proj(h).reshape(b, t, g["attention_heads"], hd).transpose(1, 2)
        k = self.k_proj(h).reshape(b, t, g["kv_heads"], hd).transpose(1, 2)
        v = self.v_proj(h).reshape(b, t, g["kv_heads"], hd).transpose(1, 2)
        q = rotate_half(gemma_norm(q, self.q_norm.weight, eps), cos, sin)
        k = rotate_half(gemma_norm(k, self.k_norm.weight, eps), cos, sin)
        out = attention(q, k, v, bias=bias, scale=g["query_pre_attn_scalar"] ** -0.5,
                        module=self.q_proj, head_chunk=g["attention_heads"])
        attn = self.o_proj(out.transpose(1, 2).reshape(b, t, -1))
        x = x + gemma_norm(attn, self.post_attention_layernorm.weight, eps)
        h = gemma_norm(x, self.pre_feedforward_layernorm.weight, eps)
        m = self.down_proj(gelu_tanh(self.gate_proj(h)) * self.up_proj(h))
        return x + gemma_norm(m, self.post_feedforward_layernorm.weight, eps)


class Gemma(nn.Module):
    def __init__(self, g: dict):
        super().__init__()
        self.g = g
        self.embed_tokens = Embedding(g["vocab_size"], g["hidden_size"])
        self.layers = nn.ModuleList(GemmaLayer(g) for _ in range(g["hidden_layers"]))
        self.norm = NormWeight(g["hidden_size"])

    def hidden_states(self, ids, mask, dtype=torch.float32):
        """(ids, mask) (1, T) -> (L + 1, 1, T, D) hidden states in `dtype`."""
        g = self.g
        t = ids.shape[1]
        device = self.embed_tokens.weight.device
        ids, mask = ids.to(device), mask.to(device)
        scale = float(torch.tensor(math.sqrt(g["hidden_size"]),
                                   dtype=self.embed_tokens.weight.dtype))
        x = self.embed_tokens.weight[ids].to(dtype) * scale
        causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=device))
        allowed = causal[None, None] & mask.bool()[:, None, None, :]
        bias = torch.where(allowed, 0.0, -1e9).to(dtype)
        tables = {}
        for name, base in (("global", g["rope_theta"]), ("local", g["rope_local_base_freq"])):
            cos, sin = rotate_half_tables(t, g["head_dim"], base)
            tables[name] = (torch.from_numpy(cos).to(device, dtype),
                            torch.from_numpy(sin).to(device, dtype))
        states = [x]
        for i, layer in enumerate(self.layers):
            is_global = (i + 1) % g["sliding_window_pattern"] == 0
            x = layer(x, bias, *tables["global" if is_global else "local"])
            states.append(x)
        states[-1] = gemma_norm(x, self.norm.weight, g["rms_norm_eps"])
        return torch.stack(states)


def norm_and_concat(hidden, mask):
    """(L, B, T, D) states, (B, T) mask -> (B, T, D*L): 8 (x - mean) / (max -
    min + eps) over the valid rows of all layers jointly, pads zeroed."""
    n, b, t, d = hidden.shape
    x = hidden.float().permute(1, 2, 3, 0)
    lens = mask.sum(dim=-1)
    valid = torch.arange(t, device=hidden.device)[None, :] >= (t - lens)[:, None]
    m = valid[:, :, None, None]
    mean = torch.where(m, x, 0.0).sum(dim=(1, 2), keepdim=True) / (
        (lens * d).reshape(b, 1, 1, 1).float() + 1e-6)
    lo = torch.where(m, x, float("inf")).amin(dim=(1, 2), keepdim=True)
    hi = torch.where(m, x, float("-inf")).amax(dim=(1, 2), keepdim=True)
    normed = (8.0 * (x - mean) / (hi - lo + 1e-6)).to(hidden.dtype).reshape(b, t, d * n)
    return torch.where(valid[:, :, None], normed, torch.zeros((), dtype=normed.dtype,
                                                               device=normed.device))


def with_registers(x, valid, registers):
    """The valid rows moved to the front in order, the tail filled with
    the tiled registers."""
    b, t, d = x.shape
    tiled = registers.to(x.dtype)[None].repeat(b, t // registers.shape[0], 1)
    key = (1 - valid.long()) * t + torch.arange(t, device=x.device)[None, :]
    order = torch.argsort(key, dim=1, stable=True)
    compact = torch.gather(x, 1, order[:, :, None].expand(b, t, d))
    real = valid.flip(1).to(x.dtype)[:, :, None]
    return real * compact + (1 - real) * tiled


class ConnectorAttention(Module):
    def __init__(self, t: dict):
        super().__init__()
        d = t["connector_heads"] * t["connector_head_dim"]
        self.heads, self.head_dim, self.eps = t["connector_heads"], t["connector_head_dim"], \
            t["norm_eps"]
        self.to_q, self.to_k, self.to_v, self.to_out = (Linear(d, d) for _ in range(4))
        self.q_norm, self.k_norm = NormWeight(d), NormWeight(d)

    def forward(self, x, pe):
        b, t, _ = x.shape
        h, hd = self.heads, self.head_dim
        q = rms_norm(self.to_q(x), self.q_norm.weight, self.eps)
        k = rms_norm(self.to_k(x), self.k_norm.weight, self.eps)
        q, k, v = (y.reshape(b, t, h, hd).transpose(1, 2) for y in (q, k, self.to_v(x)))
        q, k = apply_split_rope(q, *pe), apply_split_rope(k, *pe)
        out = attention(q, k, v, scale=hd ** -0.5, module=self)
        return self.to_out(out.transpose(1, 2).reshape(b, t, h * hd))


class ConnectorBlock(nn.Module):
    def __init__(self, t: dict):
        super().__init__()
        d = t["connector_heads"] * t["connector_head_dim"]
        self.attn1 = ConnectorAttention(t)
        self.ff = FeedForward(d, 4 * d)


class Connector(nn.Module):
    def __init__(self, t: dict):
        super().__init__()
        self.t = t
        d = t["connector_heads"] * t["connector_head_dim"]
        self.transformer_1d_blocks = nn.ModuleList(
            ConnectorBlock(t) for _ in range(t["connector_layers"]))
        self.learnable_registers = empty(t["num_registers"], d, dtype=torch.bfloat16)

    def forward(self, x, mask):
        t = self.t
        eps = t["norm_eps"]
        x = with_registers(x, mask.bool(), self.learnable_registers)
        grid = np.arange(x.shape[1], dtype=np.float32)[None, :]
        cos, sin = split_rope_tables(grid, x.shape[-1], t["rope_theta"], t["rope_max_pos"],
                                     t["connector_heads"])
        pe = (torch.from_numpy(cos).to(x.device, x.dtype),
              torch.from_numpy(sin).to(x.device, x.dtype))
        for block in self.transformer_1d_blocks:
            x = x + block.attn1(rms_norm(x, eps=eps), pe)
            x = x + block.ff(rms_norm(x, eps=eps))
        return rms_norm(x, eps=eps)


class FeatureExtractor(nn.Module):
    def __init__(self, t: dict):
        super().__init__()
        self.aggregate_embed = Linear(t["hidden_dim"] * t["num_gemma_layers"], t["hidden_dim"],
                                      bias=False)


class TextEncoder(nn.Module):
    def __init__(self, t: dict, include_audio: bool):
        super().__init__()
        self.feature_extractor = FeatureExtractor(t)
        self.embeddings_connector = Connector(t)
        self.audio_embeddings_connector = Connector(t) if include_audio else None

    def forward(self, hidden, mask):
        """-> {"video": (1, T, D)[, "audio": ...]}; every row valid after."""
        mask = mask.to(hidden.device)
        encoded = self.feature_extractor.aggregate_embed(norm_and_concat(hidden, mask))
        out = {"video": self.embeddings_connector(encoded, mask)}
        if self.audio_embeddings_connector is not None:
            out["audio"] = self.audio_embeddings_connector(encoded, mask)
        return out
