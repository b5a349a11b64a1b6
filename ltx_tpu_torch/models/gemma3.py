"""Gemma-3 text backbone, run as a hidden-state extractor.

Port of ltx_tpu/models/gemma3.py::forward_hidden_states (no KV cache, no
generation), with the reference's quantized modes: each projection is a
`Linear`, an int4 `QuantizedLinear` or a `W8A8Linear` (q/k/v and gate/up
through `linear_many`, so W8A8 quantizes their shared input once), and the
token table is bf16 or an `Int8Embedding` (its lookup is the reference's
`_embed_lookup`; `embed_dtype`; `lm_head` is the tied head of the
reference's generation, ROADMAP A13).
`Gemma3Model.from_state_dict` builds the model in the format of a loaded
state dict. Semantics kept:
  * embeddings scaled by sqrt(hidden_size) in the embedding dtype;
  * RMSNorm with the (1 + weight) convention, f32 statistics;
  * q/k RMSNorm per head AFTER the head split; attention scale
    query_pre_attn_scalar**-0.5, not head_dim**-0.5;
  * rotate-half RoPE, base 1e6 on global layers and 1e4 on sliding layers;
  * on this text-encoder path the sliding layers use the full causal + pad
    mask too (no window);
  * 49 hidden states: the embedding, layers 0..46 raw, the final normed one.
Attention is grouped-query with a full mask, so it runs plain PyTorch
(ops.attention._gqa_sdpa), as it ran on XLA in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ltx_tpu_torch.kernels.quantization import int8_mm, quantize_act_int8
from ltx_tpu_torch.models.common import (
    Embedding,
    Linear,
    NormWeight,
    assign_,
    gelu_tanh,
    linear_many,
    swap_for_state,
)
from ltx_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class Gemma3Config:
    """Gemma-3-12B text config (the same fields as the reference's)."""

    hidden_size: int = 3840
    hidden_layers: int = 48
    intermediate_size: int = 15360
    attention_heads: int = 16
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    vocab_size: int = 262208
    kv_heads: int = 8
    rope_theta: float = 1_000_000.0
    rope_local_base_freq: float = 10_000.0
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 1024
    sliding_window_pattern: int = 6
    max_position_embeddings: int = 131072

    @classmethod
    def from_hf_dict(cls, d: dict) -> "Gemma3Config":
        """A Hugging Face config.json (its nested `text_config` for a VLM
        export), with the reference's defaults for absent keys."""
        if "text_config" in d:
            d = d["text_config"]
        return cls(
            hidden_size=d.get("hidden_size", 3840),
            hidden_layers=d.get("num_hidden_layers", 48),
            intermediate_size=d.get("intermediate_size", 15360),
            attention_heads=d.get("num_attention_heads", 16),
            head_dim=d.get("head_dim", 256),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            vocab_size=d.get("vocab_size", 262208),
            kv_heads=d.get("num_key_value_heads", 8),
            rope_theta=d.get("rope_theta", 1_000_000.0),
            rope_local_base_freq=d.get("rope_local_base_freq", 10_000.0),
            query_pre_attn_scalar=d.get("query_pre_attn_scalar", 256.0),
            sliding_window=d.get("sliding_window", 1024),
            sliding_window_pattern=d.get("sliding_window_pattern", 6),
            max_position_embeddings=d.get("max_position_embeddings", 131072),
        )

    def tiny(self) -> "Gemma3Config":
        return dataclasses.replace(
            self, hidden_size=64, hidden_layers=7, intermediate_size=128,
            attention_heads=4, head_dim=16, vocab_size=256, kv_heads=2,
            query_pre_attn_scalar=16.0, sliding_window=4,
            sliding_window_pattern=3)

    def is_global_layer(self, i: int) -> bool:
        return (i + 1) % self.sliding_window_pattern == 0


def gemma_rms_norm(x, weight, eps: float = 1e-6):
    """normed * (1 + weight), f32 statistics."""
    dtype = x.dtype
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * (1.0 + weight.float())).to(dtype)


def rope_tables(seq_len: int, head_dim: int, base: float,
                positions: Optional[np.ndarray] = None):
    """cos/sin (T, head_dim / 2) for rotate-half RoPE, host f32."""
    if positions is None:
        positions = np.arange(seq_len, dtype=np.float32)
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    freqs = positions[:, None].astype(np.float32) * inv_freq[None, :]
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def apply_gemma_rope(x, cos, sin):
    """Rotate-half RoPE on (B, H, T, D) with cos/sin (T, D/2), f32 math."""
    dtype = x.dtype
    xf = x.float()
    d = xf.shape[-1]
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    c = cos.float()[None, None]
    s = sin.float()[None, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


def additive_causal_mask(attention_mask, seq_len: int, dtype):
    """Causal AND pad-valid -> additive (0 / dtype-min) f32 mask (B, 1, T, T)."""
    device = attention_mask.device
    causal = torch.tril(torch.ones(seq_len, seq_len, dtype=torch.bool, device=device))
    pad = attention_mask.bool()[:, None, None, :]
    combined = causal[None, None] & pad
    min_val = {torch.bfloat16: -3.3895314e38, torch.float16: -65504.0}.get(dtype, -1e9)
    return torch.where(combined, 0.0, min_val).float()


class DecoderLayer(nn.Module):
    """Pre/post sandwich norms around attention and the GELU-gated MLP."""

    def __init__(self, cfg: Gemma3Config, device, dtype):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_size, cfg.head_dim

        def dense(d_in, d_out):
            return Linear(d_in, d_out, bias=False, device=device, dtype=dtype)

        def norm(dim):
            return NormWeight(dim, 0.0, device=device, dtype=dtype)

        self.q_proj = dense(d, cfg.attention_heads * hd)
        self.k_proj = dense(d, cfg.kv_heads * hd)
        self.v_proj = dense(d, cfg.kv_heads * hd)
        self.o_proj = dense(cfg.attention_heads * hd, d)
        self.q_norm = norm(hd)
        self.k_norm = norm(hd)
        self.gate_proj = dense(d, cfg.intermediate_size)
        self.up_proj = dense(d, cfg.intermediate_size)
        self.down_proj = dense(cfg.intermediate_size, d)
        self.input_layernorm = norm(d)
        self.post_attention_layernorm = norm(d)
        self.pre_feedforward_layernorm = norm(d)
        self.post_feedforward_layernorm = norm(d)

    def attention(self, x, bias, cos, sin):
        cfg = self.cfg
        b, t, _ = x.shape
        nh, nkv, hd = cfg.attention_heads, cfg.kv_heads, cfg.head_dim
        q, k, v = linear_many((self.q_proj, self.k_proj, self.v_proj), x)
        q = q.reshape(b, t, nh, hd).transpose(1, 2)
        k = k.reshape(b, t, nkv, hd).transpose(1, 2)
        v = v.reshape(b, t, nkv, hd).transpose(1, 2)
        q = gemma_rms_norm(q, self.q_norm.weight, cfg.rms_norm_eps)
        k = gemma_rms_norm(k, self.k_norm.weight, cfg.rms_norm_eps)
        q = apply_gemma_rope(q, cos, sin)
        k = apply_gemma_rope(k, cos, sin)
        out = sdpa(q, k, v, bias=bias, scale=cfg.query_pre_attn_scalar**-0.5)
        out = out.transpose(1, 2).reshape(b, t, nh * hd)
        return self.o_proj(out)

    def mlp(self, x):
        """down(gelu_tanh(gate) * up)."""
        gate, up = linear_many((self.gate_proj, self.up_proj), x)
        return self.down_proj(gelu_tanh(gate) * up)

    def forward(self, x, bias, cos, sin):
        eps = self.cfg.rms_norm_eps
        attn = self.attention(gemma_rms_norm(x, self.input_layernorm.weight, eps),
                              bias, cos, sin)
        h = x + gemma_rms_norm(attn, self.post_attention_layernorm.weight, eps)
        m = self.mlp(gemma_rms_norm(h, self.pre_feedforward_layernorm.weight, eps))
        return h + gemma_rms_norm(m, self.post_feedforward_layernorm.weight, eps)


class Gemma3Model(nn.Module):
    """Parameter names follow ltx_tpu.models.gemma3.init_params; the JAX
    tree's stacked `layers` axis is the ModuleList index here."""

    def __init__(self, cfg: Gemma3Config, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size,
                                      device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, dtype) for _ in range(cfg.hidden_layers))
        self.norm = NormWeight(cfg.hidden_size, 0.0, device=device, dtype=dtype)

    @classmethod
    def from_state_dict(cls, cfg: Gemma3Config, state: dict) -> "Gemma3Model":
        """The model whose parameters are `state`'s tensors (`assign_`), its
        linears and token table of the formats the state holds
        (`keymaps.load_gemma_params` in any mode)."""
        dtype = state["embed_tokens.weight"].dtype if "embed_tokens.weight" in state \
            else torch.bfloat16
        return assign_(swap_for_state(cls(cfg, "meta", dtype), state), state)

    def forward_hidden_states(self, input_ids, attention_mask):
        """Token ids (B, T) + pad mask (B, T) -> (49, B, T, D) hidden states:
        [0] the scaled embedding, [1..47] layers 0..46 raw, [48] the final
        norm of layer 47 (for the 48-layer model)."""
        cfg = self.cfg
        t = input_ids.shape[1]
        dtype = embed_dtype(self)
        device = input_ids.device
        h = self.embed_tokens(input_ids) * torch.tensor(
            math.sqrt(cfg.hidden_size), dtype=dtype, device=device)
        bias = additive_causal_mask(attention_mask, t, dtype)

        tables = {}
        for name, base in (("global", cfg.rope_theta),
                           ("local", cfg.rope_local_base_freq)):
            cos, sin = rope_tables(t, cfg.head_dim, base)
            tables[name] = (torch.from_numpy(cos).to(device),
                            torch.from_numpy(sin).to(device))

        states = [h]
        x = h
        for i, layer in enumerate(self.layers):
            cos, sin = tables["global" if cfg.is_global_layer(i) else "local"]
            x = layer(x, bias, cos, sin)
            states.append(x)
        states[-1] = gemma_rms_norm(x, self.norm.weight, cfg.rms_norm_eps)
        return torch.stack(states)


def embed_dtype(model: Gemma3Model) -> torch.dtype:
    """The activation dtype the token table implies: its own, bf16 for an
    int8 table."""
    weight = getattr(model.embed_tokens, "weight", None)
    return torch.bfloat16 if weight is None else weight.dtype


def lm_head(model: Gemma3Model, h):
    """The tied head, logits in f32 (the reference's `_lm_head`): h @ W^T
    with f32 accumulation for a dense table; for an int8 table, h quantized
    per row, the exact int32 product with the rows, then acc * sx * sr,
    left to right in f32."""
    e = model.embed_tokens
    if hasattr(e, "w8r"):
        h8, sx = quantize_act_int8(h)
        lead, d = h8.shape[:-1], h8.shape[-1]
        acc = int8_mm(h8.reshape(-1, d), e.w8r.t()).reshape(*lead, -1)
        return acc.float() * sx * e.sr
    return torch.matmul(h.float(), e.weight.float().t())
