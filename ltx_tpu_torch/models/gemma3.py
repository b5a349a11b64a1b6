"""Gemma-3 text backbone: a hidden-state extractor and a KV-cached sampler.

Port of ltx_tpu/models/gemma3.py: `forward_hidden_states` (the text
encoder's 49 states) and the generation of prompt enhancement
(`generate_tokens`, `generate_tokens_batched`: a KV cache in bf16 or int8,
top-p sampling with a repetition penalty, prompt-lookup speculation), with
the reference's quantized modes: each projection is a `Linear`, an int4
`QuantizedLinear` or a `W8A8Linear` (q/k/v and gate/up through
`linear_many`, so W8A8 quantizes their shared input once), and the token
table is bf16 or an `Int8Embedding` (its lookup is the reference's
`_embed_lookup`; `embed_dtype`; `lm_head` is the tied head).
`Gemma3Model.from_state_dict` builds the model in the format of a loaded
state dict. Semantics kept:
  * embeddings scaled by sqrt(hidden_size) in the embedding dtype;
  * RMSNorm with the (1 + weight) convention, f32 statistics;
  * q/k RMSNorm per head AFTER the head split; attention scale
    query_pre_attn_scalar**-0.5, not head_dim**-0.5;
  * rotate-half RoPE, base 1e6 on global layers and 1e4 on sliding layers;
  * on the text-encoder path the sliding layers use the full causal + pad
    mask too (no window); generation's prefill windows them, its decode
    attends to every written slot;
  * 49 hidden states: the embedding, layers 0..46 raw, the final normed one.
Attention is grouped-query with a full mask, so it runs plain PyTorch
(ops.attention._gqa_sdpa), as it ran on XLA in the reference.

Generation is an eager loop, where the reference compiles one device
program (a while loop over a scanned layer stack): the sampled tokens come
to the host once a forward, which keeps the bookkeeping (outputs, the
penalty's ring, the stop test, the prompt-lookup drafts) in numpy. A
speculative bundle decides all its candidates in one vectorized step: the
candidate at row j is only committed when every draft before it was, so
its penalty sees the ring with those drafts written. Random draws are
explicit: `SamplingDraws` hands out the Gumbel and uniform numbers in the
order the loops consume them (the reference's categorical draw is
argmax(logits + Gumbel noise)); a caller may pass its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ltx_tpu_torch.errors import InvalidConfigurationError

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
    """Rotate-half RoPE on (B, H, T, D) with cos/sin (T, D/2) shared by the
    rows, or (B, T, D/2) per row (left pads that differ), f32 math."""
    dtype = x.dtype
    xf = x.float()
    d = xf.shape[-1]
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    c, s = cos.float(), sin.float()
    if c.ndim == 2:
        c, s = c[None], s[None]
    c, s = c[:, None], s[:, None]  # (B | 1, 1, T, D/2)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


def additive_causal_mask(attention_mask, seq_len: int, dtype):
    """Causal AND pad-valid -> additive (0 / dtype-min) f32 mask (B, 1, T, T)."""
    device = attention_mask.device
    causal = torch.tril(torch.ones(seq_len, seq_len, dtype=torch.bool, device=device))
    pad = attention_mask.bool()[:, None, None, :]
    combined = causal[None, None] & pad
    min_val = {torch.bfloat16: -3.3895314e38, torch.float16: -65504.0}.get(dtype, -1e9)
    return torch.where(combined, 0.0, min_val).float()


def quantize_kv(x):
    """(..., D) -> per-row int8 values and the f32 scale over the last axis
    (absmax / 127, divided by a tensor: the reference's IEEE division)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / torch.tensor(127.0, device=x.device)
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def kv_cache_init(kv_quant: str, shape, dtype, device):
    """The cache of one stream (K or V) of one layer, (B, Hkv, T, D): a
    tensor of zeros in bf16 (any kv_quant but "int8"), or for "int8"
    {"q": int8 zeros, "s": f32 ones (B, Hkv, T)}."""
    if kv_quant == "int8":
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.ones(shape[:-1], dtype=torch.float32, device=device)}
    return torch.zeros(shape, dtype=dtype, device=device)


def _write_cache(cache, new, index) -> None:
    """cache[:, :, i:i + m] = new (m = new.shape[2]) in place at the write
    offset `index`: an int for every row, or a (B,) tensor of per-row
    offsets. An offset is clamped so that the update fits, as the
    reference's dynamic_update_slice clamps."""
    m, t = new.shape[2], cache.shape[2]
    if isinstance(index, int):
        start = min(max(index, 0), t - m)
        cache[:, :, start:start + m] = new
        return
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cols = index.to(cache.device).clamp(0, t - m)[:, None] + torch.arange(m, device=cache.device)
    cache[rows, :, cols] = new.transpose(1, 2)


class DecoderLayer(nn.Module):
    """Pre/post sandwich norms around attention and the GELU-gated MLP.
    n_heads / n_kv are the query and key/value heads this module holds:
    the config's, or a model-axis share of them under tensor parallelism
    (`parallel.sharding.shard_gemma`, which sets `tp_mesh`)."""

    tp_mesh = None

    def __init__(self, cfg: Gemma3Config, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.n_heads, self.n_kv = cfg.attention_heads, cfg.kv_heads
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

    def attention(self, x, bias, cos, sin, kv_cache=None, cache_index=None):
        """Self-attention of x (B, T, D). With `kv_cache` (K and V caches of
        `kv_cache_init`'s format) this step's K and V are written into it
        in place at `cache_index` (an int, or a (B,) tensor of per-row
        offsets) and the queries attend to the whole cache under `bias`
        (B, 1, T, cache slots); an int8 cache is dequantized to x's dtype."""
        cfg = self.cfg
        b, t, _ = x.shape
        nh, nkv, hd = self.n_heads, self.n_kv, cfg.head_dim
        q, k, v = linear_many((self.q_proj, self.k_proj, self.v_proj), x)
        q = q.reshape(b, t, nh, hd).transpose(1, 2)
        k = k.reshape(b, t, nkv, hd).transpose(1, 2)
        v = v.reshape(b, t, nkv, hd).transpose(1, 2)
        q = gemma_rms_norm(q, self.q_norm.weight, cfg.rms_norm_eps)
        k = gemma_rms_norm(k, self.k_norm.weight, cfg.rms_norm_eps)
        q = apply_gemma_rope(q, cos, sin)
        k = apply_gemma_rope(k, cos, sin)
        if kv_cache is not None:
            ck, cv = kv_cache
            if isinstance(ck, dict):
                for cache, new in ((ck, k), (cv, v)):
                    codes, scales = quantize_kv(new)
                    _write_cache(cache["q"], codes, cache_index)
                    _write_cache(cache["s"], scales, cache_index)
                k = (ck["q"].float() * ck["s"][..., None]).to(x.dtype)
                v = (cv["q"].float() * cv["s"][..., None]).to(x.dtype)
            else:
                _write_cache(ck, k, cache_index)
                _write_cache(cv, v, cache_index)
                k, v = ck, cv
        out = sdpa(q, k, v, bias=bias, scale=cfg.query_pre_attn_scalar**-0.5)
        out = out.transpose(1, 2).reshape(b, t, nh * hd)
        return self.o_proj(out)

    def mlp(self, x):
        """down(gelu_tanh(gate) * up)."""
        gate, up = linear_many((self.gate_proj, self.up_proj), x)
        return self.down_proj(gelu_tanh(gate) * up)

    def forward(self, x, bias, cos, sin, kv_cache=None, cache_index=None):
        eps = self.cfg.rms_norm_eps
        attn = self.attention(gemma_rms_norm(x, self.input_layernorm.weight, eps),
                              bias, cos, sin, kv_cache, cache_index)
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
    with f32 accumulation for a dense table (on CUDA a bf16 product written
    in f32, which reads the 2 GB table once; elsewhere the same products in
    f32); for an int8 table, h quantized per row, the exact int32 product
    with the rows, then acc * sx * sr, left to right in f32. A table sharded
    over the vocabulary (`shard_gemma`) gives its shard's logits, gathered
    whole on every rank."""
    e = model.embed_tokens
    logits = _lm_head_local(e, h)
    if e.tp_mesh is not None:
        from ltx_tpu_torch.parallel.sharding import gather_logits

        logits = gather_logits(logits, e.tp_mesh)
    return logits


def _lm_head_local(e, h):
    """The tied head on this module's own table rows."""
    lead, d = h.shape[:-1], h.shape[-1]
    if hasattr(e, "w8r"):
        h8, sx = quantize_act_int8(h)
        acc = int8_mm(h8.reshape(-1, d), e.w8r.t()).reshape(*lead, -1)
        return acc.float() * sx * e.sr
    if h.is_cuda and h.dtype == e.weight.dtype == torch.bfloat16:
        return torch.mm(h.reshape(-1, d), e.weight.t(),
                        out_dtype=torch.float32).reshape(*lead, -1)
    return torch.matmul(h.float(), e.weight.float().t())


# ---------------------------------------------------------------------------
# Autoregressive generation (prompt enhancement)
# ---------------------------------------------------------------------------
#
# The reference's semantics, kept:
#   * prompts are left-padded to a multiple of `bucket`; the prefill runs the
#     global layers causal and the sliding layers windowed, over the cache's
#     slots, and the first token comes from its last row;
#   * decode attends to every written slot of the row (the reference's mask
#     "none"): slot s is visible to bundle row j iff pad <= s <= pos + j;
#   * the repetition penalty covers the last `repetition_context` GENERATED
#     tokens (positive logits divided, negative multiplied);
#   * top-p keeps the smallest descending prefix of the top_k candidates
#     whose mass reaches top_p (probabilities over the full vocabulary);
#   * speculation drafts the spec_k tokens that followed the latest earlier
#     occurrence of the trailing spec_ngram tokens (prompt lookup), verifies
#     cur + drafts in one forward and accepts by exact rejection sampling for
#     a deterministic draft, so the output distribution is the sequential
#     sampler's and greedy output is the sequential greedy sequence. The
#     cache keeps spec_k + 1 slots of slack so that a bundle's write never
#     clamps into valid history.


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class SamplingDraws:
    """The random numbers of one generation, from a torch.Generator on
    `device` seeded with `seed`, handed out in the order the loops take
    them: `token` for each sampled token of a sequential step or of the
    first token, `bundle` for each speculative verify step. Gumbel noise is
    -log(-log(u)) of a uniform u in [tiny, 1), as the reference's
    categorical draw uses it."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def _uniform(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def _gumbel(self, *shape):
        u = self._uniform(*shape).clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def token(self, rows: int, top_k: int):
        """Gumbel noise (rows, top_k) for one sampled token per row."""
        return self._gumbel(rows, top_k)

    def bundle(self, rows: int, spec_k: int, top_k: int):
        """One verify step: the acceptance uniforms (spec_k, rows), the
        residual draws' Gumbel noise (spec_k, rows, top_k) and the bonus
        token's (rows, top_k)."""
        return (self._uniform(spec_k, rows), self._gumbel(spec_k, rows, top_k),
                self._gumbel(rows, top_k))


def penalize(lg, ring, penalty: float, vocab: int):
    """The repetition penalty: lg (..., vocab) with each token of `ring`
    (..., ctx; `vocab` marks an empty slot, a negative id too) divided by
    `penalty` where positive and multiplied where not."""
    if penalty == 1.0:
        return lg
    ring = torch.where(ring < 0, torch.full_like(ring, vocab), ring)
    hit = torch.zeros(*lg.shape[:-1], vocab + 1, dtype=torch.bool, device=lg.device)
    hit.scatter_(-1, ring, True)
    pen = torch.tensor(penalty, dtype=lg.dtype, device=lg.device)
    return torch.where(hit[..., :vocab], torch.where(lg > 0, lg / pen, lg * pen), lg)


def topp_filtered(lg, temperature: float, top_p: float, top_k: int):
    """(..., vocab) logits -> (top_k candidate ids, their nucleus-filtered
    probabilities), the reference's `_topp_filtered`: probabilities over the
    full vocabulary (logsumexp), candidates the top_k logits in descending
    order with ties to the lower id (a stable sort), kept while the mass
    before a candidate is below top_p (the first always)."""
    lgt = lg.float() / torch.tensor(temperature, dtype=torch.float32, device=lg.device)
    lse = torch.logsumexp(lgt, dim=-1, keepdim=True)
    kvals, kidx = torch.sort(lgt, dim=-1, descending=True, stable=True)
    kvals, kidx = kvals[..., :top_k], kidx[..., :top_k]
    kprobs = torch.exp(kvals - lse)
    mass_before = torch.cumsum(kprobs, dim=-1) - kprobs
    return kidx, torch.where(mass_before < top_p, kprobs, torch.zeros_like(kprobs))


def _categorical(probs, gumbel):
    """The index of argmax(log(probs + 1e-12) + gumbel) over the last axis:
    a draw from the categorical of `probs` (the first maximum on a tie)."""
    return torch.argmax(torch.log(probs + 1e-12) + gumbel, dim=-1)


def topp_sample(lg, gumbel, temperature: float, top_p: float, top_k: int = 64):
    """Nucleus sampling over (..., vocab) logit rows with the Gumbel noise
    `gumbel` (..., top_k): the reference's `topp_sample` with its draw
    passed in."""
    kidx, filt = topp_filtered(lg, temperature, top_p, top_k)
    choice = _categorical(filt, gumbel)
    return kidx.gather(-1, choice[..., None])[..., 0]


def greedy(lg):
    """The first id of the largest logit, (..., vocab) -> (...)."""
    return torch.argmax(lg, dim=-1)


def spec_accept(lg, draft, uniform, gumbel, temperature: float, top_p: float,
                top_k: int = 64):
    """Rejection-sample a deterministic draft against the target rows: the
    reference's `spec_accept` with its uniform (...) and Gumbel (...,
    top_k) draws passed in. Accept the draft with probability p(draft),
    else draw from p with the draft's mass removed; at temperature <= 0
    accept iff the draft is the argmax, else emit the argmax. Returns
    (token, accepted), each of the draft's shape."""
    if temperature <= 0:
        tgt = greedy(lg)
        acc = tgt == draft
        return tgt, acc  # the draft where accepted: the same id
    kidx, filt = topp_filtered(lg, temperature, top_p, top_k)
    d_slot = kidx == draft[..., None]
    p_d = torch.where(d_slot, filt, torch.zeros_like(filt)).sum(-1) / filt.sum(-1)
    acc = uniform < p_d
    resid = torch.where(d_slot, torch.zeros_like(filt), filt)
    alt = kidx.gather(-1, _categorical(resid, gumbel)[..., None])[..., 0]
    return torch.where(acc, draft, alt), acc


def ngram_draft(ctx_buf: np.ndarray, cursor: int, pad: int, ngram: int, k: int) -> np.ndarray:
    """Prompt-lookup draft over one row's token history (-1 where nothing
    is written), the reference's `_ngram_draft`: a start s (pad <= s,
    s + ngram < cursor) where ctx_buf[s:s + ngram] equals the ngram ending at
    `cursor`, preferring the latest one with k followers before the cursor,
    else the earliest; returns the k tokens after it, -1 where there is no
    match or a follower is at or past the cursor."""
    n = ctx_buf.shape[0]
    lo = min(max(cursor - ngram, 0), n - ngram)
    pat = ctx_buf[lo:lo + ngram]
    starts = np.arange(n - ngram)
    win = np.stack([ctx_buf[j:n - ngram + j] for j in range(ngram)], axis=1)
    match = np.all(win == pat[None], axis=1) & (starts >= pad) & (starts + ngram < cursor)
    full = match & (starts + ngram + k <= cursor)
    if full.any():
        s = int(starts[full].max())
    elif match.any():
        s = int(starts[match].min())
    else:
        s = -1
    src = max(s, 0) + ngram
    at = min(max(src, 0), n - k)
    draft = ctx_buf[at:at + k]
    ok = (s >= 0) & (np.arange(k) + src < cursor)
    return np.where(ok, draft, -1)


class KVDecoder:
    """A Gemma3Model with a KV cache of `cache_len` slots for B rows that
    are left-padded by `pads`: `prefill` the padded prompts, then
    `forward` bundles of m tokens a row at per-row (or shared) positions.
    The caches are written in place."""

    def __init__(self, model: "Gemma3Model", pads, cache_len: int, kv_quant: str = "bf16"):
        cfg = model.cfg
        self.model, self.cfg, self.cache_len = model, cfg, cache_len
        self.device = model.norm.weight.device
        self.dtype = embed_dtype(model)
        self.pads = torch.as_tensor(np.asarray(pads), dtype=torch.long, device=self.device)
        b = self.pads.shape[0]
        # this rank's key/value heads under tensor parallelism
        shape = (b, model.layers[0].n_kv, cache_len, cfg.head_dim)
        self.caches = [tuple(kv_cache_init(kv_quant, shape, self.dtype, self.device)
                             for _ in range(2)) for _ in range(cfg.hidden_layers)]
        self.tables = {}
        for name, base in (("global", cfg.rope_theta), ("local", cfg.rope_local_base_freq)):
            cos, sin = rope_tables(cache_len, cfg.head_dim, base)
            self.tables[name] = (torch.from_numpy(cos).to(self.device),
                                 torch.from_numpy(sin).to(self.device))
        self.scale_emb = torch.tensor(math.sqrt(cfg.hidden_size), dtype=self.dtype,
                                      device=self.device)

    def embed(self, toks):
        """Token ids (B, m) -> scaled embeddings (B, m, D)."""
        return self.model.embed_tokens(toks) * self.scale_emb

    def _layers(self, h, bias_g, bias_s, positions, cache_index):
        cfg = self.cfg
        for i, layer in enumerate(self.model.layers):
            glob = cfg.is_global_layer(i)
            cos, sin = self.tables["global" if glob else "local"]
            h = layer(h, bias_g if glob else bias_s, cos[positions], sin[positions],
                      self.caches[i], cache_index)
        return gemma_rms_norm(h, self.model.norm.weight, cfg.rms_norm_eps)

    def prefill(self, h):
        """h (B, t_pad, D), the prompts' scaled embeddings left-padded ->
        the last row's logits (B, vocab) f32; slots 0..t_pad-1 written."""
        t_pad = h.shape[1]
        row = torch.arange(t_pad, device=self.device)[None, :, None]
        col = torch.arange(self.cache_len, device=self.device)[None, None, :]
        valid = (col <= row) & (col >= self.pads[:, None, None])
        bias_g = torch.where(valid, 0.0, -1e9)[:, None].float()
        valid_s = valid & (col > row - self.cfg.sliding_window)
        bias_s = torch.where(valid_s, 0.0, -1e9)[:, None].float()
        positions = torch.clamp(torch.arange(t_pad, device=self.device)[None]
                                - self.pads[:, None], min=0)
        h = self._layers(h.to(self.dtype), bias_g, bias_s, positions, 0)
        return lm_head(self.model, h[:, -1])

    def forward(self, toks, pos):
        """toks (B, m) -> logits (B, m, vocab) f32. Row i's tokens go to
        slots pos[i]..pos[i] + m - 1 (pos an int for every row, or B ints);
        bundle row j of row i attends to slots pads[i]..pos[i] + j."""
        toks = torch.as_tensor(np.asarray(toks), dtype=torch.long, device=self.device)
        m = toks.shape[1]
        uniform = isinstance(pos, (int, np.integer))
        pos_b = torch.as_tensor(np.array(np.broadcast_to(np.asarray(pos, np.int64),
                                                        (toks.shape[0],))), device=self.device)
        idx = torch.arange(self.cache_len, device=self.device)[None, None, None, :]
        rows = torch.arange(m, device=self.device)[None, None, :, None]
        ok = (idx >= self.pads[:, None, None, None]) & (idx <= pos_b[:, None, None, None] + rows)
        bias = torch.where(ok, 0.0, -1e9).float()
        positions = (pos_b - self.pads)[:, None] + torch.arange(m, device=self.device)[None]
        h = self._layers(self.embed(toks), bias, bias, positions,
                         int(pos) if uniform else pos_b)
        return lm_head(self.model, h)


class _LoopState:
    """The host's bookkeeping of B generating rows: the outputs, the
    penalty's ring of the last `ctx` generated tokens (`vocab` in an empty
    slot), the counts and the stop state."""

    def __init__(self, b: int, max_new: int, ctx: int, vocab: int, stops: np.ndarray):
        self.out = np.full((b, max_new), -1, np.int64)
        self.ring = np.full((b, ctx), vocab, np.int64)
        self.n_gen = np.zeros(b, np.int64)
        self.done = np.zeros(b, bool)
        self.ctx, self.stops, self.rows = ctx, stops, np.arange(b)

    def ring_tensor(self, device):
        return torch.from_numpy(self.ring).to(device)

    def commit_sequential(self, tok, n: int) -> None:
        """Step n of the sequential loop: each row not yet stopped writes
        its token unless it is a stop token, which stops the row."""
        hit = np.isin(tok, self.stops)
        write = ~self.done & ~hit
        self.out[write, n] = tok[write]
        self.ring[write, n % self.ctx] = tok[write]
        self.n_gen += write
        self.done |= hit

    def commit(self, tok, live, ctx_buf, t_pad: int):
        """One committed candidate of the speculative loop for the `live`
        rows: written to the outputs, the ring and the history unless it is
        a stop token, which stops the row. Returns the rows written."""
        hit = np.isin(tok, self.stops)
        write = live & ~hit
        r, n = self.rows[write], self.n_gen[write]
        self.out[r, n] = tok[write]
        self.ring[r, n % self.ctx] = tok[write]
        ctx_buf[r, t_pad + n] = tok[write]
        self.n_gen += write
        self.done |= live & hit
        return write

    def bundle_rings(self, draft):
        """(B, spec_k + 1, ctx): the ring that bundle row j decides with
        when drafts 0..j-1 were all committed, each at the slot of its
        position. A row after a rejection is not live and its decision
        unused, so this is the ring of every live row."""
        b, k = draft.shape
        rings = np.repeat(self.ring[:, None], k + 1, axis=1)
        for i in range(k):
            slot = (self.n_gen + i) % self.ctx
            for j in range(i + 1, k + 1):
                rings[self.rows, j, slot] = draft[:, i]
        return rings

    def tokens(self) -> List[List[int]]:
        return [[int(t) for t in self.out[i, :self.n_gen[i]]] for i in range(len(self.rows))]


def _left_padded(rows, bucket: int):
    """Token rows -> (t_pad, pads (B,), ids (B, t_pad) left-padded with 0)."""
    t_pad = _round_up(max(max(r.size for r in rows), 1), bucket)
    pads = np.asarray([t_pad - r.size for r in rows], np.int64)
    ids = np.zeros((len(rows), t_pad), np.int64)
    for i, r in enumerate(rows):
        ids[i, pads[i]:] = r
    return t_pad, pads, ids


@torch.inference_mode()
def _generate(model: "Gemma3Model", rows, input_embeds, *, max_new_tokens: int,
              temperature: float, top_p: float, repetition_penalty: float,
              repetition_context: int, stop_tokens, bucket: int, top_k: int, spec_k: int,
              spec_ngram: int, kv_quant: str, draws):
    """B prompts through one KV-cached sampling loop (sequential, or
    speculative for spec_k > 0). input_embeds: None, or one entry per row,
    each None (the row's table embeddings) or a (1, T_i, D) pre-scaled
    embedding row. Returns (B token lists, forwards)."""
    cfg = model.cfg
    device = model.norm.weight.device
    vocab = cfg.vocab_size
    b = len(rows)
    t_pad, pads, ids = _left_padded(rows, bucket)
    cache_len = t_pad + max_new_tokens + (spec_k + 1 if spec_k > 0 else 0)
    dec = KVDecoder(model, pads, cache_len, kv_quant)
    ids_t = torch.from_numpy(ids).to(device)
    if input_embeds is not None:
        parts = []
        for i, e in enumerate(input_embeds):
            if e is None:
                e = dec.embed(ids_t[i:i + 1, pads[i]:])
            if e.shape[1] != rows[i].size:
                raise InvalidConfigurationError(
                    f"input_embeds[{i}] length {e.shape[1]} != prompt length "
                    f"{rows[i].size} (ids are the bookkeeping twin)")
            full = torch.zeros(1, t_pad, e.shape[-1], dtype=e.dtype, device=device)
            full[:, int(pads[i]):] = e.to(device)
            parts.append(full)
        h = torch.cat(parts)
    else:
        h = dec.embed(ids_t)
    logits0 = dec.prefill(h)
    del h
    ctx = max(repetition_context, 1)
    stops = np.asarray(list(stop_tokens), np.int64)
    state = _LoopState(b, max_new_tokens, ctx, vocab, stops)
    sampled = temperature > 0

    def sample(lg, rings, gumbel):
        """Each row's token from its penalized logits: greedy, or top-p with
        its Gumbel noise."""
        lg = penalize(lg, rings, repetition_penalty, vocab)
        return topp_sample(lg, gumbel, temperature, top_p, top_k) if sampled else greedy(lg)

    if spec_k <= 0:
        logits, n, fwds = logits0, 0, 0
        while n < max_new_tokens and not state.done.all():
            gumbel = draws.token(b, top_k) if sampled else None
            nxt = sample(logits, state.ring_tensor(device), gumbel).cpu().numpy()
            state.commit_sequential(nxt, n)
            logits = dec.forward(nxt[:, None], t_pad + n)[:, 0]
            n += 1
            fwds += 1
        return state.tokens(), fwds

    # speculative: the first token from the prefill, then verify bundles
    ctx_buf = np.concatenate([np.where(np.arange(t_pad)[None] >= pads[:, None], ids, -1),
                              np.full((b, cache_len - t_pad), -1, np.int64)], axis=1)
    gumbel = draws.token(b, top_k) if sampled else None
    tok0 = sample(logits0, state.ring_tensor(device), gumbel).cpu().numpy()
    state.commit(tok0, np.ones(b, bool), ctx_buf, t_pad)
    cur = tok0
    fwds = 0
    while (~state.done & (state.n_gen < max_new_tokens)).any():
        cursor = t_pad + state.n_gen
        draft = np.stack([ngram_draft(ctx_buf[i], int(cursor[i]), int(pads[i]), spec_ngram,
                                      spec_k) for i in range(b)])
        toks = np.concatenate([cur[:, None], np.maximum(draft, 0)], axis=1)
        logits = dec.forward(toks, cursor - 1)  # (B, spec_k + 1, vocab)
        fwds += 1
        rings = torch.from_numpy(state.bundle_rings(draft)).to(device)
        uniform = gumbels = bonus_g = None
        if sampled:
            uniform, gumbels, bonus_g = draws.bundle(b, spec_k, top_k)
            uniform, gumbels = uniform.t(), gumbels.transpose(0, 1)
        tok, acc = spec_accept(penalize(logits[:, :spec_k], rings[:, :spec_k],
                                        repetition_penalty, vocab),
                               torch.from_numpy(draft).to(device), uniform, gumbels,
                               temperature, top_p, top_k)
        bonus = sample(logits[:, spec_k], rings[:, spec_k], bonus_g)
        tok, acc, bonus = (t.cpu().numpy() for t in (tok, acc, bonus))
        accepting = np.ones(b, bool)
        last = cur.copy()
        for j in range(spec_k):
            live = accepting & ~state.done & (state.n_gen < max_new_tokens)
            write = state.commit(tok[:, j], live, ctx_buf, t_pad)
            last = np.where(write, tok[:, j], last)
            accepting = write & acc[:, j]
        live = accepting & ~state.done & (state.n_gen < max_new_tokens)
        write = state.commit(bonus, live, ctx_buf, t_pad)
        cur = np.where(write, bonus, last)
    return state.tokens(), fwds


def _check_mesh(model: "Gemma3Model", mesh) -> None:
    """A decode given `mesh` runs on a model sharded over that mesh."""
    if mesh is None:
        return
    have = getattr(model, "tp_mesh", None)
    if have is None or have.ranks.shape != mesh.ranks.shape or (have.ranks != mesh.ranks).any():
        raise InvalidConfigurationError(
            "generate_tokens(mesh=): shard the model over that mesh first "
            "(parallel.sharding.shard_gemma)")


def generate_tokens(model: "Gemma3Model", input_ids, max_new_tokens: int = 512,
                    temperature: float = 0.7, top_p: float = 0.95,
                    repetition_penalty: float = 1.1, repetition_context: int = 64,
                    stop_tokens: Tuple[int, ...] = (1,), input_embeds=None,
                    bucket: int = 128, top_k: int = 0, spec_k: int = 0, spec_ngram: int = 3,
                    kv_quant: str = "bf16", mesh=None, return_stats: bool = False,
                    seed: int = 0, draws: Optional[SamplingDraws] = None):
    """KV-cached sampling of one prompt (the reference's `generate_tokens`,
    the model's config in place of its `cfg`, `seed` or `draws` in place
    of its key: `SamplingDraws(seed)` on the model's device unless `draws`
    is given).

    input_embeds: optional (1, T, D) pre-scaled prompt embeddings (the VLM
    path's spliced soft tokens); input_ids then holds T bookkeeping ids.
    top_k: the sampler's candidates, 0 for 64 at temperature <= 1 and 512
    above. spec_k: prompt-lookup speculation with spec_k drafts a verify
    forward (0 off; off as well for a prompt shorter than spec_ngram + 1 or
    fewer than 2 new tokens). kv_quant "int8" keeps the cache in int8 with
    per-position scales. `mesh`: the model is sharded over it
    (`shard_gemma`): the decode runs tensor parallel, every rank with its
    key/value heads' cache, the logits gathered whole, every rank drawing
    the same tokens. Returns the generated ids (without the prompt); with
    return_stats also {"forwards": decode forwards}."""
    _check_mesh(model, mesh)
    if top_k <= 0:
        top_k = 64 if temperature <= 1.0 else 512
    input_ids = np.asarray(input_ids)
    if input_ids.ndim == 1:
        input_ids = input_ids[None]
    b, t = input_ids.shape
    if b != 1:
        raise InvalidConfigurationError("prompt enhancement generates one prompt at a time")
    if spec_k > 0 and (t < spec_ngram + 1 or max_new_tokens < 2):
        spec_k = 0  # too short to look up / nothing to speculate on
    if draws is None:
        draws = SamplingDraws(seed, model.norm.weight.device)
    tokens, fwds = _generate(
        model, [input_ids[0].astype(np.int64)],
        None if input_embeds is None else [input_embeds],
        max_new_tokens=max_new_tokens, temperature=float(temperature), top_p=float(top_p),
        repetition_penalty=float(repetition_penalty),
        repetition_context=int(repetition_context), stop_tokens=stop_tokens, bucket=bucket,
        top_k=int(top_k), spec_k=int(spec_k), spec_ngram=int(spec_ngram),
        kv_quant=str(kv_quant), draws=draws)
    return (tokens[0], {"forwards": fwds}) if return_stats else tokens[0]


def generate_tokens_batched(model: "Gemma3Model", prompts, max_new_tokens: int = 512,
                            temperature: float = 0.7, top_p: float = 0.95,
                            repetition_penalty: float = 1.1, repetition_context: int = 64,
                            stop_tokens: Tuple[int, ...] = (1,), bucket: int = 128,
                            top_k: int = 0, spec_k: int = 0, spec_ngram: int = 3,
                            kv_quant: str = "bf16", mesh=None, input_embeds=None,
                            seed: int = 0, draws: Optional[SamplingDraws] = None):
    """B prompts through one KV-cached sampling loop (the reference's
    `generate_tokens_batched`; `seed` / `draws` as `generate_tokens`). Rows
    are left-padded to a shared bucket, each with its own pad, penalty ring,
    stop state and, under speculation, its own cache offsets; a row's
    greedy output is its solo `generate_tokens` output. input_embeds: None
    or one entry per prompt, each None (a text row) or a (1, T_i, D)
    pre-scaled row. `mesh` as `generate_tokens`'. Returns B token lists."""
    _check_mesh(model, mesh)
    if top_k <= 0:
        top_k = 64 if temperature <= 1.0 else 512
    rows = [np.asarray(p).reshape(-1).astype(np.int64) for p in prompts]
    if not rows or any(r.size == 0 for r in rows):
        raise InvalidConfigurationError("generate_tokens_batched needs >= 1 non-empty prompt")
    if input_embeds is not None and not any(e is not None for e in input_embeds):
        input_embeds = None
    if input_embeds is not None and len(input_embeds) != len(rows):
        raise InvalidConfigurationError(
            f"{len(input_embeds)} input_embeds rows for {len(rows)} prompts")
    if spec_k > 0 and max_new_tokens < 2:
        spec_k = 0  # nothing to speculate on
    if draws is None:
        draws = SamplingDraws(seed, model.norm.weight.device)
    tokens, _ = _generate(
        model, rows, input_embeds, max_new_tokens=max_new_tokens,
        temperature=float(temperature), top_p=float(top_p),
        repetition_penalty=float(repetition_penalty),
        repetition_context=int(repetition_context), stop_tokens=stop_tokens, bucket=bucket,
        top_k=int(top_k), spec_k=int(spec_k), spec_ngram=int(spec_ngram),
        kv_quant=str(kv_quant), draws=draws)
    return tokens
