"""Video diffusion transformer (DiT): the denoising hot path.

Port of ltx_tpu/models/dit.py. The 48 blocks are an nn.ModuleList run in a
Python loop (the reference stacks them and scans). Semantics kept exactly:
QK RMSNorm across all heads on the flat (B, T, H*D) tensor, then RoPE on the
flat tensor, then the head split; AdaLN-single with a per-block (6, D) f32
scale_shift_table; affine-free LayerNorm and a (2, D) table at the output.
Every attention goes through ops.attention.sdpa, so on CUDA through the
flash-attention kernel. `quantize_transformer` swaps the blocks' large
linears for int8 / int4 `QuantizedLinear`s or `W8A8Linear`s, as the reference's
`quantize_transformer_params` quantizes the tree. For training, `remat`
and `remat_segments` rematerialise the blocks with
torch.utils.checkpoint, as the reference's jax.checkpoint over its scan.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ltx_tpu_torch.config import TransformerConfig
from ltx_tpu_torch.kernels.quantization import _MIN_QUANT_SIZE, QUANTIZABLE_LEAVES
from ltx_tpu_torch.models.common import (
    Linear,
    NormWeight,
    QuantizedLinear,
    W8A8Linear,
    gelu_tanh,
    param,
    silu,
)
from ltx_tpu_torch.ops.attention import sdpa
from ltx_tpu_torch.ops.embeddings import get_timestep_embedding
from ltx_tpu_torch.ops.normalization import adaln, layer_norm_no_affine, rms_norm
from ltx_tpu_torch.ops.rope import apply_rope_split


class Attention(nn.Module):
    def __init__(self, query_dim, context_dim, inner_dim, num_heads, head_dim,
                 norm_eps, device, dtype):
        super().__init__()
        self.num_heads, self.head_dim, self.norm_eps = num_heads, head_dim, norm_eps
        self.to_q = Linear(query_dim, inner_dim, device=device, dtype=dtype)
        self.to_k = Linear(context_dim, inner_dim, device=device, dtype=dtype)
        self.to_v = Linear(context_dim, inner_dim, device=device, dtype=dtype)
        self.to_out = Linear(inner_dim, query_dim, device=device, dtype=dtype)
        self.q_norm = NormWeight(inner_dim, 1.0, device=device, dtype=dtype)
        self.k_norm = NormWeight(inner_dim, 1.0, device=device, dtype=dtype)

    def forward(self, x, context, bias=None, rope=None, k_rope=None):
        """QK RMSNorm on the flat tensor, RoPE on the flat tensor, then the
        head split and attention. k_rope: the keys' own (cos, sin) tables
        (the dual block's cross-modal attentions), else `rope`'s."""
        b, tq, _ = x.shape
        tk = context.shape[1]
        h, d = self.num_heads, self.head_dim
        q = rms_norm(self.to_q(x), self.q_norm.weight, eps=self.norm_eps)
        k = rms_norm(self.to_k(context), self.k_norm.weight, eps=self.norm_eps)
        v = self.to_v(context)
        if rope is not None:
            q = apply_rope_split(q, *rope)
            k = apply_rope_split(k, *(k_rope if k_rope is not None else rope))
        # (B, H, T, D) views of the (B, T, H*D) projections: the forward
        # kernel reads them by their strides and writes its output in q's
        # layout, so the transpose back is a view too
        q = q.reshape(b, tq, h, d).transpose(1, 2)
        k = k.reshape(b, tk, h, d).transpose(1, 2)
        v = v.reshape(b, tk, h, d).transpose(1, 2)
        out = sdpa(q, k, v, bias=bias)
        out = out.transpose(1, 2).reshape(b, tq, h * d)
        return self.to_out(out)


class FeedForward(nn.Module):
    """Linear -> GELU(tanh) -> Linear."""

    def __init__(self, dim, hidden, device, dtype):
        super().__init__()
        self.project_in = Linear(dim, hidden, device=device, dtype=dtype)
        self.project_out = Linear(hidden, dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.project_out(gelu_tanh(self.project_in(x)))


class TwoLinear(nn.Module):
    """linear_1 -> act -> linear_2 (timestep MLP, caption projection)."""

    def __init__(self, d_in, d_hidden, d_out, device, dtype):
        super().__init__()
        self.linear_1 = Linear(d_in, d_hidden, device=device, dtype=dtype)
        self.linear_2 = Linear(d_hidden, d_out, device=device, dtype=dtype)


class AdaLNSingle(nn.Module):
    def __init__(self, d, device, dtype, n: int = 6):
        super().__init__()
        self.emb = TwoLinear(256, d, d, device, dtype)
        self.linear = Linear(d, n * d, device=device, dtype=dtype)

    def forward(self, t):
        """Timestep -> (n*D modulation, D embedded timestep): sinusoid(256)
        -> Linear -> SiLU -> Linear, then SiLU -> Linear."""
        emb = get_timestep_embedding(t, 256)
        emb = self.emb.linear_1(emb.to(self.emb.linear_1.weight.dtype))
        embedded = self.emb.linear_2(silu(emb))
        return self.linear(silu(embedded)), embedded


def _ada_values(table, ts_emb, start: int):
    """(shift, scale, gate) f32 from a block's (6, D) table and the
    (B, T', 6, D) timestep modulation."""
    vals = table[None, None, start:start + 3] + ts_emb[:, :, start:start + 3].float()
    return vals[:, :, 0], vals[:, :, 1], vals[:, :, 2]


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, dtype):
        super().__init__()
        d = cfg.inner_dim
        self.norm_eps = cfg.norm_eps
        args = (cfg.num_heads, cfg.head_dim, cfg.norm_eps, device, dtype)
        self.attn1 = Attention(d, d, d, *args)
        self.attn2 = Attention(d, cfg.cross_attention_dim, d, *args)
        self.ff = FeedForward(d, cfg.ffn_dim, device, dtype)
        self.scale_shift_table = param(6, d, device=device)

    def reset_parameters(self, gen):
        self.scale_shift_table.zero_()

    def forward(self, x, context, ts_emb, rope, bias, skip_self_attn=None,
                skip_ff=None, cross_attn_scale=None):
        """skip_self_attn / skip_ff: None or (B,) bool, the rows whose
        self-attention (feed-forward) this block skips (STG). The skipped
        row's branch is still computed and then replaced by its input, so
        the work does not depend on the skips. cross_attn_scale: None or a
        scalar that multiplies the cross-attention's output."""
        eps = self.norm_eps
        table = self.scale_shift_table.float()
        dtype = x.dtype

        shift, scale, gate = _ada_values(table, ts_emb, 0)
        normed = adaln(x, scale.to(dtype), shift.to(dtype), eps=eps)
        x_attn = x + self.attn1(normed, normed, rope=rope) * gate.to(dtype)
        if skip_self_attn is not None:
            x_attn = torch.where(skip_self_attn[:, None, None], x, x_attn)
        x = x_attn

        # cross-attention has no pre-norm (q_norm inside handles Q)
        cross = self.attn2(x, context, bias=bias)
        if cross_attn_scale is not None:
            cross = cross * torch.as_tensor(cross_attn_scale, dtype=dtype,
                                            device=cross.device)
        x = x + cross

        shift, scale, gate = _ada_values(table, ts_emb, 3)
        normed = adaln(x, scale.to(dtype), shift.to(dtype), eps=eps)
        x_ff = x + self.ff(normed) * gate.to(dtype)
        if skip_ff is not None:
            x_ff = torch.where(skip_ff[:, None, None], x, x_ff)
        return x_ff


class LTXTransformer(nn.Module):
    """The video DiT. Parameter names follow ltx_tpu.models.dit.init_params;
    the JAX tree's stacked `blocks` axis is the ModuleList index here."""

    def __init__(self, cfg: TransformerConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        d = cfg.inner_dim
        self.patchify_proj = Linear(cfg.in_channels, d, device=device, dtype=dtype)
        self.adaln_single = AdaLNSingle(d, device, dtype)
        self.caption_projection = TwoLinear(cfg.caption_channels, d, d, device, dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, device, dtype) for _ in range(cfg.num_layers))
        self.proj_out = Linear(d, cfg.out_channels, device=device, dtype=dtype)
        self.scale_shift_table = param(2, d, device=device)

    def reset_parameters(self, gen):
        self.scale_shift_table.zero_()

    def prepare_timestep(self, timesteps, batch: int, dtype):
        """(B,) or (B, T) sigmas -> ((B, T', 6, D), (B, T', D)), T' in {1, T}."""
        d = self.cfg.inner_dim
        scaled = timesteps.float() * self.cfg.timestep_scale_multiplier
        ada, embedded = self.adaln_single(scaled.reshape(-1))
        return (ada.reshape(batch, -1, 6, d).to(dtype),
                embedded.reshape(batch, -1, d).to(dtype))

    def caption_projection_forward(self, context):
        p = self.caption_projection
        return p.linear_2(gelu_tanh(p.linear_1(context)))

    def output_head(self, x, embedded_ts):
        return output_head(x, self.scale_shift_table, embedded_ts, self.proj_out,
                           self.cfg.norm_eps)

    def forward(self, latent, context, timesteps, rope, context_bias=None,
                remat: bool = False, remat_segments: int = 0,
                skip_self_attn=None, skip_ff=None, cross_attn_scale=None):
        """Velocity prediction.

        latent: (B, T, C) patchified tokens; context: (B, S, caption
        channels); timesteps: (B,) or (B, T) sigmas in [0, 1]; rope: (cos,
        sin) each (H, T, head_dim / 2) f32; context_bias: (B, 1, 1, S)
        additive key bias or None. Returns (B, T, C). skip_self_attn,
        skip_ff: None or (L, B) bool per block and row (`stg_skip_masks`);
        cross_attn_scale: None, a scalar or (L,) per block.

        While autograd records: remat=True checkpoints each block (its
        activations are recomputed in the backward, one extra forward);
        remat_segments=S > 1 (which wins over remat) checkpoints S groups of
        num_layers / S blocks with each block inside checkpointed too, as
        the reference's segmented remat (two extra forwards; S must divide
        num_layers)."""
        b = latent.shape[0]
        dtype = latent.dtype
        x = self.patchify_proj(latent)
        ts_emb, embedded_ts = self.prepare_timestep(timesteps, b, dtype)
        ctx = self.caption_projection_forward(context.to(dtype))
        ctx = ctx.reshape(b, -1, self.cfg.inner_dim)
        args = (ctx, ts_emb, rope, context_bias)
        blocks = list(self.blocks)
        extras = [()] * len(blocks)
        if skip_self_attn is not None or skip_ff is not None \
                or cross_attn_scale is not None:
            scales = None
            if cross_attn_scale is not None:
                scales = torch.as_tensor(cross_attn_scale, dtype=torch.float32,
                                         device=x.device).broadcast_to(len(blocks))
            extras = [(None if skip_self_attn is None else skip_self_attn[i],
                       None if skip_ff is None else skip_ff[i],
                       None if scales is None else scales[i])
                      for i in range(len(blocks))]
        if remat_segments and remat_segments > 1:
            if len(blocks) % remat_segments:
                raise ValueError(f"remat_segments {remat_segments} must divide "
                                 f"num_layers {len(blocks)}")
            per = len(blocks) // remat_segments
            for i in range(0, len(blocks), per):
                # each block inside the segment checkpointed too
                x = _remat(_run_blocks, blocks[i:i + per], extras[i:i + per], x, *args, True,
                           remat=True)
        else:
            x = _run_blocks(blocks, extras, x, *args, remat=remat)
        return self.output_head(x, embedded_ts)


def output_head(x, table, embedded_ts, proj_out, eps: float):
    """Final AdaLN: affine-free LayerNorm modulated by the (2, D) table plus
    the embedded timestep, then the projection."""
    dtype = x.dtype
    vals = table.float()[None, None] + embedded_ts[:, :, None].float()
    shift, scale = vals[:, :, 0].to(dtype), vals[:, :, 1].to(dtype)
    out = layer_norm_no_affine(x, eps=eps)
    out = out * (1 + scale) + shift
    return proj_out(out)


def _remat(fn, *args, remat: bool = False):
    """fn(*args), checkpointed when `remat` and autograd records."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _run_blocks(blocks, extras, x, ctx, ts_emb, rope, bias, remat: bool = False):
    """extras: per block, () or its (skip_self_attn, skip_ff, cross_attn_scale)."""
    for block, extra in zip(blocks, extras):
        x = _remat(block, x, ctx, ts_emb, rope, bias, *extra, remat=remat)
    return x


def stg_skip_masks(cfg: TransformerConfig, batch: int, stg_blocks, perturbed_rows,
                   skip_ff_too: bool = False, device=None):
    """(L, B) bool skip masks: the rows in `perturbed_rows` skip
    self-attention (and, with skip_ff_too, the feed-forward) in
    `stg_blocks`, so that the STG-perturbed row batches with the others."""
    sa = np.zeros((cfg.num_layers, batch), bool)
    for blk in stg_blocks:
        for row in perturbed_rows:
            sa[blk, row] = True
    ff = sa if skip_ff_too else np.zeros_like(sa)
    return (torch.from_numpy(sa).to(device), torch.from_numpy(ff).to(device))


@torch.no_grad()
def quantize_transformer(module: nn.Module, bits: int, group_size: int = 64,
                         device=None, w8a8: bool = False) -> nn.Module:
    """Quantize, in place, every large linear under `module.blocks`
    (`quantize_linears`), as the reference's quantize_transformer_params
    quantizes the tree: group-wise to `bits`, or with w8a8 per output
    channel to W8A8 (bits unused). Everything outside the blocks stays.
    Returns `module`."""
    quantize_linears(module.blocks, bits, group_size, device, w8a8=w8a8)
    return module


@torch.no_grad()
def quantize_linears(root: nn.Module, bits: int, group_size: int = 64,
                     device=None, w8a8: bool = False) -> nn.Module:
    """Each Linear under `root` named in QUANTIZABLE_LEAVES with d_in *
    d_out >= _MIN_QUANT_SIZE and d_in % group_size == 0 becomes a
    QuantizedLinear (a W8A8Linear with w8a8), in place, one layer at a time,
    quantized on `device` (default: where the layer lives) and kept where
    the layer lived; norms and tables stay. Returns `root`."""
    targets = [(parent, name, child)
               for parent in root.modules()
               for name, child in parent.named_children()
               if name in QUANTIZABLE_LEAVES and isinstance(child, Linear)
               and child.weight.numel() >= _MIN_QUANT_SIZE
               and child.weight.shape[1] % group_size == 0]
    for parent, name, child in targets:
        setattr(parent, name, W8A8Linear.from_linear(child, device) if w8a8 else
                QuantizedLinear.from_linear(child, bits, group_size, device))
    return root
