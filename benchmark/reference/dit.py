"""The video DiT and the dual audio-video DiT, plain.

Video block: weightless-RMSNorm AdaLN -> self-attention (QK RMSNorm over the
flat heads, then 3D split RoPE) gated, text cross-attention (no pre-norm),
AdaLN -> GELU(tanh) feed-forward gated; a per-block (6, D) table plus the
timestep modulation. Dual block: the video stream's phases with weighted
norms, the audio stream's at its own width, then audio-to-video and
video-to-audio attention on temporal 1D RoPE, gated by 5-value tables.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.layers import (
    Linear,
    Module,
    NormWeight,
    apply_split_rope,
    attention,
    create_audio_position_grid,
    create_position_grid,
    empty,
    gelu_tanh,
    layer_norm_no_affine,
    rms_norm,
    silu,
    split_rope_tables,
    timestep_embedding,
)


class Attention(Module):
    def __init__(self, query_dim, context_dim, inner_dim, heads, head_dim, eps):
        super().__init__()
        self.heads, self.head_dim, self.eps = heads, head_dim, eps
        self.to_q = Linear(query_dim, inner_dim)
        self.to_k = Linear(context_dim, inner_dim)
        self.to_v = Linear(context_dim, inner_dim)
        self.to_out = Linear(inner_dim, query_dim)
        self.q_norm = NormWeight(inner_dim)
        self.k_norm = NormWeight(inner_dim)

    def forward(self, x, context, bias=None, rope=None, k_rope=None):
        b, tq, _ = x.shape
        tk = context.shape[1]
        h, d = self.heads, self.head_dim
        q = rms_norm(self.to_q(x), self.q_norm.weight, self.eps)
        k = rms_norm(self.to_k(context), self.k_norm.weight, self.eps)
        v = self.to_v(context)
        if rope is not None:
            q = apply_split_rope(q, *rope)
            k = apply_split_rope(k, *(k_rope if k_rope is not None else rope))
        q = q.reshape(b, tq, h, d).transpose(1, 2)
        k = k.reshape(b, tk, h, d).transpose(1, 2)
        v = v.reshape(b, tk, h, d).transpose(1, 2)
        out = attention(q, k, v, bias=bias, module=self)
        return self.to_out(out.transpose(1, 2).reshape(b, tq, h * d))


class FeedForward(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.project_in = Linear(dim, hidden)
        self.project_out = Linear(hidden, dim)

    def forward(self, x):
        return self.project_out(gelu_tanh(self.project_in(x)))


class TwoLinear(nn.Module):
    def __init__(self, d_in, d_hidden, d_out):
        super().__init__()
        self.linear_1 = Linear(d_in, d_hidden)
        self.linear_2 = Linear(d_hidden, d_out)


class AdaLNSingle(nn.Module):
    def __init__(self, d, n: int = 6):
        super().__init__()
        self.emb = TwoLinear(256, d, d)
        self.linear = Linear(d, n * d)

    def forward(self, t):
        """Scaled timestep -> (n*D modulation, D embedded timestep)."""
        emb = self.emb.linear_1(timestep_embedding(t, 256))
        embedded = self.emb.linear_2(silu(emb))
        return self.linear(silu(embedded)), embedded


def _table(table, emb, start: int, n: int):
    vals = table.float()[None, None, start:start + n] + emb[:, :, start:start + n].float()
    return [vals[:, :, i] for i in range(n)]


def output_head(x, table, embedded, proj_out, eps):
    vals = table.float()[None, None] + embedded[:, :, None].float()
    out = layer_norm_no_affine(x, eps) * (1 + vals[:, :, 1]) + vals[:, :, 0]
    return proj_out(out)


class Block(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, heads, hd, eps = cfg["inner_dim"], cfg["num_heads"], cfg["head_dim"], cfg["norm_eps"]
        self.eps = eps
        self.attn1 = Attention(d, d, d, heads, hd, eps)
        self.attn2 = Attention(d, cfg["cross_attention_dim"], d, heads, hd, eps)
        self.ff = FeedForward(d, cfg["ffn_dim"])
        self.scale_shift_table = empty(6, d)

    def forward(self, x, ctx, ts_emb, rope, bias):
        shift, scale, gate = _table(self.scale_shift_table, ts_emb, 0, 3)
        normed = rms_norm(x, eps=self.eps) * (1 + scale) + shift
        x = x + self.attn1(normed, normed, rope=rope) * gate
        x = x + self.attn2(x, ctx, bias=bias)
        shift, scale, gate = _table(self.scale_shift_table, ts_emb, 3, 3)
        normed = rms_norm(x, eps=self.eps) * (1 + scale) + shift
        return x + self.ff(normed) * gate


def _prepare(proj, adaln, caption, latent, context, timesteps, d, multiplier):
    """Tokens, the (B, T', n, D) modulation, the embedded timestep, the
    projected context and the scaled timesteps of one stream."""
    b = latent.shape[0]
    x = proj(latent)
    scaled = timesteps.float() * multiplier
    ada, embedded = adaln(scaled.reshape(-1))
    ctx = caption.linear_2(gelu_tanh(caption.linear_1(context)))
    return (x, ada.reshape(b, -1, ada.shape[-1] // d, d), embedded.reshape(b, -1, d),
            ctx.reshape(b, -1, d), scaled)


class VideoDiT(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        d = cfg["inner_dim"]
        self.patchify_proj = Linear(cfg["in_channels"], d)
        self.adaln_single = AdaLNSingle(d)
        self.caption_projection = TwoLinear(cfg["caption_channels"], d, d)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg["num_layers"]))
        self.proj_out = Linear(d, cfg["out_channels"])
        self.scale_shift_table = empty(2, d)

    def forward(self, latent, context, timesteps, rope, bias):
        cfg = self.cfg
        x, ts_emb, embedded, ctx, _ = _prepare(
            self.patchify_proj, self.adaln_single, self.caption_projection, latent, context,
            timesteps, cfg["inner_dim"], cfg["timestep_scale_multiplier"])
        for block in self.blocks:
            x = block(x, ctx, ts_emb, rope, bias)
        return output_head(x, self.scale_shift_table, embedded, self.proj_out, cfg["norm_eps"])


def video_rope(cfg: dict, frames: int, height: int, width: int, fps: float, device):
    grid = create_position_grid(frames, height, width, fps=fps)
    cos, sin = split_rope_tables(grid, cfg["inner_dim"], cfg["rope_theta"], cfg["max_pos"],
                                 cfg["num_heads"])
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def av_ropes(cfg: dict, frames: int, height: int, width: int, audio_frames: int, fps: float,
             device):
    """(video 3D, audio 1D, cross-video 1D, cross-audio 1D) tables; the
    cross-modal ones on temporal coordinates at the audio inner dim."""
    da, ha = cfg["audio_inner_dim"], cfg["audio_num_heads"]
    audio_grid = create_audio_position_grid(audio_frames)
    video_grid = create_position_grid(frames, height, width, fps=fps)
    tables = (
        split_rope_tables(video_grid, cfg["inner_dim"], cfg["rope_theta"], cfg["max_pos"],
                          cfg["num_heads"]),
        split_rope_tables(audio_grid, da, cfg["rope_theta"], cfg["audio_max_pos"], ha),
        split_rope_tables(video_grid[0:1], da, cfg["rope_theta"], cfg["audio_max_pos"], ha),
        split_rope_tables(audio_grid, da, cfg["rope_theta"], cfg["audio_max_pos"], ha),
    )
    return tuple((torch.from_numpy(c).to(device), torch.from_numpy(s).to(device))
                 for c, s in tables)


class AVBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dv, da, eps = cfg["inner_dim"], cfg["audio_inner_dim"], cfg["norm_eps"]
        video = (cfg["num_heads"], cfg["head_dim"], eps)
        audio = (cfg["audio_num_heads"], cfg["audio_head_dim"], eps)
        self.eps = eps
        self.norm1, self.norm2, self.norm3 = NormWeight(dv), NormWeight(dv), NormWeight(dv)
        self.attn1 = Attention(dv, dv, dv, *video)
        self.attn2 = Attention(dv, cfg["cross_attention_dim"], dv, *video)
        self.ff = FeedForward(dv, cfg["ffn_dim"])
        self.scale_shift_table = empty(6, dv)
        self.audio_norm1, self.audio_norm2 = NormWeight(da), NormWeight(da)
        self.audio_norm3 = NormWeight(da)
        self.audio_attn1 = Attention(da, da, da, *audio)
        self.audio_attn2 = Attention(da, da, da, *audio)
        self.audio_ff = FeedForward(da, 4 * da)
        self.audio_scale_shift_table = empty(6, da)
        self.audio_to_video_norm = NormWeight(dv)
        self.audio_to_video_attn = Attention(dv, da, da, *audio)
        self.video_to_audio_norm = NormWeight(da)
        self.video_to_audio_attn = Attention(da, dv, da, *audio)
        self.scale_shift_table_a2v_ca_video = empty(5, dv)
        self.scale_shift_table_a2v_ca_audio = empty(5, da)

    def forward(self, vx, ax, ctx_v, ctx_a, ts_v, ts_a, cross_v, cross_a, ropes, bias):
        eps = self.eps
        v_rope, a_rope, cv_rope, ca_rope = ropes
        v_sh, v_sc, v_g, v_sh2, v_sc2, v_g2 = _table(self.scale_shift_table, ts_v, 0, 6)
        a_sh, a_sc, a_g, a_sh2, a_sc2, a_g2 = _table(self.audio_scale_shift_table, ts_a, 0, 6)
        normed = rms_norm(vx, self.norm1.weight, eps) * (1 + v_sc) + v_sh
        vx = vx + v_g * self.attn1(normed, normed, rope=v_rope)
        normed = rms_norm(ax, self.audio_norm1.weight, eps) * (1 + a_sc) + a_sh
        ax = ax + a_g * self.audio_attn1(normed, normed, rope=a_rope)
        vx = vx + self.attn2(rms_norm(vx, self.norm2.weight, eps), ctx_v, bias=bias)
        ax = ax + self.audio_attn2(rms_norm(ax, self.audio_norm2.weight, eps), ctx_a, bias=bias)
        v_a2v_sc, v_a2v_sh, v_v2a_sc, v_v2a_sh, v_a2v_g = _table(
            self.scale_shift_table_a2v_ca_video, cross_v, 0, 5)
        a_a2v_sc, a_a2v_sh, a_v2a_sc, a_v2a_sh, a_v2a_g = _table(
            self.scale_shift_table_a2v_ca_audio, cross_a, 0, 5)
        norm_v = rms_norm(vx, self.audio_to_video_norm.weight, eps)
        norm_a = rms_norm(ax, self.video_to_audio_norm.weight, eps)
        a2v = self.audio_to_video_attn(norm_v * (1 + v_a2v_sc) + v_a2v_sh,
                                       norm_a * (1 + a_a2v_sc) + a_a2v_sh,
                                       rope=cv_rope, k_rope=ca_rope)
        vx = vx + a2v * v_a2v_g
        v2a = self.video_to_audio_attn(norm_a * (1 + a_v2a_sc) + a_v2a_sh,
                                       norm_v * (1 + v_v2a_sc) + v_v2a_sh,
                                       rope=ca_rope, k_rope=cv_rope)
        ax = ax + v2a * a_v2a_g
        normed = rms_norm(vx, self.norm3.weight, eps) * (1 + v_sc2) + v_sh2
        vx = vx + v_g2 * self.ff(normed)
        normed = rms_norm(ax, self.audio_norm3.weight, eps) * (1 + a_sc2) + a_sh2
        return vx, ax + a_g2 * self.audio_ff(normed)


class AVDiT(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        dv, da = cfg["inner_dim"], cfg["audio_inner_dim"]
        self.patchify_proj = Linear(cfg["in_channels"], dv)
        self.adaln_single = AdaLNSingle(dv)
        self.caption_projection = TwoLinear(cfg["caption_channels"], dv, dv)
        self.proj_out = Linear(dv, cfg["out_channels"])
        self.scale_shift_table = empty(2, dv)
        self.audio_patchify_proj = Linear(cfg["audio_in_channels"], da)
        self.audio_adaln_single = AdaLNSingle(da)
        self.audio_caption_projection = TwoLinear(cfg["caption_channels"], da, da)
        self.audio_proj_out = Linear(da, cfg["audio_out_channels"])
        self.audio_scale_shift_table = empty(2, da)
        self.av_ca_video_scale_shift_adaln_single = AdaLNSingle(dv, n=4)
        self.av_ca_a2v_gate_adaln_single = AdaLNSingle(dv, n=1)
        self.av_ca_audio_scale_shift_adaln_single = AdaLNSingle(da, n=4)
        self.av_ca_v2a_gate_adaln_single = AdaLNSingle(da, n=1)
        self.blocks = nn.ModuleList(AVBlock(cfg) for _ in range(cfg["num_layers"]))

    def _cross(self, ss_mod, gate_mod, scaled, d):
        b = scaled.shape[0]
        ss, _ = ss_mod(scaled.reshape(-1))
        gate, _ = gate_mod(scaled.reshape(-1))
        return torch.cat([ss.reshape(b, -1, 4, d), gate.reshape(b, -1, 1, d)], dim=2)

    def forward(self, v_lat, a_lat, v_ctx, a_ctx, ts_v, ts_a, ropes, bias):
        cfg = self.cfg
        dv, da, mult = cfg["inner_dim"], cfg["audio_inner_dim"], cfg["timestep_scale_multiplier"]
        vx, v_mod, emb_v, ctx_v, scaled_v = _prepare(
            self.patchify_proj, self.adaln_single, self.caption_projection, v_lat, v_ctx,
            ts_v, dv, mult)
        ax, a_mod, emb_a, ctx_a, scaled_a = _prepare(
            self.audio_patchify_proj, self.audio_adaln_single, self.audio_caption_projection,
            a_lat, a_ctx, ts_a, da, mult)
        cross_v = self._cross(self.av_ca_video_scale_shift_adaln_single,
                              self.av_ca_a2v_gate_adaln_single, scaled_v, dv)
        cross_a = self._cross(self.av_ca_audio_scale_shift_adaln_single,
                              self.av_ca_v2a_gate_adaln_single, scaled_a, da)
        for block in self.blocks:
            vx, ax = block(vx, ax, ctx_v, ctx_a, v_mod, a_mod, cross_v, cross_a, ropes, bias)
        eps = cfg["norm_eps"]
        return (output_head(vx, self.scale_shift_table, emb_v, self.proj_out, eps),
                output_head(ax, self.audio_scale_shift_table, emb_a, self.audio_proj_out, eps))
