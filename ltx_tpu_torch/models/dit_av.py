"""The dual audio-video diffusion transformer.

Port of ltx_tpu/models/dit_av.py. Each of the 48 blocks runs 8 phases:
video self-attention, audio self-attention, video text cross-attention,
audio text cross-attention, audio-to-video attention (gated), video-to-audio
attention (gated), video feed-forward, audio feed-forward. Unlike the video
block (weightless AdaLN), the dual block's norms norm1/2/3 and
audio_norm1/2/3 carry weights. The cross-modal attentions align the streams
on time: both sides use temporal-only 1D RoPE at the audio inner dim.

The pieces that are the video DiT's are its modules (`Attention`,
`FeedForward`, `AdaLNSingle`, the caption projection, the output head), so
every norm goes through `ops.normalization.rms_norm` (the rms_norm kernel on
the card where the width allows) and every attention through
`ops.attention.sdpa` (the flash-attention kernel on the card: head dim 128
for the video self and text attentions, 64 for the other four). The blocks
are an nn.ModuleList run in a Python loop; parameter names follow
ltx_tpu.models.dit_av.init_params. The reference's rematerialisation is
ported for the AV train step (`forward(remat=, remat_segments=)`, as the
video DiT's); both default to off, so inference records nothing extra.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from ltx_tpu_torch.config import TransformerConfig
from ltx_tpu_torch.models.common import Linear, NormWeight, gelu_tanh, param
from ltx_tpu_torch.models.dit import (
    AdaLNSingle,
    Attention,
    FeedForward,
    TwoLinear,
    _remat,
    output_head,
)
from ltx_tpu_torch.ops import rope as rope_ops
from ltx_tpu_torch.ops.normalization import rms_norm


def prepare_av_ropes(cfg: TransformerConfig, frames: int, height: int, width: int,
                     audio_frames: int, fps: float = 24.0, device=None):
    """(video 3D, audio 1D, cross-video 1D, cross-audio 1D) (cos, sin)
    tables, f32 tensors on `device`, computed in float64 on the host. The
    cross-modal tables use temporal-only coordinates at the audio inner dim
    with the audio max_pos."""
    video = rope_ops.video_rope(frames, height, width, cfg.inner_dim, cfg.num_heads,
                                theta=cfg.rope_theta, max_pos=cfg.max_pos, fps=fps)
    audio_grid = rope_ops.create_audio_position_grid(audio_frames)
    audio = rope_ops.precompute_freqs_cis(audio_grid, cfg.audio_inner_dim,
                                          theta=cfg.rope_theta, max_pos=cfg.audio_max_pos,
                                          num_heads=cfg.audio_num_heads)
    video_grid = rope_ops.create_position_grid(frames, height, width, fps=fps)
    cross_video = rope_ops.precompute_freqs_cis(
        video_grid[0:1], cfg.audio_cross_attention_dim, theta=cfg.rope_theta,
        max_pos=cfg.audio_max_pos, num_heads=cfg.audio_num_heads)
    cross_audio = rope_ops.precompute_freqs_cis(
        audio_grid, cfg.audio_cross_attention_dim, theta=cfg.rope_theta,
        max_pos=cfg.audio_max_pos, num_heads=cfg.audio_num_heads)
    return tuple((torch.from_numpy(c).to(device), torch.from_numpy(s).to(device))
                 for c, s in (video, audio, cross_video, cross_audio))


def _modulated(norm: NormWeight, x, scale, shift, eps: float):
    """The learnable RMSNorm, then (1 + scale) and + shift."""
    return rms_norm(x, norm.weight, eps=eps) * (1 + scale) + shift


def _table_values(table, emb, n: int, dtype):
    """n (B, T', D) tensors of a block's (n, D) f32 table plus its (B, T',
    n, D) timestep modulation, added in f32 and cast to the stream's dtype."""
    vals = table.float()[None, None] + emb.float()
    return [vals[:, :, i].to(dtype) for i in range(n)]


class AVBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, dtype):
        super().__init__()
        dv, da = cfg.inner_dim, cfg.audio_inner_dim
        self.norm_eps = cfg.norm_eps
        video = (cfg.num_heads, cfg.head_dim, cfg.norm_eps, device, dtype)
        audio = (cfg.audio_num_heads, cfg.audio_head_dim, cfg.norm_eps, device, dtype)

        def norm(d):
            return NormWeight(d, 1.0, device=device, dtype=dtype)

        self.norm1 = norm(dv)
        self.attn1 = Attention(dv, dv, dv, *video)
        self.norm2 = norm(dv)
        self.attn2 = Attention(dv, cfg.cross_attention_dim, dv, *video)
        self.norm3 = norm(dv)
        self.ff = FeedForward(dv, cfg.ffn_dim, device, dtype)
        self.scale_shift_table = param(6, dv, device=device)
        self.audio_norm1 = norm(da)
        self.audio_attn1 = Attention(da, da, da, *audio)
        self.audio_norm2 = norm(da)
        self.audio_attn2 = Attention(da, cfg.audio_cross_attention_dim, da, *audio)
        self.audio_norm3 = norm(da)
        self.audio_ff = FeedForward(da, 4 * da, device, dtype)
        self.audio_scale_shift_table = param(6, da, device=device)
        # the cross-modal attentions, both at the audio inner dim
        self.audio_to_video_norm = norm(dv)
        self.audio_to_video_attn = Attention(dv, da, da, *audio)
        self.video_to_audio_norm = norm(da)
        self.video_to_audio_attn = Attention(da, dv, da, *audio)
        self.scale_shift_table_a2v_ca_video = param(5, dv, device=device)
        self.scale_shift_table_a2v_ca_audio = param(5, da, device=device)

    def reset_parameters(self, gen):
        for table in (self.scale_shift_table, self.audio_scale_shift_table,
                      self.scale_shift_table_a2v_ca_video,
                      self.scale_shift_table_a2v_ca_audio):
            table.zero_()

    def forward(self, video_x, audio_x, ctx_v, ctx_a, ts_v, ts_a, cross_v_ss, cross_a_ss,
                ropes, bias_v, bias_a):
        """One dual block, its 8 phases in the reference's order."""
        eps = self.norm_eps
        video_rope, audio_rope, cross_v_rope, cross_a_rope = ropes
        dt = video_x.dtype
        v_sh, v_sc, v_g, v_sh2, v_sc2, v_g2 = _table_values(self.scale_shift_table, ts_v, 6, dt)
        a_sh, a_sc, a_g, a_sh2, a_sc2, a_g2 = _table_values(
            self.audio_scale_shift_table, ts_a, 6, dt)

        # 1-2: self-attention
        normed = _modulated(self.norm1, video_x, v_sc, v_sh, eps)
        video_x = video_x + v_g * self.attn1(normed, normed, rope=video_rope)
        normed = _modulated(self.audio_norm1, audio_x, a_sc, a_sh, eps)
        audio_x = audio_x + a_g * self.audio_attn1(normed, normed, rope=audio_rope)

        # 3-4: text cross-attention (the norm without modulation)
        normed = rms_norm(video_x, self.norm2.weight, eps=eps)
        video_x = video_x + self.attn2(normed, ctx_v, bias=bias_v)
        normed = rms_norm(audio_x, self.audio_norm2.weight, eps=eps)
        audio_x = audio_x + self.audio_attn2(normed, ctx_a, bias=bias_a)

        # 5-6: cross-modal, from 5-value tables and the global cross-modal
        # modulation
        v_a2v_sc, v_a2v_sh, v_v2a_sc, v_v2a_sh, v_a2v_g = _table_values(
            self.scale_shift_table_a2v_ca_video, cross_v_ss, 5, dt)
        a_a2v_sc, a_a2v_sh, a_v2a_sc, a_v2a_sh, a_v2a_g = _table_values(
            self.scale_shift_table_a2v_ca_audio, cross_a_ss, 5, dt)
        norm_v = rms_norm(video_x, self.audio_to_video_norm.weight, eps=eps)
        norm_a = rms_norm(audio_x, self.video_to_audio_norm.weight, eps=eps)

        a2v = self.audio_to_video_attn(norm_v * (1 + v_a2v_sc) + v_a2v_sh,
                                       norm_a * (1 + a_a2v_sc) + a_a2v_sh,
                                       rope=cross_v_rope, k_rope=cross_a_rope)
        video_x = video_x + a2v * v_a2v_g
        v2a = self.video_to_audio_attn(norm_a * (1 + a_v2a_sc) + a_v2a_sh,
                                       norm_v * (1 + v_v2a_sc) + v_v2a_sh,
                                       rope=cross_a_rope, k_rope=cross_v_rope)
        audio_x = audio_x + v2a * a_v2a_g

        # 7-8: feed-forward
        normed = _modulated(self.norm3, video_x, v_sc2, v_sh2, eps)
        video_x = video_x + v_g2 * self.ff(normed)
        normed = _modulated(self.audio_norm3, audio_x, a_sc2, a_sh2, eps)
        audio_x = audio_x + a_g2 * self.audio_ff(normed)
        return video_x, audio_x


class LTXAVTransformer(nn.Module):
    """The dual audio-video DiT. Parameter names follow
    ltx_tpu.models.dit_av.init_params; the JAX tree's stacked `blocks` axis
    is the ModuleList index here."""

    def __init__(self, cfg: TransformerConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        dv, da = cfg.inner_dim, cfg.audio_inner_dim
        self.patchify_proj = Linear(cfg.in_channels, dv, device=device, dtype=dtype)
        self.adaln_single = AdaLNSingle(dv, device, dtype)
        self.caption_projection = TwoLinear(cfg.caption_channels, dv, dv, device, dtype)
        self.proj_out = Linear(dv, cfg.out_channels, device=device, dtype=dtype)
        self.scale_shift_table = param(2, dv, device=device)
        self.audio_patchify_proj = Linear(cfg.audio_in_channels, da, device=device,
                                          dtype=dtype)
        self.audio_adaln_single = AdaLNSingle(da, device, dtype)
        self.audio_caption_projection = TwoLinear(cfg.caption_channels, da, da, device,
                                                  dtype)
        self.audio_proj_out = Linear(da, cfg.audio_out_channels, device=device, dtype=dtype)
        self.audio_scale_shift_table = param(2, da, device=device)
        self.av_ca_video_scale_shift_adaln_single = AdaLNSingle(dv, device, dtype, n=4)
        self.av_ca_a2v_gate_adaln_single = AdaLNSingle(dv, device, dtype, n=1)
        self.av_ca_audio_scale_shift_adaln_single = AdaLNSingle(da, device, dtype, n=4)
        self.av_ca_v2a_gate_adaln_single = AdaLNSingle(da, device, dtype, n=1)
        self.blocks = nn.ModuleList(AVBlock(cfg, device, dtype) for _ in range(cfg.num_layers))

    def reset_parameters(self, gen):
        self.scale_shift_table.zero_()
        self.audio_scale_shift_table.zero_()

    def _prepare_stream(self, proj, adaln, caption, latent, context, timesteps, d, batch,
                        dtype):
        """Tokens, the (B, T', 6, D) modulation, the embedded timestep, the
        projected context and the scaled timesteps of one stream."""
        x = proj(latent)
        scaled = timesteps.float() * self.cfg.timestep_scale_multiplier
        ada, embedded = adaln(scaled.reshape(-1))
        ctx = caption.linear_2(gelu_tanh(caption.linear_1(context.to(dtype))))
        return (x, ada.reshape(batch, -1, 6, d).to(dtype),
                embedded.reshape(batch, -1, d).to(dtype), ctx.reshape(batch, -1, d), scaled)

    def cross_modal_modulation(self, scaled_v, scaled_a, batch: int, dtype):
        """Per-token cross-modal modulation of each stream: 4 scales and
        shifts and 1 gate, (B, T', 5, D)."""
        dv, da = self.cfg.inner_dim, self.cfg.audio_inner_dim
        ss_v, _ = self.av_ca_video_scale_shift_adaln_single(scaled_v.reshape(-1))
        gate_v, _ = self.av_ca_a2v_gate_adaln_single(scaled_v.reshape(-1))
        cross_v = torch.cat([ss_v.reshape(batch, -1, 4, dv),
                             gate_v.reshape(batch, -1, 1, dv)], dim=2).to(dtype)
        ss_a, _ = self.av_ca_audio_scale_shift_adaln_single(scaled_a.reshape(-1))
        gate_a, _ = self.av_ca_v2a_gate_adaln_single(scaled_a.reshape(-1))
        cross_a = torch.cat([ss_a.reshape(batch, -1, 4, da),
                             gate_a.reshape(batch, -1, 1, da)], dim=2).to(dtype)
        return cross_v, cross_a

    def forward(self, video_latent, audio_latent, video_context, audio_context,
                video_timesteps, audio_timesteps, ropes, video_bias=None, audio_bias=None,
                remat: bool = False, remat_segments: int = 0):
        """(video velocity (B, Tv, C), audio velocity (B, Ta, C_audio)).

        video_latent (B, Tv, C) patchified; audio_latent (B, Ta, C_audio)
        packed (`pack_audio_latents`); contexts (B, S, caption channels);
        timesteps (B,) or (B, T) sigmas per stream; ropes from
        `prepare_av_ropes`; biases (B, 1, 1, S) additive key biases or None.

        While autograd records: remat=True checkpoints each dual block;
        remat_segments=S > 1 (which wins over remat) checkpoints S groups of
        num_layers / S blocks, each block inside checkpointed too, as the
        video DiT's `LTXTransformer.forward` (S must divide num_layers)."""
        b = video_latent.shape[0]
        dt = video_latent.dtype
        dv, da = self.cfg.inner_dim, self.cfg.audio_inner_dim
        video_x, ts_v, emb_v, ctx_v, scaled_v = self._prepare_stream(
            self.patchify_proj, self.adaln_single, self.caption_projection, video_latent,
            video_context, video_timesteps, dv, b, dt)
        audio_x, ts_a, emb_a, ctx_a, scaled_a = self._prepare_stream(
            self.audio_patchify_proj, self.audio_adaln_single, self.audio_caption_projection,
            audio_latent, audio_context, audio_timesteps, da, b, dt)
        cross_v, cross_a = self.cross_modal_modulation(scaled_v, scaled_a, b, dt)
        args = (ctx_v, ctx_a, ts_v, ts_a, cross_v, cross_a, ropes, video_bias, audio_bias)
        blocks = list(self.blocks)
        if remat_segments and remat_segments > 1:
            if len(blocks) % remat_segments:
                raise ValueError(f"remat_segments {remat_segments} must divide "
                                 f"num_layers {len(blocks)}")
            per = len(blocks) // remat_segments
            for i in range(0, len(blocks), per):
                video_x, audio_x = _remat(partial(_run_av_blocks, remat=True),
                                          blocks[i:i + per], video_x, audio_x, *args,
                                          remat=True)
        else:
            video_x, audio_x = _run_av_blocks(blocks, video_x, audio_x, *args, remat=remat)
        eps = self.cfg.norm_eps
        return (output_head(video_x, self.scale_shift_table, emb_v, self.proj_out, eps),
                output_head(audio_x, self.audio_scale_shift_table, emb_a,
                            self.audio_proj_out, eps))


def _run_av_blocks(blocks, video_x, audio_x, *args, remat: bool = False):
    """The dual blocks in order, each checkpointed when `remat`."""
    for block in blocks:
        video_x, audio_x = _remat(block, video_x, audio_x, *args, remat=remat)
    return video_x, audio_x


def pack_audio_latents(audio):
    """(B, 8, T, 16) -> (B, T, 128)."""
    b, c, t, m = audio.shape
    return audio.transpose(1, 2).reshape(b, t, c * m)


def unpack_audio_latents(packed, channels: int = 8, mel: int = 16):
    """(B, T, 128) -> (B, 8, T, 16)."""
    b, t, _ = packed.shape
    return packed.reshape(b, t, channels, mel).transpose(1, 2)


def audio_frame_count(duration_s: float, sample_rate: int = 16000, hop: int = 160,
                      scale: int = 4) -> int:
    """Audio latent frames of a clip: round(seconds * 16000 / 160 / 4)."""
    return int(round(duration_s * sample_rate / hop / scale))
