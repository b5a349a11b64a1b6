"""The denoising loop: patchify -> guidance rows -> DiT -> unpatchify ->
guidance combine -> Euler, per sigma.

Port of ltx_tpu/pipeline/denoise.py: `GuidanceSpec`, `build_guidance_context`
and its batched form, `make_denoise_step` and the dual audio-video
`make_av_denoise_step` (with their pipeline-parallel branch: a DiT split
by `parallel.pipeline.shard_pp` runs the GPipe schedule, the guidance rows
its microbatches), `run_denoise_loop` (with the DenoiseCheckpoint resume)
and `run_av_denoise_loop`. The steps run eagerly; the reference compiles each
once.

Row layout (CFG order, uncond first):
  G=1: [cond]
  G=2 (CFG): [uncond, cond]
  G=2 (STG, no CFG): [cond, perturbed]
  G=3 (CFG+STG): [uncond, cond, perturbed]
With one prompt the G rows tile the latent; with B prompts the rows are
B-major, sample i's rows at i*G .. i*G+G-1.

The re-noise of conditioned frames draws nothing itself: the step takes the
draw as a tensor, one per step, where the reference splits a key (and the
audio step's audio draw, where the reference folds 1 into that key).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ltx_tpu_torch.config import GenerationConfig
from ltx_tpu_torch.kernels.rope import rope_tables
from ltx_tpu_torch.models.dit import LTXTransformer, stg_skip_masks
from ltx_tpu_torch.models.dit_av import LTXAVTransformer, prepare_av_ropes
from ltx_tpu_torch.ops.attention import prepare_additive_mask
from ltx_tpu_torch.ops.latents import (
    VideoLatentShape,
    apply_cfg,
    apply_guidance_rescale,
    patchify,
    unpatchify,
)
from ltx_tpu_torch.ops.rope import create_position_grid
from ltx_tpu_torch.ops.schedule import euler_step
from ltx_tpu_torch.parallel.pipeline import check_plan
from ltx_tpu_torch.parallel.sharding import data_rows, gather_rows
from ltx_tpu_torch.utils.diagnostics import diag_stats, span


@dataclasses.dataclass(frozen=True)
class GuidanceSpec:
    """Guidance configuration of a run (the reference's GuidanceSpec)."""

    use_cfg: bool
    cfg_scale: float
    guidance_rescale: float
    stg_scale: float
    stg_blocks: Tuple[int, ...]
    ge_gamma: float
    cross_attention_scale: float

    @classmethod
    def from_config(cls, cfg: GenerationConfig,
                    use_cfg: Optional[bool] = None) -> "GuidanceSpec":
        if use_cfg is None:
            use_cfg = cfg.cfg_scale > 1.0
        return cls(use_cfg=use_cfg, cfg_scale=cfg.cfg_scale,
                   guidance_rescale=cfg.guidance_rescale,
                   stg_scale=cfg.stg_scale, stg_blocks=tuple(cfg.stg_blocks),
                   ge_gamma=cfg.ge_gamma,
                   cross_attention_scale=cfg.cross_attention_scale)

    @property
    def use_stg(self) -> bool:
        return self.stg_scale > 0

    @property
    def num_rows(self) -> int:
        return (2 if self.use_cfg else 1) + (1 if self.use_stg else 0)


def _guidance_rows(guidance: GuidanceSpec, pos, pos_mask, neg, neg_mask):
    """[(embeddings, mask)] per guidance row: [neg?, pos, pos(perturbed)?]."""
    rows = []
    if guidance.use_cfg:
        if neg is None:
            raise ValueError("CFG requires negative-prompt embeddings")
        rows.append((neg, neg_mask))
    rows.append((pos, pos_mask))
    if guidance.use_stg:
        rows.append((pos, pos_mask))
    return rows


def build_guidance_context(guidance: GuidanceSpec, pos_embeddings, pos_mask,
                           neg_embeddings=None, neg_mask=None):
    """One prompt's rows stacked: embeddings (1, S, D), masks (1, S) binary
    -> context (G, S, D) and its additive key bias (G, 1, 1, S) or None."""
    rows = _guidance_rows(guidance, pos_embeddings, pos_mask, neg_embeddings, neg_mask)
    context = torch.cat([e for e, _ in rows], dim=0)
    if rows[0][1] is None:
        return context, None
    return context, prepare_additive_mask(torch.cat([m for _, m in rows], dim=0))


def build_guidance_context_batched(guidance: GuidanceSpec, pos_embeddings, pos_mask,
                                   neg_embeddings=None, neg_mask=None):
    """B prompts' rows, B-major: embeddings (B, S, D), masks (B, S) ->
    context (B*G, S, D), bias (B*G, 1, 1, S) or None, the layout
    make_denoise_step expects for shape.batch = B."""
    rows = _guidance_rows(guidance, pos_embeddings, pos_mask, neg_embeddings, neg_mask)
    b, s, d = pos_embeddings.shape
    g = len(rows)
    context = torch.stack([e for e, _ in rows], dim=1).reshape(b * g, s, d)
    if rows[0][1] is None:
        return context, None
    mask = torch.stack([m for _, m in rows], dim=1).reshape(b * g, s)
    return context, prepare_additive_mask(mask)


def _video_conditioning(shape: VideoLatentShape, device, conditioning_mask,
                        conditioned_latent, image_cond_noise_scale: float, cond_frame_idx):
    """(cond_mask (1, T) f32 or None, the clean latent to re-noise from or
    None, the keyframe indices and their (1, 1, F, 1, 1) mask or Nones), on
    `device`, checked as the reference checks them."""
    cond_mask = None
    if conditioning_mask is not None:
        cond_mask = torch.as_tensor(conditioning_mask, dtype=torch.float32).to(device)
    cond_lat = None
    if cond_mask is not None and image_cond_noise_scale > 0:
        if conditioned_latent is None:
            raise ValueError("image_cond_noise_scale > 0 requires conditioned_latent "
                             "(the clean injection source)")
        cond_lat = conditioned_latent.to(device, torch.float32)

    fidx = fmask = None
    if cond_frame_idx is not None:
        if cond_mask is None:
            raise ValueError("cond_frame_idx requires conditioning_mask")
        idx = np.asarray(cond_frame_idx, np.int64).reshape(-1)
        if idx.size == 0 or (np.diff(idx) <= 0).any():
            raise ValueError("cond_frame_idx must be non-empty, strictly increasing")
        if idx[0] < 0 or idx[-1] >= shape.frames:
            raise ValueError(f"cond_frame_idx {idx.tolist()} out of range "
                             f"[0, {shape.frames})")
        fidx = torch.from_numpy(idx).to(device)
        fmask = torch.zeros(1, 1, shape.frames, 1, 1, dtype=torch.bool, device=device)
        fmask[:, :, fidx] = True
        if cond_lat is not None and cond_lat.shape[2] != idx.size:
            raise ValueError(f"conditioned_latent has {cond_lat.shape[2]} frames, "
                             f"cond_frame_idx names {idx.size}")
    return cond_mask, cond_lat, fidx, fmask


def _check_draw(noise, like, what: str):
    """The step's draw for a re-noise of `like`'s shape, as f32 on its device."""
    if noise is None:
        raise ValueError(f"the {what} re-noise needs its draw: pass noise of shape "
                         f"{tuple(like.shape)}")
    if tuple(noise.shape) != tuple(like.shape):
        raise ValueError(f"{what} re-noise draw {tuple(noise.shape)} != {tuple(like.shape)}")
    return noise.to(like.device, torch.float32)


def make_denoise_step(transformer: LTXTransformer, guidance: GuidanceSpec,
                      shape: VideoLatentShape, context, context_bias,
                      conditioning_mask=None, conditioned_latent=None,
                      image_cond_noise_scale: float = 0.0, cond_frames: int = 1,
                      cond_frame_idx=None, fps: float = 24.0, sdpa_impl: str = "auto",
                      pp_mesh=None):
    """The per-sigma step:

        step(latent, sigma, sigma_next, prev_velocity=None, has_prev=False,
             noise=None) -> (new latent, velocity)

    both f32 (B, C, F, H, W); the DiT runs on bf16 tokens, the guidance
    combine in f32. context: (B*G, S, D) from build_guidance_context[_batched].

    Conditioning (I2V, extension): conditioning_mask (1, T) marks the tokens
    of the conditioned latent frames; their timesteps are 0 and Euler skips
    them. With image_cond_noise_scale > 0 they are re-noised each step from
    the CLEAN conditioned_latent (1, C, K, h, w):
    cond + scale * noise * sigma**2, `noise` being the step's argument
    (conditioned_latent's shape, standard normal), so the injected noise
    never accumulates. cond_frames leading frames are conditioned, or the
    frames named by cond_frame_idx (strictly increasing) at any positions.

    sdpa_impl: the DiT's attention route ("ring": sequence-parallel
    self-attention over `ops.attention.set_sequence_parallel`'s mesh). A
    DiT sharded over a mesh (`parallel.sharding.shard_transformer`) with a
    data axis that divides the B*G rows runs this rank's rows only; the
    velocities are gathered whole before the guidance combine.

    A DiT split into pipeline stages (`parallel.pipeline.shard_pp`) runs
    the GPipe schedule, the guidance rows its microbatches (the plan's
    count; default one a row), the rows over the mesh's data axis, the
    velocities whole on every rank. pp_mesh, the reference's argument, must
    be that mesh (InvalidConfigurationError otherwise)."""
    check_plan(transformer, pp_mesh)
    tcfg = transformer.cfg
    g = guidance.num_rows
    b = shape.batch
    device = context.device
    with span("denoise.rope"):
        pe = rope_tables(create_position_grid(shape.frames, shape.height, shape.width, fps=fps),
                         tcfg.inner_dim, theta=tcfg.rope_theta, max_pos=tcfg.max_pos,
                         num_heads=tcfg.num_heads, device=device)

    skip_sa = skip_ff = None
    if guidance.use_stg:
        skip_sa, skip_ff = stg_skip_masks(
            tcfg, b * g, guidance.stg_blocks,
            perturbed_rows=[i * g + g - 1 for i in range(b)], device=device)

    cond_mask, cond_lat, fidx, fmask = _video_conditioning(
        shape, device, conditioning_mask, conditioned_latent, image_cond_noise_scale,
        cond_frame_idx)

    cas = (guidance.cross_attention_scale
           if guidance.cross_attention_scale != 1.0 else None)
    dp = data_rows(transformer, b * g)
    if dp is not None:  # this rank's guidance rows
        _, lo, hi = dp
        context = context[lo:hi]
        context_bias = None if context_bias is None else context_bias[lo:hi]
        skip_sa = None if skip_sa is None else skip_sa[:, lo:hi]
        skip_ff = None if skip_ff is None else skip_ff[:, lo:hi]

    def step(latent, sigma: float, sigma_next: float, prev_velocity=None,
             has_prev: bool = False, noise=None):
        if cond_lat is not None:
            sigma_f32 = torch.tensor(sigma, dtype=torch.float32, device=device)
            noised = cond_lat + image_cond_noise_scale * _check_draw(
                noise, cond_lat, "conditioned frames'") * sigma_f32**2
            latent = latent.clone()
            if fidx is not None:
                latent[:, :, fidx] = noised
            else:
                latent[:, :, :cond_frames] = noised

        tokens = patchify(latent).to(torch.bfloat16)  # (B, T, C)
        if b == 1:
            tokens_g = tokens.repeat(g, 1, 1)
        else:
            tokens_g = tokens.repeat_interleave(g, dim=0)

        if cond_mask is not None:
            # per-token timesteps: the conditioned frames' tokens are clean
            timesteps = (sigma * (1 - cond_mask)).repeat(b * g, 1)
        else:
            timesteps = torch.full((b * g,), sigma, dtype=torch.float32, device=device)

        if dp is not None:
            tokens_g, timesteps = tokens_g[dp[1]:dp[2]], timesteps[dp[1]:dp[2]]
        vel_tokens = transformer(tokens_g, context, timesteps, pe,
                                 context_bias=context_bias, skip_self_attn=skip_sa,
                                 skip_ff=skip_ff, cross_attn_scale=cas, sdpa_impl=sdpa_impl)
        if dp is not None:
            vel_tokens = gather_rows(vel_tokens, dp[0])
        rows = unpatchify(vel_tokens, dataclasses.replace(shape, batch=b * g)).float()
        if b == 1:
            def row(j):
                return rows[j:j + 1]
        else:
            rr = rows.reshape(b, g, *rows.shape[1:])

            def row(j):  # (B, C, F, H, W): row j of every sample
                return rr[:, j]

        if guidance.use_cfg:
            uncond, cond = row(0), row(1)
            velocity = apply_cfg(uncond, cond, guidance.cfg_scale)
            if guidance.guidance_rescale > 0:
                velocity = apply_guidance_rescale(velocity, cond,
                                                  guidance.guidance_rescale)
        else:
            velocity = row(0)

        if guidance.use_stg:
            velocity = velocity + guidance.stg_scale * (velocity - row(g - 1))

        if guidance.ge_gamma > 0 and has_prev:
            velocity = guidance.ge_gamma * (velocity - prev_velocity) + prev_velocity

        if fidx is not None:
            # keyframes anywhere: Euler everywhere, the conditioned frames
            # carried through a mask
            stepped = euler_step(latent, velocity, sigma, sigma_next)
            new_latent = torch.where(fmask, latent, stepped)
        elif cond_mask is not None:
            # Euler only on the generated frames; the conditioned ones carry
            stepped = euler_step(latent[:, :, cond_frames:],
                                 velocity[:, :, cond_frames:], sigma, sigma_next)
            new_latent = torch.cat([latent[:, :, :cond_frames], stepped], dim=2)
        else:
            new_latent = euler_step(latent, velocity, sigma, sigma_next)
        return new_latent, velocity

    step.needs_noise = cond_lat is not None
    return step


def make_av_denoise_step(transformer: LTXAVTransformer, guidance: GuidanceSpec,
                         shape: VideoLatentShape, audio_frames: int, video_context,
                         audio_context, context_bias, conditioning_mask=None,
                         conditioned_latent=None, image_cond_noise_scale: float = 0.0,
                         cond_frames: int = 1, cond_frame_idx=None,
                         audio_cond_frames: int = 0, audio_conditioned_latent=None,
                         fps: float = 24.0, video_euler: str = "scheduler",
                         sdpa_impl: str = "auto", pp_mesh=None):
    """The dual video + audio step, guidance rows batched:

        step(video_latent, audio_packed, sigma, sigma_next, noise=None,
             audio_noise=None) -> (new video latent, new audio packed)

    both f32: video (1, C, F, H, W), audio (1, T_a, C_a) packed. The
    streams' contexts are (G, S, D) from build_guidance_context, one key
    bias (G, 1, 1, S) for both. Guidance rescale applies to the video only,
    as in the reference; STG is not defined on this path and raises.

    Video conditioning as make_denoise_step's (conditioning_mask,
    conditioned_latent, cond_frames or cond_frame_idx, re-noised from the
    clean latent with the step's `noise` when image_cond_noise_scale > 0).
    audio_cond_frames > 0 holds the first K audio latent frames likewise:
    timestep 0 on them, re-noised from audio_conditioned_latent (1, K, C_a)
    with the step's `audio_noise`, carried through the audio Euler.

    video_euler: "scheduler" (f32 Euler with the bf16 round trip) or
    "plain" (x += (sigma_next - sigma) * v, the reference's video step in
    stage 2 of the two-stage audio path). The audio step is always plain.
    sdpa_impl, the guidance rows over a data axis and a DiT split into
    pipeline stages (pp_mesh) as make_denoise_step's; the (video, audio)
    activation pair hops between stages together."""
    check_plan(transformer, pp_mesh)
    if guidance.use_stg:
        raise ValueError("STG is not supported on the audio+video path")
    if video_euler not in ("scheduler", "plain"):
        raise ValueError(f"video_euler {video_euler!r}: 'scheduler' or 'plain'")
    tcfg = transformer.cfg
    g = guidance.num_rows
    device = video_context.device
    with span("denoise.rope"):
        ropes = prepare_av_ropes(tcfg, shape.frames, shape.height, shape.width, audio_frames,
                                 fps=fps, device=device)

    cond_mask, cond_lat, fidx, fmask = _video_conditioning(
        shape, device, conditioning_mask, conditioned_latent, image_cond_noise_scale,
        cond_frame_idx)

    a_k = int(audio_cond_frames)
    a_cond_mask = a_cond_lat = None
    if a_k > 0:
        if not a_k < audio_frames:
            raise ValueError(f"audio_cond_frames {a_k} must be < audio_frames {audio_frames}")
        a_cond_mask = torch.zeros(1, audio_frames, dtype=torch.float32, device=device)
        a_cond_mask[:, :a_k] = 1.0
        if image_cond_noise_scale > 0:
            if audio_conditioned_latent is None:
                raise ValueError("audio_cond_frames with injection requires "
                                 "audio_conditioned_latent (the clean source)")
            a_cond_lat = audio_conditioned_latent.to(device, torch.float32)
            if a_cond_lat.shape[1] != a_k:
                raise ValueError(f"audio_conditioned_latent has {a_cond_lat.shape[1]} "
                                 f"frames, audio_cond_frames is {a_k}")

    dp = data_rows(transformer, g)
    if dp is not None:  # this rank's guidance rows
        _, lo, hi = dp
        video_context, audio_context = video_context[lo:hi], audio_context[lo:hi]
        context_bias = None if context_bias is None else context_bias[lo:hi]

    def vstep(lat, vel, sigma: float, sigma_next: float, dt):
        if video_euler == "plain":
            return (lat.float() + dt * vel).to(lat.dtype)
        return euler_step(lat, vel, sigma, sigma_next)

    def step(video_latent, audio_packed, sigma: float, sigma_next: float, noise=None,
             audio_noise=None):
        sigma_t = torch.tensor(sigma, dtype=torch.float32, device=device)
        # the f32 difference of the f32 sigmas, as the reference's
        dt = torch.tensor(sigma_next, dtype=torch.float32, device=device) - sigma_t
        if cond_lat is not None:
            noised = cond_lat + image_cond_noise_scale * _check_draw(
                noise, cond_lat, "conditioned frames'") * sigma_t**2
            video_latent = video_latent.clone()
            if fidx is not None:
                video_latent[:, :, fidx] = noised.to(video_latent.dtype)
            else:
                video_latent[:, :, :cond_frames] = noised.to(video_latent.dtype)
        if a_cond_lat is not None:
            a_noised = a_cond_lat + image_cond_noise_scale * _check_draw(
                audio_noise, a_cond_lat, "conditioned audio frames'") * sigma_t**2
            audio_packed = audio_packed.clone()
            audio_packed[:, :a_k] = a_noised.to(audio_packed.dtype)

        v_tokens = patchify(video_latent).to(torch.bfloat16).repeat(g, 1, 1)
        a_tokens = audio_packed.to(torch.bfloat16).repeat(g, 1, 1)
        if cond_mask is not None:
            ts_v = (sigma_t * (1 - cond_mask)).repeat(g, 1)
        else:
            ts_v = torch.full((g,), sigma, dtype=torch.float32, device=device)
        if a_cond_mask is not None:
            ts_a = (sigma_t * (1 - a_cond_mask)).repeat(g, 1)
        else:
            ts_a = torch.full((g,), sigma, dtype=torch.float32, device=device)

        if dp is not None:
            v_tokens, a_tokens = v_tokens[dp[1]:dp[2]], a_tokens[dp[1]:dp[2]]
            ts_v, ts_a = ts_v[dp[1]:dp[2]], ts_a[dp[1]:dp[2]]
        v_vel_tok, a_vel_tok = transformer(v_tokens, a_tokens, video_context, audio_context,
                                           ts_v, ts_a, ropes, video_bias=context_bias,
                                           audio_bias=context_bias, sdpa_impl=sdpa_impl)
        if dp is not None:
            v_vel_tok, a_vel_tok = gather_rows(v_vel_tok, dp[0]), gather_rows(a_vel_tok, dp[0])
        v_rows = unpatchify(v_vel_tok, dataclasses.replace(shape, batch=g)).float()
        a_rows = a_vel_tok.float()
        if guidance.use_cfg:
            v_vel = apply_cfg(v_rows[0:1], v_rows[1:2], guidance.cfg_scale)
            a_vel = apply_cfg(a_rows[0:1], a_rows[1:2], guidance.cfg_scale)
            if guidance.guidance_rescale > 0:  # video only
                v_vel = apply_guidance_rescale(v_vel, v_rows[1:2], guidance.guidance_rescale)
        else:
            v_vel, a_vel = v_rows[0:1], a_rows[0:1]

        if fidx is not None:
            new_video = torch.where(fmask, video_latent,
                                    vstep(video_latent, v_vel, sigma, sigma_next, dt))
        elif cond_mask is not None:
            stepped = vstep(video_latent[:, :, cond_frames:], v_vel[:, :, cond_frames:],
                            sigma, sigma_next, dt)
            new_video = torch.cat([video_latent[:, :, :cond_frames], stepped], dim=2)
        else:
            new_video = vstep(video_latent, v_vel, sigma, sigma_next, dt)

        new_audio = audio_packed.float() + dt * a_vel
        if a_cond_mask is not None:
            new_audio = torch.cat([audio_packed[:, :a_k].float(), new_audio[:, a_k:]], dim=1)
        return new_video, new_audio

    step.needs_noise = cond_lat is not None
    step.needs_audio_noise = a_cond_lat is not None
    return step


def run_av_denoise_loop(step_fn, video_latent, audio_packed, sigmas, cond_noise=None,
                        audio_cond_noise=None, on_step=None):
    """Drive the dual step over the host sigma schedule. cond_noise /
    audio_cond_noise: one draw per step (a sequence of len(sigmas) - 1
    tensors) when the step re-noises conditioned video / audio frames.
    on_step(i, n, sigma) runs after each step, once the device has finished
    it. Returns (video latent, audio packed).

    Spans (utils.diagnostics.span), one of each a step: `denoise.launch`,
    the step function's call (it enqueues the step, and waits where the
    step copies host values to the device); inside `denoise.step`, which
    ends at the step's synchronise (with on_step; without, at its launch's
    end)."""
    num_steps = len(sigmas) - 1
    for needs, draws, what in ((getattr(step_fn, "needs_noise", False), cond_noise,
                                "cond_noise"),
                               (getattr(step_fn, "needs_audio_noise", False),
                                audio_cond_noise, "audio_cond_noise")):
        if needs and (draws is None or len(draws) != num_steps):
            raise ValueError(f"the conditioned frames' re-noise needs {num_steps} draws "
                             f"({what}), one per step")
    for i in range(num_steps):
        with span("denoise.step"):
            with span("denoise.launch"):
                video_latent, audio_packed = step_fn(
                    video_latent, audio_packed, float(sigmas[i]), float(sigmas[i + 1]),
                    None if cond_noise is None else cond_noise[i],
                    None if audio_cond_noise is None else audio_cond_noise[i])
            if on_step is not None and video_latent.is_cuda:
                torch.cuda.synchronize(video_latent.device)
        if on_step is not None:
            on_step(i, num_steps, float(sigmas[i]))
    return video_latent, audio_packed


def run_denoise_loop(step_fn, latent, sigmas, cond_noise=None, on_step=None,
                     checkpoint=None, seed: int = 0):
    """Drive the step over the host sigma schedule, carrying the velocity
    for guidance extrapolation. cond_noise: one re-noise draw per step (a
    sequence of len(sigmas) - 1 tensors) when the step re-noises conditioned
    frames. on_step(i, n, sigma) runs after each step, once the device has
    finished it.

    checkpoint: a utils.diagnostics.DenoiseCheckpoint. A saved state with
    the same sigmas resumes the loop after its step (latent and velocity
    from the file; the skipped steps run nothing, call no on_step); each
    step then saves (every checkpoint.every_n_steps) with `seed`. The
    per-step draws are arguments, so a resumed step takes the draw an
    uninterrupted run takes. With LTX_DIAG=1 each step logs its latent's
    [DIAG] line.

    Spans as `run_av_denoise_loop`'s, for the steps that run: a skipped
    step records none. A step's save and [DIAG] line lie in its
    `denoise.step`, after its `denoise.launch`."""
    num_steps = len(sigmas) - 1
    if getattr(step_fn, "needs_noise", False) and (
            cond_noise is None or len(cond_noise) != num_steps):
        raise ValueError(f"the conditioned frames' re-noise needs {num_steps} draws "
                         "(cond_noise), one per step")
    velocity = torch.zeros_like(latent)
    has_prev = False
    resume_from = -1
    if checkpoint is not None:
        state = checkpoint.load()
        if (state is not None and np.shape(state["sigmas"]) == np.shape(sigmas)
                and np.allclose(state["sigmas"], sigmas)):
            latent = torch.from_numpy(np.asarray(state["latent"])).to(latent.device,
                                                                      latent.dtype)
            velocity = torch.from_numpy(np.asarray(state["velocity"])).to(
                velocity.device, velocity.dtype)
            resume_from = int(state["step"])
            has_prev = True
    for i in range(num_steps):
        if i <= resume_from:
            continue
        with span("denoise.step"):
            with span("denoise.launch"):
                latent, velocity = step_fn(
                    latent, float(sigmas[i]), float(sigmas[i + 1]), velocity, has_prev,
                    None if cond_noise is None else cond_noise[i])
            has_prev = True
            if checkpoint is not None:
                checkpoint.save(i, latent, velocity, sigmas, seed)
            diag_stats(f"denoise step {i} latent", latent)
            if on_step is not None and latent.is_cuda:
                torch.cuda.synchronize(latent.device)
        if on_step is not None:
            on_step(i, num_steps, float(sigmas[i]))
    return latent
