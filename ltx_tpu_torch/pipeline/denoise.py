"""The denoising loop: patchify -> guidance rows -> DiT -> unpatchify ->
guidance combine -> Euler, per sigma.

Port of ltx_tpu/pipeline/denoise.py: `GuidanceSpec`, `build_guidance_context`
and its batched form, `make_denoise_step` (all but the pipeline-parallel
branch, ROADMAP A18) and `run_denoise_loop` (all but the DenoiseCheckpoint
resume, ROADMAP A16). The step runs eagerly; the reference compiles it once.

Row layout (CFG order, uncond first):
  G=1: [cond]
  G=2 (CFG): [uncond, cond]
  G=2 (STG, no CFG): [cond, perturbed]
  G=3 (CFG+STG): [uncond, cond, perturbed]
With one prompt the G rows tile the latent; with B prompts the rows are
B-major, sample i's rows at i*G .. i*G+G-1.

The re-noise of conditioned frames draws nothing itself: the step takes the
draw as a tensor, one per step, where the reference splits a key.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ltx_tpu_torch.config import GenerationConfig
from ltx_tpu_torch.models.dit import LTXTransformer, stg_skip_masks
from ltx_tpu_torch.ops.attention import prepare_additive_mask
from ltx_tpu_torch.ops.latents import (
    VideoLatentShape,
    apply_cfg,
    apply_guidance_rescale,
    patchify,
    unpatchify,
)
from ltx_tpu_torch.ops.rope import video_rope
from ltx_tpu_torch.ops.schedule import euler_step


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


def make_denoise_step(transformer: LTXTransformer, guidance: GuidanceSpec,
                      shape: VideoLatentShape, context, context_bias,
                      conditioning_mask=None, conditioned_latent=None,
                      image_cond_noise_scale: float = 0.0, cond_frames: int = 1,
                      cond_frame_idx=None, fps: float = 24.0):
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
    frames named by cond_frame_idx (strictly increasing) at any positions."""
    tcfg = transformer.cfg
    g = guidance.num_rows
    b = shape.batch
    device = context.device
    cos, sin = video_rope(shape.frames, shape.height, shape.width, tcfg.inner_dim,
                          tcfg.num_heads, theta=tcfg.rope_theta,
                          max_pos=tcfg.max_pos, fps=fps)
    pe = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))

    skip_sa = skip_ff = None
    if guidance.use_stg:
        skip_sa, skip_ff = stg_skip_masks(
            tcfg, b * g, guidance.stg_blocks,
            perturbed_rows=[i * g + g - 1 for i in range(b)], device=device)

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

    cas = (guidance.cross_attention_scale
           if guidance.cross_attention_scale != 1.0 else None)

    def step(latent, sigma: float, sigma_next: float, prev_velocity=None,
             has_prev: bool = False, noise=None):
        if cond_lat is not None:
            if noise is None:
                raise ValueError("the conditioned frames' re-noise needs its draw: "
                                 "pass noise of conditioned_latent's shape")
            if tuple(noise.shape) != tuple(cond_lat.shape):
                raise ValueError(f"re-noise draw {tuple(noise.shape)} != "
                                 f"{tuple(cond_lat.shape)}")
            sigma_f32 = torch.tensor(sigma, dtype=torch.float32, device=device)
            noised = cond_lat + image_cond_noise_scale * noise.to(
                device, torch.float32) * sigma_f32**2
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

        vel_tokens = transformer(tokens_g, context, timesteps, pe,
                                 context_bias=context_bias, skip_self_attn=skip_sa,
                                 skip_ff=skip_ff, cross_attn_scale=cas)
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


def run_denoise_loop(step_fn, latent, sigmas, cond_noise=None, on_step=None):
    """Drive the step over the host sigma schedule, carrying the velocity
    for guidance extrapolation. cond_noise: one re-noise draw per step (a
    sequence of len(sigmas) - 1 tensors) when the step re-noises conditioned
    frames. on_step(i, n, sigma) runs after each step, once the device has
    finished it."""
    num_steps = len(sigmas) - 1
    if getattr(step_fn, "needs_noise", False) and (
            cond_noise is None or len(cond_noise) != num_steps):
        raise ValueError(f"the conditioned frames' re-noise needs {num_steps} draws "
                         "(cond_noise), one per step")
    velocity = torch.zeros_like(latent)
    has_prev = False
    for i in range(num_steps):
        latent, velocity = step_fn(
            latent, float(sigmas[i]), float(sigmas[i + 1]), velocity, has_prev,
            None if cond_noise is None else cond_noise[i])
        has_prev = True
        if on_step is not None:
            if latent.is_cuda:
                torch.cuda.synchronize(latent.device)
            on_step(i, num_steps, float(sigmas[i]))
    return latent
