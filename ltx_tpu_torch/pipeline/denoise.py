"""The denoising loop: patchify -> DiT -> unpatchify -> Euler, per sigma.

Port of ltx_tpu/pipeline/denoise.py, text-to-video with one guidance row
(the distilled schedule's cfg 1.0). CFG, STG and guidance-extrapolation rows
and I2V conditioning are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ltx_tpu_torch.config import GenerationConfig
from ltx_tpu_torch.models.dit import LTXTransformer
from ltx_tpu_torch.ops.attention import prepare_additive_mask
from ltx_tpu_torch.ops.latents import VideoLatentShape, patchify, unpatchify
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
    def from_config(cls, cfg: GenerationConfig) -> "GuidanceSpec":
        return cls(use_cfg=cfg.cfg_scale > 1.0, cfg_scale=cfg.cfg_scale,
                   guidance_rescale=cfg.guidance_rescale,
                   stg_scale=cfg.stg_scale, stg_blocks=tuple(cfg.stg_blocks),
                   ge_gamma=cfg.ge_gamma,
                   cross_attention_scale=cfg.cross_attention_scale)

    @property
    def num_rows(self) -> int:
        return (2 if self.use_cfg else 1) + (1 if self.stg_scale > 0 else 0)

    def check_ported(self) -> None:
        """Raise NotImplementedError for guidance this port cannot run."""
        if self.num_rows != 1:
            raise NotImplementedError(
                "CFG/STG guidance rows are not ported yet (cfg_scale must be "
                "1.0 and stg_scale 0.0)")
        if self.ge_gamma > 0:
            raise NotImplementedError("guidance extrapolation is not ported yet")
        if self.cross_attention_scale != 1.0:
            raise NotImplementedError("cross_attention_scale != 1 is not ported yet")


def build_guidance_context(guidance: GuidanceSpec, pos_embeddings, pos_mask):
    """One row: context (1, S, D) and its additive key bias (1, 1, 1, S)."""
    guidance.check_ported()
    return pos_embeddings, prepare_additive_mask(pos_mask)


def make_denoise_step(transformer: LTXTransformer, guidance: GuidanceSpec,
                      shape: VideoLatentShape, context, context_bias,
                      fps: float = 24.0):
    """The per-sigma step: step(latent, sigma, sigma_next) -> (new latent,
    velocity), both f32 (B, C, F, H, W). The DiT runs on bf16 tokens."""
    guidance.check_ported()
    if shape.batch != 1:
        raise NotImplementedError("batched prompts are not ported yet")
    tcfg = transformer.cfg
    cos, sin = video_rope(shape.frames, shape.height, shape.width, tcfg.inner_dim,
                          tcfg.num_heads, theta=tcfg.rope_theta,
                          max_pos=tcfg.max_pos, fps=fps)
    device = context.device
    pe = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))

    def step(latent, sigma: float, sigma_next: float):
        tokens = patchify(latent).to(torch.bfloat16)
        timesteps = torch.full((shape.batch,), sigma, dtype=torch.float32,
                               device=device)
        vel_tokens = transformer(tokens, context, timesteps, pe,
                                 context_bias=context_bias)
        velocity = unpatchify(vel_tokens, shape).float()
        return euler_step(latent, velocity, sigma, sigma_next), velocity

    return step


def run_denoise_loop(step_fn, latent, sigmas, on_step=None):
    """Drive the step over the host sigma schedule; on_step(i, n, sigma)
    runs after each step, once the device has finished it."""
    num_steps = len(sigmas) - 1
    for i in range(num_steps):
        latent, _ = step_fn(latent, float(sigmas[i]), float(sigmas[i + 1]))
        if on_step is not None:
            if latent.is_cuda:
                torch.cuda.synchronize(latent.device)
            on_step(i, num_steps, float(sigmas[i]))
    return latent
