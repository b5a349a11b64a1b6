"""Rectified-flow (flow-matching) training objective for the DiT.

Port of ltx_tpu/train/flow_match.py: the video loss on the DiT and the
joint loss on the dual audio-video DiT. The inference scheduler's
conventions: x_t = (1 - t) x_0 + t noise (ops/schedule.py::add_noise) and
the velocity target v* = noise - x_0 (ops/schedule.py::velocity_target).
The noise levels and the noise are explicit tensor arguments: the trainer
draws them from a torch.Generator (`sample_sigmas`, `torch.randn`), the
parity tests feed the reference's own jax.random draws. Pipeline
parallelism (`pp_mesh`) waits for ROADMAP A18.
"""

from __future__ import annotations

import torch

from ltx_tpu_torch.ops.schedule import add_noise, velocity_target

SDPA_IMPLS = ("auto", "xla", "pallas")


def sample_sigmas(generator: torch.Generator, batch: int, scheme: str = "logit_normal",
                  mean: float = 0.0, std: float = 1.0):
    """Per-sample noise levels t in (0, 1), f32 on the generator's device.
    "uniform": U(1e-5, 1 - 1e-5); "logit_normal": sigmoid(N(mean, std))."""
    device = generator.device
    if scheme == "uniform":
        u = torch.rand(batch, generator=generator, dtype=torch.float32, device=device)
        return u * (1.0 - 2e-5) + 1e-5
    if scheme == "logit_normal":
        z = torch.randn(batch, generator=generator, dtype=torch.float32, device=device)
        return torch.sigmoid(z * std + mean)
    raise ValueError(f"unknown sigma sampling scheme: {scheme}")


def check_sdpa_impl(sdpa_impl: str) -> None:
    """"auto", "xla" and "pallas" name one function here (the flash kernels
    on the card, their plain versions on the CPU); "ring" is not ported."""
    if sdpa_impl == "ring":
        raise NotImplementedError("sequence-parallel ring attention is not ported "
                                  "yet (ROADMAP A18)")
    if sdpa_impl not in SDPA_IMPLS:
        raise ValueError(f"unknown sdpa impl: {sdpa_impl}")


def flow_match_loss(model, tokens, context, rope, sigma, noise, context_bias=None,
                    sdpa_impl: str = "auto", remat: bool = True, remat_segments: int = 0,
                    compute_dtype=torch.bfloat16):
    """Mean-squared velocity-matching loss of `model` (an LTXTransformer).
    Returns (loss, aux dict).

    tokens (B, T, C) clean patchified latents; context (B, S, caption
    channels); rope (cos, sin); sigma (B,) noise levels and noise (B, T, C)
    standard normal, both f32; context_bias (B, 1, 1, S) additive or None.
    The forward runs in `compute_dtype` (on the card the attention kernels
    run in bf16 whatever it is: ops.attention casts at their boundary); the
    loss reduces in f32."""
    check_sdpa_impl(sdpa_impl)
    x0 = tokens.float()
    x_t = add_noise(x0, noise.float(), sigma.float()[:, None, None])
    target = velocity_target(x0, noise.float())
    v_pred = model(x_t.to(compute_dtype), context, sigma, rope, context_bias,
                   remat=remat, remat_segments=remat_segments).float()
    loss = torch.mean(torch.square(v_pred - target))
    return loss, {"loss": loss, "sigma_mean": torch.mean(sigma.float())}


def av_flow_match_loss(model, video_tokens, audio_tokens, video_context, audio_context,
                       ropes, sigma_v, sigma_a, noise_v, noise_a, video_bias=None,
                       audio_bias=None, audio_loss_weight: float = 1.0,
                       sdpa_impl: str = "auto", remat: bool = True, remat_segments: int = 0,
                       compute_dtype=torch.bfloat16, pp_mesh=None):
    """The joint rectified-flow loss of `model` (an LTXAVTransformer):
    mse_video + audio_loss_weight * mse_audio, each reduced in f32. Returns
    (loss, aux dict with "loss", "loss_video", "loss_audio").

    video_tokens (B, Tv, C) patchified and audio_tokens (B, Ta, C_audio)
    packed clean latents; contexts (B, S, caption channels); ropes from
    `models.dit_av.prepare_av_ropes`; the streams' own noise levels sigma_v,
    sigma_a (B,) and noise noise_v, noise_a (the streams' shapes), f32
    (the reference draws them from one key split four ways, in that order:
    each stream's velocity must be right at any pair of levels); biases
    (B, 1, 1, S) additive or None."""
    if pp_mesh is not None:
        raise NotImplementedError("pipeline-parallel training is not ported yet "
                                  "(ROADMAP A18)")
    check_sdpa_impl(sdpa_impl)
    v0, a0 = video_tokens.float(), audio_tokens.float()
    noise_v, noise_a = noise_v.float(), noise_a.float()
    v_t = add_noise(v0, noise_v, sigma_v.float()[:, None, None])
    a_t = add_noise(a0, noise_a, sigma_a.float()[:, None, None])
    v_pred, a_pred = model(v_t.to(compute_dtype), a_t.to(compute_dtype), video_context,
                           audio_context, sigma_v, sigma_a, ropes, video_bias, audio_bias,
                           remat=remat, remat_segments=remat_segments)
    loss_v = torch.mean(torch.square(v_pred.float() - velocity_target(v0, noise_v)))
    loss_a = torch.mean(torch.square(a_pred.float() - velocity_target(a0, noise_a)))
    loss = loss_v + audio_loss_weight * loss_a
    return loss, {"loss": loss, "loss_video": loss_v, "loss_audio": loss_a}
