"""Flow-matching sigma schedules (host numpy), the Euler stepper and the
training forward process (torch).

Port of ltx_tpu/ops/schedule.py. The schedule is a handful of floats and
stays numpy on the host, unchanged; `euler_step` keeps the reference's
dtype round-trip and terminal branch; `add_noise` and `velocity_target` are
the flow-matching objective's conventions (train/flow_match.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# Official distilled sigma schedule: 9 values for 8 steps.
DISTILLED_SIGMAS = np.array(
    [1.0, 0.99375, 0.9875, 0.98125, 0.975, 0.909375, 0.725, 0.421875, 0.0],
    dtype=np.float32,
)

BASE_SHIFT_ANCHOR = 1024
MAX_SHIFT_ANCHOR = 4096


def compute_mu(token_count: int, base_shift: float = 0.95,
               max_shift: float = 2.05) -> float:
    """Token-count shift exponent, linear between (1024, base_shift) and
    (4096, max_shift); tokens clamp at 4096."""
    clamped = min(token_count, MAX_SHIFT_ANCHOR)
    slope = (max_shift - base_shift) / (MAX_SHIFT_ANCHOR - BASE_SHIFT_ANCHOR)
    intercept = base_shift - slope * BASE_SHIFT_ANCHOR
    return float(clamped) * slope + intercept


def _time_shift(sigmas: np.ndarray, mu: float) -> np.ndarray:
    """sigma' = e^mu / (e^mu + 1/sigma - 1), fixed points at 0 and 1."""
    exp_mu = np.exp(np.float32(mu))
    out = sigmas.copy()
    interior = (sigmas != 0.0) & (sigmas != 1.0)
    s = sigmas[interior]
    out[interior] = exp_mu / (exp_mu + (1.0 / s - 1.0))
    return out


def _stretch_to_terminal(sigmas: np.ndarray, terminal: float) -> np.ndarray:
    """Rescale so the last non-zero sigma (sigmas[-2]) maps to `terminal`,
    keeping the terminal 0.0."""
    one_minus = 1.0 - sigmas
    last_one_minus = one_minus[-2]
    if last_one_minus <= 0:
        return sigmas
    scale = last_one_minus / (1.0 - terminal)
    out = 1.0 - one_minus / scale
    out[sigmas == 0.0] = 0.0
    return out.astype(np.float32)


def get_sigmas(num_steps: int, distilled: bool = False,
               token_count: Optional[int] = None, max_shift: float = 2.05,
               base_shift: float = 0.95, stretch: bool = True,
               terminal: float = 0.1) -> np.ndarray:
    """num_effective_steps + 1 sigmas ending in 0.0. Distilled: the fixed
    table (num_steps ignored), shifted by token count and stretched when a
    count is given. Dev: linear 1 -> 0, always shifted and stretched."""
    if distilled:
        sigmas = DISTILLED_SIGMAS[DISTILLED_SIGMAS > 0].copy()
        if token_count is not None:
            mu = compute_mu(token_count, base_shift, max_shift)
            sigmas = _time_shift(sigmas, mu)
            sigmas = np.append(sigmas, np.float32(0.0))
            if stretch:
                sigmas = _stretch_to_terminal(sigmas, terminal)
        else:
            sigmas = np.append(sigmas, np.float32(0.0))
        return sigmas.astype(np.float32)

    tokens = min(token_count if token_count is not None else MAX_SHIFT_ANCHOR,
                 MAX_SHIFT_ANCHOR)
    sigmas = 1.0 - np.arange(num_steps + 1, dtype=np.float32) / np.float32(num_steps)
    mu = compute_mu(tokens, base_shift, max_shift)
    sigmas = _time_shift(sigmas, mu)
    if stretch and num_steps > 0:
        sigmas = _stretch_to_terminal(sigmas, terminal)
    return sigmas.astype(np.float32)


def euler_step(latent, velocity, sigma: float, sigma_next: float):
    """One flow-matching Euler step. `denoised` is computed in f32 and
    rounded to the latent's dtype before the f32 update (the reference's
    round-trip); sigma_next == 0 returns `denoised`."""
    dtype = latent.dtype
    latent_f32 = latent.float()
    velocity_f32 = velocity.float()
    sigma_t = torch.tensor(sigma, dtype=torch.float32, device=latent.device)
    sigma_next_t = torch.tensor(sigma_next, dtype=torch.float32,
                                device=latent.device)

    denoised_f32 = (latent_f32 - sigma_t * velocity_f32).to(dtype).float()
    if sigma_next > 0:
        out = denoised_f32 + sigma_next_t * (latent_f32 - denoised_f32) / sigma_t
    else:
        out = denoised_f32
    return out.to(dtype)


def add_noise(samples, noise, sigma):
    """Flow-matching forward x_t = (1 - t) x_0 + t noise, with t (a float or
    a tensor broadcasting against `samples`) in the samples' dtype."""
    t = torch.as_tensor(sigma, dtype=samples.dtype, device=samples.device)
    return (1 - t) * samples + t * noise


def velocity_target(sample, noise):
    """The flow-matching velocity v = noise - sample."""
    return noise - sample
