"""Layers and operations of the plain reference: linears, convolutions,
norms, attention, RoPE tables, timestep embeddings, the sigma schedule and
the Euler step.

Every module's parameters are empty on construction (build on "meta", then
`assign`); a product reads its weight in the dtype of its input. Under
`set_precision(root, "fp8")` each matrix product and convolution rounds its
weight (per output channel) and its input (per row, or per tensor for a
convolution) to float8 e4m3 first: the control, one precision step below
the configurations' bfloat16.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def fp8_round(t, dims):
    """t rounded to float8 e4m3 with one absmax scale over `dims`, back in t's dtype."""
    amax = t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Module(nn.Module):
    """A reference module: `precision` is "f32" (products in the input's
    dtype) or "fp8" (inputs and weights rounded to e4m3 first)."""

    precision = "f32"
    out_dim = 0  # the weight's output-channel dimension

    def weight_for(self, x):
        w = self.weight.to(x.dtype)
        if self.precision == "fp8":
            w = fp8_round(w, tuple(d for d in range(w.ndim) if d != self.out_dim))
        return w

    def input_for(self, x, per_row: bool = True):
        if self.precision != "fp8":
            return x
        return fp8_round(x, (-1,) if per_row else tuple(range(x.ndim)))


def set_precision(root: nn.Module, precision: str) -> nn.Module:
    """Every reference module under `root` computes in `precision`."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    for m in root.modules():
        if isinstance(m, Module):
            m.precision = precision
    return root


def empty(*shape, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta", dtype=dtype), requires_grad=False)


def assign(root: nn.Module, state: dict) -> nn.Module:
    """Make `state`'s tensors ({name: tensor}) the parameters of `root`,
    every parameter once and of its shape."""
    params = dict(root.named_parameters())
    if set(params) != set(state):
        raise ValueError(f"state does not fit {type(root).__name__}: missing "
                         f"{sorted(set(params) - set(state))[:6]}, unknown "
                         f"{sorted(set(state) - set(params))[:6]}")
    for name, tensor in state.items():
        if tuple(tensor.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: {tuple(tensor.shape)} != {tuple(params[name].shape)}")
        owner, _, leaf = name.rpartition(".")
        setattr(root.get_submodule(owner), leaf, nn.Parameter(tensor, requires_grad=False))
    return root


class Linear(Module):
    """weight (d_out, d_in), optional bias (d_out,)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.weight = empty(d_out, d_in, dtype=dtype)
        self.bias = empty(d_out, dtype=dtype) if bias else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(self.input_for(x), self.weight_for(x), bias)


class ConvWeights(Module):
    """A convolution's weight (C_out, C_in, *k) (a transposed one's (C_in,
    C_out, k)) and bias (C_out,)."""

    def __init__(self, *shape, bias_dim: int = 0, dtype=torch.float32):
        super().__init__()
        self.weight = empty(*shape, dtype=dtype)
        self.bias = empty(shape[bias_dim], dtype=dtype)


class ConvTransposeWeights(ConvWeights):
    out_dim = 1


class NormWeight(nn.Module):
    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.weight = empty(dim, dtype=dtype)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.weight = empty(vocab, dim, dtype=dtype)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


def rms_norm(x, weight=None, eps: float = 1e-6):
    """RMSNorm with f32 statistics; weight=None is the weightless form."""
    dtype = x.dtype
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(dtype)


def layer_norm_no_affine(x, eps: float = 1e-6):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def attention(q, k, v, bias=None, scale=None, module: Module = None, head_chunk: int = 4):
    """softmax(q k^T * scale + bias) v in the inputs' dtype, `head_chunk`
    heads at a time. q (B, H, Tq, D); k, v (B, Hkv, Tk, D) with H % Hkv ==
    0; bias broadcasting to (B, H, Tq, Tk). Under fp8 `module` rounds q, k
    and v first."""
    b, h, tq, d = q.shape
    hkv = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    if module is not None:
        q, k, v = (module.input_for(t) for t in (q, k, v))
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    out = torch.empty_like(q)
    for s in range(0, h, head_chunk):
        e = min(h, s + head_chunk)
        logits = torch.matmul(q[:, s:e], k[:, s:e].transpose(-1, -2)) * scale
        if bias is not None:
            hb = bias if bias.shape[1] == 1 else bias[:, s:e]
            logits = logits + hb.to(logits.dtype)
        out[:, s:e] = torch.matmul(torch.softmax(logits, dim=-1), v[:, s:e])
    return out


# ---------------------------------------------------------------------------
# RoPE tables (float64 on the host, shipped as float32) and their application
# ---------------------------------------------------------------------------

def create_position_grid(frames: int, height: int, width: int, temporal_scale: int = 8,
                         spatial_scale: int = 32, fps: float = 24.0) -> np.ndarray:
    """Pixel-space middle coordinates per latent token, (3, T): the temporal
    bounds shifted causally by (1 - scale), clamped at 0, over fps."""
    i = np.arange(frames, dtype=np.float32)
    ts = np.float32(temporal_scale)
    start = np.maximum(i * ts + (1 - ts), 0)
    end = np.maximum((i + 1) * ts + (1 - ts), 0)
    t_coords = ((start + end) / 2.0) / np.float32(fps)
    ss = np.float32(spatial_scale)
    h_coords = np.arange(height, dtype=np.float32) * ss + ss / 2
    w_coords = np.arange(width, dtype=np.float32) * ss + ss / 2
    grids = np.meshgrid(t_coords, h_coords, w_coords, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=0).astype(np.float32)


def create_audio_position_grid(audio_frames: int, hop_length: int = 160,
                               sample_rate: int = 16000, temporal_scale: int = 4,
                               causal_offset: int = 1) -> np.ndarray:
    """(1, T): the middle, in seconds, of each audio latent frame's mel span."""
    i = np.arange(audio_frames, dtype=np.float32)
    scale, off = np.float32(temporal_scale), np.float32(causal_offset)
    start = np.maximum(i * scale + off - scale, 0)
    end = np.maximum((i + 1) * scale + off - scale, 0)
    mid = (start + end) / 2.0 * np.float32(hop_length) / np.float32(sample_rate)
    return mid[None, :].astype(np.float32)


def split_rope_tables(grid: np.ndarray, dim: int, theta: float, max_pos: Sequence[int],
                      num_heads: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split-RoPE cos/sin (num_heads, T, dim // 2 // num_heads): fractional
    positions scaled to [-1, 1], frequencies theta^t * pi / 2 over t in
    [0, 1], the front padded with (1, 0) up to dim / 2."""
    grid64 = grid.astype(np.float64)
    n_pos, seq = grid64.shape
    n_freq = max(1, dim // (2 * n_pos))
    t = (np.arange(n_freq, dtype=np.float64) / np.float64(n_freq - 1) if n_freq > 1
         else np.zeros(1))
    indices = np.power(np.float64(theta), t) * (np.pi / 2.0)
    scaled = grid64 / np.asarray(max_pos, dtype=np.float64)[:, None] * 2.0 - 1.0
    freqs = (indices[None, :, None] * scaled.T[:, None, :]).reshape(seq, n_freq * n_pos)
    cos, sin = np.cos(freqs), np.sin(freqs)
    pad = max(0, dim // 2 - n_freq * n_pos)
    if pad:
        cos = np.concatenate([np.ones((seq, pad)), cos], axis=-1)
        sin = np.concatenate([np.zeros((seq, pad)), sin], axis=-1)
    per_head = (pad + n_freq * n_pos) // num_heads
    cos = cos.reshape(seq, num_heads, per_head).transpose(1, 0, 2)
    sin = sin.reshape(seq, num_heads, per_head).transpose(1, 0, 2)
    return cos.astype(np.float32), sin.astype(np.float32)


def apply_split_rope(x, cos, sin):
    """The two halves of each head rotate against each other. x (B, T, H*D)
    flat or (B, H, T, D); cos/sin (H, T, D/2)."""
    dtype = x.dtype
    h, t = cos.shape[0], cos.shape[1]
    flat = x.ndim == 3
    xf = x.float()
    if flat:
        xf = xf.reshape(x.shape[0], t, h, -1).transpose(1, 2)
    d = xf.shape[-1]
    a, b = xf[..., : d // 2], xf[..., d // 2:]
    c, s = cos.float(), sin.float()
    out = torch.cat([a * c - b * s, b * c + a * s], dim=-1)
    if flat:
        out = out.transpose(1, 2).reshape(x.shape)
    return out.to(dtype)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """concat(cos, sin) of timesteps * exp(-log(P) * k / half), f32."""
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=timesteps.device) / float(half)
    freqs = torch.exp(float(-np.log(max_period).astype(np.float32)) * idx)
    args = timesteps.float().reshape(-1, 1) * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return emb.reshape(*timesteps.shape, dim)


# ---------------------------------------------------------------------------
# The distilled schedule and the Euler step
# ---------------------------------------------------------------------------

DISTILLED_SIGMAS = np.array([1.0, 0.99375, 0.9875, 0.98125, 0.975, 0.909375, 0.725,
                             0.421875, 0.0], dtype=np.float32)


def distilled_sigmas(token_count: int, base_shift: float = 0.95, max_shift: float = 2.05,
                     terminal: float = 0.1) -> np.ndarray:
    """The distilled table shifted by the token count (mu linear between
    1024 and 4096 tokens) and stretched so that its last non-zero sigma is
    `terminal`; 0.0 at the end."""
    sigmas = DISTILLED_SIGMAS[DISTILLED_SIGMAS > 0].copy()
    slope = (max_shift - base_shift) / (4096 - 1024)
    mu = float(min(token_count, 4096)) * slope + (base_shift - slope * 1024)
    exp_mu = np.exp(np.float32(mu))
    inner = (sigmas != 0.0) & (sigmas != 1.0)
    sigmas[inner] = exp_mu / (exp_mu + (1.0 / sigmas[inner] - 1.0))
    sigmas = np.append(sigmas, np.float32(0.0))
    one_minus = 1.0 - sigmas
    if one_minus[-2] > 0:
        sigmas = 1.0 - one_minus / (one_minus[-2] / (1.0 - terminal))
        sigmas[-1] = 0.0
    return sigmas.astype(np.float32)


def euler_step(latent, velocity, sigma: float, sigma_next: float):
    """denoised = latent - sigma * v; the next latent on the line from
    denoised through latent, or denoised itself at sigma_next = 0."""
    sigma_t = torch.tensor(sigma, dtype=torch.float32, device=latent.device)
    denoised = latent.float() - sigma_t * velocity.float()
    if sigma_next > 0:
        next_t = torch.tensor(sigma_next, dtype=torch.float32, device=latent.device)
        return denoised + next_t * (latent.float() - denoised) / sigma_t
    return denoised


def patchify(latent):
    """(B, C, F, H, W) -> (B, F*H*W, C)."""
    b, c, f, h, w = latent.shape
    return latent.permute(0, 2, 3, 4, 1).reshape(b, f * h * w, c)


def unpatchify(x, shape):
    b, c, f, h, w = shape
    return x.reshape(b, f, h, w, c).permute(0, 4, 1, 2, 3)
