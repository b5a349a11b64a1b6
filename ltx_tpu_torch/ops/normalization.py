"""Normalization with float32 statistics, cast back to the input dtype.

Port of ltx_tpu/ops/normalization.py (`rms_norm`, `layer_norm_no_affine`,
`adaln`). The reference's optional Pallas RMSNorm is off by default and not
on this path; see ROADMAP.md, Queue B.
"""

from __future__ import annotations

import torch


def rms_norm(x, weight=None, eps: float = 1e-6):
    """RMSNorm with float32 statistics; weight=None is the weightless form."""
    dtype = x.dtype
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    out = xf * inv
    if weight is not None:
        out = out * weight.float()
    return out.to(dtype)


def layer_norm_no_affine(x, eps: float = 1e-6):
    """Affine-free LayerNorm with float32 statistics (the DiT output head)."""
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(dtype)


def adaln(x, scale, shift, eps: float = 1e-6):
    """Weightless RMSNorm, then norm(x) * (1 + scale) + shift."""
    return rms_norm(x, eps=eps) * (1 + scale) + shift
