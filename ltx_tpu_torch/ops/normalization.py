"""Normalization with float32 statistics, cast back to the input dtype.

Port of ltx_tpu/ops/normalization.py: `rms_norm`, `layer_norm_no_affine`,
`adaln`, `pixel_norm`, `group_norm_f32` and `set_rms_impl`. The default
`rms_norm` is the plain PyTorch chain (the reference's default is XLA's
fusion of the same chain); `set_rms_impl("cuda")` routes it through the
hand-written kernel of kernels/rms_norm.py, as `set_rms_impl("pallas")`
routes the reference's through its TPU kernel: inference only.
"""

from __future__ import annotations

import torch

from ltx_tpu_torch.kernels import rms_norm as rms_kernel

RMS_IMPLS = ("torch", "cuda")
_RMS_IMPL = "torch"


def set_rms_impl(impl: str) -> None:
    """Route rms_norm through "torch" (the plain chain, the default) or
    "cuda" (the hand-written kernel). The kernel needs a last dim that is a
    multiple of 128 and has no backward: inference only."""
    global _RMS_IMPL
    if impl not in RMS_IMPLS:
        raise ValueError(f"unknown rms impl {impl!r}")
    _RMS_IMPL = impl


def get_rms_impl() -> str:
    return _RMS_IMPL


def rms_norm(x, weight=None, eps: float = 1e-6):
    """RMSNorm with float32 statistics; weight=None is the weightless form.

    With the kernel selected, a CUDA tensor whose last dim is a multiple of
    128 (weight None or 1-D) launches it, or raises if it cannot: nothing
    gives way to the plain chain. CPU tensors and other shapes keep the
    chain, as the reference keeps XLA off a TPU."""
    if _RMS_IMPL == "cuda" and x.shape[-1] % rms_kernel.LANES == 0 and (
            weight is None or weight.ndim == 1) and x.is_cuda:
        return rms_kernel.rms_norm(x, weight, eps=eps)
    return rms_kernel.rms_norm_reference(x, weight, eps=eps)


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


def pixel_norm(x, dim: int = 1, eps: float = 1e-8):
    """Per-pixel channel RMS normalization over `dim`, float32 statistics."""
    dtype = x.dtype
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=dim, keepdim=True) + eps)
    return (xf * inv).to(dtype)


def group_norm_f32(x, weight, bias, num_groups: int, eps: float = 1e-6):
    """GroupNorm over the channel axis with float32 statistics, channels
    FIRST: x (B, C, *spatial), the port's layout for the reference's
    channels-last (..., C). Each sample's group is normalized over its
    channels and every spatial axis, with the population variance."""
    dtype = x.dtype
    xf = x.float()
    b, c = xf.shape[:2]
    xg = xf.reshape(b, num_groups, -1)
    mean = torch.mean(xg, dim=-1, keepdim=True)
    var = torch.var(xg, dim=-1, keepdim=True, correction=0)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(xf.shape)
    shape = (1, c) + (1,) * (xf.ndim - 2)
    out = out * weight.float().reshape(shape) + bias.float().reshape(shape)
    return out.to(dtype)
