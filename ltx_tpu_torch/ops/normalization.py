"""Normalization with float32 statistics, cast back to the input dtype.

Port of ltx_tpu/ops/normalization.py: `rms_norm`, `layer_norm_no_affine`,
`adaln`, `pixel_norm` and `group_norm_f32`. `rms_norm` takes the hand-written
kernel of kernels/rms_norm.py whenever the call allows it (`rms_route`) and
the plain PyTorch chain otherwise: on the CPU, where autograd records (the
kernel has no backward, as the reference's Pallas kernel has none), and for
a shape or dtype the kernel does not take. Nothing is set globally; only
`forced_rms_chain()` sends every call to the chain, for measurement and
tests.
"""

from __future__ import annotations

import contextlib

import torch

from ltx_tpu_torch.kernels import rms_norm as rms_kernel

# CUDA calls of `rms_norm` that took the plain chain (set to 0, run, read)
rms_chain_on_cuda = 0
_FORCED_CHAIN = False
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def rms_route(device_type: str, d: int, weight_ndim, dtype, records_grad: bool) -> str:
    """"kernel" or "chain" for a call of `rms_norm` on a tensor of `dtype`
    on `device_type` with last dim d; weight_ndim None for the weightless
    form; records_grad: autograd records the call. The kernel's conditions
    are the reference's (last dim % 128, weight None or 1-D) and the card's
    (a CUDA tensor of bf16 or f32, nothing for autograd to record)."""
    if (device_type == "cuda" and d % rms_kernel.LANES == 0 and weight_ndim in (None, 1)
            and dtype in _KERNEL_DTYPES and not records_grad):
        return "kernel"
    return "chain"


@contextlib.contextmanager
def forced_rms_chain():
    """Every `rms_norm` inside takes the plain chain: to measure the kernel
    against it, never on a default path."""
    global _FORCED_CHAIN
    previous, _FORCED_CHAIN = _FORCED_CHAIN, True
    try:
        yield
    finally:
        _FORCED_CHAIN = previous


def rms_norm(x, weight=None, eps: float = 1e-6):
    """RMSNorm with float32 statistics; weight=None is the weightless form.

    Where `rms_route` says "kernel", the call launches it, or raises if it
    cannot: nothing gives way to the plain chain. Every CUDA call that takes
    the chain counts in `rms_chain_on_cuda`."""
    global rms_chain_on_cuda
    records = torch.is_grad_enabled() and (
        x.requires_grad or (weight is not None and weight.requires_grad))
    if not _FORCED_CHAIN and rms_route("cuda" if x.is_cuda else x.device.type, x.shape[-1],
                                       None if weight is None else weight.ndim, x.dtype,
                                       records) == "kernel":
        return rms_kernel.rms_norm(x, weight, eps=eps)
    if x.is_cuda:
        rms_chain_on_cuda += 1
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
