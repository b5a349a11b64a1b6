"""Row RMSNorm: the hand-written Hopper kernel and its plain version.

Port of ltx_tpu/kernels/rms_norm.py (`rms_norm_pallas`): RMSNorm over the
last axis with float32 statistics, weightless or with a 1-D weight, cast back
to the input's dtype. The CUDA kernel is `ltx_tpu_torch/csrc/rms_norm.cu`,
built with nvcc for sm_90a on first use and bound with ctypes.
`ops.normalization.set_rms_impl("cuda")` routes the model norms here;
inference only, as in the reference (no gradient is defined).

`rms_norm` takes `rms_norm_reference` only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises: there is no fallback. It counts
its launches in `rms_norm.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from ltx_tpu_torch.kernels import build

LANES = 128  # the last dim must be a multiple of this, as in the reference
_LIB = "rms_norm"
_DTYPES = (torch.bfloat16, torch.float32)
_C_FNS = {}


def rms_norm_reference(x, weight=None, eps: float = 1e-6):
    """Plain PyTorch version: f32 x, mean of squares, rsqrt(+eps),
    (x * inv) then * f32 weight, one cast to x's dtype. Any last dim."""
    dtype = x.dtype
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    out = xf * inv
    if weight is not None:
        out = out * weight.float()
    return out.to(dtype)


def _c_function():
    fn = _C_FNS.get("ltx_rms_norm")
    if fn is None:
        fn = build.load(_LIB).ltx_rms_norm
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _C_FNS["ltx_rms_norm"] = fn
    return fn


def rms_norm(x, weight=None, eps: float = 1e-6):
    """x: (..., d) bf16 or f32 with d % 128 == 0 (ValueError otherwise, as
    the reference); weight: None or (d,) in x's dtype or f32. Returns x's
    shape and dtype.

    CPU tensors go to `rms_norm_reference`; CUDA tensors launch the kernel,
    counted in `rms_norm.launches` (a non-contiguous x is made contiguous
    first). A tensor that requires grad raises while autograd records: the
    kernel has no backward."""
    d = x.shape[-1]
    if d % LANES != 0:
        raise ValueError(f"rms_norm: last dim {d} is not a multiple of {LANES}")
    if weight is not None and tuple(weight.shape) != (d,):
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} against last dim {d}")
    if x.device.type == "cpu":
        return rms_norm_reference(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    if torch.is_grad_enabled() and (
            x.requires_grad or (weight is not None and weight.requires_grad)):
        raise RuntimeError("rms_norm: the kernel is inference only (no backward); "
                           "train with the plain chain")
    if x.dtype not in _DTYPES:
        raise ValueError(f"rms_norm: x is {x.dtype}, the kernel takes bfloat16 or float32")
    if weight is not None:
        if weight.device != x.device or weight.dtype not in _DTYPES:
            raise ValueError(f"rms_norm: weight {weight.dtype} on {weight.device}, "
                             f"x on {x.device}")
        weight = weight.contiguous()
        if weight.data_ptr() % 16:
            raise ValueError("rms_norm: weight is not 16-byte aligned")
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("rms_norm: x is not 16-byte aligned")
    fn = _c_function()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), None if weight is None else weight.data_ptr(),
                 out.data_ptr(), rows, d, float(eps),
                 int(x.dtype == torch.bfloat16),
                 int(weight is not None and weight.dtype == torch.bfloat16),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {err}")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0
