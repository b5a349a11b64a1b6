"""Flash-attention forward: the hand-written Hopper kernel and its plain version.

Port of ltx_tpu/kernels/flash_attention.py::flash_attention (forward only).
The CUDA kernel is `ltx_tpu_torch/csrc/flash_attention_fwd.cu`, built with
nvcc for sm_90a on first use and bound with ctypes.

`flash_attention` takes the plain PyTorch version only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ltx_tpu_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
_LIB_NAME = "flash_attention_fwd"
_C_FN = None


def key_bias(bias, batch: int, tk: int):
    """None, (B, Tk) or (B, 1, 1, Tk) additive key bias -> None or (B, Tk)
    f32. Any other mask shape is not a key bias: NotImplementedError."""
    if bias is None:
        return None
    if bias.ndim == 4:
        if bias.shape[1] != 1 or bias.shape[2] != 1:
            raise NotImplementedError(
                "flash_attention supports key-bias masks only")
        bias = bias[:, 0, 0]
    if bias.shape != (batch, tk):
        raise ValueError(f"key bias shape {tuple(bias.shape)} != {(batch, tk)}")
    return bias.float()


def attention_probs(q, k, bias=None, scale: Optional[float] = None):
    """f32 softmax(scale * Q K^T + key_bias), (B, H, Tq, Tk)."""
    b, _, _, d = q.shape
    if scale is None:
        scale = d**-0.5
    bias = key_bias(bias, b, k.shape[2])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    return torch.softmax(logits, dim=-1)


def flash_attention_reference(q, k, v, bias=None, scale: Optional[float] = None):
    """Plain PyTorch version: f32 logits, f32 softmax, P cast to V's dtype,
    f32 P V, output in q's dtype. Same signature as `flash_attention`."""
    probs = attention_probs(q, k, bias, scale)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _c_function():
    global _C_FN
    if _C_FN is None:
        fn = build.load(_LIB_NAME).ltx_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _C_FN = fn
    return _C_FN


def _check_cuda_args(q, k, v, bias):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, the kernel takes bfloat16")
        if t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous 4-D tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    b, h, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if b * h > 65535:
        raise ValueError(f"flash_attention: batch*heads {b * h} > 65535")
    if bias is not None and (bias.device != q.device or not bias.is_contiguous()):
        raise ValueError("flash_attention: bias must be contiguous on q's device")


def flash_attention(q, k, v, bias=None, scale: Optional[float] = None):
    """q: (B, H, Tq, D); k, v: (B, H, Tk, D); bias: None, (B, Tk) or
    (B, 1, 1, Tk) additive key bias (made f32). Returns (B, H, Tq, D).

    CPU tensors go to `flash_attention_reference`; CUDA tensors launch the
    kernel (bf16, D in HEAD_DIMS), counted in `flash_attention.launches`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = d**-0.5
    bias = key_bias(bias, b, tk)
    if bias is not None:
        bias = bias.contiguous()
    _check_cuda_args(q, k, v, bias)
    out = torch.empty_like(q)
    fn = _c_function()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 b * h, h, tq, tk, d, float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
