"""Scaled-dot-product attention dispatch.

Port of ltx_tpu/ops/attention.py. Attention with as many key heads as query
heads and at most a key bias (every DiT and connector attention) goes to
`kernels.flash_attention`, whatever its length: on CUDA that is the hand
kernel, on the CPU its plain version. When autograd records (grad enabled
and an input that requires grad: training) it goes to the differentiable
`flash_attention_vjp` instead, the statistics forward and the backward
kernels, as the reference's `sdpa_impl="pallas"` routes through its
`flash_attention_vjp`; under `torch.inference_mode` or `no_grad`
(generation) nothing records and B1 runs. Grouped-query attention with a
full mask (Gemma) stays plain PyTorch, as it stayed on XLA in the reference.

The card's kernels take bfloat16 only. On CUDA, q, k and v of another
floating dtype (a float32 compute dtype) are cast to bfloat16 at the kernel
boundary and the output is cast back to the caller's dtype; gradients flow
through both casts. The reference's kernel takes float32 inputs, so a
float32 run on the card differs from it by that rounding (PERF.md holds the
measured error); on the CPU the plain versions compute in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ltx_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_vjp


def _gqa_sdpa(q, k, v, bias=None, scale: Optional[float] = None):
    """Grouped-query attention without repeating K/V, f32 logits and softmax.

    q: (B, H, Tq, D); k, v: (B, Hkv, Tk, D) with H = G * Hkv; bias
    broadcasts over heads: (B, 1, Tq, Tk), (B, 1, 1, Tk) or (B, H, Tq, Tk).
    """
    b, h, tq, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    if scale is None:
        scale = 1.0 / (d**0.5)
    qg = q.reshape(b, hkv, g, tq, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) * scale
    if bias is not None:
        if bias.shape[1] not in (1, h):
            raise ValueError(f"bias heads {bias.shape[1]} != 1 or {h}")
        bias5 = (bias.reshape(b, hkv, g, *bias.shape[2:])
                 if bias.shape[1] == h else bias[:, :, None])
        logits = logits + bias5.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, h, tq, d).to(q.dtype)


def sdpa(q, k, v, bias=None, scale: Optional[float] = None):
    """q: (B, H, Tq, D); k, v: (B, Hkv, Tk, D) with H % Hkv == 0; bias an
    additive float mask. Hkv < H goes to `_gqa_sdpa`; Hkv == H to the
    flash-attention kernels, which take no bias or a key bias only. Both
    routes hand the kernels strided (B, H, T, D) views as they are (the
    DiT's views of its (B, T, H * D) projections): no copy. On CUDA a dtype
    other than bfloat16 is cast to it for the kernels and the output back
    (the module docstring)."""
    if k.shape[1] != q.shape[1]:
        return _gqa_sdpa(q, k, v, bias=bias, scale=scale)
    dtype = q.dtype
    if q.device.type == "cuda" and dtype != torch.bfloat16:
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = flash_attention_vjp(q, k, v, bias=bias, scale=scale)
    else:
        out = flash_attention(q, k, v, bias=bias, scale=scale)
    return out.to(dtype)


def prepare_additive_mask(mask, dtype=torch.float32):
    """(B, S) {0, 1} validity mask -> (B, 1, 1, S) additive bias, 0 = attend,
    -10000 = pad. A floating mask is taken as already additive."""
    if mask is None:
        return None
    if mask.is_floating_point():
        return mask
    bias = (1 - mask.float()) * -10000.0
    return bias.reshape(mask.shape[0], 1, 1, mask.shape[-1]).to(dtype)
