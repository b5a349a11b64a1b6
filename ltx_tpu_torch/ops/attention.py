"""Scaled-dot-product attention dispatch.

Port of ltx_tpu/ops/attention.py. Attention with as many key heads as query
heads and at most a key bias (every DiT and connector attention) goes to
`kernels.flash_attention`, whatever its length: on CUDA that is the hand
kernel, on the CPU its plain version. When autograd records (grad enabled
and an input that requires grad: training) it goes to the differentiable
`flash_attention_vjp` instead, the statistics forward and the backward
kernels, as the reference's `sdpa_impl="pallas"` routes through its
`flash_attention_vjp`; under `torch.inference_mode` or `no_grad`
(generation) nothing records and B1 runs. Grouped-query attention (Gemma),
and any attention whose bias is a full (Tq, Tk) mask rather than a key bias
(Gemma with as many key/value heads as query heads; every KV-cached decode),
stays plain PyTorch (`_gqa_sdpa`, one query head a group when the heads are
equal), as the reference's kernel refuses a full mask and XLA takes it.

`impl="ring"` (the reference's sdpa_impl "ring") sends a self-attention
with at most a key bias through sequence-parallel ring attention over the
mesh that `set_sequence_parallel` registered (parallel/ring_attention.py):
a key bias rotates with K and V, a sequence that does not divide the ring
is padded with keys of bias -1e30 and the padded query rows are cut, and a
full mask, a cross-attention, no registered mesh or a ring of one rank take
the route above. "auto", "xla" and "pallas" name that route.

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

SDPA_IMPLS = ("auto", "xla", "pallas", "ring")

# The sequence-parallel mesh of sdpa(impl="ring"): set by the caller that
# shards the token axis (the trainer's --sdpa ring), as the reference's
# _SP_CONTEXT, so the mesh need not be threaded through every model.
_SP_CONTEXT = {"mesh": None, "axis": "model"}


def set_sequence_parallel(mesh, axis: str = "model") -> None:
    """Register (mesh) or clear (None) the ring-attention mesh of
    sdpa(impl="ring"); the token axis shards over the mesh's `axis`."""
    _SP_CONTEXT["mesh"] = mesh
    _SP_CONTEXT["axis"] = axis


def _ring_sdpa(q, k, v, bias, scale):
    """The ring route of `sdpa`, or None where it does not apply."""
    mesh, axis = _SP_CONTEXT["mesh"], _SP_CONTEXT["axis"]
    if mesh is None or q.shape[2] != k.shape[2] or k.shape[1] != q.shape[1]:
        return None
    n = mesh.shape[axis]
    if n < 2:
        return None
    key_bias = None
    if bias is not None:
        if bias.ndim == 4 and bias.shape[1] == 1 and bias.shape[2] == 1:
            key_bias = bias[:, 0, 0].float()
        elif bias.ndim == 2:
            key_bias = bias.float()
        else:
            return None
    from ltx_tpu_torch.parallel.ring_attention import sequence_parallel_sdpa

    t = q.shape[2]
    pad = (-t) % n
    if pad:
        widths = (0, 0, 0, pad)
        q, k, v = (torch.nn.functional.pad(x, widths) for x in (q, k, v))
        if key_bias is None:
            key_bias = torch.zeros(q.shape[0], t, dtype=torch.float32, device=q.device)
        key_bias = torch.nn.functional.pad(key_bias, (0, pad), value=-1e30)
    out = sequence_parallel_sdpa(q, k, v, mesh, bias=key_bias, scale=scale, seq_axis=axis)
    return out[:, :, :t] if pad else out


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


def _is_key_bias(bias) -> bool:
    """No bias, a (B, Tk) one, or a (B, 1, 1, Tk) one: what the flash
    kernels take. A (B, 1 | H, Tq, Tk) mask with Tq > 1 is a full mask."""
    return bias is None or bias.ndim == 2 or (bias.ndim == 4 and bias.shape[1] == 1
                                               and bias.shape[2] == 1)


def sdpa(q, k, v, bias=None, scale: Optional[float] = None, impl: str = "auto"):
    """q: (B, H, Tq, D); k, v: (B, Hkv, Tk, D) with H % Hkv == 0; bias an
    additive float mask. Hkv < H, or a bias that is not a key bias (its
    query axis longer than 1), goes to `_gqa_sdpa`; Hkv == H with no bias
    or a key bias to the flash-attention kernels. Both
    routes hand the kernels strided (B, H, T, D) views as they are (the
    DiT's views of its (B, T, H * D) projections): no copy. On CUDA a dtype
    other than bfloat16 is cast to it for the kernels and the output back
    (the module docstring). impl="ring": the sequence-parallel route
    where it applies (module docstring)."""
    if impl not in SDPA_IMPLS:
        raise ValueError(f"unknown sdpa impl: {impl}")
    dtype = q.dtype
    if impl == "ring":
        cast = q.device.type == "cuda" and dtype != torch.bfloat16
        out = _ring_sdpa(*((t.to(torch.bfloat16) for t in (q, k, v)) if cast else (q, k, v)),
                         bias, scale)
        if out is not None:
            return out.to(dtype)
    if k.shape[1] != q.shape[1] or not _is_key_bias(bias):
        return _gqa_sdpa(q, k, v, bias=bias, scale=scale)
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
