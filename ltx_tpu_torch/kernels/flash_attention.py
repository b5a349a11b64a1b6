"""Flash attention: the hand-written Hopper kernels and their plain versions.

Port of ltx_tpu/kernels/flash_attention.py: the forward `flash_attention`
(B1), the forward with the softmax statistics `flash_attention_stats` (B2),
the two backward kernels `flash_attention_bwd_dq` and
`flash_attention_bwd_dkv` behind `flash_attention_backward` (B3), and the
differentiable `flash_attention_vjp` (a torch.autograd.Function: B2 forward,
B3 backward). The CUDA kernels are `ltx_tpu_torch/csrc/flash_attention_fwd.cu`
(B1 and B2, one template) and `csrc/flash_attention_bwd.cu` (B3), built with
nvcc for sm_90a on first use and bound with ctypes.

Each wrapper takes its plain PyTorch version only for tensors on the CPU.
For CUDA tensors it launches its kernel or raises: there is no fallback.
Each counts its own launches (`flash_attention.launches`, by head dim too,
`flash_attention_stats.launches`, `flash_attention_bwd_dq.launches`,
`flash_attention_bwd_dkv.launches`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ltx_tpu_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 72, 128)  # the forward's (B1, B2); 72 in 128-wide tiles
BACKWARD_HEAD_DIMS = (16, 32, 64, 128)  # B3's
_FWD_LIB = "flash_attention_fwd"
_BWD_LIB = "flash_attention_bwd"
_C_FNS = {}


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


def _wide(t):
    """t in float32, or float64 when it is float64: the plain versions'
    working precision (float64 only for gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def attention_probs(q, k, bias=None, scale: Optional[float] = None):
    """f32 softmax(scale * Q K^T + key_bias), (B, H, Tq, Tk)."""
    return torch.softmax(attention_logits(q, k, bias, scale), dim=-1)


def attention_logits(q, k, bias=None, scale: Optional[float] = None):
    """f32 scale * Q K^T + key_bias, (B, H, Tq, Tk)."""
    b, _, _, d = q.shape
    if scale is None:
        scale = d**-0.5
    bias = key_bias(bias, b, k.shape[2])
    logits = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    return logits


def flash_attention_reference(q, k, v, bias=None, scale: Optional[float] = None,
                              return_stats: bool = False):
    """Plain PyTorch version: f32 logits, f32 softmax, P cast to V's dtype,
    f32 P V, output in q's dtype. Same signature as `flash_attention`; with
    return_stats=True also the f32 (B, H, Tq) row statistics m (max logit)
    and l (sum of exp(logit - m)), as the reference's `return_stats`."""
    if not return_stats:
        probs = attention_probs(q, k, bias, scale)
        return torch.matmul(_wide(probs.to(v.dtype)), _wide(v)).to(q.dtype)
    logits = attention_logits(q, k, bias, scale)
    m = logits.amax(dim=-1)
    e = torch.exp(logits - m[..., None])
    l = e.sum(dim=-1)
    probs = e / torch.where(l == 0, 1.0, l)[..., None]
    out = torch.matmul(_wide(probs.to(v.dtype)), _wide(v)).to(q.dtype)
    return out, m, l


def _c_function(lib: str, name: str, argtypes):
    fn = _C_FNS.get(name)
    if fn is None:
        fn = getattr(build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _C_FNS[name] = fn
    return fn


def kernel_strides(name: str, t) -> tuple:
    """The element strides (sb, sh, st) by which the flash kernels (forward
    and backward) read or write `t`, a (B, H, T, D) view; ValueError, naming
    `name` and the fault, for a view their TMA loads cannot take. The rule:
    four dims, the last dense (stride 1), the other strides nonzero
    multiples of 16 bytes, the base 16-byte aligned. A view of a (B, T, H,
    D) buffer, as the DiT passes it, is one. A dim of size 1 is never
    stepped over, so its stride is free; the kernel gets the contiguous one
    there."""
    if t.ndim != 4:
        raise ValueError(f"flash_attention: {name} must be a 4-D (B, H, T, D) tensor, "
                         f"got {t.ndim}-D")
    if t.shape[3] > 1 and t.stride(3) != 1:
        raise ValueError(f"flash_attention: {name}'s last dim must be contiguous (stride 1), "
                         f"got strides {tuple(t.stride())}")
    size = t.element_size()
    dense = (t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3], t.shape[3])
    strides = tuple(s if n > 1 else c for s, n, c in zip(t.stride()[:3], t.shape[:3], dense))
    for dim, s in enumerate(strides):
        if s == 0:
            raise ValueError(f"flash_attention: {name}'s dim {dim} is broadcast (stride 0, "
                             f"strides {tuple(t.stride())})")
        if (s * size) % 16:
            raise ValueError(f"flash_attention: {name}'s stride {s} of dim {dim} is not a "
                             f"multiple of 16 bytes (strides {tuple(t.stride())})")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    return strides


def _check_cuda_args(q, k, v, bias):
    """Device, dtype and shapes of the kernels' arguments (the layout is
    each kernel's own rule)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, the kernel takes bfloat16")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be a 4-D (B, H, T, D) tensor, "
                             f"got {t.ndim}-D")
    b, h, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if bias is not None and (bias.device != q.device or not bias.is_contiguous()):
        raise ValueError("flash_attention: bias must be contiguous on q's device")


def _launch_forward(q, k, v, bias, scale, stats: bool):
    """One launch of the forward kernel; returns out, or (out, m, l). out
    takes q's layout (`torch.empty_like`): a (B, H, Tq, D) view of a (B, Tq,
    H, D) buffer when q is one, so that the caller's transpose back is free."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = d**-0.5
    bias = key_bias(bias, b, tk)
    if bias is not None:
        bias = bias.contiguous()
    strides = [kernel_strides(name, t) for name, t in (("q", q), ("k", k), ("v", v))]
    _check_cuda_args(q, k, v, bias)
    out = torch.empty_like(q)
    strides.append(kernel_strides("out", out))
    m = l = None
    if stats:
        m = torch.empty(b, h, tq, dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    fn = _c_function(_FWD_LIB, "ltx_flash_attention_fwd",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 None if m is None else m.data_ptr(),
                 None if l is None else l.data_ptr(),
                 b, h, tq, tk, d, (ctypes.c_longlong * 12)(*sum(strides, ())),
                 float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    return (out, m, l) if stats else out


def flash_attention_pv_check(q, k, v):
    """The forward kernel's P hand-off alone, for its check on the card:
    bf16(bf16(q k^T) v) over one (1, 1, 128, 128) bf16 tile each, the first
    product's f32 accumulators rounded to bf16 as the register operand of
    the second, no softmax between (CUDA only, not counted)."""
    for t in (q, k, v):
        if t.shape != (1, 1, 128, 128) or t.dtype != torch.bfloat16 \
                or t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("flash_attention_pv_check takes contiguous (1, 1, 128, 128) "
                             "bfloat16 CUDA tensors")
    out = torch.empty_like(q)
    fn = _c_function(_FWD_LIB, "ltx_flash_fwd_pv_check", [ctypes.c_void_p] * 5)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_pv_check launch failed: CUDA error {err}")
    return out


def flash_attention(q, k, v, bias=None, scale: Optional[float] = None,
                    return_stats: bool = False):
    """q: (B, H, Tq, D); k, v: (B, H, Tk, D); bias: None, (B, Tk) or
    (B, 1, 1, Tk) additive key bias (made f32). Returns (B, H, Tq, D), or
    with return_stats=True `flash_attention_stats`'s (out, m, l).

    CPU tensors go to `flash_attention_reference`; CUDA tensors launch the
    kernel (bf16, D in HEAD_DIMS: 72, SigLIP's, runs in 128-wide tiles that
    the loads fill with zeros past column 72), counted in
    `flash_attention.launches` and, by head dim, in
    `flash_attention.launches_by_head_dim`."""
    if return_stats:
        return flash_attention_stats(q, k, v, bias, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale)
    out = _launch_forward(q, k, v, bias, scale, stats=False)
    flash_attention.launches += 1
    d = q.shape[-1]
    flash_attention.launches_by_head_dim[d] = flash_attention.launches_by_head_dim.get(d, 0) + 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_head_dim = {}


def flash_attention_stats(q, k, v, bias=None, scale: Optional[float] = None):
    """The forward with the softmax statistics: (out, m, l), m and l f32
    (B, H, Tq): the max of the scaled, biased logits and the sum of
    exp(logit - m). out is normalised, as without the statistics.

    CPU tensors go to `flash_attention_reference(return_stats=True)`; CUDA
    tensors launch the forward kernel's statistics variant, counted in
    `flash_attention_stats.launches` (not in `flash_attention.launches`)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale, return_stats=True)
    out = _launch_forward(q, k, v, bias, scale, stats=True)
    flash_attention_stats.launches += 1
    return out


flash_attention_stats.launches = 0


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------


def softmax_lse(m, l):
    """lse = m + log(l) with l == 0 taken as 1, as the reference's VJP."""
    return m + torch.log(torch.where(l == 0, torch.ones_like(l), l))


def flash_attention_backward_reference(q, k, v, bias, o, lse, do,
                                       scale: Optional[float] = None):
    """Plain version of `flash_attention_backward`, the reference's
    `_bwd_tile` formulas in f32 on the whole (Tq, Tk) at once:
    delta = rowsum(dO * O), P = exp((Q * scale) K^T + bias - lse),
    dV = P^T dO, dS = P * (dO V^T - delta) * scale, dQ = dS K, dK = dS^T Q.
    Gradients in the dtypes of q, k and v."""
    b, _, _, d = q.shape
    if scale is None:
        scale = d**-0.5
    bias = key_bias(bias, b, k.shape[2])
    qf, kf, vf, dof = _wide(q), _wide(k), _wide(v), _wide(do)
    delta = (dof * _wide(o)).sum(dim=-1)
    s = torch.matmul(qf * scale, kf.transpose(-1, -2))
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = torch.exp(s - _wide(lse)[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def backward_strides(q, k, v, do) -> list:
    """The element strides (sb, sh, st) by which the backward kernels read
    q, k, v and dO: `kernel_strides`' rule for each, named in its refusal,
    and dO of q's shape and dtype. The kernels write dQ, dK and dV in the
    layouts of q, k and v."""
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_attention backward: dO must be a {q.dtype} tensor of q's "
                         f"shape {tuple(q.shape)} on {q.device}, got {do.dtype} "
                         f"{tuple(do.shape)} on {do.device}")
    return [kernel_strides(name, t) for name, t in (("q", q), ("k", k), ("v", v), ("dO", do))]


def _bwd_call(name, q, k, v, bias, do, lse, delta, outs, scale):
    """One launch of the backward kernel `name` (its C entry point), writing
    `outs` (allocated in the layouts of q, or of k and v), after checking
    the arguments' devices, dtypes, shapes and layouts."""
    _check_cuda_args(q, k, v, bias)
    if q.shape[3] not in BACKWARD_HEAD_DIMS:
        raise ValueError(f"flash_attention backward: head_dim {q.shape[3]} not in "
                         f"{BACKWARD_HEAD_DIMS}")
    strides = backward_strides(q, k, v, do)
    for arg, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {arg} must be a contiguous "
                             f"float32 {tuple(q.shape[:3])} tensor on {q.device}")
    strides += [kernel_strides(f"out{i}", t) for i, t in enumerate(outs)]
    fn = _c_function(_BWD_LIB, name, [ctypes.c_void_p] * (7 + len(outs)) + [ctypes.c_int] * 5
                     + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    b, h, tq, d = q.shape
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 *(t.data_ptr() for t in outs), b, h, tq, k.shape[2], d,
                 (ctypes.c_longlong * (3 * len(strides)))(*sum(strides, ())),
                 float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: CUDA error {err}")


def flash_attention_bwd_dq(q, k, v, bias, do, lse, delta, scale: float):
    """dQ by the dq kernel (CUDA only; the arguments as prepared by
    `flash_attention_backward`: bias None or (B, Tk) f32, delta = rowsum(dO *
    O) f32; q, k, v and dO views under `backward_strides`' rule), in q's
    layout. Counted in `flash_attention_bwd_dq.launches`."""
    dq = torch.empty_like(q)
    _bwd_call("ltx_flash_attention_bwd_dq", q, k, v, bias, do, lse, delta, (dq,), scale)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta, scale: float):
    """(dK, dV) by the dkv kernel, in the layouts of k and v (CUDA only;
    arguments as `flash_attention_bwd_dq`). Counted in
    `flash_attention_bwd_dkv.launches`."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_call("ltx_flash_attention_bwd_dkv", q, k, v, bias, do, lse, delta, (dk, dv), scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_backward(q, k, v, bias, o, lse, do, scale: Optional[float] = None):
    """(dQ, dK, dV) of `flash_attention` at (q, k, v) for the incoming
    gradient do, from the forward's output o and lse = m + log(l) (f32
    (B, H, Tq)). bias: None, (B, Tk) or (B, 1, 1, Tk); it gets no gradient.

    CPU tensors go to `flash_attention_backward_reference`; CUDA tensors
    compute delta = rowsum(dO * O) in f32 (plain torch, as XLA did in the
    reference) and launch the dq and the dkv kernels on q, k, v and dO as
    they are laid out (`backward_strides`' rule)."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, bias, o, lse, do, scale)
    b, _, _, d = q.shape
    if scale is None:
        scale = d**-0.5
    bias = key_bias(bias, b, k.shape[2])
    if bias is not None:
        bias = bias.contiguous()
    lse = lse.float().contiguous()
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    dq = flash_attention_bwd_dq(q, k, v, bias, do, lse, delta, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
    return dq, dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    """B2 forward, saving (q, k, v, bias, o, lse); B3 backward. The bias is
    an input, not a parameter: no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        o, m, l = flash_attention_stats(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, o, softmax_lse(m, l))
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        # The DiT's gradient arrives as a transposed view of (B, Tq, H, D),
        # which the kernels read as it is. Autograd may hand over a layout
        # that no TMA load can read (an expanded gradient, from a sum): that
        # one alone is made contiguous.
        if do.device.type == "cuda":
            try:
                kernel_strides("dO", do)
            except ValueError:
                do = do.contiguous()
        dq, dk, dv = flash_attention_backward(q, k, v, bias, o, lse, do, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_vjp(q, k, v, bias=None, scale: Optional[float] = None):
    """Differentiable flash attention, the port of the reference's
    `flash_attention_vjp`: the same primal as `flash_attention`, computed by
    the statistics forward; its backward is `flash_attention_backward`."""
    return _FlashAttentionFn.apply(q, k, v, bias, scale)
