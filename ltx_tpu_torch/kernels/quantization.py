"""Weight-only group-wise affine quantization (int8 / int4): the formats, the
two int4 kernels with their plain versions, and the linear that routes
between them, with the trainable LoRA side path.

Port of ltx_tpu/kernels/quantization.py (formats, `int4_matmul` with its
straight-through backward, `dequant_int4_pallas`, `_lora_delta`,
`linear_any`; W8A8 is not ported yet). Same scheme:
groups of `group_size` rows along the INPUT dimension, asymmetric affine,

    w ~= q * scale[g] + bias[g],   q in [0, 2**bits - 1],

with the product and the sum each rounded in f32. Layouts are the JAX
package's, (in, out), never transposed: int8 codes are "w_q" (K, N) uint8;
int4 codes are "w_q4" (K/2, N) uint8 in BLOCK-PLANE packing: within each
PACK_BLOCK = 256 input rows, byte row r holds q[r] in the low nibble and
q[r + 128] in the high nibble (one plane of the whole K when 256 does not
divide K). scale and bias are (K/g, N) float32.

The kernels are `ltx_tpu_torch/csrc/int4_matmul.cu` (both in one source,
sharing one dequant function), built with nvcc for sm_90a on first use and
bound with ctypes. `int4_matmul` and `dequant_int4` take their plain
versions only for tensors on the CPU; for CUDA tensors they launch the
kernel or raise. Each counts its launches (`int4_matmul.launches`,
`dequant_int4.launches`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ltx_tpu_torch.kernels import build

PACK_BLOCK = 256  # divides every DiT (4096/16384) and Gemma (3840/15360) dim

# Token count from which int4 linears dequantize the whole weight once and
# run one plain product, instead of the fused kernel that dequantizes each
# weight tile again for every tile of rows.
BIG_M_DEQUANT_THRESHOLD = 8192

_MIN_QUANT_SIZE = 1 << 16  # only quantize big matmuls (projections, FFN)

# Linear names that carry the bulk of transformer weights (video DiT, the
# dual AV transformer, Gemma's projections).
QUANTIZABLE_LEAVES = frozenset({
    "to_q", "to_k", "to_v", "to_out", "project_in", "project_out",
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
    "down_proj",
})

# K and N must each split into one of these tile widths for the kernel route
_TILES = (1024, 768, 512, 256)

# the fused kernel's tile of output columns (csrc/int4_matmul.cu kBlockN)
_KERNEL_BLOCK_N = 128

_LIB_NAME = "int4_matmul"
_C_FNS = {}


# ---------------------------------------------------------------------------
# Formats
# ---------------------------------------------------------------------------


def quantize_weight(w, bits: int = 8, group_size: int = 64) -> dict:
    """Quantize an (in, out) float weight -> {"w_q"|"w_q4", "scale", "bias"},
    on w's device. Division in f32 and rounding half to even, as jnp.round."""
    d_in, d_out = w.shape
    if d_in % group_size:
        raise ValueError(f"{d_in} % {group_size} != 0")
    levels = (1 << bits) - 1
    wf = w.float().reshape(d_in // group_size, group_size, d_out)
    w_min = wf.amin(dim=1, keepdim=True)
    w_max = wf.amax(dim=1, keepdim=True)
    # a tensor divisor: torch's CUDA kernels multiply by the reciprocal of
    # a Python scalar divisor, which is not IEEE division
    scale = (w_max - w_min) / torch.full_like(w_max, levels)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round((wf - w_min) / scale), 0, levels)
    out = {"scale": scale[:, 0].contiguous(), "bias": w_min[:, 0].contiguous()}
    q8 = q.reshape(d_in, d_out).to(torch.uint8)
    if bits == 8:
        out["w_q"] = q8
    elif bits == 4:
        out["w_q4"] = pack_int4(q8)
    else:
        raise ValueError(f"unsupported bits: {bits}")
    return out


def _effective_pack_block(d_in: int) -> int:
    """PACK_BLOCK when it divides d_in; else the whole dim (single plane)."""
    return PACK_BLOCK if d_in % PACK_BLOCK == 0 else d_in


def pack_int4(q8):
    """(in, out) uint8 values in [0, 15] -> (in/2, out) block-plane packed."""
    d_in, d_out = q8.shape
    blk = _effective_pack_block(d_in)
    half = blk // 2
    qb = q8.reshape(d_in // blk, blk, d_out)
    return (qb[:, :half] | (qb[:, half:] << 4)).reshape(d_in // 2, d_out)


def unpack_int4(packed, dtype=torch.float32):
    """Inverse of pack_int4 -> (in, out) values of `dtype`."""
    d2, d_out = packed.shape
    half = _effective_pack_block(d2 * 2) // 2
    pb = packed.reshape(d2 // half, half, d_out)
    lo = (pb & 0x0F).to(dtype)
    hi = (pb >> 4).to(dtype)
    return torch.cat([lo, hi], dim=1).reshape(d2 * 2, d_out)


def dequantize_weight(qp: dict, dtype=torch.bfloat16):
    """Inverse of quantize_weight -> (in, out) weight of `dtype`."""
    q = qp["w_q"].float() if "w_q" in qp else unpack_int4(qp["w_q4"])
    scale, bias = qp["scale"], qp["bias"]
    d_in, d_out = q.shape
    group = d_in // scale.shape[0]
    qg = q.reshape(d_in // group, group, d_out)
    w = qg * scale[:, None] + bias[:, None]
    return w.reshape(d_in, d_out).to(dtype)


def is_quantized(p) -> bool:
    return isinstance(p, dict) and ("w_q" in p or "w_q4" in p or "w8" in p)


def quantize_linear_params(p: dict, bits: int, group_size: int = 64) -> dict:
    """{"w": (in, out), "b"?} -> quantized linear params (bias kept as-is)."""
    out = quantize_weight(p["w"], bits, group_size)
    if "b" in p:
        out["b"] = p["b"]
    return out


# ---------------------------------------------------------------------------
# The int4 kernels' plain versions
# ---------------------------------------------------------------------------


def dequant_int4_reference(w_q4, scale, bias):
    """Plain version of `dequant_int4`: (K/2, N) packed codes, (K/g, N) f32
    scale and bias -> (K, N) bf16."""
    return dequantize_weight({"w_q4": w_q4, "scale": scale, "bias": bias},
                             torch.bfloat16)


def int4_matmul_reference(x, w_q4, scale, bias):
    """Plain version of `int4_matmul`: the plain dequant to bf16, then a
    bf16 product reduced in f32 and rounded to bf16 once. x (..., K) bf16."""
    return torch.matmul(x, dequant_int4_reference(w_q4, scale, bias))


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


_ARGTYPES = {
    "ltx_int4_matmul": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "ltx_dequant_int4": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _c_function(name: str):
    """The library's C function `name`, bound once a process."""
    fn = _C_FNS.get(name)
    if fn is None:
        fn = getattr(build.load(_LIB_NAME), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _C_FNS[name] = fn
    return fn


def _launch(who: str, device, name: str, *args) -> None:
    """Call the C launcher `name` with `args` and the device's current
    stream, on that device (entering its context only when it is not the
    current one); raises on a CUDA error."""
    fn = _c_function(name)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {err}")


def _check_codes(who: str, w_q4, scale, bias):
    """Device, dtype, shape, contiguity and alignment of the packed codes
    and their scale and bias. Returns (K, N, group)."""
    if w_q4.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {w_q4.device}")
    for name, t, dtype in (("w_q4", w_q4, torch.uint8), ("scale", scale, torch.float32),
                           ("bias", bias, torch.float32)):
        if t.device != w_q4.device:
            raise ValueError(f"{who}: {name} on {t.device}, w_q4 on {w_q4.device}")
        if t.dtype != dtype:
            raise ValueError(f"{who}: {name} is {t.dtype}, the kernel takes {dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous 2-D tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} is not 16-byte aligned")
    k, n = w_q4.shape[0] * 2, w_q4.shape[1]
    groups = scale.shape[0]
    if scale.shape != (groups, n) or bias.shape != scale.shape or groups == 0 \
            or k % groups:
        raise ValueError(f"{who}: w_q4 {tuple(w_q4.shape)}, scale {tuple(scale.shape)}, "
                         f"bias {tuple(bias.shape)} do not match")
    if n % 8:
        raise ValueError(f"{who}: N={n} is not a multiple of 8")
    return k, n, k // groups


def dequant_int4(w_q4, scale, bias):
    """Block-plane packed int4 (K/2, N) uint8 with (K/g, N) f32 scale and
    bias -> dense (K, N) bf16, one pass.

    CPU tensors go to `dequant_int4_reference`; CUDA tensors launch the
    kernel, counted in `dequant_int4.launches`. Bit for bit the plain
    version's arithmetic."""
    if w_q4.device.type == "cpu":
        return dequant_int4_reference(w_q4, scale, bias)
    k, n, group = _check_codes("dequant_int4", w_q4, scale, bias)
    out = torch.empty(k, n, dtype=torch.bfloat16, device=w_q4.device)
    _launch("dequant_int4", w_q4.device, "ltx_dequant_int4", w_q4.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(), k, n, group,
            _effective_pack_block(k) // 2)
    dequant_int4.launches += 1
    return out


dequant_int4.launches = 0


def int4_matmul(x, w_q4, scale, bias):
    """x (M, K) bf16 @ dequant(w_q4 (K/2, N), scale, bias (K/g, N)) -> (M, N)
    bf16, the weights dequantized tile by tile inside the product (f32
    accumulation, one rounding to bf16).

    CPU tensors go to `int4_matmul_reference`; CUDA tensors launch the fused
    kernel (K % 256 == 0, N % 128 == 0, an even group), counted in
    `int4_matmul.launches`."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, w_q4, scale, bias)
    k, n, group = _check_codes("int4_matmul", w_q4, scale, bias)
    if x.device != w_q4.device or x.dtype != torch.bfloat16 or x.ndim != 2 \
            or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"int4_matmul: x must be a contiguous, 16-byte aligned "
                         f"2-D bfloat16 tensor on {w_q4.device}")
    if x.shape[1] != k or k % PACK_BLOCK or n % _KERNEL_BLOCK_N or group % 2:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)} against K={k}, N={n}, "
                         f"group {group}: the kernel takes K % {PACK_BLOCK} == 0, "
                         f"N % {_KERNEL_BLOCK_N} == 0 and an even group")
    m = x.shape[0]
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return out
    _launch("int4_matmul", x.device, "ltx_int4_matmul", x.data_ptr(), w_q4.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(), m, k, n, group)
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _pick_block(dim: int, candidates) -> int:
    for c in candidates:
        if dim % c == 0:
            return c
    return 0


def use_int4_kernel(p: dict, x) -> bool:
    """The reference's shape rule for the kernel route: an int4 leaf whose K
    and N tile by 1024/768/512/256 and whose K is a multiple of PACK_BLOCK.
    The reference also requires a TPU; here the route is taken on every
    device (the kernel on CUDA, its plain version on the CPU)."""
    if "w_q4" not in p:
        return False
    k, n = x.shape[-1], p["w_q4"].shape[1]
    return bool(_pick_block(k, _TILES) and _pick_block(n, _TILES)
                and k % PACK_BLOCK == 0)


def _int4_mm_impl(x, w_q4, scale, bias):
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k).to(torch.bfloat16).contiguous()
    if x2.shape[0] >= BIG_M_DEQUANT_THRESHOLD:
        out = torch.matmul(x2, dequant_int4(w_q4, scale, bias))
    else:
        out = int4_matmul(x2, w_q4, scale, bias)
    return out.reshape(*lead, w_q4.shape[1])


class _Int4MatmulSTE(torch.autograd.Function):
    """The reference's `_int4_mm_ste`: the int4 product forward; backward
    g @ dequant(W)^T for x only (the frozen codes, scale and bias get none),
    the weight dequantized by `dequant_int4` (the kernel on the card, bit
    for bit the reference's `dequantize_weight`), a bf16 product with f32
    accumulation, the result in g's dtype."""

    @staticmethod
    def forward(ctx, x, w_q4, scale, bias):
        ctx.save_for_backward(w_q4, scale, bias)
        ctx.x_dtype = x.dtype
        return _int4_mm_impl(x, w_q4, scale, bias)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        w = dequant_int4(*ctx.saved_tensors)
        gx = torch.matmul(g.to(torch.bfloat16), w.t()).to(g.dtype)
        return gx.to(ctx.x_dtype), None, None, None


def int4_mm(x, w_q4, scale, bias):
    """x (..., K) -> (..., N) bf16 through the int4 kernels, by the
    reference's row rule: below BIG_M_DEQUANT_THRESHOLD rows the fused
    `int4_matmul`; from it on `dequant_int4` once, then one plain product
    (f32 accumulation, one rounding). x is cast to bf16 first.
    Differentiable in x by the straight-through `_Int4MatmulSTE`."""
    return _Int4MatmulSTE.apply(x, w_q4, scale, bias)


def lora_delta(p: dict, x):
    """The trainable LoRA side path s * (x @ A) @ B of a leaf dict holding
    "lora_a" (in, r), "lora_b" (r, out) and "lora_s" (), in f32 and rounded
    to x's dtype (the reference's `_lora_delta`)."""
    d = torch.matmul(x.float(), p["lora_a"].float())
    d = torch.matmul(d, p["lora_b"].float())
    return (d * p["lora_s"].float()).to(x.dtype)


def f32_linear(x, w_t, b=None, lora=None):
    """x @ w_t (w_t (K, N)) accumulated in f32, then the LoRA delta and the
    bias b each added in f32, one rounding to x's dtype: the reference's
    `dot(..., preferred_element_type=f32) + lora + b`. Without a LoRA this
    is `F.linear` (addmm), which gives exactly that for bf16 on CUDA
    (cuBLASLt's bias epilogue) and on the CPU, with bf16 reductions in f32
    (package init); a bf16 `x @ w + b` would round twice. With a LoRA the
    product stays f32 (a float32 product on the card, outside the int4
    kernel route)."""
    if lora is None:
        return F.linear(x, w_t.t(), None if b is None else b.to(x.dtype))
    out = torch.matmul(x.float(), w_t.float()) + lora.float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def linear_any(p: dict, x):
    """A quantized linear's leaves ({"w_q"|"w_q4", "scale", "bias", "b"?},
    the JAX package's keys, and "lora_a"/"lora_b"/"lora_s" when a LoRA side
    path is present) applied to x (..., K). Plain linears are
    `models.common.Linear`; W8A8 leaves are refused where a tree is loaded.

    int4 leaves that pass `use_int4_kernel` go through `int4_mm` (x cast to
    bf16, a bf16 product), then add the LoRA delta and then the bias, each
    in x's dtype, as the reference's kernel route does: three roundings.
    Every other leaf dequantizes to bf16, then `f32_linear`: the LoRA delta
    and the bias added in f32 and one rounding to x's dtype (the reference's
    XLA route).
    """
    b = p.get("b")
    lora = lora_delta(p, x) if "lora_a" in p else None
    if use_int4_kernel(p, x):
        out = int4_mm(x, p["w_q4"], p["scale"], p["bias"]).to(x.dtype)
        if lora is not None:
            out = out + lora
        return out if b is None else out + b.to(x.dtype)
    w = dequantize_weight(p, torch.bfloat16).to(x.dtype)
    return f32_linear(x, w, b, lora)
