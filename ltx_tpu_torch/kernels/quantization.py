"""Quantized linears: the weight-only group-wise affine formats (int8 /
int4) with the two int4 kernels and their plain versions, W8A8 (int8
weights per output channel, int8 activations per row), and the linear that
routes between them, with the trainable LoRA side path.

Port of ltx_tpu/kernels/quantization.py (formats, `int4_matmul` with its
straight-through backward, `dequant_int4_pallas`, `requant_int8_channel_np`,
`quantize_act_int8`, `int8_matmul` with its straight-through backward,
`linear_many`, `_lora_delta`, `linear_any`). The weight-only scheme:
groups of `group_size` rows along the INPUT dimension, asymmetric affine,

    w ~= q * scale[g] + bias[g],   q in [0, 2**bits - 1],

with the product and the sum each rounded in f32. Layouts are the JAX
package's, (in, out), never transposed: int8 codes are "w_q" (K, N) uint8;
int4 codes are "w_q4" (K/2, N) uint8 in BLOCK-PLANE packing: within each
PACK_BLOCK = 256 input rows, byte row r holds q[r] in the low nibble and
q[r + 128] in the high nibble (one plane of the whole K when 256 does not
divide K). scale and bias are (K/g, N) float32.

W8A8 leaves are "w8" (K, N) int8 and "sw" (N,) f32: w ~= w8 * sw. The
reference runs their product in XLA, not in a Pallas kernel; here it is
the library's int8 product `torch._int_mm` (`int8_mm`), exact in int32,
with the activation quantization and the rescale in plain PyTorch.

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
# W8A8: per-channel int8 weights, dynamic per-row int8 activations
# ---------------------------------------------------------------------------


def _int8_codes(a, dim: int):
    """(clip(round(a / s), -127, 127) as int8, s) with s = max |a| along
    `dim` (kept) / 127 in f32, 0 -> 1: the division in f32 whatever a's
    dtype (its max |a| read in that dtype, exact), rounding half to even.
    s is divided by a tensor: torch's CUDA kernels multiply by the
    reciprocal of a Python scalar divisor, which is not IEEE division."""
    s = torch.linalg.vector_norm(a, float("inf"), dim=dim, keepdim=True,
                                 dtype=torch.float32)
    s = s / torch.full_like(s, 127.0)
    s = torch.where(s == 0, torch.ones_like(s), s)
    return torch.div(a, s).round_().clamp_(-127, 127).to(torch.int8), s


def requant_int8_channel(qp_or_w) -> dict:
    """A raw (in, out) weight, or an int8/int4 leaf (dequantized in f32 as
    `dequantize_weight` does) -> {"w8": (in, out) int8, "sw": (out,) f32},
    on the tensor's device: sw = max |w| over the input / 127 (0 -> 1),
    w8 = clip(rint(w / sw), -127, 127). The arithmetic of the reference's
    numpy twin `_requant_int8_channel_np_numpy`. w8 comes back stored
    column-major (`w8_layout`)."""
    w = dequantize_weight(qp_or_w, torch.float32) if isinstance(qp_or_w, dict) else qp_or_w
    w8, sw = _int8_codes(w, 0)
    return {"w8": w8_layout(w8), "sw": sw[0].contiguous()}


def w8_layout(w8):
    """An (in, out) int8 weight stored column-major: the transposed view of
    a contiguous (out, in) tensor (the same tensor when it already is).
    cuBLASLt's int8 product takes its second operand so; row-major, it runs
    5-7x slower on an H100 and refuses some row counts."""
    return w8 if w8.t().is_contiguous() else w8.t().contiguous().t()


def quantize_act_int8(x):
    """Per-row dynamic activation quantization: (..., K) -> (int8 of the
    same shape, f32 scale (..., 1)), absmax / 127 per row."""
    return _int8_codes(x, -1)


# cuBLASLt's int8 product on CUDA (torch._int_mm's checks): more than 16
# rows, K and N multiples of 8
_INT8_MIN_ROWS = 17
_INT8_ALIGN = 8


def int8_mm(x8, w8):
    """x8 (M, K) int8 @ w8 (K, N) int8 -> (M, N) int32, exact: the
    library's int8 product `torch._int_mm` (cuBLASLt on CUDA; w8 best
    column-major, `w8_layout`). On CUDA the rows are padded with zero rows
    up to the 17 the library needs; K and N must be multiples of 8 there,
    else it raises. Each CUDA call counts in `int8_mm.calls`."""
    m = x8.shape[0]
    if x8.device.type != "cuda":
        return torch._int_mm(x8, w8)
    k, n = w8.shape
    if k % _INT8_ALIGN or n % _INT8_ALIGN:
        raise ValueError(f"int8_mm: K={k}, N={n}: the card's int8 product takes multiples "
                         f"of {_INT8_ALIGN}")
    if m < _INT8_MIN_ROWS:
        x8 = torch.cat([x8, x8.new_zeros(_INT8_MIN_ROWS - m, k)])
    out = torch._int_mm(x8.contiguous(), w8)
    int8_mm.calls += 1
    return out[:m]


int8_mm.calls = 0


def _int8_dot(p: dict, x8, sx, out_dtype):
    """The int32 product of x8 (..., K) and p["w8"], rescaled in f32 by
    (sx * sw) (one product first, then the scaling), cast to out_dtype."""
    lead, k = x8.shape[:-1], x8.shape[-1]
    acc = int8_mm(x8.reshape(-1, k), p["w8"]).reshape(*lead, -1)
    # int32 * f32 promotes to f32: acc converted as acc.float() would be
    return torch.mul(acc, sx * p["sw"]).to(out_dtype)


class _Int8MatmulSTE(torch.autograd.Function):
    """The reference's `_int8_mm_ste`: the W8A8 product forward; backward
    straight through the activation's rounding, gx = g @ (w8 * sw)^T for x
    only (the frozen int8 weight and its scale get none): gw = g * sw in
    f32 rounded to bf16, times w8 in bf16, accumulated in f32, the result
    in g's dtype (a bf16 product when g is bf16; an f32 product of the same
    bf16 values, exact products and f32 sums, when it is not)."""

    @staticmethod
    def forward(ctx, x, w8, sw):
        ctx.save_for_backward(w8, sw)
        x8, sx = quantize_act_int8(x)
        return _int8_dot({"w8": w8, "sw": sw}, x8, sx, x.dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        w8, sw = ctx.saved_tensors
        gw = (g.float() * sw).to(torch.bfloat16)
        compute = torch.bfloat16 if g.dtype == torch.bfloat16 else torch.float32
        gx = torch.matmul(gw.to(compute), w8.to(compute).t())
        return gx.to(g.dtype), None, None


def int8_matmul(p: dict, x):
    """x (..., K) @ {"w8" (K, N), "sw" (N,)} -> (..., N) in x's dtype: x
    quantized per row (absmax / 127), the int8 product exact in int32
    (`int8_mm`), rescaled by sx * sw. Differentiable in x by the
    straight-through `_Int8MatmulSTE` (QLoRA over a frozen W8A8 base)."""
    return _Int8MatmulSTE.apply(x, p["w8"], p["sw"])


def linear_many(ps, x) -> tuple:
    """Several linears' leaves applied to the same x (q/k/v; gate/up): when
    all are W8A8, x is quantized once and shared, each output rescaled and
    its bias added in x's dtype (no LoRA on this route, as the reference);
    otherwise `linear_any` one by one."""
    if all("w8" in p for p in ps):
        x8, sx = quantize_act_int8(x)
        outs = []
        for p in ps:
            out = _int8_dot(p, x8, sx, x.dtype)
            outs.append(out if p.get("b") is None else out + p["b"].to(x.dtype))
        return tuple(outs)
    return tuple(linear_any(p, x) for p in ps)


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
    """A quantized linear's leaves ({"w_q"|"w_q4", "scale", "bias", "b"?} or
    {"w8", "sw", "b"?}, the JAX package's keys, and "lora_a"/"lora_b"/
    "lora_s" when a LoRA side path is present) applied to x (..., K). Plain
    linears are `models.common.Linear`.

    W8A8 leaves go through `int8_matmul`, and int4 leaves that pass
    `use_int4_kernel` through `int4_mm` (x cast to bf16, a bf16 product);
    then each adds the LoRA delta and then the bias, each in x's dtype, as
    the reference's routes do: three roundings. Every other leaf
    dequantizes to bf16, then `f32_linear`: the LoRA delta and the bias
    added in f32 and one rounding to x's dtype (the reference's XLA route).
    """
    b = p.get("b")
    lora = lora_delta(p, x) if "lora_a" in p else None
    if "w8" in p or use_int4_kernel(p, x):
        if "w8" in p:
            out = int8_matmul(p, x)
        else:
            out = int4_mm(x, p["w_q4"], p["scale"], p["bias"]).to(x.dtype)
        if lora is not None:
            out = out + lora
        return out if b is None else out + b.to(x.dtype)
    w = dequantize_weight(p, torch.bfloat16).to(x.dtype)
    return f32_linear(x, w, b, lora)
