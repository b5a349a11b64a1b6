"""Row RMSNorm: the hand-written Hopper kernel and its plain version.

Port of ltx_tpu/kernels/rms_norm.py (`rms_norm_pallas`): RMSNorm over the
last axis with float32 statistics, weightless or with a 1-D weight, cast back
to the input's dtype. The CUDA kernel is `ltx_tpu_torch/csrc/rms_norm.cu`,
built with nvcc for sm_90a on first use and bound with ctypes; `geometry`
chooses its persistent grid and its rings. `ops.normalization.rms_norm`
routes the model norms here whenever the call allows it; inference only, as
in the reference (no gradient is defined).

`rms_norm` takes `rms_norm_reference` only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises: there is no fallback. It counts
its launches in `rms_norm.launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ltx_tpu_torch.kernels import build

LANES = 128  # the last dim must be a multiple of this, as in the reference
_LIB = "rms_norm"
_C_FNS = {}
_SMS = {}

# the kernel's shared-memory layout (csrc/rms_norm.cu): the mbarriers (the
# weight's, then one a stage), the weight, then each warp's ring of stages
BAR_BYTES = 1152
MAX_WARPS, MAX_STAGES = 8, 16
# (CTAs an SM, the shared memory each may hold): two CTAs share an H100 SM's
# 228 KB less 1 KB each; one may hold 227 KB
SMEM_PER_CTA = ((2, 115712), (1, 232448))
# a row too wide for two stages of one warp streams through in chunks of
# this many bytes (a multiple of 32 lanes x 16 bytes)
CHUNK_BYTES = 8192


@dataclasses.dataclass(frozen=True)
class Geometry:
    grid: int         # CTAs, at most `per_sm` an SM and at most one a row
    warps: int        # warps a CTA
    stages: int       # ring stages a warp
    stage_bytes: int  # bytes a stage: a whole row, or a chunk
    chunks: int       # stages a row: 1, or the chunks read twice (sum, then scale)


@functools.lru_cache(maxsize=512)
def geometry(rows: int, d: int, x_size: int, w_size: int, sms: int) -> Geometry:
    """The kernel's launch for `rows` rows of d values of x_size bytes, a
    weight of w_size bytes a value (0: weightless), on `sms` SMs: two CTAs
    an SM (at most one a row), else one, with whole rows in the stages and
    the weight beside them; else rows in chunks of CHUNK_BYTES, the weight
    read from global memory (`_fit`)."""
    row_bytes = d * x_size
    w_bytes = -(-d * w_size // 128) * 128
    for per_sm, budget in SMEM_PER_CTA:
        g = _fit(rows, per_sm * sms, budget - BAR_BYTES - w_bytes, row_bytes, 1)
        if g is not None:
            return g
    per_sm, budget = SMEM_PER_CTA[0]
    return _fit(rows, per_sm * sms, budget - BAR_BYTES, CHUNK_BYTES,
                -(-row_bytes // CHUNK_BYTES))


def _fit(rows: int, ctas: int, room: int, stage_bytes: int, chunks: int):
    """The most warps (8, 4, 2, 1) a CTA, but not twice as many as its rows,
    whose rings fit `room` bytes and hold every item a warp takes, or at
    least two (so that one is in flight while the warp works on another):
    as many stages as fit, no more than a warp's items and no more than
    MAX_STAGES. None if not even one warp's ring fits."""
    grid = min(rows, ctas)
    per_cta = -(-rows // grid)
    for warps in (MAX_WARPS, 4, 2, 1):
        if warps // 2 >= per_cta:
            continue  # half the warps would have no row
        items = -(-per_cta // warps) * (1 if chunks == 1 else 2 * chunks)
        stages = min(MAX_STAGES, items, room // (warps * stage_bytes))
        if stages >= min(2, items):
            return Geometry(grid, warps, stages, stage_bytes, chunks)
    return None


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
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                ctypes.c_float] + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _C_FNS["ltx_rms_norm"] = fn
    return fn


def _sm_count(index: int) -> int:
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def rms_norm(x, weight=None, eps: float = 1e-6):
    """x: (..., d) bf16 or f32 with d % 128 == 0 (ValueError otherwise, as
    the reference); weight: None or (d,) in bf16 or f32. Returns x's shape
    and dtype.

    CPU tensors go to `rms_norm_reference`; CUDA tensors launch the kernel,
    counted in `rms_norm.launches` (a non-contiguous x is made contiguous
    first). A tensor that requires grad raises while autograd records: the
    kernel has no backward. The host's work is what the launch needs: the
    geometry is cached by shape, the current stream's handle read once (as
    torch's own compiled kernels read it), and the device's context entered
    only when x is not on the current device."""
    d = x.shape[-1]
    if d % LANES != 0:
        raise ValueError(f"rms_norm: last dim {d} is not a multiple of {LANES}")
    if weight is not None and (weight.ndim != 1 or weight.shape[0] != d):
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} against last dim {d}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return rms_norm_reference(x, weight, eps)
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    if torch.is_grad_enabled() and (
            x.requires_grad or (weight is not None and weight.requires_grad)):
        raise RuntimeError("rms_norm: the kernel is inference only (no backward); "
                           "train with the plain chain")
    x_bf16 = x.dtype == torch.bfloat16
    if not x_bf16 and x.dtype != torch.float32:
        raise ValueError(f"rms_norm: x is {x.dtype}, the kernel takes bfloat16 or float32")
    index = x.get_device()
    w_ptr, w_bf16, w_size = None, 0, 0
    if weight is not None:
        w_bf16 = int(weight.dtype == torch.bfloat16)
        if weight.get_device() != index or not (w_bf16 or weight.dtype == torch.float32):
            raise ValueError(f"rms_norm: weight {weight.dtype} on {weight.device}, "
                             f"x on {x.device}")
        weight = weight.contiguous()
        w_ptr, w_size = weight.data_ptr(), weight.element_size()
        if w_ptr % 16:
            raise ValueError("rms_norm: weight is not 16-byte aligned")
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    x_ptr = x.data_ptr()
    if x_ptr % 16:
        raise ValueError("rms_norm: x is not 16-byte aligned")
    g = geometry(rows, d, 2 if x_bf16 else 4, w_size, _sm_count(index))
    fn = _C_FNS.get("ltx_rms_norm") or _c_function()
    args = (x_ptr, w_ptr, out.data_ptr(), rows, d, eps, int(x_bf16), w_bf16, g.grid,
            g.warps, g.stages, g.stage_bytes, g.chunks)
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {err}")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0
