"""Checks of the port on a CUDA device, shared by chip_smoke.py and
tests/test_torch_cuda.py: each hand kernel against its plain version, and
the tiny pipeline on the device against the same weights on the CPU.

Attention tolerance, element by element. The kernel and the plain version
both round every probability to bf16 before the P V product (each term off
by at most 2**-9 of itself, the kernel relative to the running max, the
plain version after normalising), then round the output to bf16. So

    |kernel - plain| <= 2**-8 * (P @ |V|) + 2 ulp_bf16(|plain|)

with P the f32 softmax. The bound scales with each output element, unlike
one absolute limit for every shape.

int4 tolerance, element by element. `dequant_int4` must equal its plain
version exactly: both round q * scale and then + bias in f32, then round to
bf16. The int4 product and its plain version multiply the same bf16 X and
the same bf16 W exactly and sum in f32, in different orders: the kernel adds
16 products per mma step to its f32 accumulator, K/16 steps; cuBLAS blocks
the same way. Each step costs at most one unit of the accumulator's last
place, and the accumulator never exceeds sum_k |x| |w|, so each sum is
within (K/16 + 16) * 2**-23 * (|X| @ |W|) of the exact one: 2**-13 of it at
K = 16384, the largest K on the path. Their difference is then within
2**-12 * (|X| @ |W|), and the two roundings to bf16 add at most one bf16 ulp
of the larger output:

    |kernel - plain| <= ulp_bf16(max(|kernel|, |plain|)) + 2**-12 * (|X| @ |W|)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ltx_tpu_torch.config import GenerationConfig
from ltx_tpu_torch.kernels import flash_attention as fa
from ltx_tpu_torch.kernels import quantization as qz
from ltx_tpu_torch.ops.latents import VideoLatentShape
from ltx_tpu_torch.pipeline.generate import LTXPipeline


@dataclasses.dataclass(frozen=True)
class AttentionCase:
    name: str
    b: int
    h: int
    tq: int
    tk: int
    d: int
    pad: Optional[int] = None  # keys at the tail masked with -10000
    scale: Optional[float] = None


ATTN_CASES = (
    # the main path's shapes: DiT self- and cross-attention at 25f@768x512,
    # the text connector
    AttentionCase("dit_self_attn", 1, 32, 1536, 1536, 128),
    AttentionCase("dit_cross_attn", 1, 32, 1536, 1024, 128, pad=300),
    AttentionCase("connector_attn", 1, 30, 1024, 1024, 128, scale=128**-0.5),
    # ragged tails, every head dim, a bias, a custom scale
    AttentionCase("ragged_d128_bias", 2, 3, 200, 77, 128, pad=30),
    AttentionCase("ragged_d64", 2, 3, 130, 67, 64),
    AttentionCase("ragged_d64_scale", 1, 2, 65, 129, 64, pad=1, scale=0.3),
    AttentionCase("ragged_d32", 1, 4, 77, 50, 32, pad=7),
    AttentionCase("ragged_d16", 2, 2, 33, 16, 16),
    AttentionCase("single_row_key", 1, 1, 1, 1, 32),
)


@dataclasses.dataclass(frozen=True)
class Int4Case:
    name: str
    m: int
    k: int
    n: int
    group: int = 64


INT4_CASES = (
    # the main path's shapes at 25f@768x512 (1536 latent tokens, 1024 text
    # tokens): attention projections, FF in and out, the text-context K/V
    Int4Case("dit_attn_proj", 1536, 4096, 4096),
    Int4Case("dit_ff_in", 1536, 4096, 16384),
    Int4Case("dit_ff_out", 1536, 16384, 4096),
    Int4Case("dit_text_kv", 1024, 4096, 4096),
    # ragged rows
    Int4Case("ragged_m1", 1, 256, 256),
    Int4Case("ragged_m77", 77, 256, 256),
    Int4Case("ragged_m1000", 1000, 256, 256),
    # 121f@1024x576 (9216 tokens): the dequant-then-product route, at each
    # of its weight shapes
    Int4Case("big_m_attn_proj", 9216, 4096, 4096),
    Int4Case("big_m_ff_in", 9216, 4096, 16384),
    Int4Case("big_m_ff_out", 9216, 16384, 4096),
)
INT4_C = 2.0**-12  # the sum-order term of the int4 tolerance (docstring)
# (K, N) of every weight the path dequantizes: the attention projections,
# FF in, FF out
DEQUANT_SHAPES = ((4096, 4096), (4096, 16384), (16384, 4096))
FF_IN_SHAPE = DEQUANT_SHAPES[1]

# the tiny pipeline, device against CPU: frames in [0, 1] from bf16 Gemma,
# connector and DiT whose sums run in other orders
TINY_FRAME_ATOL = 2e-2


def attention_inputs(case: AttentionCase, device, seed: int = 1234):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(case.b, case.h, t, case.d, generator=gen,
                           device=device).bfloat16()
               for t in (case.tq, case.tk, case.tk))
    bias = None
    if case.pad is not None:
        bias = torch.zeros(case.b, 1, 1, case.tk, device=device)
        bias[..., case.tk - case.pad:] = -10000.0
    return q, k, v, bias


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits); 0 at 0."""
    x = x.float().abs()
    _, exp = torch.frexp(x)
    return torch.where(x > 0, torch.ldexp(torch.ones_like(x), exp - 8), 0.0)


def attention_tolerance(q, k, v, bias, scale, want):
    """The element-wise bound of the module docstring."""
    probs = fa.attention_probs(q, k, bias, scale)
    return 2.0**-8 * torch.matmul(probs, v.float().abs()) + 2 * bf16_ulp(want)


def check_attention(case: AttentionCase, device) -> dict:
    """One kernel launch against the plain version; raises AssertionError
    beyond the tolerance. Returns the max abs error, the largest error as a
    share of its element's tolerance, and the max error over max |plain|."""
    q, k, v, bias = attention_inputs(case, device)
    got = fa.flash_attention(q, k, v, bias, case.scale)
    want = fa.flash_attention_reference(q, k, v, bias, case.scale)
    err = (got.float() - want.float()).abs()
    share = (err / attention_tolerance(q, k, v, bias, case.scale, want)).max().item()
    out = {"max_abs_err": err.max().item(), "tol_share": share,
           "rel_to_max": err.max().item() / max(want.float().abs().max().item(), 1e-30)}
    if not share <= 1.0:
        raise AssertionError(f"flash_attention {case.name}: error {out['max_abs_err']:.3e} "
                             f"is {share:.3f} of its element's tolerance")
    return out


def int4_weights(k: int, n: int, group: int, device, seed: int = 4321) -> dict:
    """A (k, n) weight drawn at the linear init scale k**-0.5, quantized to
    int4 on `device`: {"w_q4", "scale", "bias"}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(k, n, generator=gen, device=device) * k**-0.5
    return qz.quantize_weight(w, bits=4, group_size=group)


def int4_inputs(case: Int4Case, device, seed: int = 1234):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(case.m, case.k, generator=gen, device=device).bfloat16()
    return x, int4_weights(case.k, case.n, case.group, device, seed + 1)


def int4_tolerance(x, qp, got, want):
    """The element-wise int4 bound of the module docstring."""
    w = qz.dequant_int4_reference(qp["w_q4"], qp["scale"], qp["bias"])
    sums = torch.matmul(x.float().abs(), w.float().abs())
    return bf16_ulp(torch.maximum(got.float().abs(), want.float().abs())) + INT4_C * sums


def check_int4(case: Int4Case, device) -> dict:
    """One routed int4 product (`int4_mm`: the fused kernel below
    BIG_M_DEQUANT_THRESHOLD rows, dequant then a product from it on)
    against `int4_matmul_reference`; raises AssertionError beyond the
    tolerance. Returns the max abs error, the largest share of an element's
    tolerance, and the route's kernel launches."""
    x, qp = int4_inputs(case, device)
    before = (qz.int4_matmul.launches, qz.dequant_int4.launches)
    got = qz.int4_mm(x, qp["w_q4"], qp["scale"], qp["bias"])
    launches = (qz.int4_matmul.launches - before[0], qz.dequant_int4.launches - before[1])
    want = qz.int4_matmul_reference(x, qp["w_q4"], qp["scale"], qp["bias"])
    if got.shape != want.shape or got.dtype != torch.bfloat16:
        raise AssertionError(f"int4 {case.name}: {tuple(got.shape)} {got.dtype}")
    err = (got.float() - want.float()).abs()
    share = (err / int4_tolerance(x, qp, got, want)).max().item()
    out = {"max_abs_err": err.max().item(), "tol_share": share,
           "int4_matmul_launches": launches[0], "dequant_int4_launches": launches[1]}
    if not share <= 1.0:
        raise AssertionError(f"int4 {case.name}: error {out['max_abs_err']:.3e} "
                             f"is {share:.3f} of its element's tolerance")
    return out


def check_dequant(device, shape=FF_IN_SHAPE, group: int = 64) -> dict:
    """`dequant_int4` against `dequant_int4_reference`: must be bit for bit
    equal. Returns the max abs error (0) and the count of differing values."""
    qp = int4_weights(*shape, group, device)
    got = qz.dequant_int4(qp["w_q4"], qp["scale"], qp["bias"])
    want = qz.dequant_int4_reference(qp["w_q4"], qp["scale"], qp["bias"])
    diff = (got.float() - want.float()).abs()
    out = {"max_abs_err": diff.max().item(),
           "mismatches": int((got.view(torch.int16) != want.view(torch.int16)).sum())}
    if got.shape != want.shape or out["mismatches"]:
        raise AssertionError(f"dequant_int4 {shape}: {out['mismatches']} values differ, "
                             f"max abs {out['max_abs_err']:.3e}")
    return out


def check_quantize_on_device(device, shape=FF_IN_SHAPE, group: int = 64) -> dict:
    """quantize_weight (int4) of one seeded bf16 (K, N) weight on `device`
    against the same on the CPU: every leaf must be equal bit for bit (f32
    division and round-half-to-even on both). Returns the count of differing
    values per leaf."""
    gen = torch.Generator().manual_seed(99)
    w = (torch.randn(*shape, generator=gen) * shape[0]**-0.5).bfloat16()
    cpu = qz.quantize_weight(w, 4, group)
    dev = qz.quantize_weight(w.to(device), 4, group)
    mismatches = {k: int((dev[k].cpu() != cpu[k]).sum()) for k in cpu}
    if any(mismatches.values()) or any(dev[k].dtype != cpu[k].dtype for k in cpu):
        raise AssertionError(f"quantize_weight {shape} on {device} vs the CPU: {mismatches}")
    return mismatches


def check_tiny_pipeline(device) -> dict:
    """The tiny pipeline on `device` (its kernels) against the same weights
    on the CPU (the plain versions, held against the reference by the CPU
    tests). Raises AssertionError on a disagreement or a wrong launch count.
    Returns the max abs error on the frames and the kernel launches."""
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=8, seed=3)
    cpu = LTXPipeline.random_tiny(device="cpu", seed=2)
    shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height,
                                         config.width, channels=cpu.tcfg.in_channels)
    noise = torch.randn(shape.shape, generator=torch.Generator().manual_seed(3))
    want = cpu.generate_video("a tiny prompt", config, noise).frames

    dev = LTXPipeline.random_tiny(device="cpu", seed=2)
    for name in ("transformer", "vae_decoder", "gemma", "text_encoder"):
        getattr(dev, name).to(device)
    dev.device = torch.device(device)
    before = fa.flash_attention.launches
    got = dev.generate_video("a tiny prompt", config, noise).frames
    launches = fa.flash_attention.launches - before
    # steps x blocks x (self + cross) + one per connector layer
    expected = config.num_steps * dev.tcfg.num_layers * 2 + dev.tecfg.connector_layers
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"tiny pipeline: frames {got.shape}, finite "
                             f"{bool(np.isfinite(got).all())}")
    if not err <= TINY_FRAME_ATOL:
        raise AssertionError(f"tiny pipeline: device and CPU differ by {err}")
    if launches != expected:
        raise AssertionError(f"tiny pipeline: {launches} kernel launches, "
                             f"expected {expected}")
    return {"max_abs_err": err, "launches": launches}
