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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ltx_tpu_torch.config import GenerationConfig
from ltx_tpu_torch.kernels import flash_attention as fa
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


def check_tiny_pipeline(device) -> dict:
    """The tiny pipeline on `device` (its kernels) against the same weights
    on the CPU (the plain versions, held against the reference by the CPU
    tests). Raises AssertionError on a disagreement or a wrong launch count.
    Returns the max abs error on the frames and the kernel launches."""
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=8, seed=3)
    cpu = LTXPipeline.random_tiny(seed=2)
    shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height,
                                         config.width, channels=cpu.tcfg.in_channels)
    noise = torch.randn(shape.shape, generator=torch.Generator().manual_seed(3))
    want = cpu.generate_video("a tiny prompt", config, noise).frames

    dev = LTXPipeline.random_tiny(seed=2)
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
