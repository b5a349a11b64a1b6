"""Checks of the port on a CUDA device, shared by chip_smoke.py and
tests/test_torch_cuda.py: each hand kernel against its plain version, and
the tiny pipeline on the device against the same weights on the CPU.

Attention tolerance, element by element. The kernel and the plain version
both round every probability to bf16 before the P V product (the kernel
relative to the running max, the plain version after normalising), then
round the output to bf16. The bound takes each rounding as 2**-9 of its
term:

    |kernel - plain| <= 2**-8 * (P @ |V|) + 2 ulp_bf16(|plain|)

with P the f32 softmax. The bound scales with each output element, unlike
one absolute limit for every shape. bf16's unit roundoff is 2**-8, not
2**-9, so a correct kernel can break this bound where a few keys carry each
row's weight: at BWD_CASES' "many_heads_masked" (6 live keys a row, 5.6M
outputs) an exact emulation of the kernel's rounding reaches 1.11 of it
(tests/test_torch_attention.py). That miss is left standing, with the
bound, until a change of its own corrects it (STANDING_MISSES).

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

Softmax statistics (the forward's stats variant), row by row. The kernel
and the plain version compute the same f32 logits with the D-long dot in
another order (each within (D/16 + 16) * 2**-23 * scale * (|Q| @ |K|^T) of
exact, < 2**-17 of it at D = 128 and |logit| ~ 10 at the path shapes), so

    |m_kernel - m_plain| <= 2**-14 * max(|m_plain|, 1),
    |l_kernel - l_plain| <= 2**-12 * l_plain

(l sums Tk terms in f32, each off by about its logit's error); the output
is held to the attention bound above.

Backward, element by element. Both take the same q, k, v, dO, lse and the
same delta (one torch op). The kernel rounds P and dS to bf16 before the
dV, dK and dQ products (each off by at most 2**-8 of itself), the plain
version keeps them f32; both sum in f32 in other orders and round once to
bf16. Besides that rounding, P carries its logit's error (eps_P below) and
dS carries P's error and dO V^T's sum order (eps_S):

    eps_P = 2**-16 * P * scale * (|Q| @ |K|^T)
    eps_S = 2**-16 * P * scale * (|dO| @ |V|^T) + eps_P * |dP - delta| * scale
    |dV_k - dV_p| <= (2**-8 * P + eps_P)^T @ |dO| + 2 ulp_bf16(|dV_p|)
    |dQ_k - dQ_p| <= (2**-8 * |dS| + eps_S) @ |K| + 2 ulp_bf16(|dQ_p|)
    |dK_k - dK_p| <= (2**-8 * |dS| + eps_S)^T @ |Q| + 2 ulp_bf16(|dK_p|)

(2**-16 is more than twice the (D/16 + 16) * 2**-23 sum-order bound at
D <= 128.) Keys that the bias masks with -1e30 must get exactly 0 in dK and
dV on both sides.

RMSNorm tolerance, element by element. The kernel and the plain version
evaluate the same f32 expression, (x * inv) * w with inv = rsqrt(mean(x^2) +
eps): they differ in the order of the mean's sum (d positive terms, each
order within about log2(d) f32 roundings of the exact sum) and in the card's
rsqrt (2 ulp). Before the output rounding the kernel's value is therefore
within RMS_F32_ULPS = 16 units of the last f32 place of the plain one, and
the output rounding (none for f32, to nearest even for bf16) adds at most
half a bf16 ulp to a value compared with the plain version's f32 one:

    |kernel - plain_f32| <= RMS_F32_ULPS * 2**-23 * |plain_f32| [+ ulp_bf16 / 2]

so a bf16 output differs from the plain bf16 output by at most one bf16 ulp,
and only where the two f32 values straddle a rounding boundary; the share of
such elements is reported.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ltx_tpu_torch.config import GenerationConfig, TransformerConfig
from ltx_tpu_torch.kernels import flash_attention as fa
from ltx_tpu_torch.kernels import quantization as qz
from ltx_tpu_torch.kernels import rms_norm as rk
from ltx_tpu_torch.models.common import init_random_
from ltx_tpu_torch.models.dit import LTXTransformer
from ltx_tpu_torch.ops.attention import prepare_additive_mask
from ltx_tpu_torch.ops import schedule
from ltx_tpu_torch.ops.latents import VideoLatentShape
from ltx_tpu_torch.ops.normalization import get_rms_impl, set_rms_impl
from ltx_tpu_torch.ops.rope import video_rope
from ltx_tpu_torch.pipeline.generate import LTXPipeline
from ltx_tpu_torch.train.flow_match import flow_match_loss
from ltx_tpu_torch.train.lora import add_lora
from ltx_tpu_torch.train.step import TrainConfig, init_train_state, make_train_step


@dataclasses.dataclass(frozen=True)
class AttentionCase:
    name: str
    b: int
    h: int
    tq: int
    tk: int
    d: int
    # keys masked with -10000: one count for every row, or one count per row
    # (0: that row's bias is all zeros); at the tail, or at the head as the
    # tokenizer pads
    pad: Optional[Union[int, tuple]] = None
    scale: Optional[float] = None
    pad_left: bool = False
    # "bhtd": contiguous (B, H, T, D) tensors; "bthd": (B, H, T, D) views of
    # (B, T, H, D) buffers, as the DiT passes its projections
    layout: str = "bhtd"


ATTN_CASES = (
    # the main path's shapes: DiT self- and cross-attention at 25f@768x512,
    # the text connector
    AttentionCase("dit_self_attn", 1, 32, 1536, 1536, 128),
    AttentionCase("dit_cross_attn", 1, 32, 1536, 1024, 128, pad=300),
    AttentionCase("connector_attn", 1, 30, 1024, 1024, 128, scale=128**-0.5),
    # the guided two-stage path at 121f@1024x576: stage 1's three guidance
    # rows (conditional, negative, STG) of 2304 tokens, stage 2's two rows of
    # 9216, each over its own 1024-token text context. The connector hands on
    # a mask of ones, so the path's key bias is a tensor of zeros; the cases
    # give every row its own, rows of zeros among them. The connector at two
    # text rows (prompt and negative, or two prompts); two prompts at the
    # north star
    AttentionCase("stage1_self_attn", 3, 32, 2304, 2304, 128),
    AttentionCase("stage1_cross_attn", 3, 32, 2304, 1024, 128, pad=(300, 0, 517),
                  pad_left=True),
    AttentionCase("stage2_self_attn", 2, 32, 9216, 9216, 128),
    AttentionCase("stage2_cross_attn", 2, 32, 9216, 1024, 128, pad=(0, 300), pad_left=True),
    AttentionCase("connector_attn_two_rows", 2, 30, 1024, 1024, 128, scale=128**-0.5),
    AttentionCase("batched_self_attn", 2, 32, 1536, 1536, 128),
    AttentionCase("batched_cross_attn", 2, 32, 1536, 1024, 128, pad=(300, 0), pad_left=True),
    # ragged tails, every head dim, a bias, a custom scale
    AttentionCase("ragged_d128_bias", 2, 3, 200, 77, 128, pad=30),
    AttentionCase("ragged_d64", 2, 3, 130, 67, 64),
    AttentionCase("ragged_d64_scale", 1, 2, 65, 129, 64, pad=1, scale=0.3),
    AttentionCase("ragged_d32", 1, 4, 77, 50, 32, pad=7),
    AttentionCase("ragged_d16", 2, 2, 33, 16, 16),
    AttentionCase("single_row_key", 1, 1, 1, 1, 32),
    # the forward kernel's tile edges (128 queries a block, 128 keys a
    # tile): Tq and Tk one past a multiple of 128, with a bias; Tk below one
    # tile under several query tiles
    AttentionCase("tile_edges_bias", 1, 4, 257, 129, 128, pad=30),
    AttentionCase("short_keys_many_q_tiles", 2, 2, 384, 40, 128),
    # strided views of (B, T, H, D) buffers: the DiT's self-attention, and a
    # ragged one with a bias
    AttentionCase("dit_self_attn_view", 1, 32, 1536, 1536, 128, layout="bthd"),
    AttentionCase("ragged_d128_view", 2, 3, 200, 77, 128, pad=30, layout="bthd"),
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
    if case.layout == "bthd":
        q, k, v = (torch.randn(case.b, t, case.h, case.d, generator=gen,
                               device=device).bfloat16().transpose(1, 2)
                   for t in (case.tq, case.tk, case.tk))
    else:
        q, k, v = (torch.randn(case.b, case.h, t, case.d, generator=gen,
                               device=device).bfloat16()
                   for t in (case.tq, case.tk, case.tk))
    bias = None
    if case.pad is not None:
        bias = torch.zeros(case.b, 1, 1, case.tk, device=device)
        pads = case.pad if isinstance(case.pad, tuple) else (case.pad,) * case.b
        for row, pad in enumerate(pads):
            keys = slice(0, pad) if case.pad_left else slice(case.tk - pad, case.tk)
            bias[row, ..., keys] = -10000.0
    return q, k, v, bias


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits); 0 at 0."""
    x = x.float().abs()
    _, exp = torch.frexp(x)
    return torch.where(x > 0, torch.ldexp(torch.ones_like(x), exp - 8), 0.0)


# the plain version keeps a (B, heads, Tq, Tk) f32 score matrix: the checks
# take it this many bytes at a time, some heads after others, so that the
# 9216-token shapes fit beside the rest
PLAIN_SCORE_BYTES = 2**31


def head_slices(q, k):
    """Slices of the head axis, each with a score matrix of at most
    PLAIN_SCORE_BYTES (at least one head)."""
    b, h, tq, _ = q.shape
    step = max(1, int(PLAIN_SCORE_BYTES // (4 * b * tq * k.shape[2])))
    return [slice(s, min(s + step, h)) for s in range(0, h, step)]


def attention_reference_by_heads(q, k, v, bias, scale):
    """flash_attention_reference, some heads after others (head_slices):
    the same values, heads being independent."""
    return torch.cat([fa.flash_attention_reference(q[:, hs], k[:, hs], v[:, hs], bias, scale)
                      for hs in head_slices(q, k)], dim=1)


def attention_tolerance(q, k, v, bias, scale, want):
    """The element-wise bound of the module docstring."""
    pv = torch.cat([torch.matmul(fa.attention_probs(q[:, hs], k[:, hs], bias, scale),
                                 v[:, hs].float().abs()) for hs in head_slices(q, k)], dim=1)
    return 2.0**-8 * pv + 2 * bf16_ulp(want)


def check_attention(case: AttentionCase, device) -> dict:
    """One kernel launch against the plain version; raises AssertionError
    beyond the tolerance. Returns the max abs error, the largest error as a
    share of its element's tolerance, and the max error over max |plain|."""
    q, k, v, bias = attention_inputs(case, device)
    got = fa.flash_attention(q, k, v, bias, case.scale)
    want = attention_reference_by_heads(q, k, v, bias, case.scale)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"flash_attention {case.name}: {tuple(got.shape)} {got.dtype}")
    err = (got.float() - want.float()).abs()
    share = (err / attention_tolerance(q, k, v, bias, case.scale, want)).max().item()
    out = {"max_abs_err": err.max().item(), "tol_share": share,
           "rel_to_max": err.max().item() / max(want.float().abs().max().item(), 1e-30)}
    if not share <= 1.0:
        raise AssertionError(f"flash_attention {case.name}: error {out['max_abs_err']:.3e} "
                             f"is {share:.3f} of its element's tolerance")
    return out


def check_pv_handoff(device, seed: int = 99) -> dict:
    """The forward kernel's P hand-off alone: bf16(bf16(q k^T) v) over one
    (1, 1, 128, 128) tile (`fa.flash_attention_pv_check`: the S
    accumulators of the first wgmma, rounded to bf16 pairs, as the register
    A operand of the second) against the same in f32 products. Both round
    every S to bf16 (each off by at most 2**-9 of itself) and the output
    once, so element by element

        |kernel - plain| <= 2**-8 * (|S| @ |V|) + 2 ulp_bf16(|plain|),

    where a wrong fragment mapping would be off by the size of the output.
    Raises AssertionError beyond it; returns the max abs error and share."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(1, 1, 128, 128, generator=gen, device=device).bfloat16()
               for _ in range(3))
    got = fa.flash_attention_pv_check(q, k, v)[0, 0].float()
    s = q[0, 0].float() @ k[0, 0].float().t()
    want = (s.bfloat16().float() @ v[0, 0].float()).bfloat16()
    err = (got - want.float()).abs()
    tol = 2.0**-8 * (s.abs() @ v[0, 0].float().abs()) + 2 * bf16_ulp(want)
    out = {"max_abs_err": err.max().item(), "tol_share": (err / tol).max().item(),
           "max_abs": want.float().abs().max().item()}
    if not out["tol_share"] <= 1.0:
        raise AssertionError(f"P hand-off: error {out['max_abs_err']:.3e} is "
                             f"{out['tol_share']:.3f} of its element's tolerance")
    return out


# the statistics' tolerances (docstring)
STATS_M_REL = 2.0**-14
STATS_L_REL = 2.0**-12


@dataclasses.dataclass(frozen=True)
class BackwardCase:
    name: str
    b: int
    h: int
    tq: int
    tk: int
    d: int
    # None; ("left", n): the first n keys -10000, as the tokenizer pads;
    # ("rows", n0, n1): per-row tails of -10000 from key n0 (row 0) and n1
    # (row 1); ("masked", n): keys from n on -1e30 (their dK, dV must be 0)
    bias: Optional[tuple] = None
    scale: Optional[float] = None
    # "bhtd": contiguous (B, H, T, D) tensors; "bthd": q, k, v and dO as
    # (B, H, T, D) views of (B, T, H * D) buffers, as the DiT passes them
    layout: str = "bhtd"


BWD_CASES = (
    # the training path's shapes at 25f@768x512: DiT self-attention and the
    # cross-attention over a 1024-token, left-padded text context
    BackwardCase("dit_self_attn", 1, 32, 1536, 1536, 128),
    BackwardCase("dit_cross_attn", 1, 32, 1536, 1024, 128, bias=("left", 300)),
    # ragged tails (Tq, Tk not multiples of 64 or 32), every head dim, per-row
    # biases, a -1e30 masked key tail
    BackwardCase("ragged_d128_rows", 2, 3, 200, 77, 128, bias=("rows", 60, 33)),
    BackwardCase("ragged_d64", 1, 2, 130, 67, 64, scale=0.3),
    BackwardCase("ragged_d64_rows", 2, 2, 97, 130, 64, bias=("rows", 100, 7)),
    BackwardCase("ragged_d32_masked", 1, 4, 77, 50, 32, bias=("masked", 41)),
    BackwardCase("ragged_d16_masked", 2, 2, 33, 40, 16, bias=("masked", 17)),
    # the forward kernel's tile edges (ATTN_CASES)
    BackwardCase("tile_edges_bias", 1, 4, 257, 129, 128, bias=("left", 30)),
    BackwardCase("short_keys_many_q_tiles", 2, 2, 384, 40, 128),
    # the DiT's self-attention as it reaches the kernels: views of its
    # projections, and of its incoming gradient
    BackwardCase("dit_self_attn_view", 1, 32, 1536, 1536, 128, layout="bthd"),
    # batch * heads past 65535 at tiny T, a bias per batch row masking -1e30
    BackwardCase("many_heads_masked", 35000, 2, 5, 9, 16, bias=("masked", 6)),
)
# the cases whose gradients must be bitwise equal from run to run (the
# training path's shapes)
DETERMINISM_CASES = ("dit_self_attn", "dit_cross_attn")
# checks that a correct kernel misses because their bound is too tight (the
# module docstring): case name -> the check. chip_smoke.py prints these
# misses as standing failures instead of stopping on them;
# tests/test_torch_cuda.py holds them as it holds every other case.
STANDING_MISSES = {"many_heads_masked": "flash_attention_stats out"}


def backward_inputs(case: BackwardCase, device, seed: int = 2024):
    """q, k, v, dO (bf16) and the (B, 1, 1, Tk) f32 bias or None; o and lse
    from the plain statistics forward, shared by kernel and plain."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if case.layout == "bthd":
        q, k, v, do = (torch.randn(case.b, t, case.h * case.d, generator=gen,
                                   device=device).bfloat16()
                       .unflatten(2, (case.h, case.d)).transpose(1, 2)
                       for t in (case.tq, case.tk, case.tk, case.tq))
    else:
        q, k, v, do = (torch.randn(case.b, case.h, t, case.d, generator=gen,
                                   device=device).bfloat16()
                       for t in (case.tq, case.tk, case.tk, case.tq))
    bias = None
    if case.bias is not None:
        bias = torch.zeros(case.b, 1, 1, case.tk, device=device)
        kind = case.bias[0]
        if kind == "left":
            bias[..., :case.bias[1]] = -10000.0
        elif kind == "rows":
            for row, start in enumerate(case.bias[1:1 + case.b]):
                bias[row, ..., start:] = -10000.0
        else:
            bias[..., case.bias[1]:] = -1e30
    o, m, l = fa.flash_attention_reference(q, k, v, bias, case.scale, return_stats=True)
    return q, k, v, do, bias, o, fa.softmax_lse(m, l)


def check_stats(case: BackwardCase, device, hold_out: bool = True) -> dict:
    """The forward's statistics variant against the plain version: out
    within the attention bound, m and l within STATS_M_REL / STATS_L_REL.
    Raises AssertionError beyond them; returns the errors and shares. With
    hold_out False the out share is returned and not held (a standing miss,
    STANDING_MISSES); m and l are held all the same."""
    q, k, v, _, bias, _, _ = backward_inputs(case, device)
    o, m, l = fa.flash_attention_stats(q, k, v, bias, case.scale)
    o_p, m_p, l_p = fa.flash_attention_reference(q, k, v, bias, case.scale,
                                                  return_stats=True)
    err = (o.float() - o_p.float()).abs()
    out = {
        "max_abs_err": err.max().item(),
        "tol_share": (err / attention_tolerance(q, k, v, bias, case.scale, o_p)).max().item(),
        "m_share": ((m - m_p).abs() / (STATS_M_REL * m_p.abs().clamp_min(1.0))).max().item(),
        "l_share": ((l - l_p).abs() / (STATS_L_REL * l_p)).max().item(),
    }
    held = (out["tol_share"] if hold_out else 0.0, out["m_share"], out["l_share"])
    if not max(held) <= 1.0:
        raise AssertionError(f"flash_attention_stats {case.name}: shares of the tolerance "
                             f"out {out['tol_share']:.3f}, m {out['m_share']:.3f}, "
                             f"l {out['l_share']:.3f}")
    return out


def tolerance_share(got, want, tol) -> float:
    """The largest |got - want| / tol, an exact 0 counting 0 where tol is 0
    (a masked key's gradient)."""
    err = (got.float() - want.float()).abs()
    return torch.where(err == 0, 0.0, err / tol).max().item()


def backward_tolerance(q, k, v, bias, do, lse, scale, want):
    """The element-wise backward bounds of the module docstring, for the
    plain gradients `want` = (dQ, dK, dV)."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    if scale is None:
        scale = q.shape[-1]**-0.5
    o = fa.flash_attention_reference(q, k, v, bias, scale)
    delta = (dof * o.float()).sum(dim=-1)
    p = torch.exp(fa.attention_logits(q, k, bias, scale) - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).abs()
    eps_p = 2.0**-16 * p * scale * torch.matmul(qf.abs(), kf.abs().transpose(-1, -2))
    eps_s = (2.0**-16 * p * scale * torch.matmul(dof.abs(), vf.abs().transpose(-1, -2))
             + eps_p * (dp - delta[..., None]).abs() * scale)
    del dp
    s_term = 2.0**-8 * ds + eps_s
    del ds, eps_s
    dq_w, dk_w, dv_w = want
    tol_dq = torch.matmul(s_term, kf.abs()) + 2 * bf16_ulp(dq_w)
    tol_dk = torch.matmul(s_term.transpose(-1, -2), qf.abs()) + 2 * bf16_ulp(dk_w)
    tol_dv = (torch.matmul((2.0**-8 * p + eps_p).transpose(-1, -2), dof.abs())
              + 2 * bf16_ulp(dv_w))
    return tol_dq, tol_dk, tol_dv


def check_backward(case: BackwardCase, device) -> dict:
    """flash_attention_backward (the dq and dkv kernels) against
    flash_attention_backward_reference; raises AssertionError beyond the
    element-wise bounds, when a -1e30 masked key gets a nonzero dK or dV,
    or when the kernels' dQ, dK or dV is not in the layout of q, k or v
    (the plain version's are contiguous). Returns per gradient the max abs
    error and the largest share of an element's tolerance, and the launches
    of each kernel."""
    q, k, v, do, bias, o, lse = backward_inputs(case, device)
    before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    got = fa.flash_attention_backward(q, k, v, bias, o, lse, do, case.scale)
    launches = (fa.flash_attention_bwd_dq.launches - before[0],
                fa.flash_attention_bwd_dkv.launches - before[1])
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, case.scale)
    tols = backward_tolerance(q, k, v, bias, do, lse, case.scale, want)
    out = {"dq_launches": launches[0], "dkv_launches": launches[1]}
    for name, g, w, tol, t in zip(("dq", "dk", "dv"), got, want, tols, (q, k, v)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"backward {case.name} {name}: {tuple(g.shape)} {g.dtype}")
        if g.device.type == "cuda" and g.stride() != t.stride():
            raise AssertionError(f"backward {case.name} {name}: strides {g.stride()}, its "
                                 f"input's {t.stride()}")
        out[name] = {"max_abs_err": (g.float() - w.float()).abs().max().item(),
                     "tol_share": tolerance_share(g, w, tol)}
    if case.bias is not None and case.bias[0] == "masked":
        masked = slice(case.bias[1], None)
        out["masked_nonzero"] = int((got[1][:, :, masked] != 0).sum()
                                    + (got[2][:, :, masked] != 0).sum())
        if out["masked_nonzero"]:
            raise AssertionError(f"backward {case.name}: {out['masked_nonzero']} nonzero "
                                 "dK/dV values on masked keys")
    worst = max(out[n]["tol_share"] for n in ("dq", "dk", "dv"))
    if not worst <= 1.0:
        raise AssertionError(f"backward {case.name}: shares of the tolerance "
                             + ", ".join(f"{n} {out[n]['tol_share']:.3f}"
                                         for n in ("dq", "dk", "dv")))
    return out


def check_backward_deterministic(case: BackwardCase, device) -> dict:
    """Two runs of flash_attention_backward on the same inputs: dQ, dK and
    dV must be bitwise equal (no atomics: each gradient element is summed
    by one block in a fixed order). Raises AssertionError otherwise;
    returns the count of differing values per gradient."""
    q, k, v, do, bias, o, lse = backward_inputs(case, device)
    first = fa.flash_attention_backward(q, k, v, bias, o, lse, do, case.scale)
    second = fa.flash_attention_backward(q, k, v, bias, o, lse, do, case.scale)
    out = {name: int((a.view(torch.int16) != b.view(torch.int16)).sum())
           for name, a, b in zip(("dq", "dk", "dv"), first, second)}
    if any(out.values()):
        raise AssertionError(f"backward {case.name}: two runs differ {out}")
    return out


@dataclasses.dataclass(frozen=True)
class RmsCase:
    name: str
    rows: int
    d: int
    dtype: str = "bfloat16"       # x's dtype
    weight: Optional[str] = None  # None (weightless), or the weight's dtype


RMS_CASES = (
    # the guided two-stage path at 121f@1024x576: stage 1's three guidance
    # rows of 2304 tokens and stage 2's two rows (STG stays, CFG goes) of
    # 9216, the DiT's q/k norms (weighted) and adaln norms (weightless);
    # attn2's k norm over each stage's text context; one row of 9216 tokens;
    # the north star's 1536 tokens; the connector's norms at 3840
    RmsCase("dit_stage1_qk", 3 * 2304, 4096, weight="bfloat16"),
    RmsCase("dit_stage1_adaln", 3 * 2304, 4096),
    RmsCase("dit_stage2_qk", 2 * 9216, 4096, weight="bfloat16"),
    RmsCase("dit_stage2_adaln", 2 * 9216, 4096),
    RmsCase("dit_stage1_text_k", 3 * 1024, 4096, weight="bfloat16"),
    RmsCase("dit_stage2_text_k", 2 * 1024, 4096, weight="bfloat16"),
    RmsCase("one_row_9216_qk", 9216, 4096, weight="bfloat16"),
    RmsCase("one_row_9216_adaln", 9216, 4096),
    RmsCase("north_star_qk", 1536, 4096, weight="bfloat16"),
    RmsCase("north_star_adaln", 1536, 4096),
    RmsCase("batched_adaln", 2 * 1536, 4096),  # two prompts; its q/k shape is above
    # the connector over the two text rows of a guided or a two-prompt run
    # (the two-stage and batched paths), and over one prompt's
    RmsCase("connector_two_rows_qk", 2 * 1024, 3840, weight="bfloat16"),
    RmsCase("connector_two_rows_out", 2 * 1024, 3840),
    RmsCase("connector_qk", 1024, 3840, weight="bfloat16"),
    RmsCase("connector_out", 1024, 3840),
    # ragged rows, narrow and wide rows, f32, a weight in f32 under bf16 x
    RmsCase("one_row_d128", 1, 128),
    RmsCase("five_rows_d128_f32", 5, 128, "float32", "float32"),
    RmsCase("ragged_d256_f32", 148, 256, "float32"),
    RmsCase("ragged_d384", 16, 384, weight="bfloat16"),
    RmsCase("ragged_d2048_f32w", 77, 2048, weight="float32"),
    RmsCase("ragged_d3840", 1537, 3840, weight="bfloat16"),
    RmsCase("ragged_d3840_f32", 1537, 3840, "float32", "float32"),
    RmsCase("ragged_d4096_f32", 1537, 4096, "float32"),
    RmsCase("wide_d16384", 5, 16384, weight="bfloat16"),
    RmsCase("wide_d16384_f32", 3, 16384, "float32", "bfloat16"),
)
RMS_F32_ULPS = 16  # the f32 term of the RMSNorm tolerance (docstring)


def rms_inputs(case: RmsCase, device, seed: int = 77):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(case.rows, case.d, generator=gen, device=device)
    # rows of different scales: the norm must not depend on them
    x = (x * torch.logspace(-2, 2, case.rows, device=device)[:, None]).to(
        getattr(torch, case.dtype))
    weight = None
    if case.weight is not None:
        weight = (1 + 0.5 * torch.randn(case.d, generator=gen, device=device)).to(
            getattr(torch, case.weight))
    return x, weight


def rms_tolerance(x, weight, got, eps: float = 1e-6):
    """(the plain version's value before its output rounding, the
    element-wise bound of the module docstring for the output `got`)."""
    plain32 = rk.rms_norm_reference(x.float(), None if weight is None
                                    else weight.float(), eps)
    tol = RMS_F32_ULPS * 2.0**-23 * plain32.abs()
    if got.dtype == torch.bfloat16:
        # the ulp where the output landed, should it have crossed a binade
        tol = tol + 0.5 * bf16_ulp(torch.maximum(plain32.abs(), got.float().abs()))
    return plain32, tol


def check_rms(case: RmsCase, device, eps: float = 1e-6) -> dict:
    """One launch of the rms_norm kernel against rms_norm_reference; raises
    AssertionError beyond the tolerance. Returns the max abs error against
    the plain output, the largest share of an element's tolerance, and the
    share of output elements that differ from the plain output."""
    x, weight = rms_inputs(case, device)
    before = rk.rms_norm.launches
    got = rk.rms_norm(x, weight, eps)
    launched = rk.rms_norm.launches - before
    want = rk.rms_norm_reference(x, weight, eps)
    if got.shape != want.shape or got.dtype != want.dtype or launched != 1:
        raise AssertionError(f"rms_norm {case.name}: {tuple(got.shape)} {got.dtype}, "
                             f"{launched} launches")
    plain32, tol = rms_tolerance(x, weight, got, eps)
    out = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
           "tol_share": tolerance_share(got, plain32, tol),
           "differ_share": (got != want).float().mean().item()}
    if not (out["tol_share"] <= 1.0 and torch.isfinite(got.float()).all()):
        raise AssertionError(f"rms_norm {case.name}: error {out['max_abs_err']:.3e} is "
                             f"{out['tol_share']:.3f} of its element's tolerance")
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


def _move(pipe: LTXPipeline, device) -> LTXPipeline:
    """Every component of `pipe` onto `device`."""
    for name in ("transformer", "vae_decoder", "gemma", "text_encoder", "vae_encoder",
                 "upscaler"):
        getattr(pipe, name).to(device)
    pipe.device = torch.device(device)
    return pipe


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
    _move(dev, device)
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


def rms_launches_per_encode(tecfg) -> int:
    """rms_norm kernel launches of one connector pass (any batch): per block
    two weightless norms and the q and k norms, and the final norm; none
    when the connector's width is not a multiple of 128."""
    if tecfg.inner_dim % rk.LANES:
        return 0
    return tecfg.connector_layers * 4 + 1


def rms_launches_per_dit_call(tcfg) -> int:
    """rms_norm kernel launches of one DiT call, whatever its rows: per
    block attn1's and attn2's q and k norms and the two adaln norms."""
    return 0 if tcfg.inner_dim % rk.LANES else 6 * tcfg.num_layers


def check_tiny_two_stage(device) -> dict:
    """The tiny two-stage I2V pipeline on `device`, its norms through the
    rms_norm kernel, against the same weights and draws on the CPU (the
    plain versions, held against the reference by the CPU tests): both
    image encodes, a CFG + STG + rescale stage 1 with re-noised
    conditioning, the upscaler and AdaIN, the refine, and a tiled uint8
    decode that blends. Raises AssertionError on a disagreement or a wrong
    launch count; returns the max abs error on the frames and the launches."""
    config = GenerationConfig(width=64, height=64, num_frames=33, num_steps=4, seed=3,
                              cfg_scale=2.0, stg_scale=1.0, stg_blocks=(1,),
                              guidance_rescale=0.7, image_cond_noise_scale=0.15)
    memory = dataclasses.replace(LTXPipeline.random_tiny(device="cpu").memory,
                                 vae_tile_size=3, vae_tile_overlap=2)
    gen = torch.Generator().manual_seed(11)
    images = [torch.rand(1, 3, 1, s, s, generator=gen) * 2 - 1 for s in (32, 64)]

    def run(pipe):
        c = pipe.tcfg.in_channels
        s1 = VideoLatentShape.from_pixels(1, config.num_frames, 32, 32, channels=c)
        s2 = VideoLatentShape.from_pixels(1, config.num_frames, 64, 64, channels=c)
        n1 = len(schedule.get_sigmas(config.num_steps, distilled=False,
                                     token_count=s1.token_count)) - 1
        n2 = len(schedule.STAGE_2_SIGMAS) - 1
        g = torch.Generator().manual_seed(5)
        half, full = (pipe.encode_image(img) for img in images)
        draws = dict(
            stage1_noise=torch.randn(s1.shape, generator=g),
            stage2_noise=torch.randn(s2.shape, generator=g),
            stage1_cond_noise=[torch.randn(half.shape, generator=g) for _ in range(n1)],
            stage2_cond_noise=[torch.randn(full.shape, generator=g) for _ in range(n2)])
        out = pipe.generate_video_two_stage("a tiny two-stage prompt", config,
                                            image_latent=half, full_res_image_latent=full,
                                            **draws)
        return out.frames, n1 + n2

    cpu = LTXPipeline.random_tiny(device="cpu", seed=2, memory=memory)
    want, dit_steps = run(cpu)
    dev = _move(LTXPipeline.random_tiny(device="cpu", seed=2, memory=memory), device)
    counters = (fa.flash_attention, rk.rms_norm)
    before = [c.launches for c in counters]
    previous = get_rms_impl()
    set_rms_impl("cuda")
    try:
        got, _ = run(dev)
    finally:
        set_rms_impl(previous)
    launches = [c.launches - b for c, b in zip(counters, before)]
    expected = [dit_steps * dev.tcfg.num_layers * 2 + dev.tecfg.connector_layers,
                dit_steps * rms_launches_per_dit_call(dev.tcfg)
                + rms_launches_per_encode(dev.tecfg)]
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or got.shape[0] != config.num_frames \
            or not np.isfinite(got).all():
        raise AssertionError(f"tiny two-stage: frames {got.shape}")
    if not err <= TINY_FRAME_ATOL:
        raise AssertionError(f"tiny two-stage: device and CPU differ by {err}")
    if launches != expected:
        raise AssertionError(f"tiny two-stage: launches {launches}, expected {expected}")
    return {"max_abs_err": err, "mean_abs_err": float(np.abs(got - want).mean()),
            "launches": dict(zip(("flash_attention", "rms_norm"), launches))}


# the tiny LoRA train, device against CPU, bf16 compute: the flow-matching
# loss per step, the first backward's LoRA gradients and the LoRA leaves
# after the steps, each as the largest error relative to the CPU's largest
# magnitude (the reference's bf16 parity tolerance, 5e-2)
TINY_TRAIN_STEPS = 3
TINY_TRAIN_TOL = 5e-2
TINY_GRID = (2, 4, 6)


def _rel(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def _tiny_train_case(dtype, seed: int = 5):
    """A tiny DiT in `dtype` with rank-4 LoRA leaves (lora_b drawn nonzero,
    so that lora_a gets a gradient from the first step), a 2-row batch with
    a left-padded context mask, and each step's sigma and noise; on the
    CPU."""
    cfg = TransformerConfig().tiny()
    gen = torch.Generator().manual_seed(seed)
    model = init_random_(LTXTransformer(cfg, device="cpu", dtype=dtype), gen)
    add_lora(model, gen, rank=4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    f, h, w = TINY_GRID
    tokens = torch.randn(2, f * h * w, cfg.in_channels, generator=gen)
    context = torch.randn(2, 16, cfg.caption_channels, generator=gen)
    mask = torch.ones(2, 16, dtype=torch.int64)
    mask[0, :5] = 0
    mask[1, :9] = 0
    cos, sin = video_rope(f, h, w, cfg.inner_dim, cfg.num_heads)
    draws = [(torch.rand(2, generator=gen) * 0.98 + 0.01,
              torch.randn(tokens.shape, generator=gen)) for _ in range(TINY_TRAIN_STEPS)]
    batch = (tokens, context, (torch.from_numpy(cos), torch.from_numpy(sin)),
             prepare_additive_mask(mask))
    return model, batch, draws


def _tiny_train_run(model, batch, draws, device, dtype):
    tokens, context, rope, bias = (
        tuple(t.to(device) for t in x) if isinstance(x, tuple) else x.to(device)
        for x in batch)
    tc = TrainConfig(lora_only=True, learning_rate=1e-3, compute_dtype=dtype)
    trainable, _, opt_state = init_train_state(model, tc)
    sigma, noise = (t.to(device) for t in draws[0])
    loss, _ = flow_match_loss(model, tokens, context, rope, sigma, noise, bias,
                              compute_dtype=dtype)
    names = list(trainable)
    grads = dict(zip(names, torch.autograd.grad(loss, [trainable[n] for n in names])))
    step = make_train_step(model, tc)
    losses = []
    for sigma, noise in draws:
        trainable, opt_state, aux = step(trainable, opt_state, tokens, context, rope,
                                         sigma.to(device), noise.to(device), bias)
        losses.append(aux["loss"])
    return grads, losses, trainable


def check_tiny_train(device, dtype=torch.bfloat16) -> dict:
    """The tiny LoRA train on `device` (the flash statistics forward and
    backward kernels) against the same weights, batch and draws on the CPU
    (the plain versions, held against the reference by the CPU tests), with
    the model and its compute in `dtype`. In float32 the card runs every
    attention in bfloat16 (ops.attention casts at the kernel boundary) and
    the CPU in float32, held to the same TINY_TRAIN_TOL as the bfloat16 run.
    Raises AssertionError beyond TINY_TRAIN_TOL or on a wrong launch count;
    returns the errors and the kernel launches."""
    model, batch, draws = _tiny_train_case(dtype)
    want = _tiny_train_run(copy.deepcopy(model), batch, draws, "cpu", dtype)
    counters = (fa.flash_attention_stats, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv, fa.flash_attention)
    before = [c.launches for c in counters]
    got = _tiny_train_run(model.to(device), batch, draws, device, dtype)
    launches = [c.launches - b for c, b in zip(counters, before)]
    layers = len(model.blocks)
    # one backward alone, then the steps; each a remat forward, the blocks'
    # recompute (stats), and one backward (dq, dkv) per attention
    calls = 1 + TINY_TRAIN_STEPS
    expected = [calls * 2 * 2 * layers, calls * 2 * layers, calls * 2 * layers, 0]
    out = {
        "grad_rel": _rel(torch.cat([g.flatten() for g in got[0].values()]),
                         torch.cat([g.flatten() for g in want[0].values()])),
        "loss_rel": max(_rel(g, w) for g, w in zip(got[1], want[1])),
        "lora_rel": _rel(torch.cat([p.flatten() for p in got[2].values()]),
                         torch.cat([p.flatten() for p in want[2].values()])),
        "launches": dict(zip(("flash_attention_stats", "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv", "flash_attention"), launches)),
    }
    if launches != expected:
        raise AssertionError(f"tiny train: launches {launches}, expected {expected}")
    worst = max(out["grad_rel"], out["loss_rel"], out["lora_rel"])
    if not worst <= TINY_TRAIN_TOL:
        raise AssertionError(f"tiny train: device vs CPU {out}")
    return out
