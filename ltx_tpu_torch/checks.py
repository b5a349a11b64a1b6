"""Checks of the port on a CUDA device, shared by chip_smoke.py and
tests/test_torch_cuda.py: each hand kernel against its plain version, and
the tiny pipeline on the device against the same weights on the CPU.

Attention tolerance, element by element, one side at a time. Each output
(the kernel's, and the plain version's on the CPU) is held against the
unrounded product `attention_exact`: the f32 softmax P times V, summed in
f32 with TF32 off (f64 on small slices). With P the f32 softmax:

    |out - exact| <= 2**-8 * (P @ |V|) + (Tk/16 + 16) * 2**-23 * (P @ |V|)
                     + 2 ulp_bf16(|exact|)

Its three terms, for the kernel (the plain version is the same with the
running max fixed at the row's max):
  * one bf16 rounding of each probability. The kernel rounds p~ =
    exp(s - m_run), the probability scaled by the running max, to bf16:
    at most bf16's unit roundoff 2**-8 of itself. A later rescale by
    exp(m_old - m_new) multiplies the f32 accumulator, not the bf16 value,
    so the rounding stays 2**-8 of its term, and after the division by the
    row sum 2**-8 of p * |v| for each key: 2**-8 * (P @ |V|) in all;
  * the f32 sums: the P V accumulator and the row sum, in the kernel's
    order (16 keys a wgmma k step, Tk/16 steps, and the rescales). Each
    step rounds by at most f32's unit roundoff 2**-24 of the running sum,
    so the two together move the output by at most (Tk/16 + 16) * 2**-23 of
    sum_k p |v| (about 2**-14 of it at Tk = 9216), the 16 covering the
    exp2 approximation, the rescales, the division and the f32 exact
    product's own order, as the int4 tolerance carries its sum-order term;
  * one output rounding to bf16, within an ulp of the exact value (two are
    allowed where the output crosses a binade).
This is one side's budget, proven: the kernel and its plain version are each
within it, so within twice it of each other. The factor on P's rounding
stays 2**-8: a P rounded to fp8 (e4m3, unit roundoff 2**-4) breaks the bound
at the path's self-attention (tests/test_torch_attention.py).

int4 tolerance, element by element. `dequant_int4` must equal its plain
version exactly: both round q * scale and then + bias in f32, then round to
bf16. The int4 product and its plain version multiply the same bf16 X and
the same bf16 W exactly and sum in f32, in different orders: the kernel adds
16 products per wgmma k step to its f32 accumulator, K/16 steps (in stages
of 128 K rows: the 64 low-plane rows' 4 steps, then the 64 high-plane
rows', 128 rows further down K); cuBLAS blocks the same way. The order of
the steps does not enter the bound. Each step costs at most one unit of
the accumulator's last place, and the accumulator never exceeds sum_k |x| |w|, so each sum is
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
is held to the attention bound above, against the exact product.

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

Ring tolerances (ring attention over n ranks, `check_ring`), derived before
the first card run of the ring.

Forward. Each of the n ring steps runs B2 on the query shard against one
key block: its normalised output out_i is within the attention bound of
the block's exact product, and is rounded to bf16 (at most 2**-8 of
itself, round to nearest). The merge weights w_i = l_i e^(m_i - m) / l
sum to 1 and are f32, so the merged output's error is at most
sum_i w_i (bound_i + 2**-8 |out_i|), where sum_i w_i P_i @ |V_i| = P @ |V|
(the blocks partition the keys) and |out_i| <= P_i @ |V_i|. With the
final rounding:

    |ring - exact| <= 2 * 2**-8 * (P @ |V|) + (Tk_local/16 + 16) * 2**-23
                      * (P @ |V|) + 2 ulp_bf16(|exact|)

the attention bound with its probability term doubled (RING_ROUNDINGS = 2).

Backward, against the plain backward at the exact output and lse (f32).
Each visit's dQ_i, dK_i, dV_i is B3's, within the backward bound of the
module docstring for its key block, and is rounded to bf16 before the f32
accumulation (2**-8 of itself, and |dQ_i| <= |dS_i| @ |K_i|): summed over
the visits that doubles the 2**-8 terms, as the forward. Both the ring
and the whole-sequence B3 take their output and lse from a forward that
is not exact: lse = m + log(l) carries l's 2**-12 (the statistics bound,
STATS_L_REL), which moves P by at most 2**-12 of itself, and delta =
rowsum(dO * O) moves by at most rowsum(|dO| * fwd_bound) (the forward's
own bound), which enters dS as P * scale * that. So, with f = 2 for the
ring and 1 for B3 on the whole sequence:

    eps_P' = eps_P + 2**-12 * P
    eps_S' = eps_S(eps_P') + P * scale * rowsum(|dO| * fwd_bound)
    |dV - dV_p| <= (f * 2**-8 * P + eps_P')^T @ |dO| + 2 ulp_bf16(|dV_p|)
    |dQ - dQ_p| <= (f * 2**-8 * |dS| + eps_S') @ |K| + 2 ulp_bf16(|dQ_p|)
    |dK - dK_p| <= (f * 2**-8 * |dS| + eps_S')^T @ |Q| + 2 ulp_bf16(|dK_p|)

The ring and B3 on the whole sequence are each held to their bound around
the plain gradients, so they are within the sum of the two of each other.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from ltx_tpu_torch.config import GenerationConfig, MemoryConfig, TransformerConfig
from ltx_tpu_torch.kernels import flash_attention as fa
from ltx_tpu_torch.kernels import quantization as qz
from ltx_tpu_torch.kernels import rms_norm as rk
from ltx_tpu_torch.kernels import rope as rope_kernel
from ltx_tpu_torch.models.common import QuantizedLinear, init_random_
from ltx_tpu_torch.models.dit import LTXTransformer, quantize_transformer
from ltx_tpu_torch.models.dit_av import LTXAVTransformer, prepare_av_ropes
from ltx_tpu_torch.ops.attention import prepare_additive_mask
from ltx_tpu_torch.ops import schedule
from ltx_tpu_torch.ops.latents import VideoLatentShape
from ltx_tpu_torch.ops import normalization
from ltx_tpu_torch.ops import rope as rope_ops
from ltx_tpu_torch.ops.rope import video_rope
from ltx_tpu_torch.pipeline.generate import LTXPipeline
from ltx_tpu_torch.train.flow_match import av_flow_match_loss, flow_match_loss
from ltx_tpu_torch.train.lora import add_lora
from ltx_tpu_torch.train.step import (
    TrainConfig,
    init_train_state,
    make_av_train_step,
    make_train_step,
)


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
    # head dim 72 (128-wide tiles, zeros past column 72): the SigLIP-So400m
    # tower of I2V enhancement (16 heads over 64 x 64 patches, views of its
    # projections, scale 72**-0.5), and a ragged one with a key bias
    AttentionCase("siglip_attn", 1, 16, 4096, 4096, 72, scale=72**-0.5, layout="bthd"),
    AttentionCase("ragged_d72_bias", 2, 3, 200, 77, 72, pad=30),
    # the dual audio-video DiT's head dim 64 (32 audio heads, views of its
    # projections): audio self-attention at the north star's 26 audio tokens
    # and the flagship's 251 (241f@1024x640), the audio text cross-attention
    # with a key bias (one row, and two guidance rows), audio-to-video
    # (video queries over the audio keys: stage 1's 1536 and 4960 tokens,
    # stage 2's 19840) and video-to-audio (audio queries over the video keys)
    AttentionCase("av_audio_self_26", 1, 32, 26, 26, 64, layout="bthd"),
    AttentionCase("av_audio_self_251", 1, 32, 251, 251, 64, layout="bthd"),
    AttentionCase("av_audio_cross_26", 1, 32, 26, 1024, 64, pad=300, pad_left=True,
                  layout="bthd"),
    AttentionCase("av_audio_cross_two_rows", 2, 32, 26, 1024, 64, pad=(300, 0),
                  pad_left=True, layout="bthd"),
    AttentionCase("av_a2v_1536", 1, 32, 1536, 26, 64, layout="bthd"),
    AttentionCase("av_a2v_4960", 1, 32, 4960, 251, 64, layout="bthd"),
    AttentionCase("av_a2v_19840", 1, 32, 19840, 251, 64, layout="bthd"),
    AttentionCase("av_v2a_1536", 1, 32, 26, 1536, 64, layout="bthd"),
    AttentionCase("av_v2a_19840", 1, 32, 251, 19840, 64, layout="bthd"),
    # the long-video modes at 121f@768x512 (6144 tokens, one row; views of
    # the DiT's projections): self-attention, cross-attention over a
    # left-padded 1024-token prompt, and the connector over a chain's four
    # prompts in one text pass
    AttentionCase("long_self_attn", 1, 32, 6144, 6144, 128, layout="bthd"),
    AttentionCase("long_cross_attn", 1, 32, 6144, 1024, 128, pad=300, pad_left=True,
                  layout="bthd"),
    AttentionCase("long_connector_four_rows", 4, 30, 1024, 1024, 128, scale=128**-0.5),
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
    # the 256-wide tile at ragged rows; groups narrower than a stage's plane
    # (32) and straddling it (96), at an N of 128-wide tiles only
    Int4Case("ragged_m1000_wide", 1000, 256, 16384),
    Int4Case("ragged_m77_group32", 77, 512, 256, group=32),
    Int4Case("ragged_m77_group96", 77, 768, 384, group=96),
    # 121f@1024x576 (9216 tokens): the dequant-then-product route, at each
    # of its weight shapes
    Int4Case("big_m_attn_proj", 9216, 4096, 4096),
    Int4Case("big_m_ff_in", 9216, 4096, 16384),
    Int4Case("big_m_ff_out", 9216, 16384, 4096),
    # Gemma-3-12B's projections in its "int4" mode (hidden 3840, 16 query
    # and 8 key/value heads of 256, MLP 15360): one prompt of 1024 tokens,
    # and the MLP's input at two prompts
    Int4Case("gemma_q", 1024, 3840, 4096),
    Int4Case("gemma_kv", 1024, 3840, 2048),
    Int4Case("gemma_o", 1024, 4096, 3840),
    Int4Case("gemma_gate_up", 1024, 3840, 15360),
    Int4Case("gemma_down", 1024, 15360, 3840),
    Int4Case("gemma_gate_up_two_prompts", 2048, 3840, 15360),
    # Gemma's decode (prompt enhancement): one row a sequential step, and
    # spec_k + 1 = 9 rows a speculative verify bundle
    *(Int4Case(f"gemma_{name}_decode{m}", m, k, n) for m in (1, 9)
      for name, k, n in (("q", 3840, 4096), ("kv", 3840, 2048), ("o", 4096, 3840),
                         ("gate_up", 3840, 15360), ("down", 15360, 3840))),
)
GEMMA_INT4_CASES = tuple(c.name for c in INT4_CASES if c.name.startswith("gemma_"))
# the W8A8 product's cases: the DiT's path shapes and Gemma's (INT4_CASES)
W8A8_CASES = tuple(c for c in INT4_CASES if c.name.startswith(("dit_", "gemma_")))
INT4_C = 2.0**-12  # the sum-order term of the int4 tolerance (docstring)
# (K, N) of every weight the path dequantizes: the attention projections,
# FF in, FF out
DEQUANT_SHAPES = ((4096, 4096), (4096, 16384), (16384, 4096))
FF_IN_SHAPE = DEQUANT_SHAPES[1]

# the tiny pipeline, device against CPU: frames in [0, 1] from bf16 Gemma,
# connector and DiT whose sums run in other orders
TINY_FRAME_ATOL = 2e-2
# the tiny joint-audio pipeline's waveform in [-1, 1], device against CPU
# (the CPU parity tests' bound against the reference, tests/
# test_torch_audio_pipeline.py)
TINY_AUDIO_ATOL = 5e-2

# the tiny cycle Gemma of the generation checks: its cycle and a prompt that
# ends on it (tests/test_spec_synthetic.py's)
TINY_CYCLE_PERIOD = 11


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


# a head slice of at most this many scores computes the exact product in
# f64, larger ones in f32 (TF32 off)
EXACT_F64_SCORES = 2**22
# the factor on P's one bf16 rounding (module docstring)
ATTN_P_ROUNDING = 2.0**-8


def attention_exact_and_tolerance(q, k, v, bias, scale):
    """(attention_exact, the element-wise bound of the module docstring
    around it), some heads at a time (head_slices)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("attention_exact needs TF32 off for f32 products")
    exact, pv = [], []
    for hs in head_slices(q, k):
        p = fa.attention_probs(q[:, hs], k[:, hs], bias, scale)
        wide = torch.float64 if p.numel() <= EXACT_F64_SCORES else torch.float32
        p, vs = p.to(wide), v[:, hs].to(wide)
        exact.append(torch.matmul(p, vs).float())
        pv.append(torch.matmul(p, vs.abs()).float())
        del p, vs
    exact, pv = torch.cat(exact, dim=1), torch.cat(pv, dim=1)
    sums = (k.shape[2] / 16 + 16) * 2.0**-23
    return exact, (ATTN_P_ROUNDING + sums) * pv + 2 * bf16_ulp(exact)


def attention_exact(q, k, v, bias, scale):
    """The unrounded product every attention output is held against: the
    f32 softmax P (`fa.attention_probs`) times V, f32 (f64 on small
    slices), without any rounding of P or of the output."""
    return attention_exact_and_tolerance(q, k, v, bias, scale)[0]


def attention_tolerance(q, k, v, bias, scale):
    """The element-wise bound of the module docstring around
    `attention_exact`."""
    return attention_exact_and_tolerance(q, k, v, bias, scale)[1]


def check_attention(case: AttentionCase, device) -> dict:
    """One kernel launch against the exact product; raises AssertionError
    beyond the tolerance. Returns the max abs error, the largest error as a
    share of its element's tolerance, and the max error over max |exact|."""
    q, k, v, bias = attention_inputs(case, device)
    got = fa.flash_attention(q, k, v, bias, case.scale)
    want, tol = attention_exact_and_tolerance(q, k, v, bias, case.scale)
    if got.shape != want.shape or got.dtype != q.dtype:
        raise AssertionError(f"flash_attention {case.name}: {tuple(got.shape)} {got.dtype}")
    err = (got.float() - want).abs()
    share = (err / tol).max().item()
    out = {"max_abs_err": err.max().item(), "tol_share": share,
           "rel_to_max": err.max().item() / max(want.abs().max().item(), 1e-30)}
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
    # the dual DiT's head-dim-64 attentions in the AV train step at 25f@768x512
    # (1536 video and 26 audio tokens), views of its projections: audio
    # self-attention and audio text cross-attention (keys shorter than, and
    # many times, one key tile), audio-to-video (26 keys) and video-to-audio
    # (26 queries)
    BackwardCase("av_audio_self_26", 1, 32, 26, 26, 64, layout="bthd"),
    BackwardCase("av_audio_cross_26", 1, 32, 26, 1024, 64, bias=("left", 300),
                 layout="bthd"),
    BackwardCase("av_a2v", 1, 32, 1536, 26, 64, layout="bthd"),
    BackwardCase("av_v2a", 1, 32, 26, 1536, 64, layout="bthd"),
)
# the cases whose gradients must be bitwise equal from run to run (the
# training path's shapes)
DETERMINISM_CASES = ("dit_self_attn", "dit_cross_attn")


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


def check_stats(case: BackwardCase, device) -> dict:
    """The forward's statistics variant: out within the attention bound
    around the exact product, m and l against the plain version within
    STATS_M_REL / STATS_L_REL. Raises AssertionError beyond them; returns
    the errors and shares."""
    q, k, v, _, bias, _, _ = backward_inputs(case, device)
    o, m, l = fa.flash_attention_stats(q, k, v, bias, case.scale)
    _, m_p, l_p = fa.flash_attention_reference(q, k, v, bias, case.scale,
                                               return_stats=True)
    exact, tol = attention_exact_and_tolerance(q, k, v, bias, case.scale)
    err = (o.float() - exact).abs()
    out = {
        "max_abs_err": err.max().item(),
        "tol_share": (err / tol).max().item(),
        "m_share": ((m - m_p).abs() / (STATS_M_REL * m_p.abs().clamp_min(1.0))).max().item(),
        "l_share": ((l - l_p).abs() / (STATS_L_REL * l_p)).max().item(),
    }
    if not max(out["tol_share"], out["m_share"], out["l_share"]) <= 1.0:
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
    # the dual DiT's audio stream at 2048 wide (every one of its norms
    # weighted): the audio tokens' norms at the north star (26) and the
    # flagship (251), the audio text context's k norm, and the cross-modal
    # q / k norms over the video tokens (1536 at the north star, 19840 in
    # the flagship's stage 2)
    RmsCase("av_audio_26", 26, 2048, weight="bfloat16"),
    RmsCase("av_audio_251", 251, 2048, weight="bfloat16"),
    RmsCase("av_audio_text_k", 1024, 2048, weight="bfloat16"),
    RmsCase("av_cross_video_1536", 1536, 2048, weight="bfloat16"),
    RmsCase("av_cross_video_19840", 19840, 2048, weight="bfloat16"),
    # the long-video modes at 121f@768x512: the DiT's q/k and adaln norms
    # over 6144 tokens, and the connector over a chain's four prompts
    RmsCase("long_qk", 6144, 4096, weight="bfloat16"),
    RmsCase("long_adaln", 6144, 4096),
    RmsCase("long_connector_four_rows_qk", 4 * 1024, 3840, weight="bfloat16"),
    RmsCase("long_connector_four_rows_out", 4 * 1024, 3840),
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
    # rows too wide for two stages of a warp's ring: streamed in chunks, twice
    RmsCase("chunked_d32768_f32", 2, 32768, "float32", "float32"),
    RmsCase("chunked_d65536", 3, 65536, weight="bfloat16"),
)
# the cases whose rows are also run alone and in other batches, and twice
RMS_BITWISE_CASES = ("north_star_qk", "connector_two_rows_out", "ragged_d4096_f32",
                     "chunked_d32768_f32")
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


def check_rms_bitwise(case: RmsCase, device, eps: float = 1e-6) -> dict:
    """The kernel twice on the case's rows, then some rows (the first, one
    in the middle, the last) alone and a run of rows from the middle as a
    batch of its own: every output row bit for bit the same. Raises
    AssertionError otherwise; returns the counts of differing values."""
    x, weight = rms_inputs(case, device)
    full = rk.rms_norm(x, weight, eps)
    out = {"run_to_run": int((rk.rms_norm(x, weight, eps) != full).sum())}
    mid = case.rows // 2
    for name, rows in (("first_alone", slice(0, 1)), ("middle_alone", slice(mid, mid + 1)),
                       ("last_alone", slice(case.rows - 1, case.rows)),
                       ("middle_run", slice(mid // 2, mid // 2 + max(1, case.rows // 3)))):
        out[name] = int((rk.rms_norm(x[rows], weight, eps) != full[rows]).sum())
    if any(out.values()):
        raise AssertionError(f"rms_norm {case.name}: not bitwise the same {out}")
    return out


@dataclasses.dataclass(frozen=True)
class RopeCase:
    """One RoPE table of a denoise loop (`kernels.rope.rope_tables`):
    "video" (the 3-D grid of `latent` frames x height x width), "cross_video"
    (that grid's time row), "audio" or "cross_audio" (`audio_frames`), at
    `cfg`'s widths as `models.dit_av.prepare_av_ropes` takes them."""
    name: str
    table: str
    latent: tuple = (16, 16, 24)  # 121f@768x512
    audio_frames: int = 126
    cfg: TransformerConfig = TransformerConfig()


# the three cells' tables (121f and 25f at 768x512, the AV loop's four at
# 121f with 126 audio frames), and two small ones: two columns of (1, 0)
# in front (pad 2), an odd token count and 17 columns a head; an odd audio
# length at 3 heads of 16 columns
_ROPE_ODD = dataclasses.replace(TransformerConfig().tiny(), num_heads=4, head_dim=34,
                                audio_num_heads=3, audio_head_dim=32)
ROPE_CASES = (
    RopeCase("video_121f", "video"),
    RopeCase("av_121f_audio", "audio"),
    RopeCase("av_121f_cross_video", "cross_video"),
    RopeCase("av_121f_cross_audio", "cross_audio"),
    RopeCase("video_25f", "video", latent=(4, 16, 24)),
    RopeCase("padded_odd_tokens", "video", latent=(3, 3, 5), cfg=_ROPE_ODD),
    RopeCase("audio_odd_tokens", "audio", audio_frames=25, cfg=_ROPE_ODD),
)


def rope_case_inputs(case: RopeCase):
    """(grid, keyword arguments of `rope_tables` and of
    `precompute_freqs_cis` but the device) of a case."""
    cfg = case.cfg
    if case.table in ("video", "cross_video"):
        grid = rope_ops.create_position_grid(*case.latent)
    else:
        grid = rope_ops.create_audio_position_grid(case.audio_frames)
    if case.table == "video":
        return grid, dict(dim=cfg.inner_dim, theta=cfg.rope_theta, max_pos=cfg.max_pos,
                          num_heads=cfg.num_heads)
    dim = cfg.audio_inner_dim if case.table == "audio" else cfg.audio_cross_attention_dim
    return grid[:1], dict(dim=dim, theta=cfg.rope_theta, max_pos=cfg.audio_max_pos,
                          num_heads=cfg.audio_num_heads)


def check_rope_tables(case: RopeCase, device) -> dict:
    """One launch of the rope_tables kernel against the plain float64 host
    build: every element within one f32 ulp (libdevice's and the host's
    float64 cos and sin differ by a few float64 ulps, which move an f32
    rounding only next to its boundary). Raises AssertionError otherwise;
    returns the count and share of elements that are not bit for bit the
    plain ones, and the largest difference in f32 ulps."""
    grid, kw = rope_case_inputs(case)
    before = rope_kernel.rope_tables.launches
    got = rope_kernel.rope_tables(grid, device=device, **kw)
    launched = rope_kernel.rope_tables.launches - before
    torch.cuda.synchronize(device)
    out = {"elements": 0, "differ": 0, "max_ulps": 0.0}
    for table, want in zip(got, rope_ops.precompute_freqs_cis(grid, **kw)):
        g = table.cpu().numpy()
        if g.shape != want.shape or g.dtype != want.dtype:
            raise AssertionError(f"rope_tables {case.name}: {g.shape} {g.dtype}, "
                                 f"want {want.shape} {want.dtype}")
        ulp = np.spacing(np.maximum(np.abs(g), np.abs(want)))
        err = np.abs(g.astype(np.float64) - want.astype(np.float64)) / ulp
        out["elements"] += g.size
        out["differ"] += int((g != want).sum())
        out["max_ulps"] = max(out["max_ulps"], float(err.max()))
    out["differ_share"] = out["differ"] / out["elements"]
    if launched != 1 or not out["max_ulps"] <= 1.0:
        raise AssertionError(f"rope_tables {case.name}: {launched} launches, "
                             f"{out['differ']} elements differ, up to {out['max_ulps']} ulps")
    return out


def rope_loop_launches(device) -> dict:
    """The rope_tables launches of building one denoise step, video and
    dual, at 121f@768x512 on `device` (the DiTs at full width on "meta":
    building a step reads their configuration, no weight)."""
    from ltx_tpu_torch.pipeline.denoise import (
        GuidanceSpec,
        make_av_denoise_step,
        make_denoise_step,
    )

    cfg = TransformerConfig()
    config = GenerationConfig(width=768, height=512, num_frames=121)
    guidance = GuidanceSpec.from_config(config)
    shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height, config.width,
                                         channels=cfg.in_channels)
    context = torch.zeros(1, 16, cfg.caption_channels, dtype=torch.bfloat16, device=device)
    out = {}
    before = rope_kernel.rope_tables.launches
    make_denoise_step(LTXTransformer(cfg, device="meta"), guidance, shape, context, None)
    out["video"] = rope_kernel.rope_tables.launches - before
    before = rope_kernel.rope_tables.launches
    make_av_denoise_step(LTXAVTransformer(cfg, device="meta"), guidance, shape, 126, context,
                         context, None)
    out["av"] = rope_kernel.rope_tables.launches - before
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


def w8a8_inputs(case: Int4Case, device, seed: int = 1234):
    """x (m, k) bf16 and a (k, n) weight at the linear init scale,
    requantized per channel on `device`: {"w8", "sw"}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(case.m, case.k, generator=gen, device=device).bfloat16()
    w = torch.randn(case.k, case.n, generator=gen, device=device) * case.k**-0.5
    return x, qz.requant_int8_channel(w)


# rows of a W8A8 case recomputed on the host: the CPU's int8 product is a
# plain loop, seconds for a few rows at these widths
W8A8_CPU_ROWS = 4


def check_w8a8(case: Int4Case, device) -> dict:
    """W8A8 on `device` against exact arithmetic: the activation codes and
    scales of `quantize_act_int8` and the int32 accumulator of `int8_mm`
    (the library's int8 product) must equal, bit for bit, the CPU's on
    W8A8_CPU_ROWS rows spread over the matrix and, on every row, the int8
    codes' product in f64 on the device (exact: |sum| < 2**53); the bf16
    output of `int8_matmul` must equal the CPU's on those rows. Raises
    AssertionError otherwise; returns the counts of differing values."""
    x, p = w8a8_inputs(case, device)
    x8, sx = qz.quantize_act_int8(x)
    acc = qz.int8_mm(x8, p["w8"])
    exact = (x8.double() @ p["w8"].double()).to(torch.int32)
    rows = torch.linspace(0, case.m - 1, W8A8_CPU_ROWS).long()
    cpu_x = x[rows.to(x.device)].cpu()
    cpu_p = {k: v.cpu() for k, v in p.items()}
    cpu_x8, cpu_sx = qz.quantize_act_int8(cpu_x)
    cpu_acc = qz.int8_mm(cpu_x8, cpu_p["w8"])
    out = qz.int8_matmul(p, x)
    cpu_out = qz.int8_matmul(cpu_p, cpu_x)
    dev_rows = rows.to(x.device)
    res = {"accumulator_vs_exact": int((acc != exact).sum()),
           "codes_vs_cpu": int((x8[dev_rows].cpu() != cpu_x8).sum())
           + int((sx[dev_rows].cpu() != cpu_sx).sum()),
           "accumulator_vs_cpu": int((acc[dev_rows].cpu() != cpu_acc).sum()),
           "output_vs_cpu": int((out[dev_rows].cpu().view(torch.int16)
                                 != cpu_out.view(torch.int16)).sum())}
    if acc.dtype != torch.int32 or out.dtype != torch.bfloat16 or any(res.values()):
        raise AssertionError(f"w8a8 {case.name}: {res}")
    return res


def _move(pipe: LTXPipeline, device) -> LTXPipeline:
    """Every component of `pipe` onto `device`."""
    for name in ("transformer", "vae_decoder", "gemma", "text_encoder", "vae_encoder",
                 "upscaler", "av_transformer", "audio_vae", "vocoder"):
        if getattr(pipe, name) is not None:
            getattr(pipe, name).to(device)
    pipe.device = torch.device(device)
    return pipe


def check_tiny_pipeline(device) -> dict:
    """The tiny pipeline on `device` (its kernels; the norms through the
    rms_norm kernel by the default route where the width allows: the DiT's
    128, not the tiny connector's 64) against the same weights on the CPU
    (the plain versions, held against the reference by the CPU tests).
    Raises AssertionError on a disagreement or a wrong launch count.
    Returns the max abs error on the frames and the kernel launches."""
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=8, seed=3)
    cpu = LTXPipeline.random_tiny(device="cpu", seed=2)
    shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height,
                                         config.width, channels=cpu.tcfg.in_channels)
    noise = torch.randn(shape.shape, generator=torch.Generator().manual_seed(3))
    want = cpu.generate_video("a tiny prompt", config, noise).frames

    dev = LTXPipeline.random_tiny(device="cpu", seed=2)
    _move(dev, device)
    before = _tiny_counts()
    got = dev.generate_video("a tiny prompt", config, noise).frames
    launches = [a - b for a, b in zip(_tiny_counts(), before)]
    # flash: steps x blocks x (self + cross) + one per connector layer; the
    # norms through the rms_norm kernel where their width allows it
    expected = [flash_inference_counts(dev.tcfg, dev.tecfg, config.num_steps, 1),
                *rms_inference_counts(dev.tcfg, dev.tecfg, config.num_steps, 1)]
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"tiny pipeline: frames {got.shape}, finite "
                             f"{bool(np.isfinite(got).all())}")
    if not err <= TINY_FRAME_ATOL:
        raise AssertionError(f"tiny pipeline: device and CPU differ by {err}")
    if launches != expected:
        raise AssertionError(f"tiny pipeline: {launches} kernel launches, "
                             f"expected {expected}")
    return {"max_abs_err": err, "launches": dict(zip(_TINY_COUNTS, launches))}


_TINY_COUNTS = ("flash_attention", "rms_norm", "rms_chain_on_cuda")


def _tiny_counts() -> list:
    """The flash and rms_norm kernels' launches and the chain-on-CUDA count."""
    return [fa.flash_attention.launches, rk.rms_norm.launches,
            normalization.rms_chain_on_cuda]


def rms_launches_per_encode(tecfg, audio: bool = False) -> int:
    """rms_norm kernel launches of one text pass (any batch) through the
    connector, and with `audio` the audio connector too: per block two
    weightless norms and the q and k norms, and the final norm; none when
    the connectors' width is not a multiple of 128 (they take the chain)."""
    if tecfg.inner_dim % rk.LANES:
        return 0
    return (2 if audio else 1) * (tecfg.connector_layers * 4 + 1)


def av_block_norm_widths(tcfg) -> list:
    """The widths of a dual block's 20 weighted RMSNorms, in its order:
    norm1, attn1's q and k, the audio's; norm2, attn2's q and k, the
    audio's; the cross-modal norms of the video and of the audio stream;
    audio-to-video's and video-to-audio's q and k (both at the audio inner
    dim); norm3, the audio's."""
    dv, da = tcfg.inner_dim, tcfg.audio_inner_dim
    return [dv, dv, dv, da, da, da, dv, dv, dv, da, da, da, dv, da, da, da, da, da, dv, da]


def rms_launches_per_dit_call(tcfg) -> int:
    """rms_norm kernel launches of one DiT call, whatever its rows: per
    block attn1's and attn2's q and k norms and the two adaln norms; none
    when the width is not a multiple of 128 (they take the chain)."""
    return 0 if tcfg.inner_dim % rk.LANES else 6 * tcfg.num_layers


def rms_inference_counts(tcfg, tecfg, dit_calls: int, text_passes: int,
                         av: bool = False) -> list:
    """[rms_norm kernel launches, chain calls on the card] of an inference
    run (nothing recorded by autograd): every norm of a width that is a
    multiple of 128 through the kernel, the rest through the chain. av: the
    DiT calls are the dual DiT's and the text passes run both connectors."""
    if av:
        widths = av_block_norm_widths(tcfg)
        per_call = tcfg.num_layers * sum(w % rk.LANES == 0 for w in widths)
        calls_per_call = tcfg.num_layers * len(widths)
    else:
        per_call, calls_per_call = rms_launches_per_dit_call(tcfg), 6 * tcfg.num_layers
    connectors = 2 if av else 1
    launches = dit_calls * per_call + text_passes * rms_launches_per_encode(tecfg, av)
    calls = dit_calls * calls_per_call \
        + text_passes * connectors * (tecfg.connector_layers * 4 + 1)
    return [launches, calls - launches]


def av_flash_counts(tcfg, tecfg, dit_calls: int, text_passes: int) -> dict:
    """{head dim: flash_attention launches} of a joint-audio inference run:
    each dual block's video self and text attentions at the video head dim,
    its audio self, audio text, audio-to-video and video-to-audio ones at
    the audio head dim; each connector layer of both connectors a text
    pass."""
    out = {}
    for d, n in ((tcfg.head_dim, 2 * tcfg.num_layers * dit_calls),
                 (tcfg.audio_head_dim, 4 * tcfg.num_layers * dit_calls),
                 (tecfg.connector_head_dim, 2 * tecfg.connector_layers * text_passes)):
        out[d] = out.get(d, 0) + n
    return out


def flash_inference_counts(tcfg, tecfg, dit_calls: int, text_passes: int,
                           av: bool = False) -> int:
    """flash_attention launches of an inference run: each DiT block's self-
    and cross-attention a call (the dual block's six), each connector layer
    a text pass (both connectors' with av)."""
    if av:
        return sum(av_flash_counts(tcfg, tecfg, dit_calls, text_passes).values())
    return dit_calls * tcfg.num_layers * 2 + text_passes * tecfg.connector_layers


def check_tiny_av_pipeline(device) -> dict:
    """The tiny joint-audio pipeline on `device` (its kernels; the norms
    through the rms_norm kernel where the width allows: the video stream's
    128, not the audio stream's 64 nor the connectors') against the same
    weights and draws on the CPU: generate_video_with_audio with CFG, then
    I2V with the conditioned frame re-noised. Raises AssertionError on a
    disagreement or a wrong launch count; returns the max abs errors on the
    frames and the waveform and the launches."""
    results = {}
    gen = torch.Generator().manual_seed(13)
    image = torch.rand(1, 3, 1, 64, 64, generator=gen) * 2 - 1
    cases = {"t2v_cfg": GenerationConfig(width=64, height=64, num_frames=17, num_steps=4,
                                         seed=3, cfg_scale=2.5),
             "i2v": GenerationConfig(width=64, height=64, num_frames=9, num_steps=3, seed=4,
                                     image_cond_noise_scale=0.15)}

    def run(pipe, config, i2v):
        c = pipe.tcfg.in_channels
        shape = VideoLatentShape.from_pixels(1, config.num_frames, 64, 64, channels=c)
        g = torch.Generator().manual_seed(config.seed)
        kw = dict(initial_noise=torch.randn(shape.shape, generator=g),
                  audio_noise=torch.randn(pipe.audio_noise_shape(config), generator=g))
        if i2v:
            kw["image_latent"] = pipe.encode_image(image)
            steps = len(pipe._sigmas(config, shape)) - 1
            kw["cond_noise"] = [torch.randn(kw["image_latent"].shape, generator=g)
                                for _ in range(steps)]
        return pipe.generate_video_with_audio("a tiny song", config, **kw)

    memory = MemoryConfig(offload_text_encoder=False)  # both cases on one pipeline
    cpu = LTXPipeline.random_tiny(device="cpu", seed=2, include_audio=True, memory=memory)
    dev = _move(LTXPipeline.random_tiny(device="cpu", seed=2, include_audio=True,
                                        memory=memory), device)
    for name, config in cases.items():
        want = run(cpu, config, name == "i2v")
        before = _tiny_counts()
        by_dim = dict(fa.flash_attention.launches_by_head_dim)
        got = run(dev, config, name == "i2v")
        launches = [a - b for a, b in zip(_tiny_counts(), before)]
        dims = {d: n - by_dim.get(d, 0)
                for d, n in fa.flash_attention.launches_by_head_dim.items()
                if n != by_dim.get(d, 0)}
        steps = len(got.timings.denoise_steps)
        want_dims = av_flash_counts(dev.tcfg, dev.tecfg, steps, 1)
        expected = [sum(want_dims.values()),
                    *rms_inference_counts(dev.tcfg, dev.tecfg, steps, 1, av=True)]
        err = float(np.abs(got.frames - want.frames).max())
        audio_err = float(np.abs(got.audio - want.audio).max())
        if got.frames.shape != want.frames.shape or got.audio.shape != want.audio.shape                 or not (np.isfinite(got.frames).all() and np.isfinite(got.audio).all()):
            raise AssertionError(f"tiny AV {name}: frames {got.frames.shape}, audio "
                                 f"{got.audio.shape}")
        if not (err <= TINY_FRAME_ATOL and audio_err <= TINY_AUDIO_ATOL):
            raise AssertionError(f"tiny AV {name}: device and CPU differ by {err} (frames), "
                                 f"{audio_err} (waveform)")
        if launches != expected or dims != want_dims:
            raise AssertionError(f"tiny AV {name}: launches {launches} {dims}, expected "
                                 f"{expected} {want_dims}")
        results[name] = {"max_abs_err": err, "audio_max_abs_err": audio_err,
                         "launches": dict(zip(_TINY_COUNTS, launches)),
                         "flash_by_head_dim": dims}
    return results


def _long_video_cases(pipe: LTXPipeline, gen: torch.Generator) -> dict:
    """{name: (run(pipe) -> result, DiT calls, text passes, dual DiT)} of
    the tiny long-video checks, every draw and pixel source made here from
    `gen` on the CPU, so that the card and the CPU get the same."""
    config = GenerationConfig(width=64, height=64, num_frames=17, num_steps=2, seed=3,
                              image_cond_noise_scale=0.15)
    c = pipe.tcfg.in_channels
    shape = VideoLatentShape.from_pixels(1, 17, 64, 64, channels=c)
    steps = len(pipe._sigmas(config, shape)) - 1

    def noise():
        return torch.randn(shape.shape, generator=gen)

    def draws(frames, audio: int = 0):
        return [torch.randn((1, c, frames, 2, 2) if not audio
                            else (1, audio, pipe.tcfg.audio_in_channels), generator=gen)
                for _ in range(steps)]

    def pixels(frames=1):
        return torch.rand(1, 3, frames, 64, 64, generator=gen) * 2 - 1

    audio_noise = [torch.randn(pipe.audio_noise_shape(config), generator=gen)
                   for _ in range(2)]
    k_a = max(1, round(pipe.audio_frames(config) * 9 / 17))
    v2v = dict(initial_noise=noise(), video_frames=pixels(17), strength=0.6)
    ext = dict(initial_noise=noise(), video_frames=pixels(9), cond_frames=9,
               cond_noise=draws(2))
    kf = dict(keyframes=[(0, pixels()), (8, pixels())], initial_noise=noise(),
              cond_noise=draws(2))
    chain = dict(initial_noise=[noise(), noise()], prompts=["a tiny road", "a tiny hill"],
                 cond_noise=[None, draws(3)], anchors={1: [(16, pixels())]}, tail_renorm=0.5)
    av_chain = dict(initial_noise=[noise(), noise()], audio_noise=audio_noise,
                    cond_noise=[None, draws(2)], audio_cond_noise=[None, draws(0, k_a)],
                    audio_cond=True)
    av_kf = dict(keyframes=[(0, pixels()), (16, pixels())], initial_noise=noise(),
                 audio_noise=audio_noise[0], cond_noise=draws(2), audio=True)
    av_ext = dict(initial_noise=noise(), audio_noise=audio_noise[1], video_frames=pixels(9),
                  cond_frames=9, cond_noise=draws(2))
    v2v_steps = steps - min(max(int(round(0.4 * steps)), 0), steps - 1)
    prompt = "a tiny long video"
    return {
        "v2v_0.6": (lambda p: p.generate_video_from_video(prompt, config, **v2v),
                    v2v_steps, 1, False),
        "extension_9": (lambda p: p.generate_video_extension(prompt, config, **ext),
                        steps, 1, False),
        "keyframes_0_8": (lambda p: p.generate_video_keyframes(prompt, config, **kf),
                          steps, 1, False),
        "chain_2_anchor_renorm": (lambda p: p.generate_video_chain(prompt, config, 2, **chain),
                                  2 * steps, 1, False),
        "av_chain_2_audio_cond": (
            lambda p: p.generate_video_chain_with_audio(prompt, config, 2, **av_chain),
            2 * steps, 1, True),
        "av_keyframes_0_16": (lambda p: p.generate_video_keyframes(prompt, config, **av_kf),
                              steps, 1, True),
        "av_extension_9": (lambda p: p.generate_video_with_audio(prompt, config, **av_ext),
                           steps, 1, True),
    }


def check_tiny_long_video(device) -> dict:
    """The tiny pipeline's long-video modes on `device` (its kernels; the
    norms through the rms_norm kernel where the width allows) against the
    same weights, draws and pixel sources on the CPU: video-to-video at
    strength 0.6, the extension of a 9-frame clip, keyframes at pixel frames
    0 and 8, a two-segment chain with two prompts, an anchor in segment 1
    and tail renormalisation; with audio a two-segment chain carrying the
    audio tail, keyframes at 0 and 16 and a clip extension; every
    conditioned frame re-noised. Raises AssertionError on a disagreement
    beyond TINY_FRAME_ATOL (frames) or TINY_AUDIO_ATOL (waveform), or a
    wrong launch count. Returns each case's errors and launches."""
    memory = MemoryConfig(offload_text_encoder=False)  # every case on one pipeline
    # the video modes on a pipeline without the audio connector (a text pass
    # runs the connectors its text encoder has), the audio ones with it
    pipes = {av: (LTXPipeline.random_tiny(device="cpu", seed=2, include_audio=av,
                                          memory=memory),
                  _move(LTXPipeline.random_tiny(device="cpu", seed=2, include_audio=av,
                                                memory=memory), device))
             for av in (False, True)}
    cases = _long_video_cases(pipes[True][0], torch.Generator().manual_seed(17))
    results = {}
    for name, (run, dit_calls, text_passes, av) in cases.items():
        cpu, dev = pipes[av]
        want = run(cpu)
        before = _tiny_counts()
        got = run(dev)
        launches = [a - b for a, b in zip(_tiny_counts(), before)]
        expected = [flash_inference_counts(dev.tcfg, dev.tecfg, dit_calls, text_passes, av),
                    *rms_inference_counts(dev.tcfg, dev.tecfg, dit_calls, text_passes, av=av)]
        if got.frames.shape != want.frames.shape or not np.isfinite(got.frames).all():
            raise AssertionError(f"tiny long video {name}: frames {got.frames.shape}")
        err = float(np.abs(got.frames - want.frames).max())
        audio_err = None
        if av:
            if got.audio.shape != want.audio.shape or not np.isfinite(got.audio).all():
                raise AssertionError(f"tiny long video {name}: audio {got.audio.shape}")
            audio_err = float(np.abs(got.audio - want.audio).max())
        if not (err <= TINY_FRAME_ATOL and (audio_err is None or audio_err <= TINY_AUDIO_ATOL)):
            raise AssertionError(f"tiny long video {name}: device and CPU differ by {err} "
                                 f"(frames), {audio_err} (waveform)")
        if launches != expected:
            raise AssertionError(f"tiny long video {name}: launches {launches}, expected "
                                 f"{expected}")
        results[name] = {"frames": list(got.frames.shape), "max_abs_err": err,
                         "audio_max_abs_err": audio_err,
                         "launches": dict(zip(_TINY_COUNTS, launches))}
    return results


def http_json(url: str, body: Optional[dict] = None):
    """(status, JSON) of a GET, or of a POST of `body`, to the local server."""
    import json
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wait_job(base: str, job_id: str, timeout: float = 600.0) -> dict:
    """Poll GET /v1/jobs/<id> until the job leaves pending and running."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        code, job = http_json(f"{base}/v1/jobs/{job_id}")
        if code != 200:
            raise AssertionError(f"GET /v1/jobs/{job_id}: {code} {job}")
        if job["state"] not in ("pending", "running"):
            return job
        time.sleep(0.01)
    raise AssertionError(f"job {job_id} still {job['state']} after {timeout} s")


@contextlib.contextmanager
def recorded_mp4(write_mp4=None):
    """io.video's MP4 writer replaced for the block by one that keeps each
    file's uint8 pixels ({path: pixels}, yielded) and then calls
    `write_mp4` (default: the writer it replaces)."""
    from ltx_tpu_torch.io import video

    real = video._write_mp4
    writer = write_mp4 or real
    pixels = {}

    def recording(px, path, config):
        pixels[str(path)] = np.array(px)
        writer(px, path, config)

    video._write_mp4 = recording
    try:
        yield pixels
    finally:
        video._write_mp4 = real


class _Stop(Exception):
    """Raised by an on_progress callback to interrupt a denoise loop."""


def check_tiny_surfaces(device, write_mp4=None) -> dict:
    """The seeded front, the server and the denoise resume on a tiny
    pipeline on `device` (a dev schedule of 4 steps, 64x64x9): a
    SeededPipeline T2V at one seed twice gives the same frames, bit for
    bit; a job served over HTTP (127.0.0.1, an ephemeral port) at that seed
    hands the MP4 writer the pixels `frames_to_uint8` gives of the direct
    call, bit for bit (`write_mp4` writes them: the real writer by default);
    a run interrupted after its first step and resumed from its
    DenoiseCheckpoint gives the uninterrupted frames, bit for bit, running
    the DiT only for the 3 steps left. Raises AssertionError otherwise."""
    import tempfile
    from pathlib import Path

    from ltx_tpu_torch.io.video import frames_to_uint8
    from ltx_tpu_torch.pipeline.seeded import SeededPipeline
    from ltx_tpu_torch.serve.app import build_app
    from ltx_tpu_torch.serve.server import serve_forever_threaded
    from ltx_tpu_torch.utils.diagnostics import DenoiseCheckpoint

    pipe = LTXPipeline.random_tiny(device=device, seed=3,
                                   memory=MemoryConfig(offload_text_encoder=False))
    pipe.is_distilled = False  # the dev schedule: num_steps steps
    seeded = SeededPipeline(pipe)
    prompt = "a lighthouse at night"
    body = {"prompt": prompt, "width": 64, "height": 64, "num_frames": 9, "num_steps": 4,
            "seed": 5}
    config = GenerationConfig(**{k: v for k, v in body.items() if k != "prompt"})
    first = seeded.generate_video(prompt, config)
    again = seeded.generate_video(prompt, config)
    if not np.array_equal(first.frames, again.frames):
        raise AssertionError("SeededPipeline: one seed gave two results")
    other = seeded.generate_video(prompt, dataclasses.replace(config, seed=6))
    if np.array_equal(first.frames, other.frames):
        raise AssertionError("SeededPipeline: seeds 5 and 6 gave the same frames")

    with tempfile.TemporaryDirectory() as tmp:
        with recorded_mp4(write_mp4) as written:
            app = build_app(seeded, output_dir=tmp, port=0)
            serve_forever_threaded(app.server)
            base = "http://%s:%d" % app.server.server_address[:2]
            try:
                code, out = http_json(f"{base}/v1/generate", body)
                if code != 202:
                    raise AssertionError(f"POST /v1/generate: {code} {out}")
                job = wait_job(base, out["job_id"])
            finally:
                app.close()
        if job["state"] != "done":
            raise AssertionError(f"served job {job['state']}: {job.get('error')}")
        served = written[job["result"]["output"]]
        if not np.array_equal(served, frames_to_uint8(first.frames)):
            raise AssertionError("the served job's pixels differ from the direct call's")

        ckpt = DenoiseCheckpoint(str(Path(tmp) / "denoise.ckpt"), every_n_steps=1)

        def stop(i, n, sigma):
            if i == 0:
                raise _Stop

        try:
            seeded.generate_video(prompt, config, on_progress=stop, checkpoint=ckpt)
            raise AssertionError("the interrupted run was not interrupted")
        except _Stop:
            pass
        before = _tiny_counts()
        resumed = seeded.generate_video(prompt, config, checkpoint=ckpt)
        launches = [a - b for a, b in zip(_tiny_counts(), before)]
    if not np.array_equal(resumed.frames, first.frames):
        raise AssertionError("the resumed run differs from the uninterrupted one: "
                             f"{float(np.abs(resumed.frames - first.frames).max())}")
    expected = [flash_inference_counts(pipe.tcfg, pipe.tecfg, 3, 1),
                *rms_inference_counts(pipe.tcfg, pipe.tecfg, 3, 1)]
    if pipe.device.type == "cuda" and launches != expected:
        raise AssertionError(f"resumed run: launches {launches}, expected {expected}")
    return {"frames": list(first.frames.shape), "served_pixels": list(served.shape),
            "resumed_steps": len(resumed.timings.denoise_steps),
            "resumed_launches": dict(zip(_TINY_COUNTS, launches))}


def rms_train_counts(tcfg, forwards: int = 2) -> dict:
    """{"rms_norm": kernel launches, "rms_chain_on_cuda": plain-chain calls}
    of the DiT's norms in one LoRA train step on the card, with LoRA on every
    block linear (attention q/k/v/out, both FF linears) and everything else
    frozen; `forwards` is the DiT forwards the step runs while autograd
    records: 2 with per-block remat (the step's forward, then each block's
    recompute in the backward), 1 without, 3 with segmented remat.

    `ops.normalization.rms_route` gives a norm the kernel wherever nothing
    upstream of it requires grad. Every q and k norm reads the output of a
    linear with LoRA, and every adaln after block 0's first reads a hidden
    state that a LoRA branch has fed, so one norm a forward qualifies:
    block 0's pre-attention adaln, on the frozen patchify projection of the
    noised latents. The other 6 * num_layers - 1 take the chain (all of them
    where the width is not a multiple of 128)."""
    calls = 6 * tcfg.num_layers * forwards
    kernel = 0 if tcfg.inner_dim % rk.LANES else forwards
    return {"rms_norm": kernel, "rms_chain_on_cuda": calls - kernel}


def check_tiny_two_stage(device) -> dict:
    """The tiny two-stage I2V pipeline on `device`, its DiT's norms through
    the rms_norm kernel by the default route, against the same weights and
    draws on the CPU (the plain versions, held against the reference by the
    CPU tests): both
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
    before = _tiny_counts()
    got, _ = run(dev)
    launches = [a - b for a, b in zip(_tiny_counts(), before)]
    expected = [dit_steps * dev.tcfg.num_layers * 2 + dev.tecfg.connector_layers,
                *rms_inference_counts(dev.tcfg, dev.tecfg, dit_steps, 1)]
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or got.shape[0] != config.num_frames \
            or not np.isfinite(got).all():
        raise AssertionError(f"tiny two-stage: frames {got.shape}")
    if not err <= TINY_FRAME_ATOL:
        raise AssertionError(f"tiny two-stage: device and CPU differ by {err}")
    if launches != expected:
        raise AssertionError(f"tiny two-stage: launches {launches}, expected {expected}")
    return {"max_abs_err": err, "mean_abs_err": float(np.abs(got - want).mean()),
            "launches": dict(zip(_TINY_COUNTS, launches))}


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
    names = ("flash_attention_stats", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
             "flash_attention", "rms_norm", "rms_chain_on_cuda")

    def counts():
        return [fa.flash_attention_stats.launches, fa.flash_attention_bwd_dq.launches,
                fa.flash_attention_bwd_dkv.launches, fa.flash_attention.launches,
                rk.rms_norm.launches, normalization.rms_chain_on_cuda]

    before = counts()
    got = _tiny_train_run(model.to(device), batch, draws, device, dtype)
    launches = [a - b for a, b in zip(counts(), before)]
    layers = len(model.blocks)
    # one backward alone, then the steps; each a remat forward, the blocks'
    # recompute (stats), and one backward (dq, dkv) per attention; the norms
    # as the route gives them in a LoRA step (rms_train_counts)
    calls = 1 + TINY_TRAIN_STEPS
    norms = rms_train_counts(model.cfg, forwards=2)
    expected = [calls * 2 * 2 * layers, calls * 2 * layers, calls * 2 * layers, 0,
                calls * norms["rms_norm"], calls * norms["rms_chain_on_cuda"]]
    out = {
        "grad_rel": _rel(torch.cat([g.flatten() for g in got[0].values()]),
                         torch.cat([g.flatten() for g in want[0].values()])),
        "loss_rel": max(_rel(g, w) for g, w in zip(got[1], want[1])),
        "lora_rel": _rel(torch.cat([p.flatten() for p in got[2].values()]),
                         torch.cat([p.flatten() for p in want[2].values()])),
        "launches": dict(zip(names, launches)),
    }
    if launches != expected:
        raise AssertionError(f"tiny train: launches {launches}, expected {expected}")
    worst = max(out["grad_rel"], out["loss_rel"], out["lora_rel"])
    if not worst <= TINY_TRAIN_TOL:
        raise AssertionError(f"tiny train: device vs CPU {out}")
    return out


# the dual block's attentions, and the int4 linears of a LoRA step whose
# input carries no gradient: block 0's self-attention q, k, v read the frozen
# patchify projections, every text cross-attention's k, v the frozen caption
# projections
AV_ATTENTIONS = ("attn1", "attn2", "audio_attn1", "audio_attn2", "audio_to_video_attn",
                 "video_to_audio_attn")
AV_FROZEN_INPUTS = tuple(f"blocks.0.{a}.{p}" for a in ("attn1", "audio_attn1")
                         for p in ("to_q", "to_k", "to_v"))
AV_FROZEN_CONTEXT = tuple(f"{a}.{p}" for a in ("attn2", "audio_attn2") for p in ("to_k", "to_v"))
# norms of a dual block: the eight block norms and each attention's q and k norms
AV_BLOCK_NORMS = 8 + 2 * len(AV_ATTENTIONS)


def av_train_step_launches(model: torch.nn.Module, forwards: int = 2) -> dict:
    """Launches of one LoRA step of an LTXAVTransformer on the card, with
    LoRA on every block linear, fewer than BIG_M_DEQUANT_THRESHOLD rows, and
    `forwards` DiT forwards while autograd records (2 with per-block remat:
    the step's forward, then each block's recompute in the backward).

    Every attention runs the statistics forward once a forward, and dq and
    dkv once in the backward (its q has LoRA, so its inputs need gradients).
    Every int4 block linear that passes `use_int4_kernel` runs int4_matmul
    once a forward, and dequant_int4 once in its straight-through backward
    where its input needs a gradient: all but AV_FROZEN_INPUTS and the text
    cross-attentions' k and v. The norms go as `rms_route` gives them: block
    0's norm1 and audio_norm1 read the frozen patchify projections and take
    the kernel where their width is a multiple of 128; the other norms read
    hidden states that a LoRA branch has fed, and take the chain."""
    layers = len(model.blocks)
    routed = [name for name, m in model.blocks.named_modules(prefix="blocks")
              if isinstance(m, QuantizedLinear) and hasattr(m, "w_q4")
              and qz.use_int4_kernel({"w_q4": m.w_q4}, torch.empty(0, m.dims[0], device="meta"))]
    frozen = [n for n in routed
              if n in AV_FROZEN_INPUTS or n.split(".", 2)[2] in AV_FROZEN_CONTEXT]
    cfg = model.cfg
    kernel = forwards * sum(d % rk.LANES == 0 for d in (cfg.inner_dim, cfg.audio_inner_dim))
    return {"flash_attention_stats": forwards * len(AV_ATTENTIONS) * layers,
            "flash_attention_bwd_dq": len(AV_ATTENTIONS) * layers,
            "flash_attention_bwd_dkv": len(AV_ATTENTIONS) * layers,
            "flash_attention": 0,
            "int4_matmul": forwards * len(routed),
            "dequant_int4": len(routed) - len(frozen),
            "rms_norm": kernel,
            "rms_chain_on_cuda": forwards * AV_BLOCK_NORMS * layers - kernel}


# the tiny AV QLoRA step: the dual DiT at widths where every block linear
# quantizes to int4 and passes the kernel route's shape rule (head dims 64:
# 256 wide), so that the card runs B2, B3, B4 and B5 at head dim 64
TINY_AV_CFG = dataclasses.replace(TransformerConfig().tiny(), head_dim=64,
                                  cross_attention_dim=256, audio_head_dim=64)
TINY_AV_GRID, TINY_AV_AUDIO, TINY_AV_TEXT = (2, 4, 6), 7, 16


def _tiny_av_train_case(seed: int = 7):
    """The tiny dual DiT in bf16, its block linears int4 (quantized on the
    CPU), rank-4 LoRA (lora_b drawn nonzero), a 2-row batch with a
    left-padded text mask per row, the RoPE tables and each step's draws
    (sigma_v, sigma_a, noise_v, noise_a); on the CPU."""
    cfg = TINY_AV_CFG
    gen = torch.Generator().manual_seed(seed)
    model = init_random_(LTXAVTransformer(cfg, device="cpu", dtype=torch.bfloat16), gen)
    quantize_transformer(model, 4)
    add_lora(model, gen, rank=4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    f, h, w = TINY_AV_GRID
    video = torch.randn(2, f * h * w, cfg.in_channels, generator=gen)
    audio = torch.randn(2, TINY_AV_AUDIO, cfg.audio_in_channels, generator=gen)
    vctx, actx = (torch.randn(2, TINY_AV_TEXT, cfg.caption_channels, generator=gen)
                  for _ in range(2))
    mask = torch.ones(2, TINY_AV_TEXT, dtype=torch.int64)
    mask[0, :5] = 0
    mask[1, :9] = 0
    bias = prepare_additive_mask(mask)
    ropes = prepare_av_ropes(cfg, f, h, w, TINY_AV_AUDIO)
    draws = [(torch.rand(2, generator=gen) * 0.98 + 0.01,
              torch.rand(2, generator=gen) * 0.98 + 0.01,
              torch.randn(video.shape, generator=gen), torch.randn(audio.shape, generator=gen))
             for _ in range(TINY_TRAIN_STEPS)]
    return model, (video, audio, vctx, actx, ropes, bias), draws


def _to(x, device):
    return tuple(_to(t, device) for t in x) if isinstance(x, tuple) else x.to(device)


def _tiny_av_train_run(model, batch, draws, device):
    video, audio, vctx, actx, ropes, bias = _to(batch, device)
    tc = TrainConfig(lora_only=True, learning_rate=1e-3)
    trainable, _, opt_state = init_train_state(model, tc)
    inputs = (video, audio, vctx, actx, ropes)
    loss, _ = av_flow_match_loss(model, *inputs, *_to(draws[0], device), bias, bias)
    names = list(trainable)
    grads = dict(zip(names, torch.autograd.grad(loss, [trainable[n] for n in names])))
    step = make_av_train_step(model, tc)
    metrics = []
    for draw in draws:
        trainable, opt_state, aux = step(trainable, opt_state, *inputs, *_to(draw, device),
                                         bias, bias)
        metrics.append(aux)
    return grads, metrics, trainable


def check_tiny_av_train(device) -> dict:
    """The tiny AV QLoRA step on `device` (B2, B3a and B3b at head dim 64,
    B4 forward and B5 in the int4 straight-through backward) against the
    same int4 weights, batch and draws on the CPU (the plain versions, held
    against the reference by the CPU tests), bf16 compute, per-block remat:
    one loss and its LoRA gradients, then TINY_TRAIN_STEPS steps. Raises
    AssertionError beyond TINY_TRAIN_TOL, on a non-finite or non-positive
    stream loss, a base weight that moved, or a wrong launch count; returns
    the errors and the launches."""
    model, batch, draws = _tiny_av_train_case()
    base = {n: p.detach().clone() for n, p in model.named_parameters()
            if not n.endswith(("lora_a", "lora_b", "lora_s"))}
    want = _tiny_av_train_run(copy.deepcopy(model), batch, draws, "cpu")
    expected = av_train_step_launches(model)
    before = read_kernel_counts()
    got = _tiny_av_train_run(model.to(device), batch, draws, device)
    launches = {k: v - before[k] for k, v in read_kernel_counts().items()}
    calls = 1 + TINY_TRAIN_STEPS
    expected = {k: calls * v for k, v in expected.items()}
    out = {
        "grad_rel": _rel(torch.cat([g.flatten() for g in got[0].values()]),
                         torch.cat([g.flatten() for g in want[0].values()])),
        "loss_rel": max(_rel(g[k], w[k]) for g, w in zip(got[1], want[1])
                        for k in ("loss", "loss_video", "loss_audio")),
        "lora_rel": _rel(torch.cat([p.flatten() for p in got[2].values()]),
                         torch.cat([p.flatten() for p in want[2].values()])),
        "launches": launches,
    }
    for aux in got[1]:
        if not all(torch.isfinite(v).all() for v in aux.values()) \
                or not (aux["loss_video"] > 0 and aux["loss_audio"] > 0):
            raise AssertionError(f"tiny AV train: metrics {aux}")
    moved = [n for n, p in model.named_parameters() if n in base
             and not torch.equal(p.detach().cpu(), base[n])]
    if moved:
        raise AssertionError(f"tiny AV train: base parameters moved: {moved[:4]}")
    if launches != expected:
        raise AssertionError(f"tiny AV train: launches {launches}, expected {expected}")
    worst = max(out["grad_rel"], out["loss_rel"], out["lora_rel"])
    if not worst <= TINY_TRAIN_TOL:
        raise AssertionError(f"tiny AV train: device vs CPU {out}")
    return out


def read_kernel_counts() -> dict:
    """Every kernel wrapper's launch count, and the CUDA calls of rms_norm
    that took the plain chain."""
    return {"flash_attention": fa.flash_attention.launches,
            "flash_attention_stats": fa.flash_attention_stats.launches,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv.launches,
            "int4_matmul": qz.int4_matmul.launches, "dequant_int4": qz.dequant_int4.launches,
            "rms_norm": rk.rms_norm.launches,
            "rms_chain_on_cuda": normalization.rms_chain_on_cuda}


# --------------------------------------------------------------------------
# Weights from files: the MLX dequantization, LoRA fusion
# --------------------------------------------------------------------------


def _bf16_payload_to_f32(payload: np.ndarray) -> np.ndarray:
    return (payload.astype(np.uint32) << 16).view(np.float32)


def mlx_dequant_bits(packed, scales, biases, group: int = 64, bits: int = 4) -> np.ndarray:
    """An MLX 4-bit linear dequantized by numpy, independently of the port:
    (out, in / 8) uint32 words (code n of a word in bits 4n..4n+3), (out,
    in / group) bf16 scales and biases -> the (out, in) bf16 weight's
    payload (uint16): q * scale + bias in float32 (two roundings), then
    round to nearest even. Arguments are CPU tensors as read from the file."""
    words = packed.view(torch.int32).numpy().view(np.uint32)
    s = _bf16_payload_to_f32(scales.view(torch.int16).numpy().view(np.uint16))
    b = _bf16_payload_to_f32(biases.view(torch.int16).numpy().view(np.uint16))
    per_word = 32 // bits
    o, iw = words.shape
    q = np.zeros((o, iw * per_word), np.float32)
    for n in range(per_word):
        q[:, n::per_word] = ((words >> np.uint32(n * bits)) & np.uint32((1 << bits) - 1))
    w = q.reshape(o, -1, group) * s[:, :, None]
    w = (w + b[:, :, None]).reshape(o, -1)
    u = w.view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
            >> np.uint32(16)).astype(np.uint16)


def check_mlx_dequant(packed, scales, biases, loaded) -> dict:
    """The loaded bf16 Gemma weight against `mlx_dequant_bits` of its file
    arrays: the number of differing values (must be 0)."""
    want = mlx_dequant_bits(packed, scales, biases)
    got = loaded.detach().cpu().contiguous().view(torch.int16).numpy().view(np.uint16)
    differing = int(np.count_nonzero(got != want))
    if got.shape != want.shape or differing:
        raise AssertionError(f"MLX dequant: {differing} values differ from numpy's "
                             f"(shapes {got.shape} / {want.shape})")
    return {"values": int(want.size), "differing": differing}


def device_copy(model: torch.nn.Module, device) -> torch.nn.Module:
    """A copy of `model` whose parameters are new tensors on `device`
    (Module.to would move the shared parameters of a structure copy)."""
    memo = {id(p): torch.nn.Parameter(p.detach().to(device), requires_grad=p.requires_grad)
            for p in model.parameters()}
    return copy.deepcopy(model, memo)


def lora_fuse_bound(layer, scale: float, device):
    """How far two float32 deltas scale * (alpha / rank) * (up @ down)
    computed in different summation orders can be apart, element by element:
    each is within rank * 2**-24 * (|up| @ |down|) * |scale * alpha / rank|
    of the exact one."""
    up = layer.up.to(device, torch.float32).abs()
    down = layer.down.to(device, torch.float32).abs()
    return (up @ down) * (layer.rank * 2.0**-23 * abs(scale * layer.effective_scale))


def check_fused_leaves(got: torch.nn.Module, want: torch.nn.Module, layers, scale: float,
                       paths) -> dict:
    """Fused bf16 Linear weights of two fusions of the same LoRA (e.g. the
    card's and the CPU's) at the module `paths`, element by element, on
    `got`'s device:

        |a - b| <= ulp_bf16(max(|a|, |b|)) + 2**-23 max(|a|, |b|) + lora_fuse_bound

    (the two f32 sums W + delta, each rounded once in f32, then to bf16: one
    bf16 ulp where the f32 values straddle a rounding boundary). Returns the
    worst share of the bound (<= 1) and the share of differing values."""
    from ltx_tpu_torch.lora.fuse import module_path

    worst, differing, total = 0.0, 0, 0
    blocks = len(got.blocks)
    for layer in layers:
        path = module_path(layer.original_key, blocks)
        if path not in paths:
            continue
        a = got.get_submodule(path).weight.detach().float()
        b = want.get_submodule(path).weight.detach().to(a.device, torch.float32)
        big = torch.maximum(a.abs(), b.abs())
        bound = bf16_ulp(big) + 2.0**-23 * big + lora_fuse_bound(layer, scale, a.device)
        worst = max(worst, ((a - b).abs() / bound).max().item())
        differing += int((a != b).sum())
        total += a.numel()
    if not total or worst > 1.0:
        raise AssertionError(f"fused leaves: worst share of the bound {worst} over "
                             f"{total} values")
    return {"share": worst, "differing": differing / total, "values": total}


# a DiT call with the LoRA fused into bf16 weights against the same call with
# the adapter as a float32 side path: the fused weight's bf16 rounding and
# the bf16 product against the side path's float32 one, through every block
# (the port's bf16 DiT tolerance, test_torch_dit)
LORA_SIDE_PATH_TOL = 5e-2


@torch.inference_mode()
def lora_side_path_check(model: torch.nn.Module, layers, scale: float, tokens=(4, 16, 24),
                         text_tokens: int = 1024, device="cuda", seed: int = 11) -> dict:
    """One DiT call of `model` (an unfused bf16 LTXTransformer, anywhere)
    with `layers` fused on `device`, against the same call of the unfused
    model carrying each layer as a LoRA side path (lora_a = down^T, lora_b
    = up^T, lora_s = scale * alpha / rank: train/lora.py's slots), on a
    seeded latent of `tokens` (F', H', W') and a text context. Returns the
    velocity's max abs error relative to its max magnitude, and the fused
    model on `device` (for `check_fused_leaves`)."""
    from ltx_tpu_torch.lora.fuse import fuse_lora, module_path

    base = device_copy(model, device)
    fused = fuse_lora(base, layers, scale)
    side = fuse_lora(base, [], scale)  # a structure copy: slots go on it only
    for layer in layers:
        path = module_path(layer.original_key, len(side.blocks))
        if path is None:
            continue
        linear = side.get_submodule(path)
        linear.add_lora_params(layer.rank, torch.float32)
        linear.lora_a.copy_(layer.down.t())
        linear.lora_b.copy_(layer.up.t())
        linear.lora_s.fill_(scale * layer.effective_scale)
    cfg = model.cfg
    gen = torch.Generator().manual_seed(seed)
    f, h, w = tokens
    latent = torch.randn(1, f * h * w, cfg.in_channels, generator=gen)
    context = torch.randn(1, text_tokens, cfg.caption_channels, generator=gen)
    cos, sin = video_rope(f, h, w, cfg.inner_dim, cfg.num_heads)
    args = (latent.to(device, torch.bfloat16), context.to(device, torch.bfloat16),
            torch.full((1,), 0.5, device=device),
            (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)))
    got, want = fused(*args).float(), side(*args).float()
    return {"rel_err": _rel(got, want), "fused": fused,
            "finite": bool(torch.isfinite(got).all() and torch.isfinite(want).all())}


def tiny_cycle_gemma(device="cpu", seed: int = 0):
    """The tiny cycle Gemma (f32) on `device`, its cycle and a prompt that
    ends on the cycle."""
    from ltx_tpu_torch.models.gemma3 import Gemma3Config
    from ltx_tpu_torch.weights.synthetic import default_cycle, make_cycle_gemma

    cfg = Gemma3Config().tiny()
    cycle = default_cycle(cfg, period=TINY_CYCLE_PERIOD)
    model = make_cycle_gemma(cfg, torch.Generator().manual_seed(seed), cycle=cycle)
    return model.to(device), cycle, np.asarray((5, 7, 9) + cycle + cycle[:4], np.int64)


def check_tiny_generate(device) -> dict:
    """The tiny cycle Gemma's greedy generation on `device` against the same
    weights on the CPU, token for token: generate_tokens sequential and
    speculative (spec_k 4), with the bf16 and the int8 cache, and
    generate_tokens_batched on two prompts. Raises AssertionError on a
    difference; returns the tokens generated and the speculative forwards."""
    from ltx_tpu_torch.models.gemma3 import generate_tokens, generate_tokens_batched

    cpu, _, prompt = tiny_cycle_gemma("cpu")
    dev = tiny_cycle_gemma(device)[0]
    kw = dict(max_new_tokens=24, temperature=0.0, stop_tokens=(), bucket=16)
    res = {}
    for name, extra in (("sequential", {}), ("spec", dict(spec_k=4)),
                        ("int8_kv", dict(kv_quant="int8"))):
        want, stats = generate_tokens(cpu, prompt, return_stats=True, **kw, **extra)
        got, dev_stats = generate_tokens(dev, prompt, return_stats=True, **kw, **extra)
        if got != want or stats != dev_stats:
            raise AssertionError(f"tiny generate {name} on {device}: {got} {dev_stats}, "
                                 f"the CPU {want} {stats}")
        res[name] = {"tokens": len(got), **dev_stats}
    prompts = [prompt, prompt[3:9]]
    want = generate_tokens_batched(cpu, prompts, spec_k=4, **kw)
    got = generate_tokens_batched(dev, prompts, spec_k=4, **kw)
    if got != want:
        raise AssertionError(f"tiny batched generate on {device}: {got}, the CPU {want}")
    res["batched"] = [len(t) for t in got]
    return res


# the SigLIP tower on the card through the flash kernel against the same
# tower with the plain attention: bf16 features, relative to their largest
# value (the CPU tests' bf16 bound)
SIGLIP_REL_TOL = 5e-2


@contextlib.contextmanager
def plain_siglip_attention():
    """SigLIP's attention through `flash_attention_reference` (the plain
    version, on any device) instead of `ops.attention.sdpa`, for holding
    the tower's kernel route against it."""
    from ltx_tpu_torch.models import siglip

    routed = siglip.sdpa
    siglip.sdpa = lambda q, k, v, bias=None, scale=None: fa.flash_attention_reference(
        q, k, v, bias, scale)
    try:
        yield
    finally:
        siglip.sdpa = routed


def siglip_inputs(cfg, device, seed: int = 11, dtype=torch.bfloat16):
    """A SigLIP tower at `cfg` with seeded random weights on `device`, and a
    seeded (1, S, S, 3) pixel array in [-1, 1]."""
    from ltx_tpu_torch.models.siglip import SigLIPModel

    gen = torch.Generator(device=device).manual_seed(seed)
    model = init_random_(SigLIPModel(cfg, device=device, dtype=dtype), gen)
    pixels = torch.rand(1, cfg.image_size, cfg.image_size, 3, generator=gen,
                        device=device) * 2 - 1
    return model, pixels


@torch.inference_mode()
def check_siglip(model, pixels) -> dict:
    """`vision_forward` with the flash kernel (its launches counted) against
    the same tower with the plain attention on the same device, within
    SIGLIP_REL_TOL of the plain features' largest value; raises
    AssertionError otherwise. Returns the error, the launches, the soft
    tokens' shape and the features (kernel route)."""
    from ltx_tpu_torch.models.siglip import project_to_soft_tokens, vision_forward

    before = fa.flash_attention.launches
    got = vision_forward(model, pixels)
    launches = fa.flash_attention.launches - before
    with plain_siglip_attention():
        want = vision_forward(model, pixels)
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    soft = project_to_soft_tokens(model, got)
    cfg = model.cfg
    if not (np.isfinite(err) and err <= SIGLIP_REL_TOL) or tuple(soft.shape) != (
            1, cfg.mm_tokens_per_image, cfg.text_hidden_size):
        raise AssertionError(f"SigLIP on {pixels.device}: kernel vs plain attention "
                             f"{err}, soft tokens {tuple(soft.shape)}")
    return {"rel_err": err, "launches": launches, "soft_tokens": tuple(soft.shape),
            "features": got}


# --------------------------------------------------------------------------
# Parallelism: ring attention, TP denoise steps, the sharded decode
# --------------------------------------------------------------------------

# the ring bounds' roundings of each partial (module docstring)
RING_ROUNDINGS = 2


@dataclasses.dataclass(frozen=True)
class RingCase:
    name: str
    b: int
    h: int
    t: int
    d: int
    # None; ("left", n): the first n keys -10000, as the tokenizer pads;
    # ("masked", n): keys from n on -1e30, as sdpa pads to the ring
    bias: Optional[tuple] = None


RING_CASES = (
    # the north star's self-attention (25f@768x512, 1536 tokens) and the
    # flagship stage 2's (19840 tokens), with and without a key bias
    RingCase("north_star_self", 1, 32, 1536, 128),
    RingCase("north_star_self_bias", 1, 32, 1536, 128, bias=("left", 300)),
    RingCase("flagship_stage2_self", 1, 32, 19840, 128),
    RingCase("flagship_stage2_self_bias", 1, 32, 19840, 128, bias=("masked", 19776)),
)


def ring_inputs(case: RingCase, device, seed: int = 31):
    """q, k, v, dO (bf16, contiguous (B, H, T, D)) and the (B, T) f32 key
    bias or None, the same on every rank."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(case.b, case.h, case.t, case.d, generator=gen,
                               device=device).bfloat16() for _ in range(4))
    bias = None
    if case.bias is not None:
        bias = torch.zeros(case.b, case.t, device=device)
        if case.bias[0] == "left":
            bias[:, :case.bias[1]] = -10000.0
        else:
            bias[:, case.bias[1]:] = -1e30
    return q, k, v, do, bias


def _ring_head_bounds(q, k, v, bias, do, scale, t_local: int, rounds: int):
    """One head's exact output and plain gradients (f32, at the exact output
    and lse) and the ring bounds around them (the derivation above) with
    `rounds` roundings of each partial: (exact, fwd_bound, (dq, dk, dv),
    (tol_dq, tol_dk, tol_dv))."""
    logits = fa.attention_logits(q, k, bias, scale)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    del logits
    l = p.sum(dim=-1)
    p /= l[..., None]
    vf, qf, kf, dof = v.float(), q.float(), k.float(), do.float()
    exact, pv = torch.matmul(p, vf), torch.matmul(p, vf.abs())
    lse = m + torch.log(l)
    fwd = (rounds * ATTN_P_ROUNDING + (t_local / 16 + 16) * 2.0**-23) * pv \
        + 2 * bf16_ulp(exact)
    want = fa.flash_attention_backward_reference(qf, kf, vf, bias, exact, lse, dof, scale)
    delta = (dof * exact).sum(dim=-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None]
    eps_p = (2.0**-16 * scale * torch.matmul(qf.abs(), kf.abs().transpose(-1, -2))
             + STATS_L_REL) * p
    ddelta = (dof.abs() * fwd).sum(dim=-1)
    eps_s = (2.0**-16 * scale * torch.matmul(dof.abs(), vf.abs().transpose(-1, -2)) * p
             + eps_p * dp.abs() * scale + p * scale * ddelta[..., None])
    s_term = rounds * ATTN_P_ROUNDING * (p * dp * scale).abs() + eps_s
    del dp, eps_s
    dq_w, dk_w, dv_w = want
    tols = (torch.matmul(s_term, kf.abs()) + 2 * bf16_ulp(dq_w),
            torch.matmul(s_term.transpose(-1, -2), qf.abs()) + 2 * bf16_ulp(dk_w),
            torch.matmul((rounds * ATTN_P_ROUNDING * p + eps_p).transpose(-1, -2), dof.abs())
            + 2 * bf16_ulp(dv_w))
    return exact, fwd, want, tols


def check_ring(case: RingCase, mesh, device, judge: bool) -> dict:
    """Ring attention forward and backward (`parallel.ring_attention.
    sequence_parallel_sdpa`) over `mesh`'s model axis, called by every rank
    of it alike; the rank with `judge` also runs B1 and the B3 pair on the
    whole sequence and holds both, head by head, to their bounds around the
    exact output and the plain gradients (the derivation above): the ring
    with RING_ROUNDINGS, the whole-sequence kernels with one. Raises
    AssertionError beyond them. Returns the launches per ring step, the
    ring's seconds (two ranks on one card share it: not a time of the ring
    apart) and, on the judge, the shares and errors."""
    from ltx_tpu_torch.parallel.ring_attention import sequence_parallel_sdpa

    n = mesh.shape["model"]
    q, k, v, do, bias = ring_inputs(case, device)
    scale = case.d**-0.5
    sync = torch.cuda.synchronize if q.is_cuda else (lambda d: None)
    before = read_kernel_counts()
    sync(device)
    t0 = time.perf_counter()
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = sequence_parallel_sdpa(qr, kr, vr, mesh, bias=bias)
    out.backward(do)
    sync(device)
    seconds = time.perf_counter() - t0
    after = read_kernel_counts()
    res = {"case": case.name, "shared_card_seconds": seconds,
           "per_ring_step": {name: (after[name] - before[name]) / n
                             for name in ("flash_attention_stats", "flash_attention_bwd_dq",
                                          "flash_attention_bwd_dkv")},
           "out": out.detach(), "grads": (qr.grad, kr.grad, vr.grad)}
    if not judge:
        return res
    whole = fa.flash_attention(q, k, v, bias, scale)
    o2, m2, l2 = fa.flash_attention_stats(q, k, v, bias, scale)
    whole_g = fa.flash_attention_backward(q, k, v, bias, o2, fa.softmax_lse(m2, l2), do, scale)
    del o2, m2, l2
    shares = {"out": 0.0, "whole_out": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0,
              "whole_dq": 0.0, "whole_dk": 0.0, "whole_dv": 0.0}
    err = {"out": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for h in range(case.h):
        hs = slice(h, h + 1)
        args = (q[:, hs], k[:, hs], v[:, hs], bias, do[:, hs], scale)
        for rounds, tag, o, grads in ((RING_ROUNDINGS, "", out, res["grads"]),
                                      (1, "whole_", whole, whole_g)):
            exact, fwd, want, tols = _ring_head_bounds(*args, case.t // (n if tag == "" else 1),
                                                       rounds)
            shares[tag + "out"] = max(shares[tag + "out"],
                                      tolerance_share(o[:, hs].detach(), exact, fwd))
            for name, g, w, tol in zip(("dq", "dk", "dv"), grads, want, tols):
                shares[tag + name] = max(shares[tag + name],
                                         tolerance_share(g[:, hs], w, tol))
                if tag == "":
                    err[name] = max(err[name], (g[:, hs].float() - w).abs().max().item())
            if tag == "":
                err["out"] = max(err["out"], (o[:, hs].float() - exact).abs().max().item())
            del exact, fwd, want, tols
    res.update(shares=shares, max_abs_err=err,
               ring_vs_whole=(out.float() - whole.float()).abs().max().item())
    if not max(shares.values()) <= 1.0:
        raise AssertionError(f"ring {case.name}: shares of the tolerance {shares}")
    return res


def seeded_module_(module: torch.nn.Module, device, seed: int, mesh=None, pp_mesh=None):
    """Materialise `module` (built on "meta") on `device`, submodule by
    submodule: each submodule with `reset_parameters` draws its own
    parameters from a generator seeded with (seed, its index in the whole
    module's `modules()`), so that any rank can draw any part alone. With
    `mesh` each DiT block is sliced to this rank's shard as soon as it is
    drawn (`parallel.sharding.shard_transformer`), so no rank holds the
    whole model, then the model is marked for the mesh. With `pp_mesh` the
    model keeps this stage's blocks (`parallel.pipeline.shard_pp`) before
    anything is drawn, and only they are. The same seed gives the same
    weights, whole, sharded or split into stages."""
    from ltx_tpu_torch.parallel import pipeline, sharding

    index = {id(m): i for i, m in enumerate(module.modules())}
    if pp_mesh is not None:
        pipeline.shard_pp(module, pp_mesh)
    blocks = getattr(module, "blocks", None)
    owner = {id(m): b for b in (blocks or []) for m in b.modules()}
    done = set()
    for mod in module.modules():
        i = index[id(mod)]
        if any(p.is_meta for p in mod.parameters(recurse=False)):
            mod.to_empty(device=device, recurse=False)
        reset = getattr(mod, "reset_parameters", None)
        if reset is not None:
            with torch.no_grad():
                reset(torch.Generator(device=device).manual_seed(seed * 1_000_003 + i))
        block = owner.get(id(mod))
        if mesh is not None and block is not None and id(block) not in done \
                and all(not p.is_meta for p in block.parameters()):
            sharding.shard_transformer(block, mesh)
            done.add(id(block))
    if mesh is not None:
        sharding.shard_transformer(module, mesh)
    return module


# the TP denoise step at the north star: one step, sigma 0.9 -> 0.5, the
# text context of 1024 keys left-padded by 300 as the tokenizer pads
TP_STEP_SIGMAS = (0.9, 0.5)
TP_CONTEXT_PAD = 300


def tp_step_inputs(tcfg: TransformerConfig, config: GenerationConfig, device, seed: int = 41,
                   rows: int = 1):
    """(shape, latent, context, bias): the north star's latent and a text
    context of its width, drawn on `device` from one seeded generator. With
    rows=2 a negative prompt's row, drawn after, comes first (CFG's order:
    uncond, cond)."""
    shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height, config.width,
                                         channels=tcfg.in_channels)
    gen = torch.Generator(device=device).manual_seed(seed)
    latent = torch.randn(shape.shape, generator=gen, device=device)
    context = torch.randn(1, 1024, tcfg.caption_channels, generator=gen,
                          device=device).bfloat16()
    if rows == 2:
        negative = torch.randn(1, 1024, tcfg.caption_channels, generator=gen,
                               device=device).bfloat16()
        context = torch.cat([negative, context])
    mask = torch.ones(rows, 1024, dtype=torch.int64, device=device)
    mask[:, :TP_CONTEXT_PAD] = 0
    return shape, latent, context, prepare_additive_mask(mask)


def tp_step_velocity(model, config: GenerationConfig, inputs) -> torch.Tensor:
    """One denoise step of `model` (whole, or this rank's shard) at
    `inputs`; returns the velocity, f32 on the host."""
    from ltx_tpu_torch.pipeline.denoise import GuidanceSpec, make_denoise_step

    shape, latent, context, bias = inputs
    guidance = GuidanceSpec.from_config(config)
    step = make_denoise_step(model, guidance, shape, context, bias)
    with torch.inference_mode():
        _, velocity = step(latent, *TP_STEP_SIGMAS)
    return velocity.float().cpu()


def tp_counts() -> dict:
    """The kernels' launches, the sharded QK norms and the collectives."""
    from ltx_tpu_torch.parallel import collectives, sharding

    return {**read_kernel_counts(), "sharded_rms_norm": sharding.sharded_rms_norm.calls,
            **{f"collective_{k}": v for k, v in collectives.counts.items()}}


def reset_tp_counts() -> None:
    from ltx_tpu_torch.parallel import collectives, sharding

    for fn in (fa.flash_attention, fa.flash_attention_stats, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, qz.int4_matmul, qz.dequant_int4, rk.rms_norm):
        fn.launches = 0
    normalization.rms_chain_on_cuda = 0
    sharding.sharded_rms_norm.calls = 0
    collectives.reset_counts()


def check_tp_world_one(device) -> dict:
    """A world of one on the card: the tiny DiT sharded over a (1, 1) mesh
    (`shard_transformer`) gives the unsharded step's velocity bit for bit,
    and runs no collective."""
    from ltx_tpu_torch.parallel import collectives, runtime, sharding

    cfg = TransformerConfig().tiny()
    config = GenerationConfig(width=256, height=128, num_frames=9)
    whole = seeded_module_(LTXTransformer(cfg, device="meta"), device, seed=3)
    inputs = tp_step_inputs(cfg, config, device)
    want = tp_step_velocity(whole, config, inputs)
    sharding.shard_transformer(whole, runtime.make_mesh(1, 1))
    collectives.reset_counts()
    got = tp_step_velocity(whole, config, inputs)
    if not torch.equal(got, want) or any(collectives.counts.values()):
        raise AssertionError(f"world of one: max diff {(got - want).abs().max().item()}, "
                             f"collectives {collectives.counts}")
    return {"bitwise": True}


# the two-rank phase: the DiT's and the decoder's seeds, the north star
PARALLEL_DIT_SEED = 17
PARALLEL_VAE_SEED = 19
PARALLEL_LATENT_SEED = 23
PARALLEL_CONFIG = GenerationConfig(width=768, height=512, num_frames=25, num_steps=8, seed=0)


# pipeline parallelism: the guided step (CFG, two rows) and the LoRA train
# step of a DiT cut to PP_TRAIN_BLOCKS blocks at full width
PP_GUIDED_CONFIG = dataclasses.replace(PARALLEL_CONFIG, cfg_scale=3.0)
PP_TRAIN_BLOCKS = 4
PP_TRAIN_ROWS = 2
PP_LORA_RANK = 16
PP_TRAIN_SEED = 29


def parallel_spec(device_type: str = "cuda") -> dict:
    """What the two-rank phase runs: the ring cases, the DiT's and the
    decoder's configs (full width and depth) and the north star (guided
    too, for the pipeline's two microbatches)."""
    from ltx_tpu_torch.models.vae import VAEConfig

    return {"device": device_type, "ring_cases": RING_CASES, "tcfg": TransformerConfig(),
            "vcfg": VAEConfig(), "config": PARALLEL_CONFIG, "guided": PP_GUIDED_CONFIG}


def pp_train_model(tcfg: TransformerConfig, device, pp_mesh=None) -> LTXTransformer:
    """The seeded bf16 DiT cut to PP_TRAIN_BLOCKS blocks (this stage's with
    `pp_mesh`), rank-16 LoRA on every block linear, each block's LoRA drawn
    from its own seed (its index in the whole DiT): the same adapters whole
    or split. lora_b is drawn nonzero (a LoRA's init zeroes it, and with it
    lora_a's gradient)."""
    from ltx_tpu_torch.train import lora

    model = seeded_module_(LTXTransformer(dataclasses.replace(tcfg, num_layers=PP_TRAIN_BLOCKS),
                                          device="meta"), device, PARALLEL_DIT_SEED,
                           pp_mesh=pp_mesh)
    first = model.pp_plan.first if model.pp_plan is not None else 0
    for i, block in enumerate(model.blocks):
        gen = torch.Generator(device=device).manual_seed(PP_TRAIN_SEED * 1000 + first + i)
        lora.add_lora(block, gen, rank=PP_LORA_RANK)
        with torch.no_grad():
            for _, linear in lora.lora_targets(block):
                b = torch.randn(linear.lora_b.shape, generator=gen, device=device)
                linear.lora_b.copy_(b * 0.02)
    return model


def pp_train_inputs(tcfg: TransformerConfig, config: GenerationConfig, device,
                    seed: int = PP_TRAIN_SEED):
    """(tokens, context, rope, sigma, noise, bias): PP_TRAIN_ROWS rows of the
    north star's clean tokens, text contexts of 1024 keys left-padded by
    300, the step's draws; all from one seeded generator on `device`."""
    shape = VideoLatentShape.from_pixels(PP_TRAIN_ROWS, config.num_frames, config.height,
                                         config.width, channels=tcfg.in_channels)
    gen = torch.Generator(device=device).manual_seed(seed)
    rows, tokens = PP_TRAIN_ROWS, shape.token_count
    latent = torch.randn(rows, tokens, tcfg.in_channels, generator=gen, device=device)
    context = torch.randn(rows, 1024, tcfg.caption_channels, generator=gen,
                          device=device).bfloat16()
    sigma = torch.sigmoid(torch.randn(rows, generator=gen, device=device))
    noise = torch.randn(rows, tokens, tcfg.in_channels, generator=gen, device=device)
    mask = torch.ones(rows, 1024, dtype=torch.int64, device=device)
    mask[:, :TP_CONTEXT_PAD] = 0
    cos, sin = video_rope(shape.frames, shape.height, shape.width, tcfg.inner_dim,
                          tcfg.num_heads, theta=tcfg.rope_theta, max_pos=tcfg.max_pos)
    rope = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))
    return latent, context, rope, sigma, noise, prepare_additive_mask(mask)


def pp_train_gradients(model, inputs) -> dict:
    """The LoRA train step's forward and backward on `model` (whole, or this
    stage's with its plan; bf16, per-block remat): {"loss", "grad_norm",
    "grads": {name in the whole DiT: f32 host array}}, the gradients reduced
    as the step reduces them (`train.step.step_gradients`) and normed as it
    norms them. The optimizer's update, the same elementwise arithmetic on
    every rank, is left out."""
    from ltx_tpu_torch.train import step as tstep

    tc = TrainConfig(lora_only=True, remat=True, compute_dtype=torch.bfloat16)
    trainable, _, _ = init_train_state(model, tc)
    tokens, context, rope, sigma, noise, bias = inputs
    loss, _ = flow_match_loss(model, tokens, context, rope, sigma, noise, context_bias=bias,
                              remat=tc.remat, compute_dtype=tc.compute_dtype)
    grads = tstep.step_gradients(model, trainable, loss)
    norm = tstep.sharded_global_norm(model)(grads)
    first = model.pp_plan.first if model.pp_plan is not None else 0

    def whole(name):
        _, i, rest = name.split(".", 2)
        return f"blocks.{int(i) + first}.{rest}"

    return {"loss": float(loss.detach()), "grad_norm": float(norm),
            "grads": {whole(n): g.float().cpu().numpy() for n, g in grads.items()}}


def parallel_decode_inputs(spec: dict, device):
    """(decoder, latent): the VAE decoder (bf16) seeded submodule by
    submodule and the north star's latent, the same on every process."""
    from ltx_tpu_torch.models.vae import VideoDecoder

    decoder = seeded_module_(VideoDecoder(spec["vcfg"], device="meta", dtype=torch.bfloat16),
                             device, PARALLEL_VAE_SEED)
    config = spec["config"]
    shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height, config.width,
                                         channels=decoder.cfg.latent_channels)
    gen = torch.Generator(device=device).manual_seed(PARALLEL_LATENT_SEED)
    return decoder, torch.randn(shape.shape, generator=gen, device=device).bfloat16()


def _digest(t) -> str:
    """A hash of a tensor's or an array's bytes: equal digests, equal bits."""
    import hashlib

    if torch.is_tensor(t):
        t = t.detach().cpu().contiguous()
        t = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return hashlib.sha1(np.ascontiguousarray(t).tobytes()).hexdigest()


def parallel_rank(rank: int, spec: dict) -> dict:
    """One rank of a gloo world (chip_smoke's phase 7, through
    `parallel.spawn.run_world`): ring attention over RING_CASES, one TP
    denoise step of the seeded full-size DiT in bf16 and quantized to int4
    on its shards, the sharded decode of the north star's latent, and the
    pipeline-parallel steps (`pp_rank`)."""
    import torch.distributed as dist

    from ltx_tpu_torch.models.vae import decode_video_sharded
    from ltx_tpu_torch.parallel import runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    world = dist.get_world_size()
    device = (torch.device("cuda", torch.cuda.current_device()) if spec["device"] == "cuda"
              else torch.device("cpu"))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda d: None)
    mesh = runtime.make_mesh(1, world)
    out = {"rank": rank, "backend": dist.get_backend(), "device": str(device),
           "device_mesh": type(mesh.device_mesh).__name__}
    # (a) ring attention, forward and backward
    out["ring"] = []
    for case in spec["ring_cases"]:
        res = check_ring(case, mesh, device, judge=rank == 0)
        res["digest"] = [_digest(res.pop("out"))] + [_digest(g) for g in res.pop("grads")]
        out["ring"].append(res)
    # (b) one TP denoise step of the full-width, full-depth bf16 DiT
    tcfg, config = spec["tcfg"], spec["config"]
    t0 = time.perf_counter()
    model = seeded_module_(LTXTransformer(tcfg, device="meta"), device, PARALLEL_DIT_SEED, mesh)
    sync(device)
    out["build_seconds"] = time.perf_counter() - t0
    out["dit_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    inputs = tp_step_inputs(tcfg, config, device)
    for tag in ("bf16", "int4"):
        if tag == "int4":  # (c) the same step on the shards quantized to int4
            quantize_transformer(model, bits=4, group_size=64)
        reset_tp_counts()
        sync(device)
        t0 = time.perf_counter()
        vel = tp_step_velocity(model, config, inputs)
        out[tag] = {"velocity": vel.numpy(), "counts": tp_counts(),
                    "shared_card_seconds": time.perf_counter() - t0}
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    del model, inputs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # (d) the sharded decode of the north star's latent
    decoder, latent = parallel_decode_inputs(spec, device)
    with torch.inference_mode():
        frames = decode_video_sharded(decoder, latent, mesh, timestep=None, tile_overlap=1)
    out["frames_digest"] = _digest(frames)
    out["frames"] = frames if rank == 0 else None
    del decoder, latent, frames
    out.update(pp_rank(spec, device, sync))
    return out


def pp_rank(spec: dict, device, sync) -> dict:
    """Pipeline parallelism on a (1, world) mesh: (e) this stage's blocks of
    the seeded full-size DiT drawn alone, one denoise step of one row (one
    microbatch), the guided step (two rows, two microbatches), the int4
    step on the stage's blocks quantized in place; (f) the LoRA train
    step's forward and backward of the DiT cut to PP_TRAIN_BLOCKS blocks,
    two rows, two microbatches."""
    import torch.distributed as dist

    from ltx_tpu_torch.parallel import runtime

    pp_mesh = runtime.make_pp_mesh(1, dist.get_world_size())
    tcfg, out = spec["tcfg"], {}
    t0 = time.perf_counter()
    model = seeded_module_(LTXTransformer(tcfg, device="meta"), device, PARALLEL_DIT_SEED,
                           pp_mesh=pp_mesh)
    sync(device)
    out["pp_stage"] = (model.pp_plan.first, len(model.blocks), time.perf_counter() - t0)
    steps = (("pp_bf16", spec["config"], 1), ("pp_guided", spec["guided"], 2),
             ("pp_int4", spec["config"], 1))
    for tag, config, rows in steps:
        if tag == "pp_int4":
            quantize_transformer(model, bits=4, group_size=64)
        inputs = tp_step_inputs(tcfg, config, device, rows=rows)
        reset_tp_counts()
        sync(device)
        t0 = time.perf_counter()
        vel = tp_step_velocity(model, config, inputs)
        out[tag] = {"velocity": vel.numpy(), "counts": tp_counts(),
                    "shared_card_seconds": time.perf_counter() - t0}
    del model, inputs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    model = pp_train_model(tcfg, device, pp_mesh)
    inputs = pp_train_inputs(tcfg, spec["config"], device)
    reset_tp_counts()
    sync(device)
    t0 = time.perf_counter()
    res = pp_train_gradients(model, inputs)
    out["pp_train"] = {**res, "counts": tp_counts(),
                       "shared_card_seconds": time.perf_counter() - t0}
    if device.type == "cuda":
        out["pp_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return out

