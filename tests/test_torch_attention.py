"""Port parity: the plain flash-attention version and the attention dispatch
of ltx_tpu_torch against the Pallas kernel (in interpret mode) and the XLA
paths of ltx_tpu, on the five cases of tests/test_pallas_kernels.py.

Tolerances: float32 2e-5 relative, as the Pallas contract tests use. bf16:
2**-6 relative against the Pallas kernel, which rounds P relative to the
running max before normalising (the plain version normalises first), and
2**-7 against the XLA path, which rounds where the plain version does.
The card's element-wise tolerance (ltx_tpu_torch.checks) is held here
against the Pallas kernel, whose arithmetic the CUDA kernel follows.

Training: the plain statistics forward and backward against the Pallas
stats and backward kernels in interpret mode and against jax.grad of
flash_attention_vjp, float32, within the contract's 5e-5 relative; the
autograd Function against jax.grad and torch's gradcheck in float64; the
card's backward tolerance against the Pallas backward and a bf16 emulation
of the CUDA kernels' rounding."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.kernels.flash_attention import flash_attention as j_flash
from ltx_tpu.ops.attention import _gqa_sdpa as j_gqa
from ltx_tpu.ops.attention import _xla_sdpa as j_xla
from ltx_tpu_torch import checks
from ltx_tpu_torch.kernels.flash_attention import attention_logits as fa_logits
from ltx_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from ltx_tpu_torch.ops.attention import sdpa
from torch_parity import as_torch, assert_rel
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

F32_TOL = 2e-5


def _qkv(seed, b, h, tq, tk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, tq, d)).astype(np.float32),
            rng.standard_normal((b, h, tk, d)).astype(np.float32),
            rng.standard_normal((b, h, tk, d)).astype(np.float32))


def _key_mask(b, tk, pad_from, four_d=False):
    m = np.zeros((b, tk), np.float32)
    m[0, pad_from:] = -1e9
    return m.reshape(b, 1, 1, tk) if four_d else m


# the five cases of tests/test_pallas_kernels.py:31-80:
# (name, b, h, tq, tk, d, bias maker or None, scale, pallas blocks)
CASES = [
    ("no_bias", 2, 3, 32, 32, 16, None, None, (16, 16)),
    ("key_bias", 2, 2, 16, 24, 8, lambda: _key_mask(2, 24, 20), None, (8, 8)),
    ("bias4d_padded_tail", 1, 2, 10, 12, 8,
     lambda: _key_mask(1, 12, 9, four_d=True), None, (8, 8)),
    ("padded_tail_no_bias", 1, 1, 9, 11, 8, None, None, (8, 8)),
    ("scale", 1, 2, 16, 16, 8, None, 0.25, (8, 8)),
]


@pytest.mark.parametrize("name,b,h,tq,tk,d,make_bias,scale,blocks", CASES,
                         ids=[c[0] for c in CASES])
def test_flash_reference_matches_pallas_and_xla_f32(name, b, h, tq, tk, d,
                                                    make_bias, scale, blocks):
    q, k, v = _qkv(len(name), b, h, tq, tk, d)
    bias = make_bias() if make_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    pallas = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jb,
                     scale=scale, block_q=blocks[0], block_k=blocks[1],
                     interpret=True)
    xla_bias = None if jb is None else (jb if jb.ndim == 4 else jb[:, None, None, :])
    xla = j_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=xla_bias,
                scale=scale)
    tb = None if bias is None else torch.from_numpy(bias)
    got = flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), tb, scale)
    assert_rel(got, pallas, F32_TOL, f"flash {name} f32 vs pallas")
    assert_rel(got, xla, F32_TOL, f"flash {name} f32 vs xla")
    # the public wrapper takes the plain version for CPU tensors
    wrapped = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), tb, scale)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_reference_matches_bf16(with_bias):
    q, k, v = _qkv(7, 1, 4, 96, 80, 32)
    bias = _key_mask(1, 80, 61) if with_bias else None
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq_, tk_, tv_ = (as_torch(x, torch.bfloat16) for x in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    pallas = j_flash(jq, jk, jv, bias=jb, block_q=32, block_k=32, interpret=True)
    xla = j_xla(jq, jk, jv, bias=None if jb is None else jb[:, None, None, :])
    got = flash_attention_reference(tq_, tk_, tv_,
                                    None if bias is None else torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    assert_rel(got, pallas, 2.0**-6, f"flash bf16 bias={with_bias} vs pallas")
    assert_rel(got, xla, 2.0**-7, f"flash bf16 bias={with_bias} vs xla")


@pytest.mark.parametrize("b,h,tq,tk,d,pad", [
    (1, 4, 96, 160, 32, None), (2, 2, 80, 130, 64, 20), (1, 2, 64, 96, 128, 7)])
def test_card_tolerance_admits_pallas_and_rejects_a_dropped_tile(b, h, tq, tk, d, pad):
    """checks.attention_tolerance bounds the TPU kernel's bf16 arithmetic
    (P rounded relative to the running max, tile by tile) against the exact
    product, and a kernel that skipped one K/V tile would break it."""
    case = checks.AttentionCase("pallas", b, h, tq, tk, d, pad=pad)
    q, k, v, bias = checks.attention_inputs(case, "cpu", seed=d)
    jb = None if bias is None else jnp.asarray(bias[:, 0, 0].numpy())
    pallas = j_flash(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
                     bias=jb, block_q=32, block_k=32, interpret=True)
    exact, tol = checks.attention_exact_and_tolerance(q, k, v, bias, None)
    err = (torch.from_numpy(np.asarray(pallas, np.float32)) - exact).abs()
    share = (err / tol).max().item()
    print(f"[parity] pallas bf16 vs the exact product: {share:.3f} of the card's tolerance")
    assert share <= 1.0
    dropped = torch.zeros(b, 1, 1, tk) if bias is None else bias.clone()
    dropped[..., 32:64] = -1e30
    skipped = flash_attention_reference(q, k, v, dropped)
    assert ((skipped.float() - exact).abs() > tol).any()


def _kernel_forward_emulation(q, k, v, bias, scale, p_dtype=torch.bfloat16, tile=128):
    """The card kernel's forward numerics on the CPU: f32 logits, per
    128-key tile P = exp(logit - running max) rounded to `p_dtype`, the f32
    accumulator rescaled as the max moves, divided by the f32 row sum of the
    unrounded P, one output rounding."""
    logits = fa_logits(q, k, bias, scale)
    acc = torch.zeros(*logits.shape[:-1], v.shape[-1])
    m = torch.full(logits.shape[:-1], -torch.inf)
    l = torch.zeros(logits.shape[:-1])
    for start in range(0, logits.shape[-1], tile):
        s = logits[..., start:start + tile]
        m_new = torch.maximum(m, s.amax(-1))
        e = torch.exp(s - m_new[..., None])
        keep = torch.exp(m - m_new)
        acc = acc * keep[..., None] + e.to(p_dtype).float() @ v[..., start:start + tile, :].float()
        l = l * keep + e.sum(-1)
        m = m_new
    return (acc / l[..., None]).bfloat16()


@pytest.mark.parametrize("name,heads", [("many_heads_masked", 2), ("dit_self_attn", 2)])
def test_card_tolerance_against_the_kernels_rounding(name, heads):
    """checks.attention_tolerance, around the exact product, against an
    emulation of the card kernel's forward numerics: one bf16 rounding of
    each probability relative to the running max, at most 2**-8 of itself,
    which the bound's 2**-8 * (P @ |V|) covers. The emulation keeps inside
    it at "many_heads_masked" (6 live keys a row, 70000 rows) and at the
    path's self-attention (2 of its 32 heads); P rounded to fp8 (e4m3)
    breaks it at the self-attention, and a kernel that skipped a key breaks
    it at both. The three shares are printed."""
    case = dataclasses.replace(next(c for c in checks.BWD_CASES if c.name == name), h=heads)
    q, k, v, _, bias, _, _ = checks.backward_inputs(case, "cpu")
    scale = case.scale if case.scale is not None else case.d**-0.5
    exact, tol = checks.attention_exact_and_tolerance(q, k, v, bias, case.scale)
    shares = {}
    for label, p_dtype in (("bf16", torch.bfloat16), ("fp8", torch.float8_e4m3fn)):
        got = _kernel_forward_emulation(q, k, v, bias, scale, p_dtype)
        shares[label] = ((got.float() - exact).abs() / tol).max().item()
    dropped = torch.zeros(case.b, 1, 1, case.tk) if bias is None else bias.clone()
    dropped[..., 0] = -1e30
    skipped = flash_attention_reference(q, k, v, dropped, case.scale)
    shares["skipped_key"] = ((skipped.float() - exact).abs() / tol).max().item()
    print(f"[parity] {name}: of the card's tolerance around the exact product, the kernel's "
          f"emulation {shares['bf16']:.3f}, fp8 P {shares['fp8']:.3f}, a skipped key "
          f"{shares['skipped_key']:.3f}")
    assert shares["bf16"] <= 1.0
    if name == "dit_self_attn":
        assert shares["fp8"] > 1.0
    assert shares["skipped_key"] > 1.0


# the plain version against the exact product at every ATTN_CASES and
# BWD_CASES shape whose scores the CPU can afford with one head each
# (heads are independent); the 2304- and 9216-token shapes are left to the card
_AFFORDABLE_SCORES = 8_000_000
_EXACT_CASES = [
    dataclasses.replace(c, h=1) for c in checks.ATTN_CASES + checks.BWD_CASES
    if c.b * c.tq * c.tk <= _AFFORDABLE_SCORES]


@pytest.mark.parametrize("case", _EXACT_CASES,
                         ids=lambda c: f"{type(c).__name__[:3].lower()}_{c.name}")
def test_plain_version_within_the_bound_of_the_exact_product(case):
    """flash_attention_reference (P normalised, then rounded to bf16 once)
    within checks.attention_tolerance of checks.attention_exact: the kernel
    is held to the same bound on the card, so the two are within twice it
    of each other."""
    if isinstance(case, checks.AttentionCase):
        q, k, v, bias = checks.attention_inputs(case, "cpu")
    else:
        q, k, v, _, bias, _, _ = checks.backward_inputs(case, "cpu")
    exact, tol = checks.attention_exact_and_tolerance(q, k, v, bias, case.scale)
    plain = flash_attention_reference(q, k, v, bias, case.scale)
    share = ((plain.float() - exact).abs() / tol).max().item()
    print(f"[parity] plain {case.name}: {share:.3f} of the bound around the exact product")
    assert share <= 1.0
    torch.testing.assert_close(checks.attention_exact(q, k, v, bias, case.scale), exact,
                               rtol=0, atol=0)


def test_checks_take_the_plain_version_some_heads_at_a_time(monkeypatch):
    """The path-shape checks compute the plain version and its tolerance a
    few heads at a time (the 9216-token score matrix would not fit whole):
    the same values as whole, with each row's keys masked at its own count,
    at the head as the tokenizer pads."""
    case = checks.AttentionCase("rows", 3, 5, 40, 24, 32, pad=(7, 0, 11), pad_left=True)
    q, k, v, bias = checks.attention_inputs(case, "cpu")
    assert (bias[0, 0, 0, :7] == -10000).all() and (bias[0, 0, 0, 7:] == 0).all()
    assert (bias[1] == 0).all() and (bias[2, 0, 0, :11] == -10000).all()
    tail = checks.attention_inputs(dataclasses.replace(case, pad=4, pad_left=False), "cpu")[3]
    assert (tail[..., -4:] == -10000).all() and (tail[..., :-4] == 0).all()
    whole = flash_attention_reference(q, k, v, bias)
    exact, tol = checks.attention_exact_and_tolerance(q, k, v, bias, None)
    monkeypatch.setattr(checks, "PLAIN_SCORE_BYTES", 2 * 4 * 3 * 40 * 24)  # two heads
    assert [(s.start, s.stop) for s in checks.head_slices(q, k)] == [(0, 2), (2, 4), (4, 5)]
    assert torch.equal(checks.attention_reference_by_heads(q, k, v, bias, None), whole)
    torch.testing.assert_close(checks.attention_tolerance(q, k, v, bias, None), tol,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(checks.attention_exact(q, k, v, bias, None), exact,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32_TOL), (jnp.bfloat16, 2.0**-7)])
def test_gqa_sdpa_matches(dtype, tol):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 4, 12, 16)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, 2, 12, 16)).astype(np.float32)
    causal = np.where(np.tril(np.ones((12, 12), bool)), 0.0, -1e9).astype(np.float32)
    bias = np.broadcast_to(causal, (2, 1, 12, 12)).copy()
    want = j_gqa(*(jnp.asarray(x, dtype) for x in (q, k, v)), bias=jnp.asarray(bias),
                 scale=0.25)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = sdpa(*(as_torch(x, tdt) for x in (q, k, v)), bias=torch.from_numpy(bias),
               scale=0.25)
    assert_rel(got, want, tol, f"gqa sdpa {jnp.dtype(dtype).name}")


def test_sdpa_equal_heads_goes_to_flash():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 8, 8, 16))
    launches = flash_attention.launches
    out = sdpa(q, k, v, scale=0.3)
    assert torch.equal(out, flash_attention_reference(q, k, v, None, 0.3))
    # CPU tensors take the plain version: no kernel launch is counted
    assert flash_attention.launches == launches


def test_flash_raises_on_full_mask_and_non_cpu_tensor():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 2, 8, 8, 16))
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, torch.zeros(1, 1, 8, 8))
    # a tensor off the CPU never reaches the plain version: it needs the
    # kernel, and a device the kernel does not take raises
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# ---------------------------------------------------------------------------
# Training: the statistics forward (B2), the backward (B3), the VJP
# ---------------------------------------------------------------------------

from ltx_tpu.kernels.flash_attention import _flash_backward as j_flash_backward  # noqa: E402
from ltx_tpu.kernels.flash_attention import flash_attention_vjp as j_flash_vjp  # noqa: E402
from ltx_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_stats,
    flash_attention_vjp,
    softmax_lse,
)

# the backward contract's cases (tests/test_pallas_kernels.py:182-230): name,
# (b, h, tq, tk, d), per-row valid key counts (-1e30 beyond) or None, 4-D bias
BWD_CASES = [
    ("no_bias", (2, 3, 32, 32, 16), None, False),
    ("key_bias", (2, 4, 24, 40, 16), (33, 17), False),
    ("padded_tail", (1, 2, 23, 37, 16), None, False),
    ("bias4d", (2, 2, 16, 48, 16), (40, 40), True),
]


def _bwd_inputs(shape, valid, four_d, seed=0):
    b, h, tq, tk, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = _qkv(seed, b, h, tq, tk, d)
    do = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    bias = None
    if valid is not None:
        bias = np.zeros((b, tk), np.float32)
        for row, n in enumerate(valid):
            bias[row, n:] = -1e30
        if four_d:
            bias = bias[:, None, None, :]
    return q, k, v, do, bias


@pytest.mark.parametrize("name,shape,valid,four_d", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_stats_and_backward_match_pallas_and_jax_grad(name, shape, valid, four_d):
    """f32: the plain statistics forward against the Pallas stats kernel,
    the plain backward against the two Pallas backward kernels (interpret
    mode, 16x16 blocks), within the contract's 5e-5; keys masked with -1e30
    get exactly zero dK, dV. (jax.grad of flash_attention_vjp, which runs
    the same kernels, is held in the next test.)"""
    q, k, v, do, bias = _bwd_inputs(shape, valid, four_d)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jb = None if bias is None else jnp.asarray(bias)
    o_j, m_j, l_j = j_flash(jq, jk, jv, bias=jb, block_q=16, block_k=16, interpret=True,
                            return_stats=True)
    tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tb = None if bias is None else torch.from_numpy(bias)
    o, m, l = flash_attention_stats(tq_, tk_, tv_, tb)
    assert_rel(o, o_j, 5e-5, f"stats {name} out")
    assert_rel(m, m_j, 5e-5, f"stats {name} m")
    assert_rel(l, l_j, 5e-5, f"stats {name} l")

    lse = softmax_lse(m, l)
    key_bias2 = None if jb is None else (jb[:, 0, 0] if jb.ndim == 4 else jb)
    pallas = j_flash_backward(jq, jk, jv, key_bias2, jnp.asarray(o.numpy()),
                              jnp.asarray(lse.numpy()), jdo, shape[4]**-0.5,
                              block_q=16, block_k=16, interpret=True)
    got = flash_attention_backward(tq_, tk_, tv_, tb, o, lse, tdo)
    for g, p, n in zip(got, pallas, ("dq", "dk", "dv")):
        assert_rel(g, p, 5e-5, f"backward {name} {n} vs pallas")
    if valid is not None:
        for row, n in enumerate(valid):
            assert not got[1][row, :, n:].any() and not got[2][row, :, n:].any()


def test_vjp_function_matches_jax_grad_and_routes():
    """The autograd Function (plain versions on the CPU) gives jax.grad's
    gradients through flash_attention_vjp, no gradient to the bias, and
    sdpa routes there only while autograd records."""
    q, k, v, do, bias = _bwd_inputs((2, 2, 20, 28, 32), (21, 9), True, seed=3)
    jb = jnp.asarray(bias)
    want = jax.grad(lambda a, b_, c: jnp.sum(
        j_flash_vjp(a, b_, c, jb, 0.2, 8, 8, True) * jnp.asarray(do)),
        argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_(True)
    out = sdpa(tq_, tk_, tv_, bias=tb, scale=0.2)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (tq_, tk_, tv_, tb), torch.from_numpy(do),
                              allow_unused=True)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert_rel(g, w, 5e-5, f"vjp {n} vs jax.grad")
    assert got[3] is None
    with torch.no_grad():
        assert sdpa(tq_, tk_, tv_, bias=tb, scale=0.2).grad_fn is None


def test_vjp_gradcheck_f64():
    """torch.autograd.gradcheck of the Function in float64 (the plain
    versions keep float64): the backward formulas are the forward's
    derivative, with a key bias and a ragged tail."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, t, 8, generator=gen, dtype=torch.float64,
                           requires_grad=True) for t in (5, 7, 7))
    bias = torch.zeros(1, 7, dtype=torch.float64)
    bias[0, 5:] = -1e30
    assert torch.autograd.gradcheck(lambda a, b_, c: flash_attention_vjp(a, b_, c, bias, 0.4),
                                    (q, k, v))


@pytest.mark.parametrize("case", [
    checks.BackwardCase("cpu_d32_rows", 2, 2, 70, 90, 32, bias=("rows", 80, 33)),
    checks.BackwardCase("cpu_d64_masked", 1, 2, 65, 100, 64, bias=("masked", 70)),
], ids=lambda c: c.name)
def test_card_backward_tolerance_admits_bf16_and_rejects_a_dropped_tile(case):
    """checks.backward_tolerance (the card's bound) admits the Pallas
    backward in interpret mode and an emulation of the CUDA kernels' bf16
    rounding of P and dS, and a backward that skipped one K/V tile breaks
    it."""
    q, k, v, do, bias, o, lse = checks.backward_inputs(case, "cpu")
    want = flash_attention_backward_reference(q, k, v, bias, o, lse, do)
    tols = checks.backward_tolerance(q, k, v, bias, do, lse, None, want)
    jb = None if bias is None else jnp.asarray(bias[:, 0, 0].numpy())
    pallas = j_flash_backward(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
                              jb, jnp.asarray(o.float().numpy(), jnp.bfloat16),
                              jnp.asarray(lse.numpy()),
                              jnp.asarray(do.float().numpy(), jnp.bfloat16), case.d**-0.5,
                              block_q=32, block_k=32, interpret=True)
    scale = case.d**-0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(fa_logits(q, k, bias, scale) - lse[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * o.float()).sum(-1)[..., None]) * scale
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    emulated = ((dsb @ kf).bfloat16(), (dsb.transpose(-1, -2) @ qf).bfloat16(),
                (pb.transpose(-1, -2) @ dof).bfloat16())
    for name, side in (("pallas", [torch.from_numpy(np.asarray(x, np.float32)) for x in pallas]),
                       ("bf16 emulation", emulated)):
        shares = [checks.tolerance_share(g, w, t) for g, w, t in zip(side, want, tols)]
        print(f"[parity] {case.name} {name} vs plain: {[round(s, 3) for s in shares]} "
              "of the card's backward tolerance")
        assert max(shares) <= 1.0
    dropped = torch.zeros(case.b, 1, 1, case.tk) if bias is None else bias.clone()
    dropped[..., 32:64] = -1e30
    skipped = flash_attention_backward_reference(q, k, v, dropped, o, lse, do)
    assert all(((s.float() - w.float()).abs() > t).any()
               for s, w, t in zip(skipped, want, tols))
