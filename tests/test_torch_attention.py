"""Port parity: the plain flash-attention version and the attention dispatch
of ltx_tpu_torch against the Pallas kernel (in interpret mode) and the XLA
paths of ltx_tpu, on the five cases of tests/test_pallas_kernels.py.

Tolerances: float32 2e-5 relative, as the Pallas contract tests use. bf16:
2**-6 relative against the Pallas kernel, which rounds P relative to the
running max before normalising (the plain version normalises first), and
2**-7 against the XLA path, which rounds where the plain version does.
The card's element-wise tolerance (ltx_tpu_torch.checks) is held here
against the Pallas kernel, whose arithmetic the CUDA kernel follows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.kernels.flash_attention import flash_attention as j_flash
from ltx_tpu.ops.attention import _gqa_sdpa as j_gqa
from ltx_tpu.ops.attention import _xla_sdpa as j_xla
from ltx_tpu_torch import checks
from ltx_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from ltx_tpu_torch.ops.attention import sdpa
from torch_parity import as_torch, assert_rel

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
    (P rounded relative to the running max, tile by tile) against the plain
    version, and a kernel that skipped one K/V tile would break it."""
    case = checks.AttentionCase("pallas", b, h, tq, tk, d, pad=pad)
    q, k, v, bias = checks.attention_inputs(case, "cpu", seed=d)
    jb = None if bias is None else jnp.asarray(bias[:, 0, 0].numpy())
    pallas = j_flash(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
                     bias=jb, block_q=32, block_k=32, interpret=True)
    want = flash_attention_reference(q, k, v, bias)
    tol = checks.attention_tolerance(q, k, v, bias, None, want)
    err = (torch.from_numpy(np.asarray(pallas, np.float32)) - want.float()).abs()
    share = (err / tol).max().item()
    print(f"[parity] pallas bf16 vs plain: {share:.3f} of the card's tolerance")
    assert share <= 1.0
    dropped = torch.zeros(b, 1, 1, tk) if bias is None else bias.clone()
    dropped[..., 32:64] = -1e30
    skipped = flash_attention_reference(q, k, v, dropped)
    assert ((skipped.float() - want.float()).abs() > tol).any()


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
