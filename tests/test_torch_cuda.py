"""The port on an NVIDIA GPU: the hand kernels against their plain versions,
and the tiny pipeline on CUDA against the same pipeline on the CPU.

Marked `cuda`; each test skips when no CUDA device is present (decided in
the fixture, never at import). Imports no jax, so it runs on a machine with
only torch (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

The cases and tolerances are ltx_tpu_torch.checks', which chip_smoke.py
runs too: attention element by element within 2**-8 * (P @ |V|) plus two
bf16 ulps of the plain output; the P hand-off of the forward (bf16(q k^T) v) within 2**-8 * (|S| @ |V|)
plus two bf16 ulps; the softmax statistics within 2**-14 (m) and
2**-12 (l) relative; the backward's dQ, dK, dV element by element (the bf16
rounding of P and dS, checks' docstring), exactly 0 on -1e30 masked keys,
in the layouts of q, k and v, and bitwise equal from run to run (one
standing failure: the statistics output at BWD_CASES' many_heads_masked,
checks.STANDING_MISSES); the int4
product within one bf16 ulp plus 2**-12 * (|X| @ |W|);
dequant_int4 and quantize_weight on the card bit for bit; the tiny
pipeline's frames within 2e-2; the tiny LoRA train within 5e-2 relative,
in bf16 and with a float32 compute dtype;
rms_norm within 16 f32 ulps of the plain version's f32 value plus, for a
bf16 output, half a bf16 ulp; the tiny two-stage I2V pipeline, its norms
through that kernel, within 2e-2.
"""

import pytest
import torch
import torch.nn.functional as F

from ltx_tpu_torch import checks
from ltx_tpu_torch.kernels import flash_attention as fa
from ltx_tpu_torch.kernels import quantization as qz
from ltx_tpu_torch.kernels import rms_norm as rk
from ltx_tpu_torch.ops import normalization

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", checks.ATTN_CASES, ids=lambda c: c.name)
def test_flash_kernel_matches_plain(device, case):
    before = fa.flash_attention.launches
    checks.check_attention(case, device)
    assert fa.flash_attention.launches == before + 1


def test_flash_kernel_p_handoff(device):
    """The S accumulators of the first wgmma, rounded to bf16, as the
    register operand of the P V product, with no softmax between."""
    assert checks.check_pv_handoff(device)["tol_share"] <= 1.0


def test_flash_kernel_writes_in_q_layout_and_takes_many_heads(device):
    """A (B, H, T, D) view of a (B, T, H, D) buffer gives an output of the
    same layout (the DiT's transpose back is a view); batch * heads past
    65535 (one block a query tile per head) launches."""
    gen = torch.Generator(device=device).manual_seed(3)
    q, k, v = (torch.randn(1, t, 4, 64, generator=gen, device=device).bfloat16()
               .transpose(1, 2) for t in (130, 70, 70))
    out = fa.flash_attention(q, k, v)
    assert out.stride() == q.stride()
    want = fa.flash_attention_reference(q, k, v)
    assert (out.float() - want.float()).abs().max() <= 2e-2
    q = torch.randn(70000, 1, 3, 16, generator=gen, device=device).bfloat16()
    out = fa.flash_attention(q, q, q)
    assert (out.float() - fa.flash_attention_reference(q, q, q).float()).abs().max() <= 2e-2


def test_flash_kernel_rejects_what_it_does_not_take(device):
    q = torch.randn(1, 2, 8, 32, device=device)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q, q, q)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(qb.transpose(2, 3), qb, qb)
    q48 = torch.randn(1, 2, 8, 48, device=device).bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q48, q48, q48)


@pytest.mark.parametrize("case", checks.BWD_CASES, ids=lambda c: c.name)
def test_flash_stats_and_backward_kernels_match_plain(device, case):
    before = (fa.flash_attention_stats.launches, fa.flash_attention.launches)
    checks.check_stats(case, device)
    assert (fa.flash_attention_stats.launches, fa.flash_attention.launches) == (
        before[0] + 1, before[1])
    res = checks.check_backward(case, device)
    assert (res["dq_launches"], res["dkv_launches"]) == (1, 1)


@pytest.mark.parametrize("name", checks.DETERMINISM_CASES)
def test_flash_backward_is_bitwise_deterministic(device, name):
    """No atomics: two runs of the dq and dkv kernels give equal dQ, dK and
    dV, bit for bit (check_backward also holds each gradient to its input's
    layout)."""
    case = next(c for c in checks.BWD_CASES if c.name == name)
    assert not any(checks.check_backward_deterministic(case, device).values())


def test_flash_backward_rejects_what_it_does_not_take(device):
    case = checks.BackwardCase("reject", 1, 2, 40, 40, 32)
    q, k, v, do, bias, o, lse = checks.backward_inputs(case, device)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_attention_backward(q, k, v, bias, o, lse, do.float())
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dq(q, k, v, None, do, lse[:, :, :8], lse, 0.1)
    delta = torch.zeros_like(lse)
    with pytest.raises(ValueError, match="dO's last dim"):
        fa.flash_attention_bwd_dkv(q, k, v, None, do.transpose(2, 3).contiguous()
                                   .transpose(2, 3), lse, delta, 0.1)


def test_tiny_lora_train_cuda_matches_cpu(device):
    checks.check_tiny_train(device)


def test_tiny_lora_train_f32_runs_on_the_card(device):
    """A float32 compute dtype on the card: the attention kernels get bf16
    casts (ops.attention), held to the bf16 run's tolerance against the
    CPU's float32 run."""
    res = checks.check_tiny_train(device, torch.float32)
    assert res["launches"]["flash_attention_stats"] > 0


@pytest.mark.parametrize("case", checks.INT4_CASES, ids=lambda c: c.name)
def test_int4_route_matches_plain(device, case):
    res = checks.check_int4(case, device)
    big = case.m >= qz.BIG_M_DEQUANT_THRESHOLD
    assert (res["int4_matmul_launches"], res["dequant_int4_launches"]) == (
        (0, 1) if big else (1, 0))


def test_dequant_kernel_is_exact(device):
    for shape in checks.DEQUANT_SHAPES:
        assert checks.check_dequant(device, shape)["mismatches"] == 0
    assert checks.check_dequant(device, (512, 264), group=32)["mismatches"] == 0


def test_quantize_on_the_card_matches_the_cpu(device):
    assert not any(checks.check_quantize_on_device(device).values())


def test_int4_kernels_reject_what_they_do_not_take(device):
    case = checks.Int4Case("reject", 64, 512, 256)
    x, qp = checks.int4_inputs(case, device)
    args = (qp["w_q4"], qp["scale"], qp["bias"])
    with pytest.raises(ValueError, match="bfloat16"):
        qz.int4_matmul(x.float(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        qz.int4_matmul(x.t().contiguous().t(), *args)
    with pytest.raises(ValueError, match="scale is"):
        qz.int4_matmul(x, qp["w_q4"], qp["scale"].bfloat16(), qp["bias"])
    with pytest.raises(ValueError, match="K % 256"):
        small = checks.int4_weights(128, 256, 64, device)
        qz.int4_matmul(x[:, :128].contiguous(), small["w_q4"], small["scale"], small["bias"])
    with pytest.raises(ValueError, match="do not match"):
        qz.dequant_int4(qp["w_q4"], qp["scale"][:3], qp["bias"][:3])


def test_bf16_linear_rounds_once(device):
    """F.linear in bf16 adds the bias in f32 before its one rounding (the
    reference's linear); a bf16 matmul then a bf16 add would round twice."""
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(512, 1024, generator=gen, device=device).bfloat16()
    w = (torch.randn(768, 1024, generator=gen, device=device) * 0.03).bfloat16()
    b = torch.randn(768, generator=gen, device=device).bfloat16()
    exact = (x.float() @ w.float().t() + b.float()).bfloat16()
    mismatch = (F.linear(x, w, b) != exact).float().mean().item()
    assert mismatch < 0.01, mismatch


def test_tiny_pipeline_cuda_matches_cpu(device):
    checks.check_tiny_pipeline(device)


@pytest.mark.parametrize("case", checks.RMS_CASES, ids=lambda c: c.name)
def test_rms_norm_kernel_matches_plain(device, case):
    res = checks.check_rms(case, device)
    assert res["tol_share"] <= 1.0


def test_rms_norm_dispatch_and_what_the_kernel_does_not_take(device):
    """With the kernel selected a CUDA tensor on the 128 rule launches it
    (3-D and non-contiguous inputs too); other shapes and the default keep
    the plain chain; a tensor that requires grad raises; float16 raises."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(4, 37, 512, generator=gen, device=device).bfloat16()
    w = torch.randn(256, generator=gen, device=device).bfloat16()
    strided = x[:, :, ::2]
    before = rk.rms_norm.launches
    assert normalization.rms_norm(x).shape == x.shape
    assert rk.rms_norm.launches == before  # the default is the plain chain
    normalization.set_rms_impl("cuda")
    try:
        got = normalization.rms_norm(strided, w)
        assert rk.rms_norm.launches == before + 1
        want = rk.rms_norm_reference(strided, w)
        assert (got.float() - want.float()).abs().max() <= checks.bf16_ulp(want).max()
        odd = torch.ones(3, 100, device=device)
        assert torch.equal(normalization.rms_norm(odd), rk.rms_norm_reference(odd))
        assert rk.rms_norm.launches == before + 1
        with pytest.raises(RuntimeError, match="inference only"):
            normalization.rms_norm(x.float().requires_grad_(True))
        with torch.no_grad():
            normalization.rms_norm(x.float().requires_grad_(True))
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            normalization.rms_norm(x.half())
    finally:
        normalization.set_rms_impl("torch")
    with pytest.raises(ValueError, match="multiple of 128"):
        rk.rms_norm(torch.ones(3, 100, device=device))
    assert rk.rms_norm(torch.empty(0, 128, device=device)).shape == (0, 128)


def test_tiny_two_stage_cuda_matches_cpu(device):
    res = checks.check_tiny_two_stage(device)
    assert res["launches"]["rms_norm"] > 0
    assert normalization.get_rms_impl() == "torch"
