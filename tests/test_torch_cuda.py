"""The port on an NVIDIA GPU: the hand kernels against their plain versions,
and the tiny pipeline on CUDA against the same pipeline on the CPU.

Marked `cuda`; each test skips when no CUDA device is present (decided in
the fixture, never at import). Imports no jax, so it runs on a machine with
only torch (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

The cases and tolerances are ltx_tpu_torch.checks', which chip_smoke.py
runs too: attention element by element within 2**-8 * (P @ |V|) plus two
bf16 ulps of the plain output; the tiny pipeline's frames within 2e-2.
"""

import pytest
import torch
import torch.nn.functional as F

from ltx_tpu_torch import checks
from ltx_tpu_torch.kernels import flash_attention as fa

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
