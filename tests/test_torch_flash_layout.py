"""The forward flash kernel's layout rule (kernels/flash_attention.py::
kernel_strides) on the CPU: which (B, H, T, D) views its TMA loads take,
the strides it hands the kernel, and the message of each refusal. The
kernel itself runs on the card only (tests/test_torch_cuda.py); the rule is
plain Python over shapes, strides and addresses."""

import pytest
import torch

from ltx_tpu_torch.kernels import flash_attention as fa


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,strides", [
    (lambda: _bf16(2, 4, 40, 128), (4 * 40 * 128, 40 * 128, 128)),
    # the DiT's view of its (B, T, H * D) projections
    (lambda: _bf16(2, 40, 4, 128).transpose(1, 2), (40 * 4 * 128, 128, 4 * 128)),
    (lambda: _bf16(1, 1536, 32, 64).transpose(1, 2), (1536 * 32 * 64, 64, 32 * 64)),
    # a run of rows out of a longer buffer: the base moves by whole rows
    (lambda: _bf16(1, 2, 50, 16)[:, :, 3:20], (2 * 17 * 16, 50 * 16, 16)),
    # size-1 dims are never stepped over: the contiguous stride stands in
    (lambda: _bf16(7, 1, 1, 32).as_strided((1, 1, 1, 32), (3, 5, 7, 1)), (32, 32, 32)),
], ids=["contiguous", "dit_view", "dit_view_d64", "row_slice", "size_one_dims"])
def test_accepted_views(make, strides):
    t = make()
    assert fa.kernel_strides("q", t) == strides


@pytest.mark.parametrize("make,message", [
    (lambda: _bf16(4, 40, 128), "must be a 4-D"),
    (lambda: _bf16(1, 2, 32, 16).transpose(2, 3), "last dim must be contiguous"),
    (lambda: _bf16(2, 2, 5, 16, 2)[..., 0], "last dim must be contiguous"),
    # rows 17 elements (34 bytes) apart
    (lambda: _bf16(400).as_strided((1, 2, 5, 16), (170, 85, 17, 1)), "multiple of 16 bytes"),
    # heads 72 bytes apart
    (lambda: _bf16(2, 5, 2 * 16 + 4)[:, :, :32].unflatten(2, (2, 16)).transpose(1, 2),
     "multiple of 16 bytes"),
    (lambda: _bf16(4 * 64 + 1)[1:].view(1, 1, 4, 64), "16-byte aligned"),
], ids=["three_dims", "transposed_last", "strided_last", "odd_rows", "padded_heads",
        "unaligned_base"])
def test_rejected_views_say_why(make, message):
    with pytest.raises(ValueError, match=message) as err:
        fa.kernel_strides("k", make())
    assert "k" in str(err.value).split(":")[1]


def test_strided_views_take_the_plain_version_on_the_cpu():
    """On the CPU a strided view goes to the plain version and gives the
    values of its contiguous copy."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, t, 2, 32, generator=gen).transpose(1, 2) for t in (9, 7, 7))
    bias = torch.zeros(1, 7)
    bias[:, :2] = -10000.0
    got = fa.flash_attention(q, k, v, bias)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), bias)
    assert torch.equal(got, want)
