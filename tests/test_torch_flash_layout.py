"""The flash kernels' layout rule (kernels/flash_attention.py::
kernel_strides, and backward_strides for the backward's q, k, v and dO) on
the CPU: which (B, H, T, D) views their TMA loads take, the strides handed
to the kernels, and the message of each refusal; and that the
differentiable route hands the DiT's views through uncopied. The kernels
themselves run on the card only (tests/test_torch_cuda.py); the rule is
plain Python over shapes, strides and addresses."""

import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

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


# ---------------------------------------------------------------------------
# The backward kernels' layout rule (kernels/flash_attention.py::
# backward_strides) and the differentiable route's hand-over of views.
# ---------------------------------------------------------------------------


def _dit_views(b=2, tq=40, tk=24, h=4, d=64, dtype=torch.bfloat16):
    """q, k, v and dO as the DiT hands them over: (B, H, T, D) views of
    (B, T, H * D) buffers."""
    return tuple(torch.zeros(b, t, h * d, dtype=dtype).unflatten(2, (h, d)).transpose(1, 2)
                 for t in (tq, tk, tk, tq))


def test_backward_rule_takes_the_dits_views():
    q, k, v, do = _dit_views()
    assert fa.backward_strides(q, k, v, do) == [
        (40 * 256, 64, 256), (24 * 256, 64, 256), (24 * 256, 64, 256), (40 * 256, 64, 256)]
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    assert fa.backward_strides(qc, kc, vc, doc)[3] == (4 * 40 * 64, 40 * 64, 64)


@pytest.mark.parametrize("which,make,message", [
    ("dO", lambda do: do.transpose(2, 3).contiguous().transpose(2, 3),
     "last dim must be contiguous"),
    ("dO", lambda do: do[..., :1].expand(do.shape), "last dim must be contiguous"),
    ("dO", lambda do: do[:, :, :1].expand(do.shape), "broadcast"),
    ("dO", lambda do: do[:, :, :-1], "shape"),
    ("dO", lambda do: do.float(), "bfloat16"),
    ("k", lambda k: torch.zeros(2, 24, 4, 64 + 4, dtype=torch.bfloat16)[..., :64].transpose(1, 2),
     "multiple of 16 bytes"),
    ("v", lambda v: torch.zeros(2 * 4 * 24 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 4, 24, 64),
     "16-byte aligned"),
], ids=["do_transposed_last", "do_expanded_last", "do_broadcast_rows", "do_shape", "do_dtype",
        "k_padded_rows", "v_unaligned"])
def test_backward_rule_refuses_what_tma_cannot_take(which, make, message):
    args = dict(zip(("q", "k", "v", "dO"), _dit_views()))
    args[which] = make(args[which])
    with pytest.raises(ValueError, match=message) as err:
        fa.backward_strides(*args.values())
    assert which in str(err.value)


@pytest.mark.parametrize("masked", [False, True], ids=["no_bias", "key_bias"])
def test_vjp_gradients_on_views_equal_contiguous_copies(masked):
    """flash_attention_vjp on the DiT's strided views gives the values and
    gradients of the same call on contiguous copies (f32, the plain
    versions on the CPU; both sides run the same f32 products, on other
    strides)."""
    gen = torch.Generator().manual_seed(5)
    b, tq, tk, h, d = 2, 11, 7, 3, 16
    bufs = [torch.randn(b, t, h * d, generator=gen).requires_grad_(True) for t in (tq, tk, tk)]
    views = [t.unflatten(2, (h, d)).transpose(1, 2) for t in bufs]
    copies = [t.detach().contiguous().requires_grad_(True) for t in views]
    bias = None
    if masked:
        bias = torch.zeros(b, 1, 1, tk)
        bias[0, ..., :2] = -10000.0
    grad_out = torch.randn(b, tq, h * d, generator=gen)
    out_v = fa.flash_attention_vjp(*views, bias)
    out_c = fa.flash_attention_vjp(*copies, bias)
    torch.testing.assert_close(out_v, out_c, rtol=1e-6, atol=1e-6)
    out_v.transpose(1, 2).flatten(2).backward(grad_out)
    out_c.transpose(1, 2).flatten(2).backward(grad_out)
    for buf, copy in zip(bufs, copies):
        torch.testing.assert_close(buf.grad, copy.grad.transpose(1, 2).flatten(2),
                                   rtol=1e-5, atol=1e-6)


def test_sdpa_hands_the_views_through_uncopied(monkeypatch):
    """ops.attention.sdpa's differentiable route passes the DiT's q, k and v
    views to flash_attention_vjp as they are, and _FlashAttentionFn's
    backward passes the incoming gradient, a transposed view of (B, Tq, H,
    D), to flash_attention_backward as it is."""
    from ltx_tpu_torch.ops import attention

    seen = {}
    real_vjp, real_bwd = attention.flash_attention_vjp, fa.flash_attention_backward

    def vjp(q, k, v, bias=None, scale=None):
        seen["fwd"] = (q, k, v)
        return real_vjp(q, k, v, bias=bias, scale=scale)

    def bwd(q, k, v, bias, o, lse, do, scale=None):
        seen["bwd"] = (q, k, v, do)
        return real_bwd(q, k, v, bias, o, lse, do, scale)

    monkeypatch.setattr(attention, "flash_attention_vjp", vjp)
    monkeypatch.setattr(fa, "flash_attention_backward", bwd)
    gen = torch.Generator().manual_seed(2)
    b, t, h, d = 1, 9, 2, 16
    buf = torch.randn(b, t, 3 * h * d, generator=gen).requires_grad_(True)
    q, k, v = (x.unflatten(2, (h, d)).transpose(1, 2) for x in buf.chunk(3, dim=-1))
    out = attention.sdpa(q, k, v)
    for got, want in zip(seen["fwd"], (q, k, v)):
        assert got is want
    out.transpose(1, 2).reshape(b, t, h * d).backward(torch.randn(b, t, h * d, generator=gen))
    saved_q, _, _, do = seen["bwd"]
    assert saved_q.data_ptr() == q.data_ptr() and saved_q.stride() == q.stride()
    assert do.stride() == (t * h * d, d, h * d, 1)
    assert buf.grad is not None and torch.isfinite(buf.grad).all()
