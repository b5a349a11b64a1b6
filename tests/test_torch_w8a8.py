"""Port parity: W8A8 (ltx_tpu_torch.kernels.quantization's int8 format and
product against ltx_tpu.kernels.quantization) on the same numpy inputs.

Tolerances:
* requant_int8_channel (from a raw f32 or bf16 weight, an int4 and an int8
  leaf) against the reference's numpy twin, quantize_act_int8, the
  int8_matmul forward, linear_many against per-leaf linear_any (both
  packages): bitwise. Both divide in f32 by a tensor (IEEE), round half to
  even, sum the int8 products exactly in int32 and rescale by one f32
  product (sx * sw) and one rounding.
* the straight-through backward against jax.vjp of int8_matmul: f32 g
  1e-6 relative (exact bf16 x int8 products, f32 sums in another order);
  bf16 g 2**-8 relative (one bf16 rounding of sums taken in another
  order).
* linear_any on a W8A8 leaf with a LoRA side path and a bias, forward and
  the gradients of x and the three LoRA leaves against jax.vjp of the
  reference's linear_any: 2**-7 relative (the int4 route's tolerance).
* the tiny DiT with every block linear W8A8 (the size gate lowered on both
  sides, as the reference's own test does): the port's quantize_transformer
  gives the reference's tree bit for bit; its velocity against
  dit_forward on that tree 5e-2 relative (test_torch_dit's bf16
  tolerance); the tree through the port's module and back is the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.kernels import quantization as jq
from ltx_tpu_torch import convert
from ltx_tpu_torch.kernels import quantization as tq
from ltx_tpu_torch.models import dit as tdit
from ltx_tpu_torch.models.common import W8A8Linear
from test_torch_dit import CFG, _jax_forward, _params, _port_forward
from torch_parity import assert_rel
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def _t(a):
    """numpy / jax array -> torch on the CPU (bf16 kept as bf16)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def _weight(k, n, seed, dtype=np.float32):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * k**-0.5
    w[:, 3] = 0.0  # a zero channel: its scale is 1
    return np.asarray(jnp.asarray(w, dtype))


def _x(shape, seed, dtype=jnp.bfloat16):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0  # a zero row: its scale is 1
    return np.asarray(jnp.asarray(x, dtype))


def _w8a8_leaf(k, n, seed, bias=True):
    p = jq._requant_int8_channel_np_numpy(_weight(k, n, seed))
    if bias:
        p["b"] = np.asarray(jnp.asarray(np.random.default_rng(seed + 1).standard_normal(n)
                                        .astype(np.float32) * 0.1, jnp.bfloat16))
    return p


def _source(kind):
    if kind == "f32":
        return _weight(256, 128, 1)
    if kind == "bf16":
        return _weight(512, 384, 2, jnp.bfloat16)
    bits, group = (4, 32) if kind == "int4" else (8, 64)
    return {k: np.asarray(v) for k, v in
            jq.quantize_weight(jnp.asarray(_weight(256, 192, 3)), bits, group).items()}


@pytest.mark.parametrize("kind", ["f32", "bf16", "int4", "int8"])
def test_requant_int8_channel_bitwise(kind):
    src = _source(kind)
    want = jq._requant_int8_channel_np_numpy(src)
    got = tq.requant_int8_channel({k: _t(v) for k, v in src.items()} if isinstance(src, dict)
                                  else _t(src))
    assert got["w8"].dtype == torch.int8 and got["sw"].dtype == torch.float32
    assert got["w8"].t().is_contiguous()  # stored column-major for the card's product
    np.testing.assert_array_equal(got["w8"].numpy(), want["w8"])
    np.testing.assert_array_equal(got["sw"].numpy(), want["sw"])


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_quantize_act_int8_bitwise(dtype):
    x = _x((2, 7, 256), 4, dtype)
    want8, want_s = jq.quantize_act_int8(jnp.asarray(x))
    got8, got_s = tq.quantize_act_int8(_t(x))
    assert got8.dtype == torch.int8 and got_s.shape == (2, 7, 1)
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_int8_matmul_forward_bitwise(dtype):
    p = _w8a8_leaf(256, 192, 5, bias=False)
    x = _x((3, 5, 256), 6, dtype)
    want = jq.int8_matmul({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tq.int8_matmul(tq.requant_int8_channel(_t(_weight(256, 192, 5))), _t(x))
    assert got.dtype == _t(x).dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_linear_many_shares_one_quantization_bitwise():
    """All W8A8: the port's linear_many equals its per-leaf linear_any and
    the reference's linear_many; a mix with an int4 leaf runs per leaf."""
    ps = [_w8a8_leaf(256, n, 7 + n, bias=n != 64) for n in (128, 64, 64)]
    x = _x((2, 4, 256), 8)
    tps = [{k: _t(v) for k, v in p.items()} for p in ps]
    got = tq.linear_many(tps, _t(x))
    want = jq.linear_many([{k: jnp.asarray(v) for k, v in p.items()} for p in ps],
                          jnp.asarray(x))
    for g, single, w in zip(got, (tq.linear_any(p, _t(x)) for p in tps), want):
        np.testing.assert_array_equal(_np(g), _np(single))
        np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))
    q4 = {k: _t(v) for k, v in jq.quantize_weight(jnp.asarray(_weight(256, 64, 9)), 4,
                                                  64).items()}
    mixed = tq.linear_many([tps[0], q4], _t(x))
    np.testing.assert_array_equal(_np(mixed[1]), _np(tq.linear_any(q4, _t(x))))


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-6), (jnp.bfloat16, 2**-8)])
def test_int8_ste_backward(dtype, tol):
    p = _w8a8_leaf(256, 192, 10, bias=False)
    x = _x((3, 5, 256), 11, dtype)
    g = _x((3, 5, 192), 12, dtype)
    _, vjp = jax.vjp(lambda xx: jq.int8_matmul({k: jnp.asarray(v) for k, v in p.items()}, xx),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    w8 = tq.w8_layout(torch.from_numpy(p["w8"]))
    tq.int8_matmul({"w8": w8, "sw": torch.from_numpy(p["sw"])}, xt).backward(_t(g))
    assert xt.grad.dtype == xt.dtype
    assert_rel(xt.grad, want, tol, f"int8 STE backward {jnp.dtype(dtype).name}")


def test_linear_any_w8a8_with_lora():
    rng = np.random.default_rng(13)
    p = _w8a8_leaf(256, 128, 13)
    p.update(lora_a=(rng.standard_normal((256, 4)) * 0.1).astype(np.float32),
             lora_b=(rng.standard_normal((4, 128)) * 0.1).astype(np.float32),
             lora_s=np.float32(0.5))
    x = _x((2, 6, 256), 14)
    g = _x((2, 6, 128), 15)
    train = ("lora_a", "lora_b", "lora_s")

    def ref(xx, *lora):
        return jq.linear_any({**{k: jnp.asarray(v) for k, v in p.items()},
                              **dict(zip(train, lora))}, xx)

    want, vjp = jax.vjp(ref, jnp.asarray(x), *(jnp.asarray(p[k]) for k in train))
    want_grads = vjp(jnp.asarray(g))
    leaves = {k: _t(v) for k, v in p.items()}
    for k in train:
        leaves[k].requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    got = tq.linear_any(leaves, xt)
    got.backward(_t(g))
    assert_rel(got, want, 2**-7, "linear_any W8A8 + LoRA, out")
    for name, t, w in zip(("x",) + train, [xt] + [leaves[k] for k in train], want_grads):
        assert_rel(t.grad, w, 2**-7, f"linear_any W8A8 + LoRA, d{name}")


@pytest.fixture(scope="module")
def w8a8_trees():
    """The tiny DiT's bf16 tree and the reference's W8A8 tree of it, every
    block linear quantized (the size gate lowered)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jq, "_MIN_QUANT_SIZE", 1)
    try:
        tree = _params(jnp.bfloat16)
        qtree = jq.quantize_transformer_params(jax.tree.map(jnp.asarray, tree), 8, w8a8=True)
    finally:
        mp.undo()
    return tree, jax.tree.map(np.asarray, qtree)


def test_quantize_transformer_w8a8_equals_reference_tree(w8a8_trees, monkeypatch):
    tree, qtree = w8a8_trees
    monkeypatch.setattr(tdit, "_MIN_QUANT_SIZE", 1)
    model = tdit.quantize_transformer(convert.transformer(tree, CFG), 8, w8a8=True)
    assert sum(isinstance(m, W8A8Linear) for m in model.modules()) == 10 * CFG.num_layers
    got = convert.transformer_tree(model)
    flat_got = jax.tree_util.tree_leaves_with_path(jax.tree.map(_np, got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else a,
                     qtree)))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(leaf, flat_want[path], err_msg=str(path))


def test_dit_forward_w8a8(w8a8_trees):
    """The reference's W8A8 tree through the port's modules (convert) and
    back (transformer_tree, transformer_from_tree), and its velocity."""
    _, qtree = w8a8_trees
    model = convert.transformer(qtree, CFG)
    back = convert.transformer_tree(model)
    again = convert.transformer_from_tree(back, CFG)
    for (name, a), (_, b) in zip(model.named_parameters(), again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert all(m.w8.t().is_contiguous() for m in again.modules() if isinstance(m, W8A8Linear))
    assert_rel(_port_forward(qtree, torch.bfloat16), _jax_forward(qtree, jnp.bfloat16),
               5e-2, "dit_forward W8A8 bf16")


def test_lora_fusion_refuses_a_w8a8_linear(w8a8_trees):
    """A LoRA is fused before W8A8 quantization (load_pipeline's order);
    fusing into a W8A8 linear raises instead of skipping it."""
    from ltx_tpu_torch.lora.fuse import LoRALayer, fuse_lora

    _, qtree = w8a8_trees
    model = convert.transformer(qtree, CFG)
    d = CFG.inner_dim
    layer = LoRALayer("transformer_blocks.0.attn1.to_q", torch.zeros(2, d), torch.zeros(d, 2),
                      alpha=2.0)
    with pytest.raises(TypeError, match="W8A8"):
        fuse_lora(model, [layer])
