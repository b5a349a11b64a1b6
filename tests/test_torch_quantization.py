"""Port parity: weight-only quantization (ltx_tpu_torch.kernels.quantization
against ltx_tpu.kernels.quantization) on the same numpy inputs.

Tolerances:
* quantize_weight (bits 4 and 8), pack_int4 / unpack_int4 and
  dequantize_weight: bitwise. Both divide in f32 and round half to even,
  and both round q * scale and then + bias separately in f32.
* dequant_int4_reference against the Pallas dequant_int4_pallas in
  interpret mode: XLA contracts the interpreted kernel's q * scale + bias
  into one fused multiply-add (one rounding instead of two), so it equals
  an f64 emulation of the FMA bit for bit, and the port (like the
  reference's own dequantize_weight, bitwise) differs from it by at most one
  bf16 ulp in a few values (15 of 131072 at this seed).
* int4 products (the port's plain version against the Pallas int4_matmul
  in interpret mode, on the fused and the big-M routes): element by element
  within ulp_bf16(max |out|) + 2**-12 * (|X| @ |W|), the bound the card's
  kernel is held to (ltx_tpu_torch.checks): the same bf16 products summed
  in f32 in another order, then one rounding to bf16 each.
* linear_any, route-matched (the reference's kernel route forced on the
  CPU by patching its `_use_pallas_int4` to the shape rule and its
  `int4_matmul` to interpret mode): the same element bound on the output.
  Unpatched, the reference takes its XLA route (f32 product, f32 bias, one
  rounding) while the port takes the kernel route (bf16 product, then a
  bf16 bias add): the bound plus one bf16 ulp of the product, for the
  extra rounding. qint8 leaves take the XLA route on both sides.
* the int4 straight-through backward against jax.vjp of the reference's
  int4_matmul (interpret mode): the same element bound on g @ dequant(W)^T.
* a LoRA side path on each route, forward and the gradients of x and the
  three LoRA leaves against jax.vjp of linear_any: 2**-7 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.core import config as jconfig
from ltx_tpu.kernels import quantization as jq
from ltx_tpu.models import dit as jdit
from ltx_tpu_torch import checks, convert
from ltx_tpu_torch.config import TransformerConfig
from ltx_tpu_torch.kernels import quantization as tq
from ltx_tpu_torch.models.common import QuantizedLinear
from ltx_tpu_torch.models.dit import LTXTransformer, quantize_transformer
from torch_parity import assert_rel, reference_int4_kernel_route
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def _t(a):
    """numpy / jax array -> torch on the CPU (bf16 kept as bf16)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _weight(k, n, seed=0, dtype=np.float32):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * k**-0.5
    return np.asarray(jnp.asarray(w, dtype))


def _assert_equal_leaves(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key], np.asarray(want[key])
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), key
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=key)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k,n,group,dtype", [
    (256, 256, 64, np.float32), (512, 384, 32, jnp.bfloat16),
    (128, 64, 64, jnp.bfloat16),  # one plane: 256 does not divide K
    (1024, 256, 128, np.float32),
])
def test_quantize_weight_bitwise(bits, k, n, group, dtype):
    w = _weight(k, n, seed=k + n, dtype=dtype)
    want = jq.quantize_weight(jnp.asarray(w), bits, group)
    got = tq.quantize_weight(_t(w), bits, group)
    _assert_equal_leaves(got, want)
    _assert_equal_leaves({"w": tq.dequantize_weight(got)},
                         {"w": jq.dequantize_weight(want, jnp.bfloat16)})


@pytest.mark.parametrize("k", [128, 256, 384, 1024])
def test_pack_unpack_bitwise(k):
    """Block-plane packing; K=128 and K=384 are single planes."""
    q8 = np.random.default_rng(k).integers(0, 16, (k, 96), dtype=np.uint8)
    packed = tq.pack_int4(torch.from_numpy(q8))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(q8))))
    np.testing.assert_array_equal(tq.unpack_int4(packed, torch.uint8).numpy(), q8)
    np.testing.assert_array_equal(
        tq.unpack_int4(packed).numpy(), np.asarray(jq.unpack_int4(jnp.asarray(packed.numpy()))))


def test_dequant_reference_against_pallas():
    qp = jq.quantize_weight(jnp.asarray(_weight(512, 256, seed=3)), 4, 64)
    args = [_t(qp[k]) for k in ("w_q4", "scale", "bias")]
    pallas = np.asarray(jq.dequant_int4_pallas(qp["w_q4"], qp["scale"], qp["bias"],
                                               interpret=True), np.float32)
    got = tq.dequant_int4_reference(*args)
    assert got.dtype == torch.bfloat16 and got.shape == (512, 256)
    got = got.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.dequantize_weight(qp), np.float32))
    # the interpreter's FMA: q * scale + bias exact in f64, rounded to f32 once
    q = tq.unpack_int4(args[0]).double().reshape(8, 64, 256)
    fma = (q * args[1].double()[:, None] + args[2].double()[:, None]).reshape(512, 256)
    np.testing.assert_array_equal(pallas, fma.float().bfloat16().float().numpy())
    gaps = got != pallas
    ulps = checks.bf16_ulp(torch.from_numpy(np.maximum(np.abs(got), np.abs(pallas)))).numpy()
    print(f"[parity] dequant vs Pallas interpret: {int(gaps.sum())} of {got.size} differ")
    assert int(gaps.sum()) <= got.size // 1000 and (np.abs(got - pallas) <= ulps).all()
    # on the CPU the wrapper is its plain version
    assert torch.equal(tq.dequant_int4(*args).float(), torch.from_numpy(got))


def _assert_within(got, want, tol, what):
    share = float((np.abs(got - want) / tol).max())
    print(f"[parity] {what}: {share:.3f} of the element bound")
    assert share <= 1.0, f"{what}: {share:.3f} of the element bound"


def _int4_bound(x, qp, got, want):
    """checks.int4_tolerance on torch copies of the inputs."""
    args = {k: _t(qp[k]) for k in ("w_q4", "scale", "bias")}
    return checks.int4_tolerance(_t(x), args, torch.from_numpy(got),
                                 torch.from_numpy(want)).numpy()


@pytest.mark.parametrize("m,k,n,group,big", [
    (1, 256, 256, 64, False), (77, 256, 256, 64, False), (130, 512, 256, 32, False),
    (384, 512, 256, 64, True),  # the dequant-then-product route
])
def test_int4_product_matches_pallas(monkeypatch, m, k, n, group, big):
    rng = np.random.default_rng(m + k)
    x = np.asarray(jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16))
    qp = jq.quantize_weight(jnp.asarray(_weight(k, n, seed=m)), 4, group)
    if big:  # both sides take the big-M route at these rows
        monkeypatch.setattr(jq, "BIG_M_DEQUANT_THRESHOLD", 256)
        monkeypatch.setattr(tq, "BIG_M_DEQUANT_THRESHOLD", 256)
    want = np.asarray(jq.int4_matmul(qp, jnp.asarray(x), interpret=True), np.float32)
    args = [_t(qp[key]) for key in ("w_q4", "scale", "bias")]
    got = tq.int4_mm(_t(x), *args)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float().numpy()
    _assert_within(got, want, _int4_bound(x, qp, got, want), f"int4 product {m}x{k}x{n}")
    # the route's own plain version gives the same
    np.testing.assert_array_equal(
        tq.int4_matmul_reference(_t(x), *args).float().numpy(), got)


@pytest.mark.parametrize("fault", ["dropped_k_tile", "swapped_nibbles", "shifted_groups"])
def test_int4_bound_catches_kernel_faults(fault):
    """The element bound the card's kernel is held to rejects the faults a
    tiled int4 kernel could make: one 128-row K tile left out, the two
    nibbles of a byte swapped, each row given its neighbour group's affine."""
    case = checks.Int4Case(fault, 64, 1024, 256)
    x, qp = checks.int4_inputs(case, "cpu")
    want = tq.int4_matmul_reference(x, qp["w_q4"], qp["scale"], qp["bias"])
    w = tq.dequant_int4_reference(qp["w_q4"], qp["scale"], qp["bias"])
    if fault == "dropped_k_tile":
        w[256:384] = 0
    elif fault == "swapped_nibbles":
        swapped = (qp["w_q4"] >> 4) | (qp["w_q4"] << 4)
        w = tq.dequant_int4_reference(swapped, qp["scale"], qp["bias"])
    else:
        w = tq.dequant_int4_reference(qp["w_q4"], qp["scale"].roll(1, 0),
                                      qp["bias"].roll(1, 0))
    got = torch.matmul(x, w)
    share = ((got.float() - want.float()).abs()
             / checks.int4_tolerance(x, qp, got, want)).max().item()
    print(f"[parity] int4 bound against a {fault}: {share:.1f} of the element bound")
    assert share > 1.0


@pytest.fixture
def route_matched(monkeypatch):
    return reference_int4_kernel_route(monkeypatch)


def _linear_case(bits, x_dtype, seed=5):
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 40, 512)), x_dtype))
    b = np.asarray(jnp.asarray(rng.standard_normal(256), x_dtype))
    p = dict(jq.quantize_weight(jnp.asarray(_weight(512, 256, seed=seed)), bits, 64), b=b)
    return x, p, {k: _t(v) for k, v in p.items()}


def _linear_bound(x, p, got, want, extra_rounding):
    w = np.asarray(jq.dequantize_weight(p, jnp.bfloat16), np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    sums = np.abs(xb) @ np.abs(w)
    bound = checks.bf16_ulp(torch.from_numpy(np.maximum(np.abs(got), np.abs(want)))).numpy() \
        + checks.INT4_C * sums
    if extra_rounding:
        bound = bound + checks.bf16_ulp(torch.from_numpy(xb @ w)).numpy()
    return bound


@pytest.mark.parametrize("x_dtype", [jnp.bfloat16, np.float32], ids=["bf16", "f32"])
def test_linear_any_int4_route_matched(route_matched, x_dtype):
    x, jp, tp = _linear_case(4, x_dtype)
    assert tq.use_int4_kernel(tp, _t(x))
    want = np.asarray(jq.linear_any(jax.tree.map(jnp.asarray, jp), jnp.asarray(x)), np.float32)
    assert route_matched == [x.shape]  # the reference took its kernel route
    got = tq.linear_any(tp, _t(x))
    assert got.dtype == _t(x).dtype
    got = got.float().numpy()
    _assert_within(got, want, _linear_bound(x, jp, got, want, False),
                   f"linear_any int4 route-matched {np.dtype(x_dtype).name}")


def test_linear_any_int4_unpatched_xla_route():
    x, jp, tp = _linear_case(4, jnp.bfloat16, seed=6)
    assert not jq._use_pallas_int4(jp, jnp.asarray(x))  # no TPU: the XLA route
    want = np.asarray(jq.linear_any(jax.tree.map(jnp.asarray, jp), jnp.asarray(x)), np.float32)
    got = tq.linear_any(tp, _t(x)).float().numpy()
    _assert_within(got, want, _linear_bound(x, jp, got, want, True),
                   "linear_any int4 vs the XLA route")


def test_linear_any_qint8_and_off_rule_int4():
    """qint8 leaves, and int4 leaves whose N fails the shape rule, take
    dequantize-then-linear with the bias in f32 on both sides."""
    x, jp, tp = _linear_case(8, jnp.bfloat16, seed=7)
    want = np.asarray(jq.linear_any(jax.tree.map(jnp.asarray, jp), jnp.asarray(x)), np.float32)
    got = tq.linear_any(tp, _t(x)).float().numpy()
    _assert_within(got, want, _linear_bound(x, jp, got, want, False), "linear_any qint8")

    rng = np.random.default_rng(8)
    x = np.asarray(jnp.asarray(rng.standard_normal((3, 256)), jnp.bfloat16))
    jp = dict(jq.quantize_weight(jnp.asarray(_weight(256, 96)), 4, 64),
              b=np.asarray(jnp.asarray(rng.standard_normal(96), jnp.bfloat16)))
    tp = {k: _t(v) for k, v in jp.items()}
    assert not tq.use_int4_kernel(tp, _t(x))
    want = np.asarray(jq.linear_any(jax.tree.map(jnp.asarray, jp), jnp.asarray(x)), np.float32)
    got = tq.linear_any(tp, _t(x)).float().numpy()
    _assert_within(got, want, _linear_bound(x, jp, got, want, False), "linear_any int4 off-rule")


# ---------------------------------------------------------------------------
# QuantizedLinear, the DiT walker and the converter
# ---------------------------------------------------------------------------

CFG = TransformerConfig(num_layers=2, num_heads=4, head_dim=64, in_channels=16,
                        out_channels=16, cross_attention_dim=256, caption_channels=48)
JCFG = convert.port_config(CFG, jconfig.TransformerConfig)


@pytest.fixture(scope="module")
def trees():
    """The reference's bf16 DiT tree at 256 wide, and its int4 tree."""
    tree = jax.tree.map(np.asarray, jdit.init_params(jax.random.key(7), JCFG, jnp.bfloat16))
    return tree, jax.tree.map(np.asarray, jq.quantize_transformer_params(tree, 4, 64))


def test_quantize_transformer_matches_reference_tree(trees):
    """The port's walker on the converted bf16 DiT gives the reference's
    quantized tree bit for bit: the same 10 linears a block, the rest kept."""
    tree, qtree = trees
    model = quantize_transformer(convert.transformer(tree, CFG), bits=4, group_size=64)
    quantized = sorted(n for n, m in model.named_modules() if isinstance(m, QuantizedLinear))
    assert len(quantized) == 10 * CFG.num_layers
    assert isinstance(model.caption_projection.linear_1, torch.nn.Module) \
        and not isinstance(model.proj_out, QuantizedLinear)
    want = dict(model.named_parameters())
    for name, p in convert.transformer(qtree, CFG).named_parameters():
        assert p.dtype == want[name].dtype and torch.equal(p, want[name]), name
        assert not p.requires_grad


def test_quantized_convert_roundtrip_and_strictness(trees):
    _, qtree = trees
    model = convert.transformer(qtree, CFG)
    to_q = model.blocks[1].attn1.to_q
    leaf = {k: v[1] for k, v in qtree["blocks"]["attn1"]["to_q"].items()}
    assert isinstance(to_q, QuantizedLinear) and to_q.w_q4.dtype == torch.uint8
    for key in ("w_q4", "scale", "bias", "b"):  # every leaf exactly once, JAX keys
        np.testing.assert_array_equal(getattr(to_q, key).float().numpy(),
                                      leaf[key].astype(np.float32))
    assert sorted(n for n, _ in to_q.named_parameters()) == ["b", "bias", "scale", "w_q4"]

    def edited(edit):
        tree = jax.tree.map(lambda a: a, qtree)
        edit(tree["blocks"]["attn1"]["to_q"])
        return tree

    for edit, match in (
            (lambda d: d.update(extra=d["b"]), "unconsumed leaf"),
            (lambda d: d.pop("bias"), "no leaf"),
            (lambda d: d.pop("scale"), "no scale"),
            (lambda d: d.update(w_q4=d["w_q4"].astype(np.int8)), "dtype"),
            (lambda d: d.update(w_q4=d["w_q4"][:, :64]), "shape")):
        with pytest.raises(ValueError, match=match):
            convert.transformer(edited(edit), CFG)


def test_convert_rejects_w8a8(trees):
    """W8A8 leaves convert into W8A8Linear modules holding them as they are
    (tests/test_torch_w8a8.py holds the numbers); a W8A8 leaf of the wrong
    shape is rejected where the tree is loaded."""
    from ltx_tpu_torch.models.common import W8A8Linear

    tree, _ = trees
    w8a8 = jax.tree.map(np.asarray, jq.quantize_transformer_params(tree, 8, 64, w8a8=True))
    model = convert.transformer(w8a8, CFG)
    linear = model.blocks[1].ff.project_in
    assert isinstance(linear, W8A8Linear)
    np.testing.assert_array_equal(linear.w8.numpy(),
                                  w8a8["blocks"]["ff"]["project_in"]["w8"][1])
    w8a8["blocks"]["ff"]["project_in"]["sw"] = w8a8["blocks"]["ff"]["project_in"]["sw"][:, :8]
    with pytest.raises(ValueError, match="sw"):
        convert.transformer(w8a8, CFG)


def test_quantized_linear_keeps_its_format():
    layer = QuantizedLinear(256, 256, bits=4)
    assert layer.to("cpu") is layer and layer.scale.dtype == torch.float32
    with pytest.raises(TypeError, match="format"):
        layer.to(torch.bfloat16)
    with pytest.raises(TypeError, match="format"):
        torch.nn.Sequential(layer).half()
    from ltx_tpu_torch.models.common import W8A8Linear

    model = quantize_transformer(LTXTransformer(CFG, dtype=torch.float32), 8, w8a8=True)
    w8a8 = [m for m in model.modules() if isinstance(m, W8A8Linear)]
    assert len(w8a8) == 10 * CFG.num_layers and w8a8[0].w8.dtype == torch.int8
    with pytest.raises(TypeError, match="format"):
        w8a8[0].to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Training: the int4 straight-through backward and the LoRA side path
# ---------------------------------------------------------------------------


def test_int4_ste_matches_jax_grad():
    """d/dx of the int4 product: the port's straight-through backward (the
    plain dequant on the CPU, a bf16 product) against jax.vjp of the
    reference's int4_matmul in interpret mode, within one bf16 ulp plus the
    sum-order term of the int4 bound; the codes get no gradient."""
    rng = np.random.default_rng(21)
    x = np.asarray(jnp.asarray(rng.standard_normal((40, 512)), jnp.bfloat16))
    g = np.asarray(jnp.asarray(rng.standard_normal((40, 256)), jnp.bfloat16))
    qp = jq.quantize_weight(jnp.asarray(_weight(512, 256, seed=21)), 4, 64)
    _, vjp = jax.vjp(lambda xx: jq.int4_matmul(qp, xx, interpret=True), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0], np.float32)
    xt = _t(x).requires_grad_(True)
    args = [_t(qp[k]) for k in ("w_q4", "scale", "bias")]
    (got,) = torch.autograd.grad(tq.int4_mm(xt, *args), xt, _t(g))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    w = tq.dequant_int4_reference(*args).float().numpy()
    bound = checks.bf16_ulp(torch.from_numpy(np.maximum(np.abs(got), np.abs(want)))).numpy() \
        + checks.INT4_C * (np.abs(g.astype(np.float32)) @ np.abs(w).T)
    _assert_within(got, want, bound, "int4 STE backward vs jax.vjp")


def _lora_leaf(k, n, seed, r=4):
    rng = np.random.default_rng(seed)
    return {"lora_a": (rng.standard_normal((k, r)) * k**-0.5).astype(np.float32),
            "lora_b": (rng.standard_normal((r, n)) * 0.1).astype(np.float32),
            "lora_s": np.asarray(1.5, np.float32)}


@pytest.mark.parametrize("route", ["int4_kernel", "qint8_xla", "plain"])
def test_linear_any_lora_forward_and_grads(monkeypatch, route):
    """A LoRA side path on the int4 kernel route (the reference's kernel
    route forced on the CPU), the dequantize-then-f32 route (qint8) and a
    plain bf16 Linear module: the output and the gradients of x, lora_a,
    lora_b and lora_s against jax.vjp of the reference's linear_any, bf16
    activations. Tolerance 2**-7 of the largest magnitude (one bf16
    rounding of the output; the f32 LoRA gradients see the same bf16
    cotangent on both sides)."""
    rng = np.random.default_rng(31)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 40, 512)), jnp.bfloat16))
    g = np.asarray(jnp.asarray(rng.standard_normal((2, 40, 256)), jnp.bfloat16))
    b = np.asarray(jnp.asarray(rng.standard_normal(256) * 0.1, jnp.bfloat16))
    w = _weight(512, 256, seed=31, dtype=jnp.bfloat16)
    if route == "plain":
        jp = {"w": w, "b": b}
    else:
        jp = dict(jq.quantize_weight(jnp.asarray(w), 4 if route == "int4_kernel" else 8, 64),
                  b=b)
    if route == "int4_kernel":
        reference_int4_kernel_route(monkeypatch)
    jp.update(_lora_leaf(512, 256, 32))
    names = ("lora_a", "lora_b", "lora_s")
    base = {k: jnp.asarray(v) for k, v in jp.items() if k not in names}

    def ref(xx, a, bb, s):
        return jq.linear_any(dict(base, lora_a=a, lora_b=bb, lora_s=s), xx)

    want, vjp = jax.vjp(ref, jnp.asarray(x), *(jnp.asarray(jp[k]) for k in names))
    want_grads = vjp(jnp.asarray(g))

    leaves = {k: _t(v).requires_grad_(k in names) for k, v in jp.items()}
    xt = _t(x).requires_grad_(True)
    if route == "plain":
        from ltx_tpu_torch.models.common import Linear
        layer = Linear(512, 256, dtype=torch.bfloat16)
        with torch.no_grad():
            layer.weight.copy_(leaves["w"].t())
            layer.bias.copy_(leaves["b"])
        layer.add_lora_params(4)
        for k in names:
            setattr(layer, k, torch.nn.Parameter(leaves[k]))
            leaves[k] = getattr(layer, k)
        got = layer(xt)
    else:
        assert tq.use_int4_kernel(leaves, xt) == (route == "int4_kernel")
        got = tq.linear_any(leaves, xt)
    got_grads = torch.autograd.grad(got, [xt] + [leaves[k] for k in names], _t(g))
    assert got.dtype == torch.bfloat16
    assert_rel(got, want, 2.0**-7, f"linear_any LoRA {route} forward")
    for n, gg, ww in zip(("x",) + names, got_grads, want_grads):
        assert_rel(gg, ww, 2.0**-7, f"linear_any LoRA {route} d{n}")


# ---------------------------------------------------------------------------
# The card kernel's schedule, emulated (csrc/int4_matmul.cu)
# ---------------------------------------------------------------------------


def _dequant_plane_emulation(w_q4, scale, bias, stage, plane):
    """One half-stage of the kernel's dequant: packed byte rows [64 stage,
    64 stage + 64), nibble `plane`, as K rows k0 + 128 plane + r with k0 =
    256 (stage // 2) + 64 (stage % 2); each weight through the kernel's
    `dequant8` arithmetic: fma(2**23 + q, scale, -2**23 scale) (exact in
    f64, one rounding to f32), then + bias in f32, then bf16."""
    codes = w_q4[64 * stage:64 * stage + 64].to(torch.int64)
    q = (codes >> (4 * plane)) & 0xF
    k0 = 256 * (stage // 2) + 64 * (stage % 2) + 128 * plane
    group = w_q4.shape[0] * 2 // scale.shape[0]
    rows = (k0 + torch.arange(64)) // group
    s, b = scale[rows].double(), bias[rows]
    f = (2.0**23 + q).double()
    prod = (f * s + (-2.0**23) * s).float()
    return (prod + b).bfloat16(), k0


def _int4_schedule_emulation(x, w_q4, scale, bias, fault=None):
    """The fused kernel's arithmetic in its order: rows padded to the
    256-row tile with zeros (TMA's fill), 128-column tiles; per stage the low plane's four k steps, then the high plane's, each the
    X box at that plane's K rows; each k step 16 exact products added to
    the f32 accumulator with one rounding; one rounding to bf16; rows past
    M dropped. `fault`: "swapped_boxes" pairs each plane with the other
    plane's X box, "skipped_stage" leaves stage 1 out."""
    m, k = x.shape
    n = w_q4.shape[1]
    assert n % 128 == 0 and k % 256 == 0
    rows = -(-m // 256) * 256
    xp = torch.zeros(rows, k, dtype=torch.bfloat16)
    xp[:m] = x
    acc = torch.zeros(rows, n)
    for stage in range(k // 128):
        if fault == "skipped_stage" and stage == 1:
            continue
        for plane in (0, 1):
            w, k0 = _dequant_plane_emulation(w_q4, scale, bias, stage, plane)
            xk0 = k0 + (128 if plane == 0 else -128) if fault == "swapped_boxes" else k0
            box = xp[:, xk0:xk0 + 64].double()
            for kk in range(4):
                step = box[:, 16 * kk:16 * kk + 16] @ w[16 * kk:16 * kk + 16].double()
                acc = (acc.double() + step).float()
    return acc[:m].bfloat16()


@pytest.mark.parametrize("m,k,n,group", [
    (1, 512, 256, 64), (77, 512, 384, 64), (1000, 256, 256, 64), (77, 768, 384, 96),
    (300, 512, 512, 32)])
def test_int4_kernel_schedule_emulation_within_the_bound(m, k, n, group):
    """The card kernel's schedule (stages of 64 packed rows, each plane's
    X box, k steps of 16, ragged rows past the 256-row tile) within the
    int4 tolerance of int4_matmul_reference; its dequant bit for bit
    dequant_int4_reference (the fma form of q * scale is exact)."""
    case = checks.Int4Case("emulation", m, k, n, group)
    x, qp = checks.int4_inputs(case, "cpu")
    args = (qp["w_q4"], qp["scale"], qp["bias"])
    dense = tq.dequant_int4_reference(*args)
    for stage in range(k // 128):
        for plane in (0, 1):
            w, k0 = _dequant_plane_emulation(*args, stage, plane)
            assert torch.equal(w.view(torch.int16), dense[k0:k0 + 64].view(torch.int16))
    want = tq.int4_matmul_reference(x, *args)
    got = _int4_schedule_emulation(x, *args)
    share = ((got.float() - want.float()).abs()
             / checks.int4_tolerance(x, qp, got, want)).max().item()
    print(f"[parity] int4 kernel schedule {m}x{k}x{n} group {group}: {share:.3f} of the "
          f"element bound")
    assert share <= 1.0


@pytest.mark.parametrize("fault", ["swapped_boxes", "skipped_stage"])
def test_int4_kernel_schedule_faults_break_the_bound(fault):
    """A schedule that paired each plane's weights with the other plane's X
    box, or left a stage out, breaks the int4 element bound."""
    case = checks.Int4Case(fault, 64, 512, 256)
    x, qp = checks.int4_inputs(case, "cpu")
    args = (qp["w_q4"], qp["scale"], qp["bias"])
    want = tq.int4_matmul_reference(x, *args)
    got = _int4_schedule_emulation(x, *args, fault=fault)
    share = ((got.float() - want.float()).abs()
             / checks.int4_tolerance(x, qp, got, want)).max().item()
    print(f"[parity] int4 kernel schedule with {fault}: {share:.1f} of the element bound")
    assert share > 1.0
