"""Port parity: one DiT velocity call (ltx_tpu_torch.models.dit against
ltx_tpu.models.dit.dit_forward) on the tiny config, weights converted from
the reference's own init with their zero tables, zero biases and unit
norms replaced by random values, so that every parameter matters.

Tolerances: float32 5e-5 relative: the timestep sinusoid at sigma * 1000
carries one ulp of exp times ~700 (see test_torch_ops), which the AdaLN
modulation passes on (measured 1.3e-6). bf16: the two frameworks round the
same math at different places (XLA may keep f32 between fused ops), so the
port is held to the reference's own bf16 error against an f32 run of the
same weights (x1.5), and to 5e-2 of the reference's bf16 output.

int4: a 256-wide config (head_dim 64, cross-attention width 256), so that
every block linear passes the kernel route's shape rule; the reference's
tree from quantize_transformer_params, its kernel route forced on the CPU
(torch_parity.reference_int4_kernel_route). The DiT test's bf16 tolerance
applies: 5e-2 of the reference's output."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ltx_tpu.core import config as jconfig
from ltx_tpu.kernels.quantization import quantize_transformer_params
from ltx_tpu.models import dit as jdit
from ltx_tpu.ops import rope as jrope
from ltx_tpu.ops.attention import prepare_additive_mask as j_mask
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import TransformerConfig
from ltx_tpu_torch.ops.attention import prepare_additive_mask
from ltx_tpu_torch.models.common import QuantizedLinear
from torch_parity import as_torch, assert_rel, reference_int4_kernel_route, rel_err
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CFG = TransformerConfig().tiny()
QCFG = dataclasses.replace(CFG, head_dim=64, cross_attention_dim=256)


def randomize(tree, rng, names):
    """numpy copy of a tree with the leaves under `names` redrawn."""
    if isinstance(tree, dict):
        return {k: (randomize(v, rng, names) if isinstance(v, (dict, list))
                    else (rng.uniform(-0.5, 1.5, np.shape(v)).astype(np.asarray(v).dtype)
                          if k in names else np.asarray(v)))
                for k, v in tree.items()}
    return [randomize(v, rng, names) for v in tree]


def _norms_to_random(tree, rng):
    """Also redraw the q/k norm weights ({"w"} under q_norm / k_norm)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("q_norm", "k_norm"):
                w = np.asarray(v["w"])
                out[k] = {"w": rng.uniform(0.5, 1.5, w.shape).astype(w.dtype)}
            elif isinstance(v, (dict, list)):
                out[k] = _norms_to_random(v, rng)
            else:
                out[k] = v
        return out
    return [_norms_to_random(v, rng) for v in tree]


def _jcfg(cfg):
    return convert.port_config(cfg, jconfig.TransformerConfig)


def _params(dtype, cfg=CFG):
    tree = jdit.init_params(jax.random.key(3), _jcfg(cfg), dtype)
    rng = np.random.default_rng(0)
    return _norms_to_random(randomize(tree, rng, {"scale_shift_table", "b"}), rng)


def _inputs(cfg):
    rng = np.random.default_rng(1)
    f, h, w, s = 2, 2, 3, 8
    latent = rng.standard_normal((1, f * h * w, cfg.in_channels))
    context = rng.standard_normal((1, s, cfg.caption_channels))
    # bf16-representable, so that both dtypes see the same values
    latent, context = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                       for x in (latent, context))
    mask = np.ones((1, s), np.int32)
    mask[0, :3] = 0  # left padding, as the tokenizer pads
    rope = jrope.video_rope(f, h, w, cfg.inner_dim, cfg.num_heads)
    return latent, context, mask, np.array([0.7], np.float32), rope


def _jax_forward(tree, dtype, cfg=CFG):
    latent, context, mask, sigma, (cos, sin) = _inputs(cfg)
    return jdit.dit_forward(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(latent, dtype),
        jnp.asarray(context, dtype), jnp.asarray(sigma),
        (jnp.asarray(cos), jnp.asarray(sin)), _jcfg(cfg),
        context_bias=j_mask(jnp.asarray(mask)))


def _port_forward(tree, dtype, cfg=CFG):
    latent, context, mask, sigma, (cos, sin) = _inputs(cfg)
    model = convert.transformer(tree, cfg)
    out = model(as_torch(latent, dtype), as_torch(context, dtype),
                torch.from_numpy(sigma), (torch.from_numpy(cos), torch.from_numpy(sin)),
                context_bias=prepare_additive_mask(torch.from_numpy(mask)))
    assert out.dtype == dtype and out.shape == (1, 12, cfg.out_channels)
    return out


def test_dit_forward_matches_f32():
    tree = _params(jnp.float32)
    assert_rel(_port_forward(tree, torch.float32), _jax_forward(tree, jnp.float32),
               5e-5, "dit_forward float32")


def test_dit_forward_matches_bf16():
    """Both packages in bf16 against the reference in f32 on the same (bf16)
    weights: the port must be as close to it as the reference itself is
    (within 1.5x), and within 5e-2 of the reference's bf16 output."""
    tree = _params(jnp.bfloat16)
    got = _port_forward(tree, torch.bfloat16)
    want = _jax_forward(tree, jnp.bfloat16)
    exact = _jax_forward(jax.tree.map(lambda a: np.asarray(a, np.float32), tree),
                         jnp.float32)
    ref_err = rel_err(want, exact)
    assert_rel(got, exact, 1.5 * ref_err, "dit_forward bf16 vs f32 reference")
    assert_rel(got, want, 5e-2, "dit_forward bf16")


def test_dit_forward_int4_route_matched(monkeypatch):
    """Every block linear int4 on both sides, each through its kernel route
    (the port's plain version here, the reference's Pallas interpreter)."""
    calls = reference_int4_kernel_route(monkeypatch)
    tree = quantize_transformer_params(_params(jnp.bfloat16, QCFG), 4, 64)
    got = _port_forward(tree, torch.bfloat16, QCFG)
    want = _jax_forward(tree, jnp.bfloat16, QCFG)
    assert len(calls) == 10  # one traced block body: attn1, attn2 q/k/v/out, ff
    model = convert.transformer(tree, QCFG)
    assert sum(isinstance(m, QuantizedLinear) for m in model.modules()) == 10 * QCFG.num_layers
    assert_rel(got, want, 5e-2, "dit_forward int4 bf16, route-matched")
