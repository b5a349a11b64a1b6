"""Port parity: tensor parallelism of the DiTs and Gemma on a gloo world of 2.

The port's ranks (`torch_parallel_cases.tp_cases`) shard each model over a
(1, 2) mesh; the reference runs the named ltx_tpu function on its params
sharded over a 2-device sub-mesh of the conftest's 8 CPU devices. The
trees are the reference's inits (jitted: any weights do, both sides load
the same), their zero tables, biases and unit norms redrawn so that every
parameter matters. Tolerances, of the reference's largest magnitude: f32
5e-5, bf16 5e-2 (the DiT parity bounds of test_torch_dit.py); greedy
decodes token for token (test_tp_gemma_decode.py). Every output the ranks
hold alike is bit for bit the same on both. The shared helpers and the
other world-of-2 cases are test_torch_parallel.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_tpu.kernels.quantization import (
    quantize_transformer_params,
    requant_int8_channel_np,
    set_tensor_parallel,
)
from ltx_tpu.models import dit as jdit
from ltx_tpu.models import dit_av as jav
from ltx_tpu.models import gemma3 as jg
from ltx_tpu.ops import rope as jrope
from ltx_tpu.parallel import sharding as jsh
from ltx_tpu_torch import convert
from ltx_tpu_torch.errors import InvalidConfigurationError
from ltx_tpu_torch.models import gemma3 as pg
from ltx_tpu_torch.parallel import runtime, sharding
import torch_parallel_cases as cases
from test_torch_parallel import (
    AV_CFG,
    CFG,
    GRID,
    INT4_CFG,
    _jcfg,
    _jit_init,
    _mesh2,
    _np_tree,
    _randomized,
    _same_on_ranks,
    _sharded,
)
from torch_dist import run_world
from torch_parity import assert_rel
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)


@pytest.fixture(scope="module")
def plan_and_ref():
    rng = np.random.default_rng(1)
    mesh = _mesh2()
    plan, ref = {}, {}

    # the video DiT, f32 and bf16, and an int4 one 512 wide
    f, h, wd = GRID
    tokens = f * h * wd
    cos, sin = jrope.video_rope(f, h, wd, CFG.inner_dim, CFG.num_heads)
    plan["dit_rope"] = (np.asarray(cos), np.asarray(sin))
    plan["dit_cfg"] = CFG
    plan["dit_x"] = rng.standard_normal((2, tokens, CFG.in_channels)).astype(np.float32)
    plan["dit_ctx"] = rng.standard_normal((2, 8, CFG.caption_channels)).astype(np.float32)
    plan["dit_t"] = np.asarray([0.3, 0.8], np.float32)
    rope = (jnp.asarray(cos), jnp.asarray(sin))
    for name, dtype in (("dit_f32", jnp.float32), ("dit_bf16", jnp.bfloat16)):
        tree = _randomized(
            _np_tree(_jit_init(jdit.init_params, jax.random.key(3), _jcfg(CFG), dtype)), rng)
        plan[name + "_tree"] = tree
        ref[name] = np.asarray(_sharded(
            jdit.dit_forward, jax.tree.map(jnp.asarray, tree), mesh,
            jnp.asarray(plan["dit_x"], dtype), jnp.asarray(plan["dit_ctx"], dtype),
            jnp.asarray(plan["dit_t"]), rope, _jcfg(CFG)), np.float32)
    qtree = quantize_transformer_params(jax.tree.map(jnp.asarray, _randomized(_np_tree(
        _jit_init(jdit.init_params, jax.random.key(4), _jcfg(INT4_CFG), jnp.bfloat16)), rng)),
        bits=4, group_size=64)
    plan["dit_int4_tree"] = _np_tree(qtree)
    plan["dit_int4_cfg"] = INT4_CFG
    c4, s4 = jrope.video_rope(f, h, wd, INT4_CFG.inner_dim, INT4_CFG.num_heads)
    plan["dit_int4_rope"] = (np.asarray(c4), np.asarray(s4))
    plan["dit_int4_x"] = plan["dit_x"][:1]
    plan["dit_int4_ctx"] = plan["dit_ctx"][:1]

    # the dual DiT (bf16), its TP forward and its sequence-parallel step
    avtree = _randomized(_np_tree(_jit_init(jav.init_params, jax.random.key(5),
                                                  _jcfg(AV_CFG), jnp.bfloat16)), rng)
    plan["av_tree"], plan["av_cfg"] = avtree, AV_CFG
    ta = 5
    ropes = jav.prepare_av_ropes(_jcfg(AV_CFG), f, h, wd, ta, fps=24.0)
    plan["av_ropes"] = [tuple(np.asarray(x) for x in pair) for pair in ropes]
    plan["av_v"] = rng.standard_normal((1, tokens, CFG.in_channels)).astype(np.float32)
    plan["av_a"] = rng.standard_normal((1, ta, CFG.audio_in_channels)).astype(np.float32)
    plan["av_ctx"] = rng.standard_normal((1, 8, CFG.caption_channels)).astype(np.float32)
    plan["av_t"] = np.asarray([0.6], np.float32)
    bf = jnp.bfloat16
    ref["av"] = [np.asarray(x, np.float32) for x in _sharded(
        jav.dit_av_forward, jax.tree.map(jnp.asarray, avtree), mesh,
        jnp.asarray(plan["av_v"], bf), jnp.asarray(plan["av_a"], bf),
        jnp.asarray(plan["av_ctx"], bf), jnp.asarray(plan["av_ctx"], bf),
        jnp.asarray(plan["av_t"]), jnp.asarray(plan["av_t"]), ropes, _jcfg(AV_CFG))]

    # Gemma f32 and W8A8: forwards and greedy decodes
    gcfg_j = jg.Gemma3Config().tiny()
    gparams = _jit_init(jg.init_params, jax.random.key(11), gcfg_j, jnp.float32)
    ql = dict(gparams["layers"])
    for nm in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"):
        wl = np.asarray(gparams["layers"][nm]["w"], np.float32)
        per = [requant_int8_channel_np(wl[i]) for i in range(gcfg_j.hidden_layers)]
        ql[nm] = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *per)
    p8 = {**gparams, "layers": ql}
    plan["g_cfg"] = convert.port_config(gcfg_j, pg.Gemma3Config)
    plan["gemma_tree"], plan["gemma_w8a8_tree"] = _np_tree(gparams), _np_tree(p8)
    plan["g_ids"] = np.arange(1, 9, dtype=np.int64)[None]
    plan["g_mask"] = np.ones((1, 8), np.int64)
    plan["g_prompt"] = np.asarray(([5, 9, 13, 5, 9, 13, 21, 7] * 2)[:12], np.int32)
    ids, mask = jnp.asarray(plan["g_ids"], jnp.int32), jnp.asarray(plan["g_mask"], jnp.int32)
    for name, params in (("gemma", gparams), ("gemma_w8a8", p8)):
        try:
            ref[name] = np.asarray(jg.forward_hidden_states(
                jsh.shard_gemma_params(params, mesh), ids, mask, gcfg_j))
        finally:
            set_tensor_parallel(False)
    try:
        gsh = jsh.shard_gemma_params(gparams, mesh)
        kw = dict(temperature=0.0, stop_tokens=(), mesh=mesh)
        ref["decode"] = jg.generate_tokens(gsh, plan["g_prompt"], gcfg_j, jax.random.key(0),
                                           max_new_tokens=16, **kw)
        ref["decode_w8a8"] = jg.generate_tokens(
            jsh.shard_gemma_params(p8, mesh), plan["g_prompt"], gcfg_j, jax.random.key(0),
            max_new_tokens=12, **kw)
    finally:
        set_tensor_parallel(False)
    return plan, ref


@pytest.fixture(scope="module")
def ranks(plan_and_ref, tmp_path_factory):
    return run_world(cases.tp_cases, 2, tmp_path_factory.mktemp("gloo"), plan_and_ref[0])


@pytest.fixture(scope="module")
def ref(plan_and_ref):
    return plan_and_ref[1]


def test_tp_dit_matches_reference(ranks, ref):
    for r in ranks:
        assert_rel(r["dit_f32"], ref["dit_f32"], 5e-5, "TP-2 DiT f32")
        assert_rel(r["dit_bf16"], ref["dit_bf16"], 5e-2, "TP-2 DiT bf16")
        # 3 row-parallel sums and 4 flat QK norms a block
        counts, norms = r["dit_f32_counts"]
        assert counts["all_reduce"] == 7 * CFG.num_layers and norms == 4 * CFG.num_layers
    _same_on_ranks(ranks, "dit_f32")
    _same_on_ranks(ranks, "dit_bf16")


def test_tp_int4_dit_matches_reference(ranks):
    """The TP-2 int4 DiT (the dequantize route on each shard) against the
    port's unsharded int4 DiT (its kernel route's plain version, held to
    the reference's int4 DiT in test_torch_dit.py)."""
    for r in ranks:
        assert_rel(r["dit_int4"], r["dit_int4_whole"], 5e-2, "TP-2 int4 DiT")
        # half of the 512 input rows, packed two a byte
        assert r["dit_int4_shards"] == (128, INT4_CFG.inner_dim)
    _same_on_ranks(ranks, "dit_int4")


def test_tp_dual_dit_matches_reference(ranks, ref):
    for r in ranks:
        assert_rel(r["av"][0], ref["av"][0], 5e-2, "TP-2 dual DiT video")
        assert_rel(r["av"][1], ref["av"][1], 5e-2, "TP-2 dual DiT audio")
    _same_on_ranks(ranks, "av")


def test_tp_gemma_matches_reference(ranks, ref):
    for r in ranks:
        assert_rel(r["gemma"], ref["gemma"], 5e-5, "TP-2 Gemma f32")
        assert_rel(r["gemma_w8a8"], ref["gemma_w8a8"], 5e-5, "TP-2 Gemma W8A8")
        assert r["kv_heads_local"] == 1
    _same_on_ranks(ranks, "gemma")
    _same_on_ranks(ranks, "gemma_w8a8")


def test_tp_greedy_decode_matches_reference(ranks, ref):
    """Greedy TP decodes token for token: plain and W8A8 against the
    reference's TP decode; speculative and batched against the plain one
    (the reference's own contract: greedy speculation and a batched row
    are the sequential greedy sequence)."""
    for r in ranks:
        for key in ("decode", "decode_w8a8"):
            assert r[key] == ref[key], key
        assert r["decode_spec"] == r["decode"]
        assert r["decode_batched"][0] == r["decode"][:8]
        assert r["decode_batched"][1] == r["decode_short"]
    assert len(ranks[0]["decode"]) == 16
    for key in ("decode", "decode_spec", "decode_batched", "decode_w8a8"):
        assert ranks[0][key] == ranks[1][key]


def test_int4_row_shard_must_hold_whole_planes(plan_and_ref):
    """A row shard of int4 codes that would split a packing plane raises."""
    model = convert.transformer(plan_and_ref[0]["dit_int4_tree"], INT4_CFG)
    mesh = runtime.Mesh(np.arange(4).reshape(1, 4))
    with pytest.raises(InvalidConfigurationError, match="packing plane"):
        sharding.shard_transformer(model, mesh)


def test_tp_decode_refuses_an_unsharded_model():
    model = pg.Gemma3Model(pg.Gemma3Config().tiny(), device="cpu")
    with pytest.raises(InvalidConfigurationError, match="shard the model"):
        pg.generate_tokens(model, [1, 2, 3], max_new_tokens=2, mesh=runtime.make_mesh(1, 1))
