"""Port parity: pipeline parallelism (GPipe over the DiTs' blocks) on a gloo
world of 4, the port of tests/test_pp.py.

The port's ranks (`torch_parallel_cases.pp_cases`) split the reference's
4-layer f32 tiny DiT (and dual DiT) into stages with `shard_pp`:

* `dit_forward_pp` with STG masks, a per-block cross-attention scale and a
  key bias at (1, 4) with 4 and 2 microbatches and at (2, 2) with 2 and 1,
  the defaults with a batch-1 bias at (2, 2), and `dit_av_forward_pp` at
  (2, 2) with 2: against the reference's pipeline (its shard_map jitted on
  4 of the conftest's 8 CPU devices), 2e-5 (test_pp.py's bound);
* the gradients of mean(v^2) in every leaf and in the latent through a
  (1, 4) pipeline, 2 microbatches, each block rematerialised; one full
  fine-tune train step of each DiT (loss rtol 1e-5, every updated leaf
  3e-5): each against the reference's sequential function, which
  test_pp.py holds to its pipeline at these bounds;
* the guided video step (CFG + STG) and dual step (CFG) of bf16 DiTs
  against the port's whole step, 2e-2 (test_pp.py's bound), and against
  the reference's sequential step relative to the largest value, the dual
  step 2e-2, the video step 5e-2 (a bf16 DiT row's bound);
* every replicated output bit for bit the same on all four ranks.

The stage-local rule and the reference's three InvalidConfigurationErrors
run in-process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.core import config as jconfig
from ltx_tpu.core.errors import InvalidConfigurationError as JInvalid
from ltx_tpu.models import dit as jdit
from ltx_tpu.models import dit_av as jav
from ltx_tpu.ops.attention import prepare_additive_mask
from ltx_tpu.ops.latents import VideoLatentShape as JShape
from ltx_tpu.parallel import pipeline as jpp
from ltx_tpu.pipeline import denoise as jdn
from ltx_tpu.train import flow_match as jfm
from ltx_tpu.train import step as jstep
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import TransformerConfig
from ltx_tpu_torch.errors import InvalidConfigurationError
from ltx_tpu_torch.ops.latents import VideoLatentShape
from ltx_tpu_torch.parallel import pipeline, runtime
from ltx_tpu_torch.pipeline import denoise
from ltx_tpu_torch.train import step as tstep
import torch_parallel_cases as cases
from torch_dist import run_world
from torch_parity import assert_rel
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CFG = dataclasses.replace(TransformerConfig().tiny(), num_layers=4)
JCFG = convert.port_config(CFG, jconfig.TransformerConfig)
B, T, S_CTX = 4, 6, 8
FORWARD_CASES = ((1, 4, 4), (1, 4, 2), (2, 2, 2), (2, 2, 1))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _tree(av: bool, seed: int, dtype=torch.float32):
    """A parameter tree of the reference's layout, drawn by the port's
    seeded init at the reference's scales (any valid weights do: both sides
    load the same tree; the reference's jitted init of the dual DiT takes
    16 s), its tables and biases redrawn so that every parameter matters; jax arrays."""
    from ltx_tpu_torch.models.common import init_random_
    from ltx_tpu_torch.models.dit import LTXTransformer
    from ltx_tpu_torch.models.dit_av import LTXAVTransformer

    gen = torch.Generator().manual_seed(seed)
    model = init_random_((LTXAVTransformer if av else LTXTransformer)(CFG, "cpu", dtype), gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "scale_shift_table" in name or name.endswith(".bias"):
                p.uniform_(-0.2, 0.2, generator=gen)
    tree = (convert.av_transformer_tree if av else convert.transformer_tree)(model)
    return jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


def _devices4():
    return jax.devices()[:4]


# the reference's programs compile without XLA's backend optimizations (a
# tenth of the compile; the same numbers within its own f32 rounding)
FAST = {"xla_backend_optimization_level": 0}


def _fast(fn, *args):
    """fn(*args), `fn` jitted and compiled FAST."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def _whole(tree, av=False):
    """{name: tensor} of a whole port module built from a reference tree
    (parameters, gradients or updated parameters alike)."""
    model = (convert.av_transformer if av else convert.transformer)(_np_tree(tree), CFG)
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def _inputs():
    """(plan, j): the ranks' inputs (numpy trees and arrays, the draws the
    reference takes from its keys) and the same as jax values."""
    plan, j = {}, {}
    k = jax.random.split(jax.random.key(0), 5)
    j["params"] = params = _tree(False, 0)
    j["latent"] = latent = jax.random.normal(k[1], (B, T, CFG.in_channels), jnp.float32)
    j["context"] = context = jax.random.normal(k[2], (B, S_CTX, CFG.caption_channels),
                                               jnp.float32)
    j["ts"] = ts = jax.random.uniform(k[3], (B,), jnp.float32)
    rng = np.random.default_rng(7)
    shape = (CFG.num_heads, T, CFG.head_dim // 2)
    j["rope"] = rope = (jnp.asarray(np.cos(rng.normal(size=shape)).astype(np.float32)),
                        jnp.asarray(np.sin(rng.normal(size=shape)).astype(np.float32)))
    mask = jnp.asarray(rng.integers(0, 2, size=(B, S_CTX)).astype(np.int32) | 1)
    j["bias"] = bias = prepare_additive_mask(mask)
    j["sa"], j["ff"] = sa, ff = jdit.stg_skip_masks(JCFG, B, (1, 2), (B - 1,), skip_ff_too=True)
    j["cas"] = cas = jnp.asarray(np.linspace(0.8, 1.2, CFG.num_layers), jnp.float32)
    j["bias1"] = bias1 = prepare_additive_mask(jnp.ones((1, S_CTX), jnp.int32))
    plan.update(pp_tree=_np_tree(params), pp_cfg=CFG, pp_cases=FORWARD_CASES,
                pp_x=np.asarray(latent), pp_ctx=np.asarray(context), pp_t=np.asarray(ts),
                pp_rope=tuple(np.asarray(a) for a in rope), pp_bias=np.asarray(bias),
                pp_sa=np.asarray(sa), pp_ff=np.asarray(ff), pp_cas=np.asarray(cas),
                pp_bias1=np.asarray(bias1))

    # the dual DiT: 8 video and 5 audio tokens
    ka = jax.random.split(jax.random.key(3), 6)
    j["avp"] = avp = _tree(True, 3)
    j["ta"] = ta = 5
    j["vlat"] = vlat = jax.random.normal(ka[1], (B, 8, CFG.in_channels), jnp.float32)
    j["alat"] = alat = jax.random.normal(ka[2], (B, ta, CFG.audio_in_channels), jnp.float32)
    j["vctx"] = vctx = jax.random.normal(ka[3], (B, S_CTX, CFG.caption_channels), jnp.float32)
    j["actx"] = actx = jax.random.normal(ka[4], (B, S_CTX, CFG.caption_channels), jnp.float32)
    j["ts_v"] = ts_v = jax.random.uniform(ka[5], (B,), jnp.float32)
    j["ropes"] = ropes = jav.prepare_av_ropes(JCFG, 2, 2, 2, ta)
    j["vbias"] = vbias = prepare_additive_mask(
        jnp.ones((B, S_CTX), jnp.int32).at[1, :3].set(0))
    plan.update(ppav_tree=_np_tree(avp), ppav_v=np.asarray(vlat), ppav_a=np.asarray(alat),
                ppav_vctx=np.asarray(vctx), ppav_actx=np.asarray(actx), ppav_t=np.asarray(ts_v),
                ppav_bias=np.asarray(vbias),
                ppav_ropes=[tuple(np.asarray(x) for x in pair) for pair in ropes])

    # the train steps' draws, as the reference takes them from its keys
    # (Adam's eps 1e-3, as test_torch_av_train.py's: at 1e-8 the first
    # step's update g / (|g| + eps) of a gradient near zero turns on its
    # last bits)
    j["key"] = jax.random.key(5)
    k_sigma, k_noise = jax.random.split(j["key"])
    plan["pp_sigma"] = np.asarray(jfm.sample_sigmas(k_sigma, B, "logit_normal"))
    plan["pp_noise"] = np.asarray(jax.random.normal(k_noise, latent.shape, jnp.float32))
    plan["pp_tc"] = tstep.TrainConfig(learning_rate=1e-3, lora_only=False, remat=True,
                                      eps=1e-3, compute_dtype=torch.float32)
    j["av_key"] = jax.random.key(7)
    k_sv, k_sa, k_nv, k_na = jax.random.split(j["av_key"], 4)
    plan.update(ppav_sigma_v=np.asarray(jfm.sample_sigmas(k_sv, 2, "logit_normal")),
                ppav_sigma_a=np.asarray(jfm.sample_sigmas(k_sa, 2, "logit_normal")),
                ppav_noise_v=np.asarray(jax.random.normal(k_nv, vlat[:2].shape, jnp.float32)),
                ppav_noise_a=np.asarray(jax.random.normal(k_na, alat[:2].shape, jnp.float32)),
                ppav_tc=tstep.TrainConfig(learning_rate=1e-3, eps=1e-3,
                                          compute_dtype=torch.float32))

    # the guided steps, on bf16 DiTs (the steps run them on bf16 tokens)
    j["dn_params"], j["dnav_params"] = _tree(False, 1, torch.bfloat16), _tree(True, 4,
                                                                               torch.bfloat16)
    j["g"] = g = dict(use_cfg=True, cfg_scale=4.0, guidance_rescale=0.7, stg_scale=0.5,
                      stg_blocks=(1,), ge_gamma=0.0, cross_attention_scale=1.1)
    j["gav"] = gav = dict(g, guidance_rescale=0.3, stg_scale=0.0, stg_blocks=(),
                          cross_attention_scale=1.0)
    j["jshape"] = jshape = JShape(1, CFG.in_channels, 2, 4, 4)
    pos = jax.random.normal(jax.random.key(11), (1, 16, CFG.caption_channels), jnp.float32)
    neg = jax.random.normal(jax.random.key(12), (1, 16, CFG.caption_channels), jnp.float32)
    ones = jnp.ones((1, 16), jnp.int32)
    j["dctx"], j["dbias"] = dctx, dbias = jdn.build_guidance_context(
        jdn.GuidanceSpec(**g), pos, ones, neg, ones)
    j["dlat"] = dlat = np.asarray(jax.random.normal(jax.random.key(13), jshape.shape))
    j["av_ctx"] = av_ctx = jnp.tile(jax.random.normal(
        jax.random.key(32), (1, 8, CFG.caption_channels), jnp.float32), (2, 1, 1))
    j["audio"] = audio = np.asarray(jax.random.normal(jax.random.key(34),
                                                      (1, ta, CFG.audio_in_channels)))
    plan.update(dn_tree=_np_tree(j["dn_params"]), dnav_tree=_np_tree(j["dnav_params"]),
                dn_guidance=denoise.GuidanceSpec(**g), dn_shape=VideoLatentShape(*jshape.shape),
                dn_ctx=np.asarray(dctx), dn_bias=np.asarray(dbias), dn_latent=dlat,
                dnav_guidance=denoise.GuidanceSpec(**gav), dnav_frames=ta,
                dnav_ctx=np.asarray(av_ctx), dnav_audio=audio)
    return plan, j


def _reference(j):
    """The reference's outputs: its pipeline forwards (shard_map, jitted on
    4 devices), its sequential gradients, train steps and guided steps
    (test_pp.py holds its pipeline to each of these)."""
    ref = {}
    params, latent, context, ts, rope, bias = (j[k] for k in (
        "params", "latent", "context", "ts", "rope", "bias"))
    for data, pipe, n_mb in FORWARD_CASES:
        mesh = jpp.make_pp_mesh(data, pipe, devices=_devices4())
        fn = (lambda p, x, c, t, m=mesh, n=n_mb: jpp.dit_forward_pp(
            p, x, c, t, rope, JCFG, m, context_bias=bias, skip_self_attn=j["sa"],
            skip_ff=j["ff"], cross_attn_scale=j["cas"], n_microbatches=n, sdpa_impl="xla"))
        ref[f"fwd_{data}x{pipe}_m{n_mb}"] = np.asarray(
            _fast(fn, jpp.shard_pp_params(params, mesh), latent, context, ts))
    mesh = jpp.make_pp_mesh(2, 2, devices=_devices4())
    ref["fwd_defaults"] = np.asarray(_fast(lambda p, x, c, t: jpp.dit_forward_pp(
        p, x, c, t, rope, JCFG, mesh, context_bias=j["bias1"], sdpa_impl="xla"),
        jpp.shard_pp_params(params, mesh), latent, context, ts))
    ref["fwd_av"] = [np.asarray(x) for x in _fast(lambda p: jpp.dit_av_forward_pp(
        p, j["vlat"], j["alat"], j["vctx"], j["actx"], j["ts_v"], j["ts_v"] * 0.9, j["ropes"],
        JCFG, mesh, video_bias=j["vbias"], n_microbatches=2, sdpa_impl="xla"),
        jpp.shard_pp_params(j["avp"], mesh))]

    def loss_seq(p, lat):
        out = jdit.dit_forward(p, lat, context, ts, rope, JCFG, context_bias=bias,
                               sdpa_impl="xla")
        return jnp.mean(out.astype(jnp.float32) ** 2)

    g_params, g_lat = _fast(jax.grad(loss_seq, argnums=(0, 1)), params, latent)
    ref["grad_leaves"], ref["grad_latent"] = _whole(g_params), np.asarray(g_lat)

    # the steps without remat: the same numbers, less to compile
    tc = jstep.TrainConfig(learning_rate=1e-3, lora_only=False, remat=False, eps=1e-3,
                           compute_dtype=jnp.float32, sdpa_impl="xla")
    t_state, f_state, o_state = jstep.init_train_state(params, tc)
    args = (t_state, f_state, o_state, latent, context, rope, j["key"], bias)
    t_state, _, aux = jstep.make_train_step(JCFG, tc, donate=False).lower(*args).compile(
        compiler_options=FAST)(*args)
    ref["step"] = (float(aux["loss"]), float(aux["grad_norm"]))
    ref["step_leaves"] = _whole(jstep.combine_params(t_state, f_state))
    tca = jstep.TrainConfig(learning_rate=1e-3, compute_dtype=jnp.float32, sdpa_impl="xla",
                            remat=False, eps=1e-3)
    t_state, f_state, o_state = jstep.init_train_state(j["avp"], tca)
    args = (t_state, f_state, o_state, j["vlat"][:2], j["alat"][:2], j["vctx"][:2],
            j["actx"][:2], j["ropes"], j["av_key"])
    t_state, _, aux = jstep.make_av_train_step(JCFG, tca, donate=False).lower(*args).compile(
        compiler_options=FAST)(*args)
    ref["av_step"] = (float(aux["loss"]), float(aux["grad_norm"]))
    ref["av_step_leaves"] = _whole(jstep.combine_params(t_state, f_state), av=True)

    g, jshape = j["g"], j["jshape"]
    step = jdn.make_denoise_step(j["dn_params"], JCFG, jdn.GuidanceSpec(**g), jshape, j["dctx"],
                                 j["dbias"], sdpa_impl="xla")
    new, vel = step(jnp.asarray(j["dlat"]), 0.9, 0.5, jnp.zeros(jshape.shape),
                    jnp.asarray(False), jax.random.key(14))
    ref["denoise"] = [np.asarray(new), np.asarray(vel)]
    step = jdn.make_av_denoise_step(j["dnav_params"], JCFG, jdn.GuidanceSpec(**j["gav"]), jshape,
                                    j["ta"], j["av_ctx"], j["av_ctx"] * 0.9, None,
                                    sdpa_impl="xla")
    v, a = step(jnp.asarray(j["dlat"]), jnp.asarray(j["audio"]), 0.9, 0.5, jax.random.key(35))
    ref["denoise_av"] = [np.asarray(v), np.asarray(a)]
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(ranks' results, reference outputs): the gloo world runs while the
    reference computes (the ranks need only the inputs)."""
    from concurrent.futures import ThreadPoolExecutor

    plan, j = _inputs()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_world, cases.pp_cases, 4, tmp_path_factory.mktemp("gloo"), plan)
        ref = _reference(j)
        return ranks.result(), ref


@pytest.fixture(scope="module")
def ranks(world):
    return world[0]


@pytest.fixture(scope="module")
def ref(world):
    return world[1]


def _close(got, want, tol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    print(f"[parity] {what}: max abs {err:.3e} (tol {tol:.0e} abs + rel)")
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def _same_on_ranks(ranks, key):
    for r in ranks[1:]:
        a, b = ranks[0][key], r[key]
        for x, y in zip(a if isinstance(a, (list, tuple)) else [a],
                        b if isinstance(b, (list, tuple)) else [b]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=key)


def _merged(ranks, key):
    """The stage-local leaves of every rank and the whole ones (the same on
    every rank, checked) as one {name: array} of the whole module."""
    out = {}
    for r in ranks:
        for n, a in r[key].items():
            if n in out and not n.startswith("blocks."):
                np.testing.assert_array_equal(out[n], a, err_msg=f"{key} {n}")
            out[n] = a
    return out


@pytest.mark.parametrize("case", [f"fwd_{d}x{p}_m{m}" for d, p, m in FORWARD_CASES]
                         + ["fwd_defaults"])
def test_pp_forward_matches_reference(ranks, ref, case):
    for r in ranks:
        _close(r[case], ref[case], 2e-5, f"dit_forward_pp {case}")
    _same_on_ranks(ranks, case)


def test_pp_hops_and_broadcast_per_forward(ranks):
    """M + S - 2 hops (the reference's last ppermute carries nothing that
    is read), one broadcast of the outputs, one all-gather of the rows over
    a data axis of two, nothing host-staged on CPU tensors."""
    for r in ranks:
        for data, pipe, n_mb in FORWARD_CASES:
            counts = r[f"fwd_{data}x{pipe}_m{n_mb}_counts"]
            assert counts["send_recv"] == n_mb + pipe - 2
            assert counts["broadcast"] == 1 and counts["all_reduce"] == 0
            assert counts["all_gather"] == (data > 1) and counts["host_staged"] == 0
        assert r["fwd_av_counts"]["send_recv"] == 2 and r["fwd_av_counts"]["broadcast"] == 2


def test_pp_av_forward_matches_reference(ranks, ref):
    for r in ranks:
        _close(r["fwd_av"][0], ref["fwd_av"][0], 2e-5, "dit_av_forward_pp video")
        _close(r["fwd_av"][1], ref["fwd_av"][1], 2e-5, "dit_av_forward_pp audio")
    _same_on_ranks(ranks, "fwd_av")


def test_pp_gradients_match_reference(ranks, ref):
    got = _merged(ranks, "grad_leaves")
    assert sorted(got) == sorted(ref["grad_leaves"])
    err = 0.0
    for n, want in ref["grad_leaves"].items():
        np.testing.assert_allclose(got[n], want, atol=3e-5, rtol=3e-5, err_msg=n)
        err = max(err, float(np.abs(got[n] - want).max()))
    print(f"[parity] PP gradients, every leaf: max abs {err:.3e} (tol 3e-5)")
    for r in ranks:
        _close(r["grad_latent"], ref["grad_latent"], 3e-5, "PP gradient of the latent")
    _same_on_ranks(ranks, "grad_latent")


@pytest.mark.parametrize("kind", ["step", "av_step"])
def test_pp_train_step_matches_reference(ranks, ref, kind):
    """One full fine-tune step on a (1, 4) pipeline, 2 microbatches: loss
    and grad norm, every updated leaf."""
    for r in ranks:
        print(f"[parity] PP {kind} loss, grad norm: {r[kind]} against {ref[kind]}")
        np.testing.assert_allclose(r[kind][0], ref[kind][0], rtol=1e-5)
        np.testing.assert_allclose(r[kind][1], ref[kind][1], rtol=1e-5)
    _same_on_ranks(ranks, kind)
    got = _merged(ranks, kind + "_leaves")
    want = ref[kind + "_leaves"]
    assert sorted(got) == sorted(want)
    err = max(float(np.abs(got[n] - want[n]).max()) for n in want)
    print(f"[parity] PP {kind}, every updated leaf: max abs {err:.3e} (tol 3e-5)")
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=3e-5, rtol=3e-5, err_msg=n)


@pytest.mark.parametrize("kind", ["denoise", "denoise_av"])
def test_pp_denoise_step_matches_sequential(ranks, ref, kind):
    """The guided steps of bf16 DiTs on a (1, 4) pipeline against the port's
    own step of the whole DiT, 2e-2 (test_pp.py's bound between the
    reference's pipeline and its sequential step: microbatched and batched
    bf16 products round differently), and against the reference's
    sequential step, relative to the largest value: the dual step's video
    and audio latents 2e-2 (measured 4.7e-3, 4.4e-3), the video step's new
    latent and velocity 5e-2, a bf16 DiT row's bound (test_torch_dit.py;
    measured 1.7e-2 and 2.5e-2 after CFG 4, STG 0.5 and rescale 0.7:
    test_torch_guidance.py's rule for the combined rows would allow
    0.38)."""
    names = ("latent", "velocity") if kind == "denoise" else ("video", "audio")
    bound = 5e-2 if kind == "denoise" else 2e-2
    for r in ranks:
        for got, whole, want, what in zip(r[kind], r[kind + "_whole"], ref[kind], names):
            _close(got, whole, 2e-2, f"PP {kind} {what} vs the whole DiT's step")
            assert_rel(got, want, bound, f"PP {kind} {what} vs the reference's sequential step")
    _same_on_ranks(ranks, kind)


def test_pp_param_specs_match_reference():
    """Every leaf under `blocks` is stage-local ("pipe"), the rest whole."""
    params = _tree(False, 0)
    specs = jpp.pp_param_specs(params)
    model = convert.transformer(_np_tree(params), CFG)
    flags = jax.tree.map(lambda p, s: np.full(np.shape(p), "pipe" in s), params, specs)
    want = {name: "pipe" if bool(np.asarray(leaf).flat[0]) else None
            for name, leaf in convert._leaves(flags, model, "")}
    assert pipeline.pp_param_specs(model) == want
    assert want["blocks.0.attn1.to_q.weight"] == "pipe" and want["patchify_proj.weight"] is None


def test_pp_errors_match_reference():
    """The reference's three InvalidConfigurationErrors, message for
    message: blocks that do not split over the stages, rows that do not
    split over the data axis, local rows that do not split into the
    microbatches."""
    params = _tree(False, 0)
    x = jnp.zeros((4, T, CFG.in_channels))
    c = jnp.zeros((4, S_CTX, CFG.caption_channels))
    t = jnp.zeros((4,))
    rope = (jnp.ones((CFG.num_heads, T, CFG.head_dim // 2)),) * 2
    cases_ = [((1, 8), dict(), None), ((2, 2), dict(), 3), ((1, 2), dict(n_microbatches=3), 4)]
    for (data, pipe), kw, rows in cases_:
        jmesh = jpp.make_pp_mesh(data, pipe)
        with pytest.raises(JInvalid) as want:
            jpp.dit_forward_pp(params, x[:rows or 4], c[:rows or 4], t[:rows or 4], rope, JCFG,
                               jmesh, **kw)
        model = convert.transformer(_np_tree(params), CFG)
        mesh = runtime.make_pp_mesh(data, pipe, devices=range(8))
        with pytest.raises(InvalidConfigurationError) as got:
            pipeline.shard_pp(model, mesh)
            model(torch.zeros(rows or 4, T, CFG.in_channels),
                  torch.zeros(rows or 4, S_CTX, CFG.caption_channels), torch.zeros(rows or 4),
                  tuple(torch.ones(CFG.num_heads, T, CFG.head_dim // 2) for _ in range(2)),
                  pp_microbatches=kw.get("n_microbatches"))
        assert str(got.value) == str(want.value)


def test_pp_mesh_must_be_the_plan():
    """A pp_mesh that is not the one the model is split over raises, in
    the denoise steps and the train steps; shard_pp refuses a TP-sharded
    model and a split one."""
    model = convert.transformer(_np_tree(_tree(False, 0)), CFG)
    shape = VideoLatentShape(1, CFG.in_channels, 2, 4, 4)
    g = denoise.GuidanceSpec(use_cfg=False, cfg_scale=1.0, guidance_rescale=0.0, stg_scale=0.0,
                             stg_blocks=(), ge_gamma=0.0, cross_attention_scale=1.0)
    ctx = torch.zeros(1, S_CTX, CFG.caption_channels)
    other = runtime.make_pp_mesh(1, 1)
    with pytest.raises(InvalidConfigurationError, match="pp_mesh"):
        denoise.make_denoise_step(model, g, shape, ctx, None, pp_mesh=other)
    pipeline.shard_pp(model, runtime.make_pp_mesh(1, 1))
    for fn in (lambda: denoise.make_denoise_step(model, g, shape, ctx, None, pp_mesh=other),
               lambda: tstep.make_train_step(model, tstep.TrainConfig(pp_mesh=other))):
        with pytest.raises(InvalidConfigurationError, match="pp_mesh"):
            fn()
    with pytest.raises(InvalidConfigurationError, match="already"):
        pipeline.shard_pp(model, model.pp_plan.mesh)
