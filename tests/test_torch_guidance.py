"""Port parity: guidance rows, STG skips, conditioning and the denoise step
(ltx_tpu_torch.pipeline.denoise and models.dit against ltx_tpu's) on the
tiny DiT, the same numpy inputs and jax.random draws on both sides.

Tolerances. The step's own arithmetic (row layout, CFG, rescale, STG,
guidance extrapolation, per-token timesteps, the re-noise, Euler on the
generated frames only) is held exactly: both packages run it around the SAME
stand-in for the DiT, an elementwise function of every argument the step
hands over, in f32: 1e-5 relative. With the real bf16 DiT a row's velocity
carries the DiT's bf16 tolerance (5e-2 of its largest value, test_torch_dit)
and the combine weighs the rows with s(1 + t) (cond), -(s - 1)(1 + t)
(uncond) and -t (perturbed) for CFG s and STG t; the rows' differences are
independent roundings, so the combined velocity is held to 5e-2 times the
root of the sum of those weights' squares (10 at CFG 4 + STG 1; measured
8.7e-2, that is 1.7 x 5e-2), the Euler-stepped latent to the same times
sigma - sigma_next."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.core import config as jconfig
from ltx_tpu.models import dit as jdit
from ltx_tpu.ops.latents import VideoLatentShape as JShape
from ltx_tpu.pipeline import denoise as jdenoise
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import GenerationConfig, TransformerConfig
from ltx_tpu_torch.models.dit import stg_skip_masks
from ltx_tpu_torch.ops.latents import VideoLatentShape
from ltx_tpu_torch.pipeline import denoise
from test_torch_dit import _params
from torch_parity import as_np, as_torch, assert_rel, rel_err
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CFG = TransformerConfig().tiny()
JCFG = convert.port_config(CFG, jconfig.TransformerConfig)
DIT_BF16_TOL = 5e-2
# one guided bf16 step against the reference, relative to the reference's
# largest value: (velocity, latent), about twice what was measured (8.7e-2,
# 7.2e-2, 4.5e-2 on the velocity; 4.5e-2, 3.3e-2, 2.5e-2 on the latent). The
# combine multiplies each row's bf16 error by its guidance weights, so the
# limits sit above DIT_BF16_TOL; the exact combine is held at 1e-5 by
# test_step_arithmetic_is_the_references.
# Each row's velocity std over the reference's: 4.2e-3 measured; a dropped
# rescale moves it by 2.1e-2 or more
GUIDED_STD_TOL = 1e-2
GUIDED_STEP_TOL = {"b1_g3": (1.75e-1, 9e-2), "b2_g3": (1.5e-1, 7e-2), "i2v_g3": (9e-2, 5e-2)}
GRID = (3, 2, 2)   # latent frames, height, width: 12 tokens
S = 8              # text tokens


def _spec(**kw):
    base = dict(cfg_scale=1.0)
    base.update(kw)
    cfg = GenerationConfig(**base)
    jcfg = convert.port_config(cfg, jconfig.GenerationConfig)
    return (denoise.GuidanceSpec.from_config(cfg), jdenoise.GuidanceSpec.from_config(jcfg))


def _text(b, rng):
    pos = rng.standard_normal((b, S, CFG.caption_channels)).astype(np.float32)
    neg = rng.standard_normal((b, S, CFG.caption_channels)).astype(np.float32)
    pos_m = np.ones((b, S), np.int32)
    neg_m = np.ones((b, S), np.int32)
    for i in range(b):
        pos_m[i, :1 + i] = 0
        neg_m[i, :3 + i] = 0
    return pos, pos_m, neg, neg_m


@pytest.mark.parametrize("kw,rows", [
    (dict(), 1), (dict(cfg_scale=3.0), 2), (dict(stg_scale=1.0), 2),
    (dict(cfg_scale=3.0, stg_scale=0.5), 3)], ids=["g1", "cfg", "stg", "cfg_stg"])
def test_guidance_context_layout(kw, rows):
    """[neg?, pos, pos?] tiled for one prompt, B-major for two; the use_cfg
    override stage 2 needs."""
    g, jg = _spec(**kw)
    assert g.num_rows == jg.num_rows == rows and g.use_stg == jg.use_stg
    rng = np.random.default_rng(0)
    for b, build, jbuild in ((1, denoise.build_guidance_context,
                              jdenoise.build_guidance_context),
                             (2, denoise.build_guidance_context_batched,
                              jdenoise.build_guidance_context_batched)):
        pos, pos_m, neg, neg_m = _text(b, rng)
        want_c, want_b = jbuild(jg, jnp.asarray(pos), jnp.asarray(pos_m),
                                jnp.asarray(neg), jnp.asarray(neg_m))
        got_c, got_b = build(g, torch.from_numpy(pos), torch.from_numpy(pos_m),
                             torch.from_numpy(neg), torch.from_numpy(neg_m))
        np.testing.assert_array_equal(as_np(got_c), np.asarray(want_c))
        np.testing.assert_array_equal(as_np(got_b), np.asarray(want_b))
        assert got_c.shape == (b * rows, S, CFG.caption_channels)
    cfg = GenerationConfig(cfg_scale=4.0, stg_scale=1.0)
    g2 = denoise.GuidanceSpec.from_config(cfg, use_cfg=False)
    assert not g2.use_cfg and g2.num_rows == 2 and g2.cfg_scale == 4.0
    if g.use_cfg:
        with pytest.raises(ValueError, match="negative-prompt"):
            denoise.build_guidance_context(g, torch.zeros(1, S, 4), torch.ones(1, S))


def test_stg_skip_masks_match():
    for batch, rows, ff in ((3, [2], False), (6, [2, 5], True)):
        want = jdit.stg_skip_masks(JCFG, batch, (1,), rows, skip_ff_too=ff)
        got = stg_skip_masks(CFG, batch, (1,), rows, skip_ff_too=ff)
        for g, w in zip(got, want):
            assert g.dtype == torch.bool
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _dit_inputs(b, rng):
    f, h, w = GRID
    from ltx_tpu.ops import rope as jrope
    latent = rng.standard_normal((b, f * h * w, CFG.in_channels)).astype(np.float32)
    context = rng.standard_normal((b, S, CFG.caption_channels)).astype(np.float32)
    cos, sin = jrope.video_rope(f, h, w, CFG.inner_dim, CFG.num_heads)
    return latent, context, cos, sin


@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float32, torch.float32, 5e-5),
                                         (jnp.bfloat16, torch.bfloat16, DIT_BF16_TOL)],
                         ids=["f32", "bf16"])
def test_dit_forward_with_skips_and_cross_attn_scale(jdt, tdt, tol):
    """Per-row STG skips of self-attention and feed-forward, per-token
    timesteps and a per-block cross-attention scale; a skipped row equals
    the same row run alone with the skip, and differs from the unskipped."""
    tree = _params(jdt)
    model = convert.transformer(tree, CFG)
    rng = np.random.default_rng(3)
    latent, context, cos, sin = _dit_inputs(3, rng)
    ts = rng.uniform(0.1, 1.0, (3, latent.shape[1])).astype(np.float32)
    sa = np.zeros((CFG.num_layers, 3), bool)
    ff = np.zeros((CFG.num_layers, 3), bool)
    sa[1, 2] = ff[0, 1] = True
    scales = np.array([0.5, 1.5], np.float32)
    want = jdit.dit_forward(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(latent, jdt), jnp.asarray(context, jdt),
        jnp.asarray(ts), (jnp.asarray(cos), jnp.asarray(sin)), JCFG,
        skip_self_attn=jnp.asarray(sa), skip_ff=jnp.asarray(ff),
        cross_attn_scale=jnp.asarray(scales))
    rope = (torch.from_numpy(cos), torch.from_numpy(sin))
    args = (as_torch(latent, tdt), as_torch(context, tdt), torch.from_numpy(ts), rope)
    with torch.inference_mode():
        got = model(*args, skip_self_attn=torch.from_numpy(sa), skip_ff=torch.from_numpy(ff),
                    cross_attn_scale=torch.from_numpy(scales))
        plain = model(*args, cross_attn_scale=torch.from_numpy(scales))
    assert_rel(got, want, tol, f"dit_forward with skips {tdt}")
    # row 0 has no skip: equal to the run without masks; rows 1 and 2 are not
    assert torch.equal(got[0], plain[0])
    assert not torch.equal(got[1], plain[1]) and not torch.equal(got[2], plain[2])
    # the skips ride through the rematerialised paths too
    for kw in (dict(remat=True), dict(remat_segments=2)):
        again = model(*args, skip_self_attn=torch.from_numpy(sa), skip_ff=torch.from_numpy(ff),
                      cross_attn_scale=torch.from_numpy(scales), **kw)
        assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# The step around a stand-in DiT: its own arithmetic, exactly
# ---------------------------------------------------------------------------


def _standin(xp, tokens, context, timesteps, bias, skip_sa, skip_ff, cas):
    """An elementwise function of everything the step hands the DiT, the
    same expression in jnp and torch: mixes each row's tokens with its
    context, its key bias, its (per-token) timesteps, its skip flags and the
    cross-attention scale, so that any mix-up of rows shows."""
    t32 = tokens.astype(xp.float32) if xp is jnp else tokens.float()
    ctx = context.astype(xp.float32) if xp is jnp else context.float()
    row = ctx.mean(axis=(1, 2)) if xp is jnp else ctx.mean(dim=(1, 2))
    ts = timesteps if timesteps.ndim == 2 else timesteps[:, None]
    out = t32 * (0.5 + ts[:, :, None]) + row[:, None, None]
    if bias is not None:
        out = out + 1e-4 * (bias[:, 0, 0].sum(-1))[:, None, None]
    if skip_sa is not None:
        flags = (skip_sa.astype(xp.float32) if xp is jnp else skip_sa.float()).sum(0)
        out = out * (1.0 - 0.25 * flags)[:, None, None]
    if cas is not None:
        out = out * cas
    return out.astype(tokens.dtype) if xp is jnp else out.to(tokens.dtype)


class StandInTransformer(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.cfg = CFG

    def forward(self, tokens, context, timesteps, rope, context_bias=None,
                skip_self_attn=None, skip_ff=None, cross_attn_scale=None, sdpa_impl="auto"):
        assert rope[0].shape[1] == tokens.shape[1]
        return _standin(torch, tokens, context, timesteps, context_bias, skip_self_attn,
                        skip_ff, cross_attn_scale)


def _j_standin(params, tokens, context, timesteps, pe, tcfg, context_bias=None,
               skip_self_attn=None, skip_ff=None, cross_attn_scale=None, **_):
    return _standin(jnp, tokens, context, timesteps, context_bias, skip_self_attn, skip_ff,
                    cross_attn_scale)


def _step_pair(transformer, tree, kw, b, cond):
    """The port's and the reference's step for guidance `kw`, B prompts and
    a conditioning (None, "leading", "leading2", "keyframes"), with their
    inputs: latent, previous velocity and the re-noise draw."""
    rng = np.random.default_rng(5)
    g, jg = _spec(**kw)
    f, h, w = GRID
    shape = VideoLatentShape(b, CFG.in_channels, f, h, w)
    jshape = JShape(b, CFG.in_channels, f, h, w)
    pos, pos_m, neg, neg_m = _text(b, rng)
    build = (denoise.build_guidance_context, jdenoise.build_guidance_context) if b == 1 \
        else (denoise.build_guidance_context_batched, jdenoise.build_guidance_context_batched)
    ctx, bias = build[0](g, as_torch(pos, torch.bfloat16), torch.from_numpy(pos_m),
                         as_torch(neg, torch.bfloat16), torch.from_numpy(neg_m))
    jctx, jbias = build[1](jg, jnp.asarray(pos, jnp.bfloat16), jnp.asarray(pos_m),
                           jnp.asarray(neg, jnp.bfloat16), jnp.asarray(neg_m))
    extra, jextra, noise, key = {}, {}, None, jax.random.key(9)
    if cond is not None:
        idx = {"leading": None, "leading2": None, "keyframes": (0, 2)}[cond]
        k = {"leading": 1, "leading2": 2, "keyframes": 2}[cond]
        cm = np.zeros((1, f * h * w), np.float32)
        for fr in (idx if idx is not None else range(k)):
            cm[:, fr * h * w:(fr + 1) * h * w] = 1.0
        clean = rng.standard_normal((1, CFG.in_channels, k, h, w)).astype(np.float32)
        common = dict(conditioning_mask=cm, image_cond_noise_scale=0.2, cond_frames=k,
                      cond_frame_idx=idx)
        extra = dict(common, conditioned_latent=torch.from_numpy(clean))
        jextra = dict(common, conditioned_latent=jnp.asarray(clean))
        noise = torch.from_numpy(np.array(jax.random.normal(key, clean.shape, jnp.float32)))
    step = denoise.make_denoise_step(transformer, g, shape, ctx, bias, **extra)
    jstep = jdenoise.make_denoise_step(tree, JCFG, jg, jshape, jctx, jbias, **jextra)
    latent = rng.standard_normal(shape.shape).astype(np.float32)
    prev = rng.standard_normal(shape.shape).astype(np.float32)
    return step, jstep, latent, prev, noise, key


STEP_CASES = [
    ("b1_g3", dict(cfg_scale=4.0, stg_scale=1.0, stg_blocks=(1,), guidance_rescale=0.7), 1, None),
    ("b2_g3", dict(cfg_scale=4.0, stg_scale=1.0, stg_blocks=(1,), guidance_rescale=0.7), 2, None),
    ("b1_stg_only_ge", dict(stg_scale=0.7, stg_blocks=(0, 1), ge_gamma=0.4), 1, None),
    ("b2_cfg_cas", dict(cfg_scale=2.5, cross_attention_scale=0.6), 2, None),
    ("i2v_g3", dict(cfg_scale=3.0, stg_scale=1.0, stg_blocks=(1,)), 1, "leading"),
    ("extension_g1", dict(), 1, "leading2"),
    ("keyframes_cfg", dict(cfg_scale=2.0, ge_gamma=0.3), 1, "keyframes"),
]


@pytest.mark.parametrize("name,kw,b,cond", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_step_arithmetic_is_the_references(monkeypatch, name, kw, b, cond):
    monkeypatch.setattr(jdit, "dit_forward", _j_standin)
    step, jstep, latent, prev, noise, key = _step_pair(
        StandInTransformer(), {}, kw, b, cond)
    for has_prev in (False, True):
        want_l, want_v = jstep(jnp.asarray(latent), 0.725, 0.421875, jnp.asarray(prev),
                               jnp.asarray(has_prev), key)
        got_l, got_v = step(torch.from_numpy(latent), 0.725, 0.421875,
                            torch.from_numpy(prev), has_prev, noise)
        assert got_l.dtype == got_v.dtype == torch.float32
        assert_rel(got_v, want_v, 1e-5, f"step {name} velocity has_prev={has_prev}")
        assert_rel(got_l, want_l, 1e-5, f"step {name} latent has_prev={has_prev}")
    if cond is not None:
        # the conditioned frames carry the re-noised clean latent, unstepped
        frames = [0, 2] if cond == "keyframes" else list(range(1 if cond == "leading" else 2))
        np.testing.assert_allclose(as_np(got_l)[:, :, frames], np.asarray(want_l)[:, :, frames],
                                   rtol=1e-6, atol=1e-6)
        assert not np.allclose(as_np(got_l)[:, :, frames], latent[:, :, frames])


def _std_ratio(got, want):
    """Each batch row's standard deviation in got over that in want."""
    got, want = as_np(got).astype(np.float64), np.asarray(want, np.float64)
    rows = got.shape[0]
    return got.reshape(rows, -1).std(axis=1) / want.reshape(rows, -1).std(axis=1)


@pytest.mark.parametrize("name,kw,b,cond", [STEP_CASES[0], STEP_CASES[1], STEP_CASES[4]],
                         ids=["b1_g3", "b2_g3", "i2v_g3"])
def test_guided_step_with_the_bf16_dit(name, kw, b, cond):
    tree = _params(jnp.bfloat16)
    model = convert.transformer(tree, CFG)
    step, jstep, latent, prev, noise, key = _step_pair(
        model, jax.tree.map(jnp.asarray, tree), kw, b, cond)
    sigma, sigma_next = 0.9875, 0.725
    want_l, want_v = jstep(jnp.asarray(latent), sigma, sigma_next, jnp.asarray(prev),
                           jnp.asarray(False), key)
    with torch.inference_mode():
        got_l, got_v = step(torch.from_numpy(latent), sigma, sigma_next,
                            torch.from_numpy(prev), False, noise)
    assert_rel(got_v, want_v, GUIDED_STEP_TOL[name][0], f"guided step {name} velocity")
    assert_rel(got_l, want_l, GUIDED_STEP_TOL[name][1], f"guided step {name} latent")
    spread = float(np.abs(_std_ratio(got_v, want_v) - 1).max())
    print(f"[parity] guided step {name} std of the velocity, each row: {spread:.3e} from "
          f"the reference's (tol {GUIDED_STD_TOL:.0e})")
    assert spread <= GUIDED_STD_TOL
    # the limits must tell a dropped guidance term: the port's step without
    # STG or without CFG is farther from the reference's full step than the
    # velocity's limit, and without the rescale (a factor on each row, which
    # bf16 noise hides element by element) its rows' std is farther than theirs
    dropped = [dict(kw, stg_scale=0.0, stg_blocks=()), dict(kw, cfg_scale=1.0)]
    if kw.get("guidance_rescale"):
        dropped.append(dict(kw, guidance_rescale=0.0))
    for less in dropped:
        lesser = _step_pair(model, {}, less, b, cond)[0]
        with torch.inference_mode():
            _, less_v = lesser(torch.from_numpy(latent), sigma, sigma_next,
                               torch.from_numpy(prev), False, noise)
        err = rel_err(less_v, want_v)
        spread = float(np.abs(_std_ratio(less_v, want_v) - 1).min())
        print(f"[parity] guided step {name} with {less}: {err:.3e} and std {spread:.3e} "
              "from the reference")
        if "guidance_rescale" in less and less["guidance_rescale"] == 0.0:
            assert spread > GUIDED_STD_TOL, (name, less, spread)
        else:
            assert err > GUIDED_STEP_TOL[name][0], (name, less, err)


def test_run_denoise_loop_carries_velocity_and_draws(monkeypatch):
    """The loop hands each step its own re-noise draw and the previous
    velocity (guidance extrapolation from the second step on), as the
    reference's loop, which splits its key once a step."""
    monkeypatch.setattr(jdit, "dit_forward", _j_standin)
    kw = dict(cfg_scale=2.0, ge_gamma=0.5)
    step, jstep, latent, _, _, _ = _step_pair(StandInTransformer(), {}, kw, 1, "leading")
    sigmas = np.array([1.0, 0.9, 0.6, 0.0], np.float32)
    dkey = jax.random.key(21)
    want = jdenoise.run_denoise_loop(jstep, jnp.asarray(latent), sigmas, key=dkey)
    draws, key = [], dkey
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.normal(
            sub, (1, CFG.in_channels, 1, GRID[1], GRID[2]), jnp.float32))))
    seen = []
    got = denoise.run_denoise_loop(step, torch.from_numpy(latent), sigmas, cond_noise=draws,
                                   on_step=lambda i, n, s: seen.append((i, n, s)))
    assert_rel(got, want, 1e-5, "run_denoise_loop with GE and re-noise")
    assert [i for i, _, _ in seen] == [0, 1, 2] and seen[0][1] == 3
    with pytest.raises(ValueError, match="3 draws"):
        denoise.run_denoise_loop(step, torch.from_numpy(latent), sigmas, cond_noise=draws[:2])


def test_step_rejects_bad_conditioning():
    g, _ = _spec()
    shape = VideoLatentShape(1, CFG.in_channels, *GRID)
    ctx = torch.zeros(1, S, CFG.caption_channels)
    cm = np.ones((1, 12), np.float32)
    make = lambda **kw: denoise.make_denoise_step(StandInTransformer(), g, shape, ctx, None, **kw)
    with pytest.raises(ValueError, match="requires conditioned_latent"):
        make(conditioning_mask=cm, image_cond_noise_scale=0.1)
    with pytest.raises(ValueError, match="requires conditioning_mask"):
        make(cond_frame_idx=(0,))
    with pytest.raises(ValueError, match="strictly increasing"):
        make(conditioning_mask=cm, cond_frame_idx=(1, 1))
    with pytest.raises(ValueError, match="out of range"):
        make(conditioning_mask=cm, cond_frame_idx=(0, 3))
    with pytest.raises(ValueError, match="names 2"):
        make(conditioning_mask=cm, cond_frame_idx=(0, 2), image_cond_noise_scale=0.1,
             conditioned_latent=torch.zeros(1, CFG.in_channels, 1, 2, 2))
    step = make(conditioning_mask=cm, image_cond_noise_scale=0.1,
                conditioned_latent=torch.zeros(1, CFG.in_channels, 1, 2, 2))
    with pytest.raises(ValueError, match="needs its draw"):
        step(torch.zeros(shape.shape), 1.0, 0.5)
