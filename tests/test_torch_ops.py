"""Port parity: schedule, RoPE, embeddings, latents and normalization ops of
ltx_tpu_torch against ltx_tpu, on the same numpy inputs.

Tolerances: float32 on both sides is held to 1e-5 relative (summation
order and libm differences only). bf16 results may differ by one bf16
rounding where the two frameworks round at a different point: 2**-7
relative (one bf16 ulp at the largest magnitude)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.ops import embeddings as jemb
from ltx_tpu.ops import latents as jlat
from ltx_tpu.ops import normalization as jnorm
from ltx_tpu.ops import rope as jrope
from ltx_tpu.ops import schedule as jsched
from ltx_tpu.ops.attention import prepare_additive_mask as j_prepare_mask
from ltx_tpu_torch.ops import embeddings, latents, normalization, rope, schedule
from ltx_tpu_torch.ops.attention import prepare_additive_mask
from torch_parity import as_np, as_torch, assert_rel

F32_TOL = 1e-5
BF16_TOL = 2.0**-7
DTYPES = [(jnp.float32, torch.float32, F32_TOL), (jnp.bfloat16, torch.bfloat16, BF16_TOL)]


@pytest.mark.parametrize("kw", [
    dict(num_steps=8, distilled=True),
    dict(num_steps=8, distilled=True, token_count=1536),
    dict(num_steps=8, distilled=True, token_count=64),
    dict(num_steps=40, distilled=False, token_count=6144),
    dict(num_steps=20, distilled=False),
])
def test_get_sigmas_matches(kw):
    np.testing.assert_array_equal(schedule.get_sigmas(**kw), jsched.get_sigmas(**kw))


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("sigma,sigma_next", [(0.99375, 0.9875), (0.421875, 0.0)])
def test_euler_step_matches(jdt, tdt, tol, sigma, sigma_next):
    rng = np.random.default_rng(0)
    lat, vel = rng.standard_normal((2, 1, 16, 2, 4, 4)).astype(np.float32)
    want = jsched.euler_step(jnp.asarray(lat, jdt), jnp.asarray(vel, jdt), sigma, sigma_next)
    got = schedule.euler_step(as_torch(lat, tdt), as_torch(vel, tdt), sigma, sigma_next)
    assert got.dtype == tdt
    assert_rel(got, want, tol, "euler_step")


def test_rope_tables_match():
    for args in [(2, 4, 6, 128, 4), (3, 16, 24, 4096, 32)]:
        got = rope.video_rope(*args)
        want = jrope.video_rope(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    grid = np.arange(16, dtype=np.float32)[None]
    for g, w in zip(rope.precompute_freqs_cis(grid, 64, max_pos=(4096,), num_heads=4),
                    jrope.precompute_freqs_cis(grid, 64, max_pos=(4096,), num_heads=4)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("flat", [True, False])
def test_apply_rope_split_matches(jdt, tdt, tol, flat):
    h, t, d = 4, 32, 32
    cos, sin = jrope.video_rope(2, 4, 4, h * d, h)
    x = np.random.default_rng(1).standard_normal(
        (2, t, h * d) if flat else (2, h, t, d)).astype(np.float32)
    want = jrope.apply_rope_split(jnp.asarray(x, jdt), jnp.asarray(cos), jnp.asarray(sin))
    got = rope.apply_rope_split(as_torch(x, tdt), torch.from_numpy(cos), torch.from_numpy(sin))
    assert_rel(got, want, tol, f"apply_rope_split flat={flat}")


def test_timestep_embedding_matches():
    """torch's and XLA's f32 exp differ by one ulp on some frequencies, and
    the argument t * freq carries that ulp times t: at t = 1000 (sigma 1 x
    the DiT's multiplier) the cos/sin differ by up to ~1.2e-4."""
    t = np.array([0.0, 1.0, 421.875, 993.75, 1000.0], np.float32)
    for dim in (256, 7):
        want = jemb.get_timestep_embedding(jnp.asarray(t), dim)
        got = embeddings.get_timestep_embedding(torch.from_numpy(t), dim)
        assert_rel(got, want, 2e-4, f"timestep embedding dim={dim}")
        small = t[:2]
        assert_rel(embeddings.get_timestep_embedding(torch.from_numpy(small), dim),
                   jemb.get_timestep_embedding(jnp.asarray(small), dim),
                   F32_TOL, f"timestep embedding t<=1 dim={dim}")


def test_latents_match():
    shape = latents.VideoLatentShape.from_pixels(1, 25, 512, 768)
    jshape = jlat.VideoLatentShape.from_pixels(1, 25, 512, 768)
    assert dataclasses.astuple(shape) == dataclasses.astuple(jshape) == (1, 128, 4, 16, 24)
    assert shape.token_count == 1536 and shape.pixel_frames == jshape.pixel_frames == 25
    small = latents.VideoLatentShape(1, 16, 2, 3, 4)
    x = np.random.default_rng(2).standard_normal(small.shape).astype(np.float32)
    tok = latents.patchify(torch.from_numpy(x))
    np.testing.assert_array_equal(as_np(tok), np.asarray(jlat.patchify(jnp.asarray(x))))
    np.testing.assert_array_equal(as_np(latents.unpatchify(tok, small)), x)
    u, c = np.random.default_rng(3).standard_normal((2, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        as_np(latents.apply_cfg(torch.from_numpy(u), torch.from_numpy(c), 4.0)),
        np.asarray(jlat.apply_cfg(jnp.asarray(u), jnp.asarray(c), 4.0)))


def test_generate_noise_shape_and_seed():
    shape = latents.VideoLatentShape(1, 16, 2, 2, 2)
    a = latents.generate_noise(shape, torch.Generator().manual_seed(5))
    b = latents.generate_noise(shape, torch.Generator().manual_seed(5))
    assert a.shape == shape.shape and a.dtype == torch.float32
    assert torch.equal(a, b)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_normalization_matches(jdt, tdt, tol):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 8, 128)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    scale, shift = rng.standard_normal((2, 2, 1, 128)).astype(np.float32)
    xj, xt = jnp.asarray(x, jdt), as_torch(x, tdt)
    assert_rel(normalization.rms_norm(xt), jnorm.rms_norm(xj), tol, "rms_norm")
    assert_rel(normalization.rms_norm(xt, as_torch(w, tdt)),
               jnorm.rms_norm(xj, jnp.asarray(w, jdt)), tol, "rms_norm weighted")
    assert_rel(normalization.layer_norm_no_affine(xt), jnorm.layer_norm_no_affine(xj),
               tol, "layer_norm_no_affine")
    assert_rel(normalization.adaln(xt, as_torch(scale, tdt), as_torch(shift, tdt)),
               jnorm.adaln(xj, jnp.asarray(scale, jdt), jnp.asarray(shift, jdt)),
               tol, "adaln")


def test_prepare_additive_mask_matches():
    mask = np.array([[1, 1, 0, 0], [0, 1, 1, 1]], np.int32)
    got = prepare_additive_mask(torch.from_numpy(mask))
    want = j_prepare_mask(jnp.asarray(mask))
    assert got.shape == (2, 1, 1, 4)
    np.testing.assert_array_equal(as_np(got), np.asarray(want))
    assert prepare_additive_mask(None) is None


# ---------------------------------------------------------------------------
# RMSNorm: the kernel's plain version, the dispatch, pixel and group norms
# ---------------------------------------------------------------------------

RMS_SHAPES = [(4, 37, 256), (2, 8, 384), (1, 512), (5, 128)]


def _assert_rms_close(got, want, dtype):
    """The same f32 expression on both sides; only the mean's reduction
    order differs: 1-2 f32 ulps, which the bf16 output cast usually rounds
    away. At most one ulp of the output dtype, as the reference's own test
    of its Pallas kernel allows."""
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("weighted", [False, True], ids=["weightless", "weighted"])
def test_rms_norm_reference_matches_pallas_and_xla(shape, jdt, tdt, tol, weighted):
    """rms_norm_reference (the CUDA kernel's plain version) against the
    reference's Pallas kernel in interpret mode and its XLA rms_norm."""
    from ltx_tpu.kernels.rms_norm import rms_norm_pallas
    from ltx_tpu_torch.kernels import rms_norm as rk

    rng = np.random.default_rng(10)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32) if weighted else None
    xj, xt = jnp.asarray(x, jdt), as_torch(x, tdt)
    wj = None if w is None else jnp.asarray(w, jdt)
    wt = None if w is None else as_torch(w, tdt)
    got = rk.rms_norm_reference(xt, wt)
    assert got.dtype == tdt and got.shape == xt.shape
    _assert_rms_close(got, rms_norm_pallas(xj, wj, interpret=True), tdt)
    _assert_rms_close(got, jnorm.rms_norm(xj, wj), tdt)
    # on the CPU the wrapper and the dispatcher are the plain version, bit for bit
    assert torch.equal(rk.rms_norm(xt, wt), got)
    assert torch.equal(normalization.rms_norm(xt, wt), got)


def test_rms_norm_wrapper_contract_on_the_cpu():
    from ltx_tpu_torch.kernels import rms_norm as rk

    with pytest.raises(ValueError, match="multiple of 128"):
        rk.rms_norm(torch.ones(4, 100))
    with pytest.raises(ValueError, match="weight"):
        rk.rms_norm(torch.ones(4, 128), torch.ones(64))
    # an f32 weight under a bf16 input multiplies in f32, one rounding
    x = as_torch(np.random.default_rng(0).standard_normal((3, 128)), torch.bfloat16)
    w = torch.linspace(0.5, 1.5, 128)
    want = (x.float() * torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + 1e-6)
            * w).bfloat16()
    assert torch.equal(rk.rms_norm(x, w), want)
    # non-contiguous input
    xt = torch.randn(128, 6, generator=torch.Generator().manual_seed(1)).t()
    assert torch.equal(rk.rms_norm(xt), rk.rms_norm_reference(xt.contiguous()))
    assert rk.rms_norm.launches == 0


def test_set_rms_impl_keeps_the_plain_chain_on_the_cpu():
    """The reference's toggle contract: with the kernel selected a CPU
    tensor keeps the plain chain (there: a non-TPU backend keeps XLA); an
    unknown value raises ValueError; a last dim off the 128 rule keeps it
    too."""
    x = as_torch(np.random.default_rng(4).standard_normal((2, 7, 256)), torch.bfloat16)
    odd = torch.ones(3, 100)
    want = normalization.rms_norm(x)
    assert normalization.get_rms_impl() == "torch"
    normalization.set_rms_impl("cuda")
    try:
        assert normalization.get_rms_impl() == "cuda"
        got = normalization.rms_norm(x)
        normalization.rms_norm(odd)
    finally:
        normalization.set_rms_impl("torch")
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown rms impl"):
        normalization.set_rms_impl("pallas")
    with pytest.raises(ValueError):
        jnorm.set_rms_impl("cuda")
    assert normalization.get_rms_impl() == "torch"


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_pixel_and_group_norm_match(jdt, tdt, tol):
    """pixel_norm over the channel axis, and group_norm_f32 (population
    variance) on the port's channels-first layout against the reference's
    channels-last."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, 8, 3, 4, 5)) * 2 + 0.5).astype(np.float32)  # (B, C, F, H, W)
    w, b = rng.standard_normal((2, 8)).astype(np.float32)
    assert_rel(normalization.pixel_norm(as_torch(x, tdt)),
               jnorm.pixel_norm(jnp.asarray(x, jdt), axis=1), tol, "pixel_norm")
    last = np.moveaxis(x, 1, -1)
    want = jnorm.group_norm_f32(jnp.asarray(last, jdt), jnp.asarray(w, jdt),
                                jnp.asarray(b, jdt), 4, 1e-5)
    got = normalization.group_norm_f32(as_torch(x, tdt), as_torch(w, tdt),
                                       as_torch(b, tdt), 4, 1e-5)
    assert_rel(got, np.moveaxis(np.asarray(want, np.float32), -1, 1), tol, "group_norm_f32")


def test_guidance_and_statistics_latent_ops_match():
    """apply_guidance_rescale (std over all non-batch axes), AdaIN with
    different spatial sizes, normalize / denormalize: population variances."""
    rng = np.random.default_rng(13)
    cfg_out, cond = (rng.standard_normal((2, 2, 4, 3, 3, 5)) * [[[[[[2.0]]]]], [[[[[0.7]]]]]]
                     ).astype(np.float32)
    for phi in (0.0, 0.7, 1.0):
        assert_rel(latents.apply_guidance_rescale(torch.from_numpy(cfg_out),
                                                  torch.from_numpy(cond), phi),
                   jlat.apply_guidance_rescale(jnp.asarray(cfg_out), jnp.asarray(cond), phi),
                   F32_TOL, f"apply_guidance_rescale phi={phi}")
    lat = (rng.standard_normal((1, 4, 3, 6, 8)) * 3 + 1).astype(np.float32)
    ref = rng.standard_normal((1, 4, 3, 3, 4)).astype(np.float32)
    for factor in (0.0, 0.4, 1.0):
        assert_rel(latents.adain_filter_latent(torch.from_numpy(lat), torch.from_numpy(ref),
                                               factor),
                   jlat.adain_filter_latent(jnp.asarray(lat), jnp.asarray(ref), factor),
                   F32_TOL, f"adain_filter_latent factor={factor}")
    assert_rel(latents.normalize_latent(torch.from_numpy(lat)),
               jlat.normalize_latent(jnp.asarray(lat)), F32_TOL, "normalize_latent")
    mean, std = rng.standard_normal((2, 4)).astype(np.float32)
    assert_rel(latents.denormalize_latent(torch.from_numpy(lat), torch.from_numpy(mean),
                                          torch.from_numpy(std)),
               jlat.denormalize_latent(jnp.asarray(lat), jnp.asarray(mean), jnp.asarray(std)),
               F32_TOL, "denormalize_latent")
    np.testing.assert_array_equal(schedule.STAGE_2_SIGMAS, jsched.STAGE_2_SIGMAS)
