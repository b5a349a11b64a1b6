"""Port parity end to end for the guided, image-conditioned, batched and
two-stage paths: ltx_tpu_torch's LTXPipeline against a live run of the
reference's on the tiny pipeline, weights converted from the reference's
random_tiny(seed=0) and every draw taken from jax.random exactly as the
reference derives it from the seed; and against tests/goldens/
tiny_t2v_guided.npz and tiny_two_stage.npz.

Tolerances, absolute on frames in [0, 1] (max over the clip, and the
golden's first frame and mean/std/min/max). Paths with one guidance row
(I2V, the unguided two-stage, the batched run at cfg 1): 2e-2, the tolerance
of the single-stage T2V test, for bf16 Gemma, connector and DiT whose
roundings fall at other places in the two frameworks. Guided paths: the
combine weighs the frameworks' differing bf16 rows with its coefficients
(8, -6 and -1 at CFG 4 with STG 1, test_torch_guidance), and the clip's
largest pixel error grows with them: 8e-2 on the max (4.5e-2 measured at
CFG 4 + STG 1) with the mean absolute error held to 1e-2 (4.5e-3 measured). The f32 components
(upscaler, VAE encoder): 1e-5 relative."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.core import config as jconfig
from ltx_tpu.models import dit as jdit
from ltx_tpu.models import gemma3 as jgemma
from ltx_tpu.models import text_encoder as jte
from ltx_tpu.models import upscaler as jup
from ltx_tpu.models import vae as jvae
from ltx_tpu.ops import schedule as jsched
from ltx_tpu.ops.latents import VideoLatentShape as JShape
from ltx_tpu.pipeline.generate import LTXPipeline as JaxPipeline
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import GenerationConfig, MemoryConfig
from ltx_tpu_torch.models import upscaler
from ltx_tpu_torch.pipeline import generate
from ltx_tpu_torch.pipeline.generate import LTXPipeline
from torch_parity import as_np, assert_rel

GOLDENS = pathlib.Path(__file__).parent / "goldens"
FRAME_ATOL = 2e-2
GUIDED_ATOL, GUIDED_MEAN_ATOL = 8e-2, 1e-2


def _jcfg(config):
    return convert.port_config(config, jconfig.GenerationConfig)


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))


def _loop_draws(dkey, steps, shape):
    """The reference's re-noise draws: run_denoise_loop splits its key once
    a step and the step draws normal(sub, conditioned_latent.shape)."""
    draws, key = [], dkey
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws.append(_normal(sub, shape))
    return draws


def _shape(port, config, scale=1):
    return JShape.from_pixels(1, config.num_frames, config.height // scale,
                              config.width // scale, channels=port.tcfg.in_channels)


def _single_stage_keys(seed):
    """generate_video's keys: the initial noise, the denoise loop, the decode."""
    key = jax.random.key(seed)
    key, nkey = jax.random.split(key)
    key, dkey = jax.random.split(key)
    return nkey, dkey


def _check(got, want, what, guided=False):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    err, mean = float(np.abs(got - want).max()), float(np.abs(got - want).mean())
    tol = GUIDED_ATOL if guided else FRAME_ATOL
    print(f"[parity] {what}: max abs {err:.3e}, mean abs {mean:.3e} (tol {tol:.0e})")
    assert err <= tol
    if guided:
        assert mean <= GUIDED_MEAN_ATOL


def _check_golden(name, got, want, guided=False):
    with np.load(GOLDENS / f"{name}.npz") as z:
        first, stats = z["first_frame"], z["stats"]
    # the rebuilt reference reproduces the golden
    np.testing.assert_allclose(want[0], first, atol=2e-4, rtol=2e-4)
    got_stats = np.array([got.mean(), got.std(), got.min(), got.max()], np.float32)
    e_first, e_stats = float(np.abs(got[0] - first).max()), float(np.abs(got_stats - stats).max())
    tol = GUIDED_ATOL if guided else FRAME_ATOL
    print(f"[parity] {name} golden: first frame {e_first:.3e}, stats {e_stats:.3e} "
          f"(tol {tol:.0e})")
    assert e_first <= tol and e_stats <= FRAME_ATOL


@pytest.fixture(scope="module")
def pipes():
    """The reference's random_tiny(seed=0) components (the same keys) as a
    JAX pipeline, and the port built from the same trees: all six. The bf16
    components init eagerly as random_tiny does (a jitted init rounds some
    bf16 weights differently); the f32 VAE and upscaler init jitted, within
    2e-8 of eager."""
    tcfg, vcfg, gcfg, tecfg = generate.tiny_configs()
    ucfg = generate.tiny_upscaler_config(tcfg)
    jtcfg = convert.port_config(tcfg, jconfig.TransformerConfig)
    jvcfg = convert.port_config(vcfg, jvae.VAEConfig)
    jgcfg = convert.port_config(gcfg, jgemma.Gemma3Config)
    jtecfg = convert.port_config(tecfg, jte.TextEncoderConfig)
    jucfg = convert.port_config(ucfg, jup.UpscalerConfig)
    ks = jax.random.split(jax.random.key(0), 9)
    ref = JaxPipeline(
        transformer_params=jdit.init_params(ks[0], jtcfg, jnp.bfloat16),
        transformer_config=jtcfg,
        vae_decoder_params=jax.jit(jvae.init_decoder_params, static_argnums=1)(ks[1], jvcfg),
        vae_config=jvcfg,
        gemma_params=jgemma.init_params(ks[2], jgcfg, jnp.bfloat16), gemma_config=jgcfg,
        text_encoder_params=jte.init_params(ks[3], jtecfg, jnp.bfloat16),
        text_encoder_config=jtecfg,
        vae_encoder_params=jax.jit(jvae.init_encoder_params, static_argnums=1)(ks[4], jvcfg),
        upscaler_params=jax.jit(jup.init_params, static_argnums=1)(ks[5], jucfg),
        upscaler_config=jucfg,
        memory=jconfig.MemoryConfig(offload_text_encoder=False))
    port = LTXPipeline(
        transformer=convert.transformer(ref.transformer_params, tcfg),
        vae_decoder=convert.vae_decoder(ref.vae_decoder_params, vcfg),
        gemma=convert.gemma(ref.gemma_params, gcfg),
        text_encoder=convert.text_encoder(ref.text_encoder_params, tecfg),
        vae_encoder=convert.vae_encoder(ref.vae_encoder_params, vcfg),
        upscaler=convert.upscaler(ref.upscaler_params, ucfg),
        memory=MemoryConfig(offload_text_encoder=False), device="cpu")
    assert dataclasses.asdict(port.upscaler.cfg) == dataclasses.asdict(ref.upscaler_config)
    return ref, port


@pytest.fixture(scope="module")
def image_latents(pipes):
    """A seeded image at half and full resolution through both encode_image."""
    ref, port = pipes
    rng = np.random.default_rng(0)
    out = {}
    for name, size in (("half", 32), ("full", 64)):
        px = rng.uniform(-1, 1, (1, 3, 1, size, size)).astype(np.float32)
        want = ref.encode_image(jnp.asarray(px))
        got = port.encode_image(px)
        assert got.dtype == torch.float32
        assert_rel(got, want, 1e-5, f"encode_image {size}x{size}")
        out[name] = (want, got)
    return out


def test_upscaler_matches_reference():
    """upsample_latents in f32 (denormalize, conv3d / GroupNorm / res
    blocks, the per-frame conv2d and pixel shuffle, renormalize), norm
    weights and biases redrawn so that they matter; and the shuffle's
    channel order (c, rh, rw) on its own."""
    cfg = jup.UpscalerConfig().tiny()
    rng = np.random.default_rng(1)
    tree = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32))
        if a.ndim == 1 else a,
        jax.jit(jup.init_params, static_argnums=1)(jax.random.key(2), cfg))
    x = rng.standard_normal((2, cfg.in_channels, 3, 4, 6)).astype(np.float32)
    mean = rng.standard_normal(cfg.in_channels).astype(np.float32)
    std = rng.uniform(0.5, 2.0, cfg.in_channels).astype(np.float32)
    want = jup.upsample_latents_jit(tree, jnp.asarray(x), jnp.asarray(mean),
                                    jnp.asarray(std), cfg)
    model = convert.upscaler(tree, cfg)
    got = upscaler.upsample_latents(model, torch.from_numpy(x), torch.from_numpy(mean),
                                    torch.from_numpy(std))
    assert got.shape == (2, cfg.in_channels, 3, 8, 12)
    assert_rel(got, want, 1e-5, "upsample_latents float32")
    y = np.arange(2 * 3 * 4 * 8, dtype=np.float32).reshape(2, 3, 4, 8)  # NHWC, C = 2*2*2
    want_s = np.asarray(jup.pixel_shuffle_2d(jnp.asarray(y), 2))
    got_s = upscaler.pixel_shuffle_2d(torch.from_numpy(y).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got_s.permute(0, 2, 3, 1).numpy(), want_s)
    # the order spelled out: input channel c*4 + rh*2 + rw lands at (2h + rh, 2w + rw)
    assert got_s[1, 1, 2 * 2 + 1, 2 * 3 + 0] == y[1, 2, 3, 1 * 4 + 1 * 2 + 0]


GUIDED_CASES = {
    "golden_cfg_stg": dict(cfg_scale=4.0, stg_scale=1.0, stg_blocks=(1,), seed=7),
    "cfg_rescale_negative": dict(cfg_scale=2.0, guidance_rescale=0.7, seed=8,
                                 negative_prompt="washed out, blurry"),
    "stg_ge_cas": dict(stg_scale=1.0, stg_blocks=(0,), ge_gamma=0.5,
                       cross_attention_scale=0.5, seed=9),
}


@pytest.mark.parametrize("name", GUIDED_CASES)
def test_generate_video_guided_matches_live_reference(pipes, name):
    ref, port = pipes
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                              **GUIDED_CASES[name])
    prompt = "golden guided prompt"
    want = np.asarray(ref.generate_video(prompt, _jcfg(config)).frames, np.float32)
    nkey, _ = _single_stage_keys(config.seed)
    result = port.generate_video(prompt, config, _normal(nkey, _shape(port, config).shape))
    _check(result.frames, want, f"generate_video {name}", guided=True)
    assert result.seed == config.seed
    if name == "golden_cfg_stg":
        _check_golden("tiny_t2v_guided", result.frames, want, guided=True)


def test_generate_video_i2v_matches_live_reference(pipes, image_latents):
    """I2V through the image_latent hook with the conditioned frame
    re-noised every step from the reference's own draws."""
    ref, port = pipes
    config = GenerationConfig(width=64, height=64, num_frames=17, num_steps=3, seed=11,
                              image_cond_noise_scale=0.15)
    jl, tl = image_latents["full"]
    want = ref.generate_video("an image comes alive", _jcfg(config), image_latent=jl).frames
    nkey, dkey = _single_stage_keys(config.seed)
    shape = _shape(port, config)
    steps = len(port._sigmas(config, shape)) - 1
    result = port.generate_video(
        "an image comes alive", config, _normal(nkey, shape.shape), image_latent=tl,
        cond_noise=_loop_draws(dkey, steps, tuple(tl.shape)))
    _check(result.frames, want, "generate_video I2V")
    with pytest.raises(ValueError, match="draws"):
        port.generate_video("x", config, _normal(nkey, shape.shape), image_latent=tl)


def test_generate_video_i2v_from_an_image_file(pipes, tmp_path):
    """config.image_path: load_image (a copy of the reference's) and the
    in-pipeline encode."""
    Image = pytest.importorskip("PIL.Image")  # load_image needs Pillow

    from ltx_tpu.io.video import load_image as j_load_image
    from ltx_tpu_torch.io.video import load_image

    ref, port = pipes
    rng = np.random.default_rng(3)
    path = str(tmp_path / "cond.png")
    Image.fromarray(rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)).save(path)
    np.testing.assert_array_equal(load_image(path, 64, 64), j_load_image(path, 64, 64))
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=12,
                              image_path=path)
    want = ref.generate_video("from a file", _jcfg(config)).frames
    nkey, _ = _single_stage_keys(config.seed)
    got = port.generate_video("from a file", config, _normal(nkey, _shape(port, config).shape))
    _check(got.frames, want, "generate_video I2V from image_path")
    assert got.timings.image_encode > 0


@pytest.mark.parametrize("cfg_scale", [1.0, 2.0], ids=["cfg1", "cfg2"])
def test_generate_videos_matches_live_reference_and_solo(pipes, cfg_scale):
    """Two prompts through one batched loop: against the reference's
    generate_videos on the same per-prompt draws, and bit for bit each
    prompt's solo generate_video (the CPU's products do not depend on the
    batch)."""
    ref, port = pipes
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=5,
                              cfg_scale=cfg_scale)
    prompts = ["a short one", "a rather longer second prompt"]
    want = ref.generate_videos(prompts, _jcfg(config))
    shape = _shape(port, config)
    noises = [_normal(_single_stage_keys(config.seed + i)[0], shape.shape) for i in range(2)]
    got = port.generate_videos(prompts, config, torch.cat(noises))
    assert [r.seed for r in got] == [r.seed for r in want] == [5, 6]
    for i, (g, w) in enumerate(zip(got, want)):
        _check(g.frames, w.frames, f"generate_videos cfg {cfg_scale} sample {i}",
               guided=cfg_scale > 1)
        solo = port.generate_video(prompts[i], config, noises[i])
        np.testing.assert_array_equal(solo.frames, g.frames)
    assert port.generate_videos([], config, torch.zeros(0)) == []
    with pytest.raises(ValueError, match="T2V-only"):
        port.generate_videos(prompts, dataclasses.replace(config, image_path="x.png"),
                             torch.cat(noises))
    with pytest.raises(ValueError, match="initial_noise"):
        port.generate_videos(prompts, config, noises[0])


def _two_stage_draws(port, config, half=None, full=None):
    """generate_video_two_stage's draws from config.seed, as the reference
    splits its key: (nkey, dkey) for stage 1, then (nkey2, dkey2)."""
    key = jax.random.key(config.seed)
    key, nkey, dkey = jax.random.split(key, 3)
    key, nkey2, dkey2 = jax.random.split(key, 3)
    s1, s2 = _shape(port, config, 2), _shape(port, config)
    distilled = config.num_steps <= 8 and config.cfg_scale <= 1.0
    n1 = len(jsched.get_sigmas(config.num_steps, distilled=distilled,
                               token_count=s1.token_count)) - 1
    draws = dict(stage1_noise=_normal(nkey, s1.shape), stage2_noise=_normal(nkey2, s2.shape))
    if half is not None and config.image_cond_noise_scale > 0:
        draws["stage1_cond_noise"] = _loop_draws(dkey, n1, tuple(half.shape))
        draws["stage2_cond_noise"] = _loop_draws(dkey2, 3, tuple(full.shape))
    return draws, n1


def test_two_stage_matches_live_reference_and_golden(pipes):
    ref, port = pipes
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=42)
    prompt = "golden two-stage prompt"
    want = np.asarray(ref.generate_video_two_stage(prompt, _jcfg(config)).frames, np.float32)
    draws, n1 = _two_stage_draws(port, config)
    result = port.generate_video_two_stage(prompt, config, **draws)
    _check(result.frames, want, "generate_video_two_stage T2V")
    _check_golden("tiny_two_stage", result.frames, want)
    assert len(result.timings.denoise_steps) == n1 + 3 and result.timings.upscale > 0
    assert result.seed == 42


def test_two_stage_guided_i2v_matches_live_reference(pipes, image_latents):
    """The quality path: guided stage 1 on the non-distilled schedule, both
    image latents through the hooks, the re-noise in both stages, stage 2
    without CFG but with STG, and a tiled decode."""
    ref, port = pipes
    config = GenerationConfig(width=64, height=64, num_frames=17, num_steps=3, seed=13,
                              cfg_scale=3.0, stg_scale=1.0, stg_blocks=(0,),
                              guidance_rescale=0.5, image_cond_noise_scale=0.1)
    (half_j, half), (full_j, full) = image_latents["half"], image_latents["full"]
    tiled = dict(vae_tile_size=2, vae_tile_overlap=1)
    ref_memory, port_memory = ref.memory, port.memory
    ref.memory = dataclasses.replace(ref_memory, **tiled)
    port.memory = dataclasses.replace(port_memory, **tiled)
    try:
        want = ref.generate_video_two_stage(
            "the quality path", _jcfg(config), image_latent=half_j,
            full_res_image_latent=full_j).frames
        draws, _ = _two_stage_draws(port, config, half, full)
        result = port.generate_video_two_stage(
            "the quality path", config, image_latent=half, full_res_image_latent=full,
            **draws)
    finally:
        ref.memory, port.memory = ref_memory, port_memory
    assert result.frames.shape == (17, 64, 64, 3)
    _check(result.frames, want, "generate_video_two_stage guided I2V, tiled", guided=True)
    # the tiled path hands back uint8 steps
    np.testing.assert_allclose(result.frames * 255, np.round(result.frames * 255), atol=1e-4)


def test_encode_prompts_batches_and_stages(pipes):
    """Five prompts in chunks of two (a padded tail), staged and not: the
    same rows as encode_prompt one by one, and the reference's."""
    ref, port = pipes
    prompts = [f"prompt number {i} " * (i + 1) for i in range(5)]
    want = ref.encode_prompts(prompts, batch=2)
    single = [port.encode_prompt(p) for p in prompts]
    for stage in (False, True):
        got = port.encode_prompts(prompts, batch=2, stage=stage)
        assert len(got) == 5
        for g, s, w in zip(got, single, want):
            assert g["video"].shape == (1, port.tecfg.max_length, port.tecfg.inner_dim)
            np.testing.assert_array_equal(as_np(g["mask"]), np.asarray(w["mask"]))
            assert_rel(g["video"], w["video"], 5e-2, f"encode_prompts stage={stage}")
            # a row does not depend on its chunk's other rows, bit for bit on the CPU
            assert torch.equal(g["video"], s["video"])
    assert port.encode_prompts([]) == []


def test_staged_two_stage_releases_every_component():
    """Phase staging over the new components: the encoder and the upscaler
    come to the device for their phase and go back to the same host
    tensors; a missing upscaler or encoder raises ModelNotLoadedError."""
    port = LTXPipeline.random_tiny(device="cpu", seed=1,
                                   memory=MemoryConfig(phase_staging=True, vae_tile_size=2))
    before = {name: {n: p.data_ptr() for n, p in getattr(port, name).named_parameters()}
              for name in ("vae_encoder", "upscaler", "transformer", "vae_decoder")}
    config = GenerationConfig(width=64, height=64, num_frames=17, num_steps=2, seed=1)
    gen = torch.Generator().manual_seed(0)
    c = port.tcfg.in_channels
    half = port.encode_image(torch.rand(1, 3, 1, 32, 32, generator=gen) * 2 - 1)
    result = port.generate_video_two_stage(
        "staged", config, torch.randn(1, c, 3, 1, 1, generator=gen),
        torch.randn(1, c, 3, 2, 2, generator=gen), image_latent=half)
    assert result.frames.shape == (17, 64, 64, 3) and np.isfinite(result.frames).all()
    assert not port._host_store
    for name, ptrs in before.items():
        assert {n: p.data_ptr() for n, p in getattr(port, name).named_parameters()} == ptrs
    port.upscaler = None
    with pytest.raises(generate.ModelNotLoadedError, match="upscaler"):
        port.generate_video_two_stage("x", config, None, None)
    port.vae_encoder = None
    with pytest.raises(generate.ModelNotLoadedError, match="vae_encoder"):
        port.encode_image(np.zeros((1, 3, 1, 32, 32), np.float32))
    yuv = LTXPipeline.random_tiny(device="cpu", seed=1, memory=MemoryConfig(
        vae_tile_size=2, decode_transfer="yuv420"))
    with pytest.raises(NotImplementedError, match="A4b"):
        yuv.generate_video("x", config, torch.randn(1, c, 3, 2, 2, generator=gen))
