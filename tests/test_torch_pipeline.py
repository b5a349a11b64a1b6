"""Port parity end to end: ltx_tpu_torch's LTXPipeline.generate_video on the
tiny pipeline (64x64, 9 frames, seed 42, the distilled 8-step schedule),
weights converted from the reference's random_tiny(seed=0) components and
the initial noise drawn by jax.random exactly as the reference derives it
from the seed. Held against tests/goldens/tiny_t2v.npz and against a live
run of the reference on the same prompt and noise.

Tolerance: 2e-2 absolute on frames in [0, 1] (first frame and the video's
mean/std/min/max), for bf16 Gemma, connector and DiT whose roundings fall
at different places in the two frameworks; measured 9.9e-3 against the
live run and 5.3e-3 against the golden's first frame. The same 2e-2 holds
the int4 pipeline (the reference's DiT tree through
quantize_transformer_params) against a live reference run: at the tiny
widths only the FF linears are large enough to quantize, and their N or K
of 128 keeps them off the kernel route on both sides."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.core import config as jconfig
from ltx_tpu.kernels.quantization import quantize_transformer_params
from ltx_tpu.models import dit as jdit
from ltx_tpu.models import gemma3 as jgemma
from ltx_tpu.models import text_encoder as jte
from ltx_tpu.models import vae as jvae
from ltx_tpu.ops.latents import VideoLatentShape as JShape
from ltx_tpu.pipeline.generate import LTXPipeline as JaxPipeline
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import GenerationConfig, MemoryConfig, QuantizationConfig
from ltx_tpu_torch.models.common import QuantizedLinear
from ltx_tpu_torch.pipeline import generate
from ltx_tpu_torch.pipeline.generate import LTXPipeline

GOLDEN = pathlib.Path(__file__).parent / "goldens" / "tiny_t2v.npz"
FRAME_ATOL = 2e-2
PROMPT = "golden fixed-seed prompt"
CONFIG = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=42)


def _stats(frames):
    f = np.asarray(frames, np.float32)
    return np.array([f.mean(), f.std(), f.min(), f.max()], np.float32)


@pytest.fixture(scope="module")
def pipes():
    """The reference's random_tiny(seed=0) components (same keys) as a JAX
    pipeline, and the port built from the same trees. The bf16 components
    init eagerly as random_tiny does (a jitted init rounds some bf16 weights
    differently); the f32 VAE inits jitted, within 2e-8 of eager."""
    tcfg, vcfg, gcfg, tecfg = generate.tiny_configs()
    jtcfg = convert.port_config(tcfg, jconfig.TransformerConfig)
    jvcfg = convert.port_config(vcfg, jvae.VAEConfig)
    jgcfg = convert.port_config(gcfg, jgemma.Gemma3Config)
    jtecfg = convert.port_config(tecfg, jte.TextEncoderConfig)
    ks = jax.random.split(jax.random.key(0), 9)
    trees = dict(
        transformer=jdit.init_params(ks[0], jtcfg, jnp.bfloat16),
        vae=jax.jit(jvae.init_decoder_params, static_argnums=1)(ks[1], jvcfg),
        gemma=jgemma.init_params(ks[2], jgcfg, jnp.bfloat16),
        text=jte.init_params(ks[3], jtecfg, jnp.bfloat16),
    )
    ref = JaxPipeline(
        transformer_params=trees["transformer"], transformer_config=jtcfg,
        vae_decoder_params=trees["vae"], vae_config=jvcfg,
        gemma_params=trees["gemma"], gemma_config=jgcfg,
        text_encoder_params=trees["text"], text_encoder_config=jtecfg,
        memory=jconfig.MemoryConfig(offload_text_encoder=False))
    port = LTXPipeline(
        transformer=convert.transformer(trees["transformer"], tcfg),
        vae_decoder=convert.vae_decoder(trees["vae"], vcfg),
        gemma=convert.gemma(trees["gemma"], gcfg),
        text_encoder=convert.text_encoder(trees["text"], tecfg),
        memory=MemoryConfig(offload_text_encoder=False))
    return ref, port


def _reference_noise(config: GenerationConfig, channels: int) -> np.ndarray:
    """The reference's initial noise for config.seed (generate.py)."""
    shape = JShape.from_pixels(1, config.num_frames, config.height, config.width,
                               channels=channels)
    _, nkey = jax.random.split(jax.random.key(config.seed))
    return np.array(jax.random.normal(nkey, shape.shape, jnp.float32))


@pytest.fixture(scope="module")
def runs(pipes):
    ref, port = pipes
    noise = _reference_noise(CONFIG, port.tcfg.in_channels)
    ref_config = convert.port_config(CONFIG, jconfig.GenerationConfig)
    want = np.asarray(ref.generate_video(PROMPT, ref_config).frames, np.float32)
    got = port.generate_video(PROMPT, CONFIG, torch.from_numpy(noise))
    return want, got


def test_generate_video_matches_live_reference(runs):
    want, got = runs
    frames = got.frames
    assert frames.shape == want.shape == (9, 64, 64, 3)
    assert frames.dtype == np.float32 and np.isfinite(frames).all()
    assert frames.min() >= 0.0 and frames.max() <= 1.0
    err = float(np.abs(frames - want).max())
    print(f"[parity] generate_video vs live reference: max abs {err:.3e} "
          f"(tol {FRAME_ATOL:.0e})")
    assert err <= FRAME_ATOL
    assert len(got.timings.denoise_steps) == 8


def test_generate_video_int4_matches_live_reference(pipes):
    ref, port = pipes
    bf16_tree = ref.transformer_params
    tree = quantize_transformer_params(bf16_tree, 4, 64)
    int4 = LTXPipeline(
        transformer=convert.transformer(tree, port.tcfg), vae_decoder=port.vae_decoder,
        gemma=port.gemma, text_encoder=port.text_encoder,
        memory=MemoryConfig(offload_text_encoder=False))
    assert sum(isinstance(m, QuantizedLinear) for m in int4.transformer.modules()) == 4
    noise = _reference_noise(CONFIG, port.tcfg.in_channels)
    ref.transformer_params = tree
    try:
        want = np.asarray(ref.generate_video(
            PROMPT, convert.port_config(CONFIG, jconfig.GenerationConfig)).frames, np.float32)
    finally:
        ref.transformer_params = bf16_tree
    frames = int4.generate_video(PROMPT, CONFIG, torch.from_numpy(noise)).frames
    assert frames.shape == want.shape and np.isfinite(frames).all()
    err = float(np.abs(frames - want).max())
    print(f"[parity] int4 generate_video vs live reference: max abs {err:.3e} "
          f"(tol {FRAME_ATOL:.0e})")
    assert err <= FRAME_ATOL


def test_generate_video_matches_golden(runs):
    want, got = runs
    with np.load(GOLDEN) as z:
        golden_first, golden_stats = z["first_frame"], z["stats"]
    # the rebuilt reference reproduces the golden
    np.testing.assert_allclose(want[0], golden_first, atol=2e-4, rtol=2e-4)
    err_first = float(np.abs(got.frames[0] - golden_first).max())
    err_stats = float(np.abs(_stats(got.frames) - golden_stats).max())
    print(f"[parity] generate_video vs golden: first frame {err_first:.3e}, "
          f"stats {err_stats:.3e} (tol {FRAME_ATOL:.0e})")
    assert err_first <= FRAME_ATOL and err_stats <= FRAME_ATOL


def test_frames_export_to_mp4(runs, tmp_path):
    """The port's frames are in the layout ltx_tpu.io.video exports."""
    from ltx_tpu.io.video import export_video

    path = export_video(runs[1].frames, str(tmp_path / "clip.mp4"), fps=24.0)
    assert (tmp_path / "clip.mp4").stat().st_size > 0 and path.endswith("clip.mp4")


def test_tokenize_and_encode_prompt_match(pipes):
    ref, port = pipes
    ids, mask = port.tokenize(PROMPT)
    jids, jmask = ref.tokenize(PROMPT)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    got = port.encode_prompt(PROMPT)
    want = ref.encode_prompt(PROMPT)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    err = float(np.abs(got["video"].float().numpy()
                       - np.asarray(want["video"], np.float32)).max())
    scale = float(np.abs(np.asarray(want["video"], np.float32)).max())
    print(f"[parity] encode_prompt bf16: {err / scale:.3e} (tol 5e-2)")
    assert err <= 5e-2 * scale


@pytest.mark.parametrize("kw", [
    dict(cfg_scale=4.0), dict(stg_scale=1.0), dict(ge_gamma=0.5),
    dict(cross_attention_scale=0.5), dict(enhance_prompt=True),
    dict(two_stage=True), dict(image_path="x.png"),
])
def test_unported_configs_raise(pipes, kw, tmp_path):
    """Prompt enhancement is the one generation knob still to port (ROADMAP
    A13) and raises; every other knob of this list now runs (the guided and
    image-conditioned paths, held against the reference in
    test_torch_two_stage.py; `two_stage` is a flag for callers, which
    generate_video ignores as the reference's does)."""
    _, port = pipes
    if "image_path" in kw:
        Image = pytest.importorskip("PIL.Image")  # load_image needs Pillow

        kw = dict(image_path=str(tmp_path / "x.png"))
        Image.fromarray(np.full((40, 56, 3), 90, np.uint8)).save(kw["image_path"])
    if "stg_scale" in kw:
        kw = dict(kw, stg_blocks=(1,))  # the default block 29 is past the tiny DiT
    config = dataclasses.replace(CONFIG, **kw)
    if config.enhance_prompt:
        with pytest.raises(NotImplementedError, match="A13"):
            port.generate_video(PROMPT, config, torch.zeros(1, port.tcfg.in_channels, 2, 2, 2))
        return
    noise = torch.from_numpy(_reference_noise(config, port.tcfg.in_channels))
    port_with_encoder = port
    if config.image_path is not None:
        port_with_encoder = LTXPipeline.random_tiny(device="cpu", seed=0)
    frames = port_with_encoder.generate_video(PROMPT, config, noise).frames
    assert frames.shape == (9, 64, 64, 3) and np.isfinite(frames).all()
    assert frames.min() >= 0.0 and frames.max() <= 1.0


def test_staged_int4_pipeline_keeps_its_codes_on_the_host():
    """Phase staging with an int4 DiT: quantized on the pipeline's device,
    moved there for the denoise phase and released back to the same host
    tensors, uint8 codes and f32 scales unchanged."""
    port = LTXPipeline.random_tiny(device="cpu", seed=1,
                                   memory=MemoryConfig(phase_staging=True),
                                   quantization=QuantizationConfig(mode="int4"))
    layer = port.transformer.blocks[0].ff.project_in
    assert isinstance(layer, QuantizedLinear) and not layer.w_q4.requires_grad
    before = {n: (p.data_ptr(), p.dtype) for n, p in port.transformer.named_parameters()}
    noise = torch.randn(1, port.tcfg.in_channels, 2, 2, 2,
                        generator=torch.Generator().manual_seed(0))
    result = port.generate_video("staged int4", CONFIG, noise)
    assert result.frames.shape == (9, 64, 64, 3) and np.isfinite(result.frames).all()
    for n, p in port.transformer.named_parameters():
        assert (p.data_ptr(), p.dtype) == before[n], n
    assert (layer.w_q4.dtype, layer.scale.dtype) == (torch.uint8, torch.float32)


def test_staged_pipeline_runs_and_tiling_raises():
    """Staging keeps every component. Tiled decoding now runs (one latent
    frame a tile cannot overlap by one and raises ValueError, as the
    reference's does); the yuv420 transfer raises, naming ROADMAP A4b."""
    port = LTXPipeline.random_tiny(device="cpu", seed=1,
                                   memory=MemoryConfig(phase_staging=True))
    noise = torch.randn(1, port.tcfg.in_channels, 2, 2, 2,
                        generator=torch.Generator().manual_seed(0))
    result = port.generate_video("staged", CONFIG, noise)
    assert result.frames.shape == (9, 64, 64, 3) and np.isfinite(result.frames).all()
    assert port.gemma is not None  # staging keeps every component
    tiled = LTXPipeline.random_tiny(device="cpu", seed=1,
                                    memory=MemoryConfig(vae_tile_size=1))
    with pytest.raises(ValueError, match="vae_tile_overlap"):
        tiled.generate_video("tiled", CONFIG, noise)
    long = dataclasses.replace(CONFIG, num_frames=25)
    long_noise = torch.randn(1, port.tcfg.in_channels, 4, 2, 2,
                             generator=torch.Generator().manual_seed(0))
    tiled = LTXPipeline.random_tiny(device="cpu", seed=1, memory=MemoryConfig(
        vae_tile_size=2, phase_staging=True))
    frames = tiled.generate_video("tiled", long, long_noise).frames
    assert frames.shape == (25, 64, 64, 3) and np.isfinite(frames).all()
    assert tiled.decode_tile_frames(4) == [2, 2, 2]
    yuv = LTXPipeline.random_tiny(device="cpu", seed=1, memory=MemoryConfig(
        vae_tile_size=2, decode_transfer="yuv420"))
    with pytest.raises(NotImplementedError, match="A4b"):
        yuv.generate_video("tiled", long, long_noise)
