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

import contextlib
import dataclasses
import json
import logging
import pathlib
import types

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
from torch_parity import torch_threads
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

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
    """The port's frames export through the port's own MP4 writer."""
    from ltx_tpu_torch.io.video import export_video

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


class _StubTokenizer:
    """The reference's enhancement test tokenizer: bytes to ids (at most 128),
    and a fixed enhanced text."""

    def encode(self, text):
        return types.SimpleNamespace(ids=[(b % 90) + 4 for b in text.encode()][:128] or [4])

    def decode(self, ids):
        return "a cinematic, richly detailed scene"


@pytest.mark.parametrize("kw", [
    dict(cfg_scale=4.0), dict(stg_scale=1.0), dict(ge_gamma=0.5),
    dict(cross_attention_scale=0.5), dict(enhance_prompt=True),
    dict(two_stage=True), dict(image_path="x.png"),
])
def test_generation_knobs_run(pipes, kw, tmp_path):
    """Every knob of this list runs (the guided and image-conditioned paths,
    held against the reference in test_torch_two_stage.py; enhancement
    below and in test_torch_enhance.py; `two_stage` is a flag for callers,
    which generate_video ignores as the reference's does). Enhancement
    runs its phase with the reference's test tokenizer and times it."""
    _, port = pipes
    if "image_path" in kw:
        Image = pytest.importorskip("PIL.Image")  # load_image needs Pillow

        kw = dict(image_path=str(tmp_path / "x.png"))
        Image.fromarray(np.full((40, 56, 3), 90, np.uint8)).save(kw["image_path"])
    if "stg_scale" in kw:
        kw = dict(kw, stg_blocks=(1,))  # the default block 29 is past the tiny DiT
    config = dataclasses.replace(CONFIG, **kw)
    noise = torch.from_numpy(_reference_noise(config, port.tcfg.in_channels))
    port_with_encoder = port
    if config.image_path is not None:
        port_with_encoder = LTXPipeline.random_tiny(device="cpu", seed=0)
    if config.enhance_prompt:
        port.tokenizer = _StubTokenizer()
    try:
        with torch_threads(1) if config.enhance_prompt else contextlib.nullcontext():
            result = port_with_encoder.generate_video(PROMPT, config, noise)
    finally:
        port.tokenizer = None
    frames = result.frames
    assert frames.shape == (9, 64, 64, 3) and np.isfinite(frames).all()
    assert frames.min() >= 0.0 and frames.max() <= 1.0
    if config.enhance_prompt:
        assert result.timings.enhancement > 0 and result.timings.enhancement_tokens > 0


def _enhanced(caplog, logger):
    return [r.getMessage().removeprefix("Enhanced prompt: ") for r in caplog.records
            if r.name == logger and r.getMessage().startswith("Enhanced prompt: ")]


def test_enhanced_generate_video_with_the_cycle_gemma(pipes, caplog):
    """Both tiny pipelines with the reference's cycle Gemma in place of
    theirs (a vocabulary of 2048 for test_torch_enhance's Gemma-style
    tokenizer), enhance_prompt=True at the defaults (temperature 0.7, 512
    tokens, 8 drafts): the cycle walks the same tokens even when sampled,
    so the enhanced text is the reference's and the frames are within
    FRAME_ATOL of the reference's; the phase is timed, with no fallback.
    The batched path enhances each of its prompts too."""
    from tokenizers import Tokenizer

    from ltx_tpu.weights import synthetic as jsyn
    from ltx_tpu_torch.tokenizer import Tokenizer as PortTokenizer
    from test_torch_enhance import tokenizer_spec

    ref, port = pipes
    jgcfg = dataclasses.replace(ref.gcfg, vocab_size=2048)
    tree = jsyn.make_cycle_gemma_params(jgcfg, jax.random.key(2),
                                        cycle=jsyn.default_cycle(jgcfg, period=11),
                                        dtype=jnp.bfloat16)
    text = json.dumps(tokenizer_spec(jgcfg.vocab_size))
    saved = (ref.gemma_params, ref.gcfg, port.gemma, port.gcfg)
    ref.gemma_params, ref.gcfg, ref.tokenizer = tree, jgcfg, Tokenizer.from_str(text)
    port.gemma = convert.gemma(tree, convert.port_config(jgcfg, generate.Gemma3Config))
    port.gcfg, port.tokenizer = port.gemma.cfg, PortTokenizer.from_str(text)
    config = dataclasses.replace(CONFIG, enhance_prompt=True)
    noise = _reference_noise(config, port.tcfg.in_channels)
    try:
        with caplog.at_level(logging.INFO), torch_threads(1):
            want = ref.generate_video("a beaver", convert.port_config(
                config, jconfig.GenerationConfig))
            got = port.generate_video("a beaver", config, torch.from_numpy(noise))
            batched = port.generate_videos(["a beaver", "a fox"], config,
                                           torch.from_numpy(np.concatenate([noise, noise])))
    finally:
        ref.gemma_params, ref.gcfg, port.gemma, port.gcfg = saved
        ref.tokenizer = port.tokenizer = None
    want_text, got_text = _enhanced(caplog, "ltx_tpu"), _enhanced(caplog, "ltx_tpu_torch")
    assert got_text == want_text and len(got_text) == 1 and got_text[0] != "a beaver"
    assert "enhancement failed" not in caplog.text
    err = float(np.abs(got.frames - np.asarray(want.frames, np.float32)).max())
    print(f"[parity] enhanced generate_video vs live reference: max abs {err:.3e} "
          f"(tol {FRAME_ATOL:.0e}); enhancement {got.timings.enhancement:.2f} s, "
          f"{got.timings.enhancement_tokens} tokens in {got.timings.enhancement_forwards} "
          f"forwards")
    assert err <= FRAME_ATOL
    tm = got.timings
    assert tm.enhancement > 0 and tm.enhancement_tokens > 0 and tm.enhancement_forwards > 0
    assert len(batched) == 2 and batched[0].timings.enhancement > 0


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


def test_staged_and_tiled_pipelines_run_and_yuv420_decodes():
    """Staging keeps every component. Tiled decoding runs (one latent frame
    a tile cannot overlap by one and raises ValueError, as the reference's
    does), and so does the yuv420 transfer (held in test_torch_yuv.py)."""
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
    yuv_frames = yuv.generate_video("tiled", long, long_noise).frames
    assert yuv_frames.shape == (25, 64, 64, 3) and np.isfinite(yuv_frames).all()
    assert yuv_frames.min() >= 0.0 and yuv_frames.max() <= 1.0
