"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; outputs
come back as float32 numpy arrays and are compared by the largest absolute
error relative to the reference's largest magnitude.
"""

import contextlib

import numpy as np
import pytest
import torch


def as_np(x) -> np.ndarray:
    """A torch tensor or a jax/numpy array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def as_torch(x, dtype=torch.float32) -> torch.Tensor:
    """numpy -> torch on the CPU, rounded to `dtype` (bf16 rounds to
    nearest even, as jnp.asarray(x, jnp.bfloat16) does)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (max |want| floored at 1e-30)."""
    g, w = as_np(got), as_np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.isfinite(g).all(), "non-finite values in the port's output"
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def assert_rel(got, want, tol: float, what: str) -> float:
    err = rel_err(got, want)
    print(f"[parity] {what}: {err:.3e} (tol {tol:.1e})")
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol:.1e}"
    return err


def reference_int4_kernel_route(monkeypatch) -> list:
    """Make ltx_tpu's linear_any take its int4 kernel route on the CPU, as
    it does on a TPU: `_use_pallas_int4` becomes the shape rule alone and
    `int4_matmul` runs in Pallas interpret mode. Returns a list that gains
    one entry each time the reference traces or calls the kernel."""
    from ltx_tpu.kernels import quantization as jq

    tiles = (1024, 768, 512, 256)
    calls = []

    def shape_rule(p, x):
        return bool("w_q4" in p and jq._pick_block(x.shape[-1], tiles)
                    and jq._pick_block(p["w_q4"].shape[1], tiles)
                    and x.shape[-1] % jq.PACK_BLOCK == 0)

    def interpreted(p, x):
        calls.append(tuple(x.shape))
        return kernel(p, x, interpret=True)

    kernel = jq.int4_matmul
    monkeypatch.setattr(jq, "_use_pallas_int4", shape_rule)
    monkeypatch.setattr(jq, "int4_matmul", interpreted)
    return calls


@contextlib.contextmanager
def jitted_shard_map():
    """For the duration, every jax.shard_map the reference builds is jitted:
    its decode_video_sharded calls one eagerly, which on the CPU runs op by
    op (about 23 s a call at the tiny decoder, 2 s jitted). The program is
    the same; only its dispatch changes."""
    import jax

    plain = jax.shard_map

    def jitted(*args, **kwargs):
        return jax.jit(plain(*args, **kwargs))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "shard_map", jitted)
        yield


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to `n` for the duration. The generation
    loops run thousands of small ops a token; when six test workers share
    the cores, each process's default of one thread a core oversubscribes
    them and every small op waits on the others (one file took 290 s under
    such load, 24 s on one thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a whole test module, its module fixtures
    included: a test file imports this fixture by name to make it autouse
    there. The parity files run many small ops; under six test workers
    each process's default of one thread a core oversubscribes the cores
    (a chain file went from 40 s alone to 486 s so)."""
    with torch_threads(1):
        yield


# ---------------------------------------------------------------------------
# The reference's draws. Every random draw the port takes as a tensor, as
# ltx_tpu derives it from config.seed with jax.random (jax is imported inside
# each helper: the module serves tests that do not need it too).
# ---------------------------------------------------------------------------


def jax_normal(key, shape) -> torch.Tensor:
    """jax.random.normal(key, shape) in float32, as a CPU tensor."""
    import jax
    import jax.numpy as jnp

    return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))


def loop_draws(dkey, steps: int, shape) -> list:
    """The re-noise draws of a conditioned latent: run_denoise_loop splits
    its key once a step and the step draws normal(sub, shape)."""
    import jax

    draws, key = [], dkey
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws.append(jax_normal(sub, shape))
    return draws


def av_loop_draws(dkey, steps: int, shape, audio_shape=None):
    """The dual loop's re-noise draws: (video draws, audio draws or None).
    run_av_denoise_loop splits its key once a step; the step draws the
    video's normal(sub, shape) and the audio's normal(fold_in(sub, 1),
    audio_shape)."""
    import jax

    video, audio, key = [], [], dkey
    for _ in range(steps):
        key, sub = jax.random.split(key)
        video.append(jax_normal(sub, shape))
        if audio_shape is not None:
            audio.append(jax_normal(jax.random.fold_in(sub, 1), audio_shape))
    return video, (audio if audio_shape is not None else None)


def video_keys(seed: int):
    """generate_video's keys from a seed (a chain segment's from seed + i):
    (initial noise, denoise loop, decode)."""
    import jax

    key = jax.random.key(seed)
    key, nkey = jax.random.split(key)
    key, dkey = jax.random.split(key)
    key, vkey = jax.random.split(key)
    return nkey, dkey, vkey


def av_keys(seed: int):
    """generate_video_with_audio's keys from a seed (an audio chain
    segment's from seed + i): (video noise, audio noise, denoise loop,
    decode)."""
    import jax

    key = jax.random.key(seed)
    key, vkey, akey, dkey = jax.random.split(key, 4)
    key, dvkey = jax.random.split(key)
    return vkey, akey, dkey, dvkey


def reference_and_port(include_audio: bool = False):
    """The reference's random_tiny(seed=0[, include_audio=True]) components
    (the same keys) as a JAX pipeline, and the port built from the same
    trees, on the CPU; neither drops its text encoder after a run. The bf16
    components init eagerly as random_tiny does (a jitted init rounds some
    bf16 weights differently); the f32 ones (VAE, upscaler, audio VAE,
    vocoder) init jitted, within 2e-8 of eager, in a fraction of the time."""
    import jax
    import jax.numpy as jnp

    from ltx_tpu.core import config as jconfig
    from ltx_tpu.models import audio_vae as jaudio
    from ltx_tpu.models import dit as jdit
    from ltx_tpu.models import dit_av as jav
    from ltx_tpu.models import gemma3 as jgemma
    from ltx_tpu.models import text_encoder as jte
    from ltx_tpu.models import upscaler as jup
    from ltx_tpu.models import vae as jvae
    from ltx_tpu.pipeline.generate import LTXPipeline as JaxPipeline
    from ltx_tpu_torch import convert
    from ltx_tpu_torch.config import MemoryConfig
    from ltx_tpu_torch.pipeline import generate
    from ltx_tpu_torch.pipeline.generate import LTXPipeline

    tcfg, vcfg, gcfg, tecfg = generate.tiny_configs()
    ucfg = generate.tiny_upscaler_config(tcfg)
    jt = convert.port_config(tcfg, jconfig.TransformerConfig)
    jv = convert.port_config(vcfg, jvae.VAEConfig)
    jg = convert.port_config(gcfg, jgemma.Gemma3Config)
    jte_cfg = convert.port_config(tecfg, jte.TextEncoderConfig)
    ju = convert.port_config(ucfg, jup.UpscalerConfig)
    ks = jax.random.split(jax.random.key(0), 9)

    def jit(init, key, cfg):
        return jax.jit(init, static_argnums=1)(key, cfg)

    audio = {}
    if include_audio:
        jac, jvoc = jaudio.AudioVAEConfig().tiny(), jaudio.VocoderConfig().tiny()
        audio = dict(av_transformer_params=jav.init_params(ks[6], jt, jnp.bfloat16),
                     audio_vae_params=jit(jaudio.init_audio_vae_params, ks[7], jac),
                     audio_vae_config=jac,
                     vocoder_params=jit(jaudio.init_vocoder_params, ks[8], jvoc),
                     vocoder_config=jvoc)
    ref = JaxPipeline(
        transformer_params=jdit.init_params(ks[0], jt, jnp.bfloat16), transformer_config=jt,
        vae_decoder_params=jit(jvae.init_decoder_params, ks[1], jv), vae_config=jv,
        gemma_params=jgemma.init_params(ks[2], jg, jnp.bfloat16), gemma_config=jg,
        text_encoder_params=jte.init_params(ks[3], jte_cfg, jnp.bfloat16,
                                            include_audio=include_audio),
        text_encoder_config=jte_cfg,
        vae_encoder_params=jit(jvae.init_encoder_params, ks[4], jv),
        upscaler_params=jit(jup.init_params, ks[5], ju), upscaler_config=ju,
        memory=jconfig.MemoryConfig(offload_text_encoder=False), **audio)
    port_audio = {}
    if include_audio:
        port_audio = dict(
            av_transformer=convert.av_transformer(ref.av_transformer_params, tcfg),
            audio_vae=convert.audio_vae(ref.audio_vae_params, ref.audio_vae_config),
            vocoder=convert.vocoder(ref.vocoder_params, ref.vocoder_config))
    port = LTXPipeline(
        transformer=convert.transformer(ref.transformer_params, tcfg),
        vae_decoder=convert.vae_decoder(ref.vae_decoder_params, vcfg),
        gemma=convert.gemma(ref.gemma_params, gcfg),
        text_encoder=convert.text_encoder(ref.text_encoder_params, tecfg),
        vae_encoder=convert.vae_encoder(ref.vae_encoder_params, vcfg),
        upscaler=convert.upscaler(ref.upscaler_params, ucfg),
        memory=MemoryConfig(offload_text_encoder=False), device="cpu", **port_audio)
    return ref, port
