"""Files to frames with audio: the port's `load_pipeline(include_audio=True)`
against the reference's on the same checkpoint files
(tests/test_load_pipeline_e2e.py::_write_full_models_dir: the unified file
with the dual DiT (a superset of the video DiT's keys) and the audio
connector, the audio VAE's and the vocoder's files).

* bf16: every component the port loads (the video DiT, the dual DiT, the
  text encoder with its audio connector, the audio VAE, the vocoder) equals,
  bit for bit, `convert` of the reference's tree; generate_video_with_audio
  with the reference's draws matches its frames within 2e-2 and its
  waveform within 5e-2 abs (test_torch_audio_pipeline's tolerances).
* int4 and W8A8: the port's dual DiT equals the reference's bit for bit,
  and an `av-{mode}` cache written by either package loads in the other
  without quantizing again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

import ltx_tpu.kernels.quantization as jqz
from ltx_tpu.core import config as jconfig
from ltx_tpu.ops.latents import VideoLatentShape as JShape
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import (AudioVAEConfig, GenerationConfig, LTXModel, MemoryConfig,
                                  QuantizationConfig, TransformerConfig, VocoderConfig)
from ltx_tpu_torch.models.common import QuantizedLinear, W8A8Linear
from ltx_tpu_torch.models.text_encoder import TextEncoderConfig
from ltx_tpu_torch.models.vae import VAEConfig
from ltx_tpu_torch.pipeline import loader
from ltx_tpu_torch.weights import qcache
from tests import test_load_pipeline_e2e as e2e
from test_torch_loader import assert_same_params

ACFG, VOCCFG = AudioVAEConfig().tiny(), VocoderConfig().tiny()


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    base, cfgs, (_, avcfg, voccfg) = e2e._write_full_models_dir(
        tmp_path_factory.mktemp("ckpt_audio"))
    assert convert.port_config(avcfg, AudioVAEConfig) == ACFG
    return base, cfgs


def _port_load(models_dir, **kw):
    base, (tcfg, _, tecfg, vcfg) = models_dir
    return loader.load_pipeline(
        model=LTXModel.DISTILLED, models_dir=str(base), include_audio=True, device="cpu",
        memory=MemoryConfig(offload_text_encoder=False), gemma_quant="bf16",
        transformer_config=convert.port_config(tcfg, TransformerConfig),
        vae_config=convert.port_config(vcfg, VAEConfig),
        text_encoder_config=convert.port_config(tecfg, TextEncoderConfig),
        audio_vae_config=ACFG, vocoder_config=VOCCFG, **kw)


def _ref_load(models_dir, **kw):
    base, cfgs = models_dir
    ref = e2e._load(base, cfgs, gemma_quant="bf16", include_audio=True, **kw)
    ref.audio_vae_config = convert.port_config(ACFG, type(ref.audio_vae_config))
    ref.vocoder_config = convert.port_config(VOCCFG, type(ref.vocoder_config))
    return ref


def _tcfg(models_dir):
    return convert.port_config(models_dir[1][0], TransformerConfig)


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))


def test_audio_load_is_the_references_to_frames_and_waveform(models_dir):
    ref, port = _ref_load(models_dir), _port_load(models_dir)
    tcfg = _tcfg(models_dir)
    tecfg = convert.port_config(models_dir[1][2], TextEncoderConfig)
    assert_same_params(port.av_transformer,
                       convert.av_transformer(ref.av_transformer_params, tcfg))
    assert_same_params(port.transformer, convert.transformer(ref.transformer_params, tcfg))
    assert port.text_encoder.has_audio
    assert_same_params(port.text_encoder,
                       convert.text_encoder(ref.text_encoder_params, tecfg))
    assert_same_params(port.audio_vae, convert.audio_vae(ref.audio_vae_params, ACFG))
    assert_same_params(port.vocoder, convert.vocoder(ref.vocoder_params, VOCCFG))

    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=10)
    want = ref.generate_video_with_audio("a cat plays piano",
                                         convert.port_config(config, jconfig.GenerationConfig))
    key = jax.random.key(config.seed)
    _, vkey, akey, _ = jax.random.split(key, 4)
    shape = JShape.from_pixels(1, 9, 64, 64, channels=tcfg.in_channels)
    got = port.generate_video_with_audio(
        "a cat plays piano", config, _normal(vkey, shape.shape),
        _normal(akey, port.audio_noise_shape(config)))
    frames = float(np.abs(got.frames - np.asarray(want.frames)).max())
    audio = float(np.abs(got.audio - np.asarray(want.audio)).max())
    print(f"[parity] load_pipeline(include_audio=True) frames {frames:.3e} (tol 2e-02), "
          f"waveform {audio:.3e} (tol 5e-02)")
    assert got.audio.shape == np.asarray(want.audio).shape
    assert frames <= 2e-2 and audio <= 5e-2


def _refuse(*a, **kw):
    raise AssertionError("quantized again although the cache holds the tree")


@pytest.mark.parametrize("mode,cls", [("int4", QuantizedLinear), ("w8a8", W8A8Linear)])
def test_quantized_dual_dit_and_its_cache_across_packages(models_dir, monkeypatch, mode,
                                                          cls):
    base, _ = models_dir
    unified = base / "ltx-distilled" / LTXModel.DISTILLED.unified_weights_filename
    caches = [qcache.cache_path(unified, f"{c}-{mode}") for c in ("av", "dit")]
    for c in caches:
        c.unlink(missing_ok=True)
    jq = jconfig.QuantizationConfig(mode=mode)
    tcfg = _tcfg(models_dir)

    # the port writes both caches; the reference reads them and quantizes nothing
    port = _port_load(models_dir, quantization=QuantizationConfig(mode=mode))
    assert all(c.exists() for c in caches)
    # of the tiny dual DiT's linears, the video feed-forward's two pass the size gate
    assert sum(isinstance(m, cls) for m in port.av_transformer.modules()) == \
        2 * tcfg.num_layers
    monkeypatch.setattr(jqz, "quantize_transformer_params", _refuse)
    monkeypatch.setattr(jqz, "quantize_dit_params", _refuse)
    ref = _ref_load(models_dir, quantization=jq)
    assert_same_params(port.av_transformer,
                       convert.av_transformer(ref.av_transformer_params, tcfg))
    monkeypatch.undo()

    # the reference writes them; the port reads them and quantizes nothing
    for c in caches:
        c.unlink()
    fresh = _ref_load(models_dir, quantization=jq)
    assert all(c.exists() for c in caches)
    monkeypatch.setattr(loader, "_fuse_and_quantize", _refuse)
    hit = _port_load(models_dir, quantization=QuantizationConfig(mode=mode))
    assert_same_params(hit.av_transformer,
                       convert.av_transformer(fresh.av_transformer_params, tcfg))
    for c in caches:
        c.unlink()
