"""Files to frames: the port's `load_pipeline` against the reference's on the
same checkpoint files (tests/test_load_pipeline_e2e.py::_write_models_dir:
the unified file with the DiT, the connector in format 2 and the VAE
decoder; a Gemma snapshot with config.json and a tokenizer.json; the
standalone files), plus a rank-4 LoRA over the DiT's block linears and a
top-level one.

* bf16: every component the port loads equals, bit for bit, `convert` of
  the reference's tree; the tokenizer gives the same ids; generate_video
  with the reference's initial noise matches the reference's frames within
  2e-2 abs (test_torch_pipeline.py's tolerance).
* int4 with the LoRA fused before quantization: the port's DiT equals the
  reference's bit for bit (the rank-4 delta is bit for bit, see
  test_torch_lora_fuse.py); a quantized-weight cache written by either
  package loads in the other without quantizing again.
* With the reference's defaults the port loads Gemma as W8A8, equal bit for
  bit to the reference's, and its frames match within 2e-2 abs; the
  `gemma-w8a8` (with the int8 token table), `gemma-int4` and `dit-w8a8`
  caches cross between the packages without a second preparation; the
  W8A8 DiT equals the reference's bit for bit.
* train.cli --weights builds the keymaps' DiT and takes one step.
* With a unified file holding the DiT alone, the standalone connector
  (format 1) and VAE files (decoder and encoder) stand in, and the VAE
  config.json's timestep_conditioning is honoured, as in the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

from ltx_tpu.core import config as jconfig
from ltx_tpu.ops.latents import VideoLatentShape as JShape
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import GenerationConfig, LTXModel, MemoryConfig, QuantizationConfig
from ltx_tpu_torch.models.common import W8A8Linear
from ltx_tpu_torch.models.gemma3 import Gemma3Config
from ltx_tpu_torch.models.text_encoder import TextEncoderConfig
from ltx_tpu_torch.models.vae import VAEConfig
from ltx_tpu_torch.pipeline import loader
from ltx_tpu_torch.train import cli
from ltx_tpu_torch.train.data import write_shard
from ltx_tpu_torch.weights import keymaps, qcache, safetensors_io
from tests import test_load_pipeline_e2e as e2e

FRAME_ATOL = 2e-2
PROMPT = "a cat plays piano"
CONFIG = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=5)


def _bits(t):
    t = torch.as_tensor(t).detach().contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else (
        t.view(torch.int32) if t.dtype == torch.float32 else t)


def assert_same_params(got, want):
    a, b = dict(got.named_parameters()), dict(want.named_parameters())
    assert sorted(a) == sorted(b)
    for n in b:
        assert a[n].dtype == b[n].dtype and torch.equal(_bits(a[n]), _bits(b[n])), n


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    """The reference test's models directory, and a LoRA file beside it."""
    base, cfgs = e2e._write_models_dir(tmp_path_factory.mktemp("ckpt"))
    tcfg = cfgs[0]
    rng = np.random.default_rng(0)
    d, f = tcfg.inner_dim, tcfg.ffn_dim
    tensors = {}
    for key, (o, i) in {**{f"diffusion_model.transformer_blocks.{b}.{m}": s
                           for b in range(tcfg.num_layers)
                           for m, s in (("attn1.to_q", (d, d)), ("attn2.to_v", (d, d)),
                                        ("ff.net.0.proj", (f, d)), ("ff.net.2", (d, f)))},
                        "diffusion_model.proj_out": (tcfg.out_channels, d)}.items():
        tensors[f"{key}.lora_down.weight"] = (rng.standard_normal((4, i)) * 0.1).astype(
            np.float32)
        tensors[f"{key}.lora_up.weight"] = (rng.standard_normal((o, 4)) * 0.1).astype(
            np.float32)
        tensors[f"{key}.alpha"] = np.float32(2.0)
    lora_path = base / "user-lora.safetensors"
    safetensors_io.save(tensors, lora_path)
    return base, cfgs, lora_path


def _port_cfgs(cfgs):
    tcfg, gcfg, tecfg, vcfg = cfgs
    return dict(transformer_config=convert.port_config(tcfg, type(loader.TransformerConfig())),
                vae_config=convert.port_config(vcfg, VAEConfig),
                text_encoder_config=convert.port_config(tecfg, TextEncoderConfig))


def _load_both(models_dir, gemma_quant="bf16", **kw):
    base, cfgs, _ = models_dir
    ref = e2e._load(base, cfgs, gemma_quant=gemma_quant, **kw)
    jq = kw.pop("quantization", None)
    port_kw = dict(kw)
    if jq is not None:
        port_kw["quantization"] = QuantizationConfig(mode=jq.mode, group_size=jq.group_size)
    port = loader.load_pipeline(model=LTXModel.DISTILLED, models_dir=str(base),
                                memory=MemoryConfig(offload_text_encoder=False),
                                device="cpu", gemma_quant=gemma_quant, **_port_cfgs(cfgs),
                                **port_kw)
    return ref, port


@pytest.fixture(scope="module")
def bf16_pipes(models_dir):
    return _load_both(models_dir)


def test_bf16_components_equal_convert_of_reference(bf16_pipes, models_dir):
    ref, port = bf16_pipes
    _, cfgs, _ = models_dir
    tcfg, gcfg, tecfg, vcfg = (convert.port_config(c, cls) for c, cls in zip(
        cfgs, (type(loader.TransformerConfig()), Gemma3Config, TextEncoderConfig, VAEConfig)))
    assert_same_params(port.transformer, convert.transformer(ref.transformer_params, tcfg))
    assert_same_params(port.vae_decoder, convert.vae_decoder(ref.vae_decoder_params, vcfg))
    assert_same_params(port.text_encoder, convert.text_encoder(ref.text_encoder_params, tecfg))
    assert_same_params(port.gemma, convert.gemma(ref.gemma_params, gcfg))
    assert port.vae_encoder is None and ref.vae_encoder_params is None
    assert dataclasses.asdict(port.gcfg) == dataclasses.asdict(
        convert.port_config(ref.gcfg, Gemma3Config))
    assert port.is_distilled == ref.is_distilled
    for prompt in (PROMPT, "a dog plays the cat's piano", "é unknown 🦫 words"):
        ids, mask = port.tokenize(prompt)
        jids, jmask = ref.tokenize(prompt)
        assert np.array_equal(ids.numpy(), np.asarray(jids)) and \
            np.array_equal(mask.numpy(), np.asarray(jmask))


def _frames_match(ref, port, what: str):
    shape = JShape.from_pixels(1, CONFIG.num_frames, CONFIG.height, CONFIG.width,
                               channels=port.tcfg.in_channels)
    _, nkey = jax.random.split(jax.random.key(CONFIG.seed))
    noise = np.array(jax.random.normal(nkey, shape.shape, jnp.float32))
    want = np.asarray(ref.generate_video(
        PROMPT, convert.port_config(CONFIG, jconfig.GenerationConfig)).frames, np.float32)
    got = port.generate_video(PROMPT, CONFIG, torch.from_numpy(noise)).frames
    assert got.shape == want.shape == (9, 64, 64, 3) and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    print(f"[parity] {what} vs reference: max abs {err:.3e} (tol {FRAME_ATOL:.0e})")
    assert err <= FRAME_ATOL


def test_bf16_files_to_frames_match_reference(bf16_pipes):
    ref, port = bf16_pipes
    _frames_match(ref, port, "load_pipeline -> generate_video")


def _gemma_cfg(models_dir):
    return convert.port_config(models_dir[1][1], Gemma3Config)


def test_default_load_is_the_references_w8a8_gemma_to_frames(models_dir):
    """load_pipeline with the reference's defaults: Gemma as W8A8, its
    cache written beside the snapshot; it equals `convert` of the
    reference's gemma_quant="w8a8" tree, and the frames match."""
    base, cfgs, _ = models_dir
    cache = qcache.cache_path(base / "vlm-gemma", "gemma-w8a8")
    cache.unlink(missing_ok=True)
    ref = e2e._load(base, cfgs, gemma_quant="w8a8", quant_cache=False)
    port = loader.load_pipeline(models_dir=str(base), device="cpu", **_port_cfgs(cfgs))
    assert cache.exists()
    assert_same_params(port.gemma, convert.gemma(ref.gemma_params, _gemma_cfg(models_dir)))
    assert sum(isinstance(m, W8A8Linear) for m in port.gemma.modules()) == \
        7 * port.gcfg.hidden_layers
    _frames_match(ref, port, "load_pipeline defaults (W8A8 Gemma) -> generate_video")
    cache.unlink()


def _refuse(*a, **kw):
    raise AssertionError("prepared again although the cache holds the tree")


@pytest.mark.parametrize("mode,embed_int8", [("w8a8", True), ("int4", False)])
def test_gemma_cache_across_packages(models_dir, monkeypatch, mode, embed_int8):
    """A `gemma-{mode}` cache written by either package loads in the other
    without the key map running again, to the same model."""
    import ltx_tpu.weights.keymaps as jkeymaps

    base, cfgs, _ = models_dir
    cache = qcache.cache_path(base / "vlm-gemma", f"gemma-{mode}")
    cache.unlink(missing_ok=True)
    kw = dict(gemma_quant=mode, gemma_embed_int8=embed_int8)
    first = loader.LoadTimings()
    port = loader.load_pipeline(models_dir=str(base), device="cpu", timings=first,
                                **_port_cfgs(cfgs), **kw)
    assert cache.exists() and not first.gemma_cache_hit
    monkeypatch.setattr(jkeymaps, "load_gemma_params", _refuse)
    ref = e2e._load(base, cfgs, **kw)
    assert_same_params(port.gemma, convert.gemma(ref.gemma_params, _gemma_cfg(models_dir)))
    monkeypatch.undo()

    cache.unlink()
    e2e._load(base, cfgs, **kw)
    assert cache.exists()
    monkeypatch.setattr(keymaps, "load_gemma_params", _refuse)
    again = loader.LoadTimings()
    hit = loader.load_pipeline(models_dir=str(base), device="cpu", timings=again,
                               **_port_cfgs(cfgs), **kw)
    assert again.gemma_cache_hit
    assert_same_params(hit.gemma, port.gemma)
    cache.unlink()


def test_w8a8_dit_and_its_cache_across_packages(models_dir, monkeypatch):
    """QuantizationConfig(mode="w8a8"): the port's DiT equals the
    reference's bit for bit, and a `dit-w8a8` cache written by the port
    loads in the reference without quantizing again."""
    import ltx_tpu.kernels.quantization as jqz

    base, cfgs, _ = models_dir
    unified = base / "ltx-distilled" / LTXModel.DISTILLED.unified_weights_filename
    cache = qcache.cache_path(unified, "dit-w8a8")
    cache.unlink(missing_ok=True)
    tcfg = convert.port_config(cfgs[0], type(loader.TransformerConfig()))
    ref, _ = _load_both(models_dir, quantization=jconfig.QuantizationConfig(mode="w8a8"),
                        quant_cache=False)
    want = convert.transformer(ref.transformer_params, tcfg)
    port = loader.load_pipeline(models_dir=str(base), device="cpu", gemma_quant="bf16",
                                quantization=QuantizationConfig(mode="w8a8"),
                                **_port_cfgs(cfgs))
    assert cache.exists()
    assert_same_params(port.transformer, want)
    assert sum(isinstance(m, W8A8Linear) for m in port.transformer.modules()) == 4
    monkeypatch.setattr(jqz, "quantize_dit_params", _refuse)
    again = e2e._load(base, cfgs, gemma_quant="bf16",
                      quantization=jconfig.QuantizationConfig(mode="w8a8"))
    assert_same_params(convert.transformer(again.transformer_params, tcfg), want)
    cache.unlink()


def test_int4_with_lora_and_the_cache_across_packages(models_dir, monkeypatch):
    base, cfgs, lora_path = models_dir
    unified = base / "ltx-distilled" / LTXModel.DISTILLED.unified_weights_filename
    cache = qcache.cache_path(unified, "dit-int4")
    jq = jconfig.QuantizationConfig(mode="int4")
    tcfg = convert.port_config(cfgs[0], type(loader.TransformerConfig()))

    # no cache: both fuse then quantize; the reference writes the cache
    cache.unlink(missing_ok=True)
    ref, port = _load_both(models_dir, quantization=jq, lora_path=str(lora_path),
                           quant_cache=False)
    assert not cache.exists()
    want = convert.transformer(ref.transformer_params, tcfg)
    assert_same_params(port.transformer, want)
    assert sum(type(m).__name__ == "QuantizedLinear" for m in port.transformer.modules()) == 4

    def no_quantizing(*a, **kw):
        raise AssertionError("quantized again although the cache holds the tree")

    # the reference's cache -> the port, without quantizing
    e2e._load(base, cfgs, gemma_quant="bf16", quantization=jq, lora_path=str(lora_path))
    assert cache.exists()
    monkeypatch.setattr(loader, "_fuse_and_quantize", no_quantizing)
    timings = loader.LoadTimings()
    hit = loader.load_pipeline(models_dir=str(base), device="cpu", quantization=QuantizationConfig(
        mode="int4"), lora_path=str(lora_path), timings=timings, gemma_quant="bf16",
        **_port_cfgs(cfgs))
    assert timings.cache_hit
    assert_same_params(hit.transformer, want)
    monkeypatch.undo()

    # the port's cache -> the reference, without quantizing
    cache.unlink()
    loader.load_pipeline(models_dir=str(base), device="cpu",
                         quantization=QuantizationConfig(mode="int4"),
                         lora_path=str(lora_path), gemma_quant="bf16", **_port_cfgs(cfgs))
    assert cache.exists()
    import ltx_tpu.kernels.quantization as jqz
    import ltx_tpu.lora.fuse as jfuse

    monkeypatch.setattr(jqz, "quantize_dit_params", no_quantizing)
    monkeypatch.setattr(jfuse, "fuse_lora_file", no_quantizing)
    again = e2e._load(base, cfgs, gemma_quant="bf16", quantization=jq,
                      lora_path=str(lora_path))
    assert_same_params(convert.transformer(again.transformer_params, tcfg), want)
    cache.unlink()


def test_train_cli_weights_builds_the_keymaps_dit_and_steps(models_dir, tmp_path):
    base, cfgs, _ = models_dir
    unified = base / "ltx-distilled" / LTXModel.DISTILLED.unified_weights_filename
    state, cfg, _ = cli._load_base(unified)
    want = keymaps.load_transformer_params(
        keymaps.split_unified(safetensors_io.load(unified))[0], cfgs[0].num_layers)
    assert sorted(state) == sorted(want) and all(
        torch.equal(_bits(state[k]), _bits(want[k])) for k in want)
    assert (cfg.num_layers, cfg.inner_dim, cfg.in_channels, cfg.caption_channels) == (
        cfgs[0].num_layers, cfgs[0].inner_dim, cfgs[0].in_channels, cfgs[0].caption_channels)
    rng = np.random.default_rng(1)
    (tmp_path / "data").mkdir()
    write_shard(tmp_path / "data" / "s.npz",
                rng.standard_normal((2, 8, cfg.in_channels)).astype(np.float32),
                rng.standard_normal((2, 8, cfg.caption_channels)).astype(np.float32),
                (2, 2, 2))
    reports = []
    assert cli.main(["--data", str(tmp_path / "data"), "--out", str(tmp_path / "a.safetensors"),
                     "--weights", str(unified), "--quant", "none", "--rank", "2", "--steps", "1",
                     "--device", "cpu"], reports.append) == 0
    assert np.isfinite(reports[-1]["loss"]) and reports[0]["setup"]["load_s"] >= 0


def test_standalone_files_and_the_vae_config_flag(tmp_path):
    """A unified file holding the DiT alone: the connector comes from the
    standalone connector file (format 1), the VAE decoder and the encoder
    from the standalone VAE file, and config.json's timestep_conditioning
    is honoured; every component equals `convert` of the reference's."""
    import json

    import tests.weight_fixtures as wf

    base, cfgs = e2e._write_models_dir(tmp_path)
    tcfg, gcfg, tecfg, vcfg = cfgs
    b = vcfg.latent_channels
    vcfg = dataclasses.replace(vcfg, encoder_channels=(b, 2 * b, 4 * b, 8 * b, 16 * b),
                               encoder_resnets=(4, 6, 6, 2))
    unified = base / "ltx-distilled" / LTXModel.DISTILLED.unified_weights_filename
    dit = {k: v for k, v in safetensors_io.load(unified).items()
           if k.startswith("model.diffusion_model.transformer_blocks")
           or k.split(".")[2] in ("proj_in", "time_embed", "caption_projection", "proj_out",
                                  "scale_shift_table")}
    safetensors_io.save(dit, unified)
    safetensors_io.save(wf.materialize(wf.connector_spec(
        fmt=1, dim=tecfg.hidden_dim, gemma_layers=tecfg.num_gemma_layers, layers=2,
        registers=tecfg.num_registers), seed=21),
        base / "ltx-connector" / "diffusion_pytorch_model.safetensors")
    vae = wf.materialize(wf.vae_decoder_spec(base=vcfg.base_channels, latent=b,
                                             blocks_per_group=vcfg.blocks_per_group), seed=22)
    vae.update(wf.materialize(wf.vae_encoder_spec(base=b), seed=23))
    safetensors_io.save({k: np.asarray(v) for k, v in vae.items()},
                        base / "ltx-vae" / "diffusion_pytorch_model.safetensors")
    (base / "ltx-vae" / "config.json").write_text(json.dumps({"timestep_conditioning": True}))
    cfgs = (tcfg, gcfg, tecfg, vcfg)
    ref = e2e._load(base, cfgs, gemma_quant="bf16")
    port = loader.load_pipeline(models_dir=str(base), device="cpu", **_port_cfgs(cfgs))
    assert ref.vcfg.timestep_conditioning and port.vcfg.timestep_conditioning
    pvcfg = convert.port_config(vcfg, VAEConfig)
    assert_same_params(port.vae_decoder, convert.vae_decoder(ref.vae_decoder_params, pvcfg))
    assert_same_params(port.vae_encoder, convert.vae_encoder(ref.vae_encoder_params, pvcfg))
    assert_same_params(port.text_encoder, convert.text_encoder(
        ref.text_encoder_params, convert.port_config(tecfg, TextEncoderConfig)))
    assert_same_params(port.transformer, convert.transformer(
        ref.transformer_params, convert.port_config(tcfg, type(loader.TransformerConfig()))))


def test_vision_tower_from_the_gemma_snapshot(models_dir, tmp_path):
    """A VLM snapshot (the Gemma keys under `language_model.`, the SigLIP
    tower's `vision_tower.*` keys in MLX 4-bit beside them) gives the
    pipeline its vision tower, bit for bit `convert` of the reference's
    `load_vision_params`; Gemma loads as from the text-only snapshot. The
    other tests' snapshot is text-only: no tower."""
    import shutil

    from ltx_tpu.models import siglip as js
    from ltx_tpu_torch.models import siglip as ps
    from test_torch_siglip import MLX_CFG, _hf_tensors

    base, cfgs, _ = models_dir
    copy = tmp_path / "vlm"
    shutil.copytree(base, copy, ignore=shutil.ignore_patterns("*.qcache.*"))
    gdir = copy / "vlm-gemma"
    text = safetensors_io.load(gdir / "model.safetensors")
    safetensors_io.save({f"language_model.{k}": v for k, v in text.items()},
                        gdir / "model.safetensors")
    vcfg = dataclasses.replace(MLX_CFG, text_hidden_size=cfgs[1].hidden_size)
    tensors = {k: v for k, v in _hf_tensors(vcfg, mlx=True).items()
               if not k.startswith("language_model.")}
    safetensors_io.save(tensors, gdir / "vision.safetensors")
    port_vcfg = convert.port_config(vcfg, ps.SigLIPConfig)
    timings = loader.LoadTimings()
    port = loader.load_pipeline(models_dir=str(copy), device="cpu", gemma_quant="bf16",
                                vision_config=port_vcfg, timings=timings,
                                **_port_cfgs(cfgs))
    assert port.vision_config == port_vcfg and timings.vision > 0
    assert_same_params(port.vision, convert.siglip(js.load_vision_params(dict(tensors), vcfg),
                                                   vcfg))
    text_only = loader.load_pipeline(models_dir=str(base), device="cpu", gemma_quant="bf16",
                                     **_port_cfgs(cfgs))
    assert text_only.vision is None and text_only.vision_config is None
    assert_same_params(port.gemma, text_only.gemma)
