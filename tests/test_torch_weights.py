"""The port's checkpoint readers against the reference's.

* Every key map (ltx_tpu_torch.weights.keymaps) on the independently
  transcribed checkpoint specs of tests/weight_fixtures.py at small widths:
  the port's state dict equals, bit for bit and dtype for dtype, the
  parameters `convert` builds from the reference loader's tree on the same
  tensors (video DiT; the dual audio-video DiT in both spellings of its
  audio top level; VAE decoder in both layouts; encoder; connector in both
  formats, with and without the audio connector; Gemma from f32, bf16, MLX
  4-bit and a VLM export; upscaler; audio VAE; vocoder).
  One extra key raises WeightLoadingFailedError on both sides.
* `split_unified` gives the same buckets.
* The port's safetensors reader and writer against the safetensors
  package, both ways, for every dtype and the metadata.
* `download_all_components` (local paths only) and the registry against
  the reference's skip-if-exists layout.
"""

import dataclasses
import json
import sys
import types

import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

import tests.weight_fixtures as wf
from ltx_tpu.core import config as jconfig
from ltx_tpu.core import errors as jerrors
from ltx_tpu.models import audio_vae as jaudio
from ltx_tpu.models import upscaler as jupscaler
from ltx_tpu.weights import download as jdl
from ltx_tpu.weights import keymaps as jk
from ltx_tpu.weights import registry as jreg
from ltx_tpu_torch import convert, errors
from ltx_tpu_torch.config import AudioVAEConfig, LTXModel, TransformerConfig, VocoderConfig
from ltx_tpu_torch.models import audio_vae
from ltx_tpu_torch.models.gemma3 import Gemma3Config
from ltx_tpu_torch.models.text_encoder import TextEncoderConfig
from ltx_tpu_torch.models.upscaler import UpscalerConfig, load_params
from ltx_tpu_torch.models.vae import VAEConfig
from ltx_tpu_torch.weights import download, keymaps, registry, safetensors_io

TCFG = TransformerConfig().tiny()
VCFG = dataclasses.replace(VAEConfig().tiny(), encoder_resnets=(4, 6, 6, 2))
TECFG = TextEncoderConfig().tiny()
GCFG = dataclasses.replace(Gemma3Config().tiny(), hidden_layers=2)
UCFG = UpscalerConfig().tiny()
ACFG, VOCCFG = AudioVAEConfig().tiny(), VocoderConfig().tiny()


def _torch(tensors: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tensors.items()}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bits, comparable with torch.equal whatever its dtype."""
    t = t.detach().contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()]) if t.is_floating_point() else t


def assert_state_equal(got: dict, module: torch.nn.Module):
    want = dict(module.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in want.items():
        assert got[name].dtype == p.dtype and got[name].shape == p.shape, name
        assert torch.equal(_bits(got[name]), _bits(p)), name


def _dit_spec():
    return wf.video_transformer_spec(
        num_layers=TCFG.num_layers, inner=TCFG.inner_dim, in_channels=TCFG.in_channels,
        out_channels=TCFG.out_channels, cross_dim=TCFG.cross_attention_dim,
        caption_dim=TCFG.caption_channels)


def _av_spec(old_spelling=False):
    """The dual DiT's keys; old_spelling: the audio top level as
    audio_proj_in / audio_time_embed (the other spelling both key maps
    accept)."""
    spec = wf.av_transformer_spec(
        num_layers=TCFG.num_layers, inner=TCFG.inner_dim, audio_inner=TCFG.audio_inner_dim,
        in_channels=TCFG.in_channels, out_channels=TCFG.out_channels,
        cross_dim=TCFG.cross_attention_dim, caption_dim=TCFG.caption_channels,
        audio_in=TCFG.audio_in_channels, audio_out=TCFG.audio_out_channels)
    if old_spelling:
        spec = {k.replace("audio_patchify_proj.", "audio_proj_in.").replace(
            "audio_adaln_single.", "audio_time_embed."): v for k, v in spec.items()}
    return spec


def _gemma_spec(**kw):
    return wf.gemma_spec(layers=GCFG.hidden_layers, hidden=GCFG.hidden_size,
                         heads=GCFG.attention_heads, kv_heads=GCFG.kv_heads,
                         head_dim=GCFG.head_dim, intermediate=GCFG.intermediate_size,
                         vocab=GCFG.vocab_size, **kw)


def _decoder_spec(layout):
    return wf.vae_decoder_spec(base=VCFG.base_channels, latent=VCFG.latent_channels,
                               blocks_per_group=VCFG.blocks_per_group, layout=layout)


def _connector_spec(fmt, include_audio=False):
    return wf.connector_spec(fmt=fmt, dim=TECFG.hidden_dim,
                             gemma_layers=TECFG.num_gemma_layers,
                             layers=TECFG.connector_layers, registers=TECFG.num_registers,
                             include_audio=include_audio)


# component: (spec, reference loader -> tree, port loader, convert of the tree)
CASES = {
    "dit": (_dit_spec, lambda t: jk.load_transformer_params(t, TCFG.num_layers),
            lambda t: keymaps.load_transformer_params(t, TCFG.num_layers),
            lambda tree: convert.transformer(tree, TCFG)),
    "vae_decoder_unified": (lambda: _decoder_spec("unified"), jk.load_vae_decoder_params,
                            keymaps.load_vae_decoder_params,
                            lambda tree: convert.vae_decoder(tree, VCFG)),
    "vae_decoder_diffusers": (lambda: _decoder_spec("diffusers"), jk.load_vae_decoder_params,
                              keymaps.load_vae_decoder_params,
                              lambda tree: convert.vae_decoder(tree, VCFG)),
    "vae_encoder": (lambda: wf.vae_encoder_spec(base=VCFG.encoder_channels[0]),
                    jk.load_vae_encoder_params, keymaps.load_vae_encoder_params,
                    lambda tree: convert.vae_encoder(tree, VCFG)),
    "connector_fmt1": (lambda: _connector_spec(1), jk.load_text_encoder_params,
                       keymaps.load_text_encoder_params,
                       lambda tree: convert.text_encoder(tree, TECFG)),
    "connector_fmt2": (lambda: _connector_spec(2), jk.load_text_encoder_params,
                       keymaps.load_text_encoder_params,
                       lambda tree: convert.text_encoder(tree, TECFG)),
    "gemma_f32": (_gemma_spec,
                  lambda t: jk.load_gemma_params(t, GCFG.hidden_layers, mode="bf16"),
                  lambda t: keymaps.load_gemma_params(t, GCFG.hidden_layers, mode="bf16"),
                  lambda tree: convert.gemma(tree, GCFG)),
    "gemma_mlx4": (lambda: _gemma_spec(mlx_4bit=True),
                   lambda t: jk.load_gemma_params(t, GCFG.hidden_layers, mode="bf16"),
                   lambda t: keymaps.load_gemma_params(t, GCFG.hidden_layers, mode="bf16"),
                   lambda tree: convert.gemma(tree, GCFG)),
    "gemma_vlm_mlx4": (lambda: {**_gemma_spec(mlx_4bit=True, vlm_prefix=True),
                                "vision_tower.encoder.w.weight": (4, 4)},
                       lambda t: jk.load_gemma_params(t, GCFG.hidden_layers, mode="bf16"),
                       lambda t: keymaps.load_gemma_params(t, GCFG.hidden_layers, mode="bf16"),
                       lambda tree: convert.gemma(tree, GCFG)),
    "upscaler": (lambda: wf.upscaler_spec(in_ch=UCFG.in_channels, mid=UCFG.mid_channels,
                                          blocks_per_stage=UCFG.blocks_per_stage),
                 jupscaler.load_params, load_params,
                 lambda tree: convert.upscaler(tree, UCFG)),
    "av_dit": (_av_spec, lambda t: jk.load_av_transformer_params(t, TCFG.num_layers),
               lambda t: keymaps.load_av_transformer_params(t, TCFG.num_layers),
               lambda tree: convert.av_transformer(tree, TCFG)),
    "av_dit_proj_in_time_embed": (
        lambda: _av_spec(old_spelling=True),
        lambda t: jk.load_av_transformer_params(t, TCFG.num_layers),
        lambda t: keymaps.load_av_transformer_params(t, TCFG.num_layers),
        lambda tree: convert.av_transformer(tree, TCFG)),
    "connector_fmt1_audio": (lambda: _connector_spec(1, True), jk.load_text_encoder_params,
                             keymaps.load_text_encoder_params,
                             lambda tree: convert.text_encoder(tree, TECFG)),
    "connector_fmt2_audio": (lambda: _connector_spec(2, True), jk.load_text_encoder_params,
                             keymaps.load_text_encoder_params,
                             lambda tree: convert.text_encoder(tree, TECFG)),
    "audio_vae": (lambda: wf.audio_vae_spec(
        latent=ACFG.latent_channels, base=ACFG.base_channels, num_res=ACFG.num_res_blocks,
        mel_bins_packed=ACFG.latent_channels * ACFG.mel_latent_bins),
        jaudio.load_audio_vae_params, audio_vae.load_audio_vae_params,
        lambda tree: convert.audio_vae(tree, ACFG)),
    "vocoder": (lambda: wf.vocoder_spec(
        in_ch=VOCCFG.in_channels, hidden=VOCCFG.hidden_channels,
        up_factors=VOCCFG.upsample_factors, up_kernels=VOCCFG.upsample_kernels,
        res_kernels=VOCCFG.resnet_kernels, dils_per_res=len(VOCCFG.resnet_dilations[0])),
        jaudio.load_vocoder_params, audio_vae.load_vocoder_params,
        lambda tree: convert.vocoder(tree, VOCCFG)),
}


@pytest.mark.parametrize("component", sorted(CASES) + ["gemma_bf16"])
def test_key_map_equals_convert_of_reference(component):
    spec, ref_load, port_load, build = CASES[component.replace("_bf16", "_f32")]
    tensors = wf.materialize(spec(), seed=7)
    if component == "gemma_bf16":  # a bf16 snapshot: both packages keep its values
        import ml_dtypes

        port_in = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in tensors.items()}
        tensors = {k: v.astype(ml_dtypes.bfloat16) for k, v in tensors.items()}
        got = port_load(port_in)
    else:
        got = port_load(_torch(tensors))
    assert_state_equal(got, build(ref_load(dict(tensors))))
    if component == "dit":  # the config the trainer reads from the tensors
        other = dataclasses.replace(TCFG, num_layers=48, num_heads=32, in_channels=128,
                                    out_channels=128, cross_attention_dim=4096,
                                    caption_channels=3840, ffn_mult=2)
        assert keymaps.transformer_config_from_state_dict(got, other) == TCFG


def test_gemma_from_bf16_file_tensors_is_the_tensors_themselves():
    """A bf16 checkpoint maps without a copy: the state dict holds views of
    the loaded tensors (what makes a mapped file's load free)."""
    t = _torch(wf.materialize(_gemma_spec(), seed=1))
    t = {k: v.to(torch.bfloat16) for k, v in t.items()}
    got = keymaps.load_gemma_params(dict(t), GCFG.hidden_layers)
    assert got["layers.0.q_proj.weight"].data_ptr() == \
        t["model.layers.0.self_attn.q_proj.weight"].data_ptr()


@pytest.mark.parametrize("component,extra", [
    ("dit", "bogus.weight"), ("vae_decoder_unified", "decoder.bogus.weight"),
    ("vae_encoder", "encoder.bogus.weight"),
    ("connector_fmt2", "text_embedding_projection.bogus"),
    ("gemma_f32", "model.bogus.weight"), ("av_dit", "av_ca_bogus.weight"),
    ("connector_fmt1_audio", "audio_connector.bogus"),
])
def test_extra_key_raises_on_both_sides(component, extra):
    spec, ref_load, port_load, _ = CASES[component]
    tensors = wf.materialize(spec(), seed=3)
    tensors[extra] = np.zeros((2,), np.float32)
    with pytest.raises(jerrors.WeightLoadingFailedError, match="bogus"):
        ref_load(dict(tensors))
    with pytest.raises(errors.WeightLoadingFailedError, match="bogus"):
        port_load(_torch(tensors))


def test_unported_gemma_modes_and_audio_raise():
    """Gemma's modes are all ported (test_torch_gemma_quant): an unknown
    one is refused. The audio components are ported (the cases above): a
    video DiT's file given to the dual DiT's key map lacks the audio keys
    and raises on both sides, and the video key map drops a dual file's
    audio keys on both sides."""
    t = _torch(wf.materialize(_gemma_spec(), seed=1))
    with pytest.raises(ValueError, match="int3"):
        keymaps.load_gemma_params(dict(t), GCFG.hidden_layers, mode="int3")
    video = wf.materialize(_dit_spec(), seed=2)
    with pytest.raises(KeyError, match="norm1"):
        jk.load_av_transformer_params(dict(video), TCFG.num_layers)
    with pytest.raises(KeyError, match="norm1"):
        keymaps.load_av_transformer_params(_torch(video), TCFG.num_layers)
    dual = wf.materialize(_av_spec(), seed=2)
    assert_state_equal(keymaps.load_transformer_params(_torch(dual), TCFG.num_layers),
                       convert.transformer(jk.load_transformer_params(
                           dict(dual), TCFG.num_layers), TCFG))


def _meta_tensors(spec: dict) -> dict:
    """Shape-only tensors of a checkpoint spec: MLX packed codes uint32,
    everything else bf16."""
    return {k: torch.empty(shape, device="meta", dtype=torch.uint32 if k.endswith(".weight")
                           and f"{k[:-7]}.scales" in spec else torch.bfloat16)
            for k, shape in spec.items()}


@pytest.mark.parametrize("mode", ["bf16", "int4", "w8a8"])
@pytest.mark.parametrize("mlx", [True, False])
def test_gemma_key_map_takes_the_full_inventory(mode, mlx):
    """Gemma-3-12B's every key (48 layers, full widths; MLX 4-bit with the
    VLM prefix, or dense), shape-only: the key map consumes all of them but
    lm_head (strict), and the model built from the state dict takes each
    tensor once, with the shapes and the formats of the mode."""
    from ltx_tpu_torch.models.common import Linear, QuantizedLinear, W8A8Linear
    from ltx_tpu_torch.models.gemma3 import Gemma3Model

    spec = wf.gemma_spec(mlx_4bit=mlx, vlm_prefix=mlx)
    state = keymaps.load_gemma_params(_meta_tensors(spec), 48, mode=mode, strict=True)
    model = Gemma3Model.from_state_dict(Gemma3Config(), state)
    assert len(model.layers) == 48
    want = {"bf16": Linear, "int4": QuantizedLinear if mlx else Linear,
            "w8a8": W8A8Linear}[mode]
    linears = [m for layer in model.layers for m in layer.children()
               if isinstance(m, (Linear, QuantizedLinear, W8A8Linear))]
    assert len(linears) == 48 * 7 and all(type(m) is want for m in linears)
    if want is Linear:  # the checkpoint's values, lm_head (262208 x 3840) dropped
        assert sum(p.numel() for p in model.parameters()) == \
            wf.param_count(wf.gemma_spec()) - 262208 * 3840


def test_dit_key_map_takes_the_full_inventory():
    """The video DiT's every key (48 blocks, full widths), shape-only: the
    key map consumes all of them (strict), the model takes each tensor once,
    13.04 G parameters; quantized to W8A8 and int4 in place, shape-only."""
    from ltx_tpu_torch.models.common import QuantizedLinear, W8A8Linear, assign_
    from ltx_tpu_torch.models.dit import LTXTransformer, quantize_transformer

    spec = wf.video_transformer_spec()
    state = keymaps.load_transformer_params(_meta_tensors(spec), 48, strict=True)
    model = assign_(LTXTransformer(TransformerConfig(), "meta", torch.bfloat16), state)
    assert sum(p.numel() for p in model.parameters()) == wf.param_count(spec) == 13_041_520_768
    for w8a8, cls in ((True, W8A8Linear), (False, QuantizedLinear)):
        quantized = quantize_transformer(assign_(LTXTransformer(
            TransformerConfig(), "meta", torch.bfloat16), state), 8 if w8a8 else 4, w8a8=w8a8)
        assert sum(isinstance(m, cls) for m in quantized.modules()) == 48 * 10


def test_av_dit_key_map_takes_the_full_inventory():
    """The dual DiT's every key (48 blocks, full widths), shape-only: the
    key map consumes all of them (strict), the model takes each tensor once,
    18.88 G parameters; quantized to int4 in place, the six attentions and
    two feed-forwards of each block: 28 linears a block."""
    from ltx_tpu_torch.models.common import QuantizedLinear, assign_
    from ltx_tpu_torch.models.dit import quantize_transformer
    from ltx_tpu_torch.models.dit_av import LTXAVTransformer

    spec = wf.av_transformer_spec()
    state = keymaps.load_av_transformer_params(_meta_tensors(spec), 48, strict=True)
    model = assign_(LTXAVTransformer(TransformerConfig(), "meta", torch.bfloat16), state)
    assert sum(p.numel() for p in model.parameters()) == wf.param_count(spec) \
        == 18_877_354_240
    quantize_transformer(model, 4)
    assert sum(isinstance(m, QuantizedLinear) for m in model.modules()) == 48 * 28


@pytest.mark.parametrize("include_audio", [False, True], ids=["video", "audio"])
def test_split_unified_buckets_match_reference(include_audio):
    unified = {}
    for k, v in wf.materialize(_dit_spec(), seed=1).items():
        unified[f"model.diffusion_model.{k}"] = v
    for k, v in wf.materialize(_connector_spec(2), seed=2).items():
        unified[f"model.diffusion_model.{k}"] = v
    for k, v in wf.materialize(_decoder_spec("unified"), seed=3).items():
        unified[f"vae.{k}"] = np.asarray(v)
    unified["model.diffusion_model.audio_proj_in.weight"] = np.zeros((2, 2), np.float32)
    unified["model.diffusion_model.transformer_blocks.0.attn1.to_q.weight_scale"] = \
        np.ones((), np.float32)
    unified["vocoder.conv_in.weight"] = np.zeros((2,), np.float32)
    for k, v in wf.materialize(_connector_spec(2, True), seed=4).items():
        if "audio" in k:
            unified[f"model.diffusion_model.{k}"] = v
    port = _torch(unified)
    source = {id(v): k for k, v in unified.items()}
    for ref, got in zip(jk.split_unified(unified, include_audio=include_audio),
                        keymaps.split_unified(port, include_audio=include_audio)):
        assert sorted(ref) == sorted(got)
        for k, v in ref.items():
            assert got[k] is port[source[id(v)]], k


# --------------------------------------------------------------------------
# safetensors
# --------------------------------------------------------------------------

_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.uint8, torch.int8,
           torch.uint16, torch.int32, torch.uint32, torch.int64, torch.bool]


def _sample(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=g).bool()
    hi = {torch.uint8: 256, torch.int8: 127, torch.uint16: 65535, torch.int32: 2**31 - 1,
          torch.uint32: 2**32 - 1, torch.int64: 2**62}[dtype]
    return torch.randint(0, hi, shape, generator=g, dtype=torch.int64).to(dtype)


def _tensors():
    out = {}
    for i, dtype in enumerate(_DTYPES):
        out[f"t{i}.{str(dtype)[6:]}"] = _sample(dtype, (3, 5), i)
        out[f"s{i}"] = _sample(dtype, (), i + 100)
    out["empty"] = torch.zeros((0, 4))
    return out


def test_safetensors_reader_reads_the_package_and_the_package_reads_the_writer(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file, save_file

    tensors, meta = _tensors(), {"format": "pt", "note": "ünïcode"}
    theirs = tmp_path / "theirs.safetensors"
    save_file(tensors, str(theirs), metadata=meta)
    got = safetensors_io.load(theirs)
    assert safetensors_io.metadata(theirs) == meta and sorted(got) == sorted(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k

    ours = tmp_path / "ours.safetensors"
    safetensors_io.save(tensors, ours, metadata=meta)
    back = load_file(str(ours))
    with safe_open(str(ours), framework="pt") as f:
        assert f.metadata() == meta
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    # numpy arrays (the reference's trees) write as their dtype
    safetensors_io.save({"a": np.arange(6, dtype=np.uint32).reshape(2, 3)}, ours)
    assert torch.equal(load_file(str(ours))["a"], torch.arange(6).reshape(2, 3).to(
        torch.uint32))


def test_safetensors_reader_rejects_what_it_cannot_read(tmp_path):
    from safetensors.torch import save_file

    path = tmp_path / "f64.safetensors"
    save_file({"x": torch.zeros(2, dtype=torch.float64)}, str(path))
    with pytest.raises(errors.WeightLoadingFailedError, match="F64"):
        safetensors_io.load(path)
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"\x10\x00\x00\x00\x00\x00\x00\x00{\"x\": 1}")
    with pytest.raises(errors.WeightLoadingFailedError):
        safetensors_io.load(bad)
    # a tensor changed after loading does not write through to the file
    ok = tmp_path / "ok.safetensors"
    safetensors_io.save({"x": torch.ones(4)}, ok)
    safetensors_io.load(ok)["x"].zero_()
    assert torch.equal(safetensors_io.load(ok)["x"], torch.ones(4))


# --------------------------------------------------------------------------
# local layout and registry
# --------------------------------------------------------------------------


@pytest.fixture
def no_hub(monkeypatch):
    """The reference's downloader with a hub that must not be asked."""
    def refuse(*a, **kw):
        raise AssertionError("the hub was asked although every file is present")

    mod = types.ModuleType("huggingface_hub")
    mod.hf_hub_download = mod.snapshot_download = refuse
    monkeypatch.setitem(sys.modules, "huggingface_hub", mod)


def _layout(base, model, audio=True):
    for comp, (subdir, files) in jreg.component_inventory(
            jconfig.LTXModel(model.value)).items():
        if comp in ("audio_vae", "vocoder") and not audio:
            continue
        (base / subdir).mkdir(parents=True, exist_ok=True)
        for f in files:
            (base / subdir / f).write_bytes(b"x")
    (base / "vlm-gemma" / "model.safetensors").write_bytes(b"x")


@pytest.mark.parametrize("model", list(LTXModel))
def test_download_all_components_resolves_the_reference_layout(tmp_path, no_hub, model):
    _layout(tmp_path, model)
    jmodel = jconfig.LTXModel(model.value)
    for kw in (dict(include_audio=True), dict(include_upscaler=False)):
        want = jdl.download_all_components(jmodel, models_dir=str(tmp_path), **kw)
        got = download.download_all_components(model, models_dir=str(tmp_path), **kw)
        assert got == want
    for comp in jreg.component_inventory(jmodel):
        assert registry.is_downloaded(comp, str(tmp_path), model) == \
            jreg.is_downloaded(comp, str(tmp_path), jmodel)
    assert registry.component_inventory(model) == jreg.component_inventory(jmodel)

    (tmp_path / "ltx-vae" / "config.json").unlink()
    assert registry.missing_files("vae", str(tmp_path), model) == \
        jreg.missing_files("vae", str(tmp_path), jmodel) == ["config.json"]
    with pytest.raises(errors.DownloadFailedError, match=r"Lightricks/LTX-2/vae/config.json"):
        download.download_all_components(model, models_dir=str(tmp_path))
    with pytest.raises(errors.DownloadFailedError, match="gemma-3-12b"):
        download.download_all_components(model, models_dir=str(tmp_path / "empty"))


def test_constants_and_errors_match_reference():
    for name in ("LTX_REPO", "GEMMA_REPO", "CONNECTOR_FILE", "VAE_FILE", "VAE_CONFIG",
                 "UPSCALER_FILE", "DISTILLED_LORA_FILE", "AUDIO_VAE_FILE", "VOCODER_FILE"):
        assert getattr(download, name) == getattr(jdl, name), name
    for name, cls in vars(jerrors).items():
        if isinstance(cls, type) and issubclass(cls, Exception):
            ours = getattr(errors, name)
            assert [b.__name__ for b in ours.__mro__] == [b.__name__ for b in cls.__mro__]
    for args in (("x",), (9,)):
        for name in ("WeightLoadingFailedError", "DownloadFailedError", "InvalidLoRAError",
                     "FileNotFoundLTXError", "ModelNotLoadedError"):
            assert str(getattr(errors, name)(*args)) == str(getattr(jerrors, name)(*args))
    assert str(errors.InvalidFrameCountError(10)) == str(jerrors.InvalidFrameCountError(10))
    # the Gemma config of an HF export, flat and nested (a VLM's text_config)
    from ltx_tpu.models import gemma3 as jgemma

    flat = {"hidden_size": 64, "num_hidden_layers": 3, "num_key_value_heads": 2,
            "rope_theta": 5.0, "sliding_window_pattern": 3}
    for d in (flat, {"text_config": flat, "vision_config": {}}, {}):
        assert dataclasses.asdict(Gemma3Config.from_hf_dict(json.loads(json.dumps(d)))) == \
            dataclasses.asdict(jgemma.Gemma3Config.from_hf_dict(d))
