"""Assemble an LTXPipeline from checkpoint files on the local disk.

Port of ltx_tpu/pipeline/loader.py, in the reference's order: resolve the
models directory's files (nothing is downloaded) -> split the unified file
-> key-map each component -> fuse the LoRA into the DiT (the distilled
LoRA, or a user's) -> quantize the DiT -> cache the quantized DiT -> the
SigLIP vision tower, when the Gemma snapshot carries one -> the tokenizer.

Every component is built on the host from the mapped files
(`models.common.assign_`: a tensor whose dtype needs no change is a view
of the file, not a copy); the pipeline then places each on the device for
its phase (`memory.phase_staging`) or for good. Work on the weights that
would take minutes on the host runs on `device`, bit for bit the CPU's
arithmetic: the DiT's LoRA fusion and quantization, layer by layer, landing
back on the host; and Gemma's preparation in its mode (`gemma_quant`, the
reference's default "w8a8": MLX 4-bit linears requantized per channel;
"int4": repacked; "bf16": dequantized), which stays on the device unless
phase staging keeps components on the host, where then only the prepared
(quantized) leaves go. A quantized Gemma is cached beside its snapshot, as
the reference does (`gemma-{mode}` entries).

The vision tower (I2V prompt enhancement) lives where Gemma lives, its MLX
4-bit linears dequantized on `device`. With `include_audio` the audio
components come too, as the reference loads them: the text encoder's audio
connector from the unified file, the audio VAE and the vocoder from their
files, and the dual audio-video DiT assembled from the unified file again
(no LoRA fused into it), quantized block by block on `device` in the DiT's
mode and cached as `av-{mode}`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from pathlib import Path
from typing import Optional

import torch

from ltx_tpu_torch import convert
from ltx_tpu_torch.config import LTXModel, MemoryConfig, QuantizationConfig, TransformerConfig
from ltx_tpu_torch.errors import FileNotFoundLTXError
from ltx_tpu_torch.config import AudioVAEConfig, VocoderConfig
from ltx_tpu_torch.models import audio_vae as audio_mod
from ltx_tpu_torch.models import vae
from ltx_tpu_torch.models.common import assign_
from ltx_tpu_torch.models.dit_av import LTXAVTransformer
from ltx_tpu_torch.models.dit import LTXTransformer, quantize_linears
from ltx_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model
from ltx_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from ltx_tpu_torch.pipeline.generate import LTXPipeline
from ltx_tpu_torch.weights import keymaps, qcache
from ltx_tpu_torch.weights.download import (
    download_all_components,
    load_safetensors,
    load_safetensors_dir,
)

log = logging.getLogger("ltx_tpu_torch")


@dataclasses.dataclass
class LoadTimings:
    """Seconds of each part of `load_pipeline` (device work synchronised):
    mapping the files, the key maps (with their dtype changes), building
    the modules, Gemma's preparation in its mode and its placement, the
    vision tower's, the DiT's LoRA fusion and quantization, the quantized
    caches (read or written), and the whole; whether the DiT's and Gemma's
    caches hit."""

    read: float = 0.0
    key_map: float = 0.0
    build: float = 0.0
    gemma: float = 0.0
    vision: float = 0.0
    fuse: float = 0.0
    quantize: float = 0.0
    cache: float = 0.0
    total: float = 0.0
    cache_hit: bool = False
    gemma_cache_hit: bool = False


def load_tokenizer(gemma_dir):
    """The Gemma snapshot's tokenizer.json, read by the port's reader."""
    from ltx_tpu_torch.tokenizer import Tokenizer

    path = Path(gemma_dir) / "tokenizer.json"
    if not path.exists():
        raise FileNotFoundLTXError(f"tokenizer.json in {gemma_dir}")
    return Tokenizer.from_file(path)


def _quant_signature(component: str, quantization, layers: int, audio: bool = False,
                     lora_path=None, lora_scale: float = 1.0) -> dict:
    """Staleness key of a quantized-weight cache entry: what changes the
    quantized tree besides the source file itself (which qcache records)."""
    sig = {"component": component, "mode": quantization.mode,
           "group": quantization.group_size, "layers": layers, "audio": audio}
    if lora_path is not None:
        st = os.stat(lora_path)
        sig["lora"] = (f"{os.path.basename(str(lora_path))}:"
                       f"{st.st_size}:{st.st_mtime_ns}:{lora_scale}")
    return sig


def gemma_signature(mode: str, layers: int, embed_int8: bool) -> dict:
    """Staleness key of a quantized Gemma's cache entry, the reference's."""
    return {"component": "gemma", "mode": mode, "layers": layers, "embed_int8": embed_int8}


def _cached_leaves(tree, device, home):
    """A cached tree's leaves on `home`, each W8A8 weight ("w8", row-major
    in the JAX layout) made column-major as W8A8Linear keeps it, on
    `device`: the card transposes an int8 matrix in a fraction of the
    host's time."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _cached_leaves(value, device, home)
        elif key == "w8":
            out[key] = value.to(device).transpose(-1, -2).contiguous().transpose(-1, -2).to(home)
        else:
            out[key] = value.to(home)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def _fuse_and_quantize(model, lora_layers, lora_scale: float,
                       quantization: QuantizationConfig, device, timings: LoadTimings):
    """A DiT's LoRA fusion, then its quantization, each block in turn on
    `device` and back to the host; the top-level linears fuse on `device`
    too (they are not quantized). The dual DiT comes with no LoRA."""
    from ltx_tpu_torch.lora.fuse import _BLOCK_KEY, fuse_lora

    per_block = {}
    top = []
    for layer in lora_layers:
        m = _BLOCK_KEY.match(layer.original_key)
        (per_block.setdefault(int(m.group(1)), []) if m else top).append(layer)
    t0 = time.perf_counter()
    if top:
        fuse_lora(model, top, lora_scale, device=device, inplace=True)
        timings.fuse += time.perf_counter() - t0
    for i, block in enumerate(model.blocks):
        layers = per_block.get(i, [])
        if not layers and quantization.bits is None:
            continue
        block.to(device)
        if layers:
            t1 = time.perf_counter()
            fuse_lora(model, layers, lora_scale, inplace=True)
            _sync(device)
            timings.fuse += time.perf_counter() - t1
        if quantization.bits is not None:
            t1 = time.perf_counter()
            quantize_linears(block, quantization.bits, quantization.group_size,
                             w8a8=quantization.mode == "w8a8")
            _sync(device)
            timings.quantize += time.perf_counter() - t1
        block.to("cpu")
    log.info("DiT prepared on %s in %.2f s", device, time.perf_counter() - t0)


def _load_vision(tensors, vision_config, device, home, timings: LoadTimings):
    """The SigLIP tower of a Gemma snapshot's `vision_tower.*` tensors (the
    reference's `siglip.load_vision_params`, at `vision_config` or its
    SigLIPConfig()), built on the host and placed on `home`; (None, None)
    for a text-only snapshot."""
    from ltx_tpu_torch.models import siglip

    t0 = time.perf_counter()
    cfg = vision_config or siglip.SigLIPConfig()
    state = siglip.load_vision_params(tensors, cfg, device=device)
    if state is None:
        return None, None
    vision = assign_(siglip.SigLIPModel(cfg, "meta"), state).to(home)
    _sync(device)
    timings.vision += time.perf_counter() - t0
    return vision, cfg


def _load_audio(paths, unified_path, tcfg: TransformerConfig,
                quantization: QuantizationConfig, quant_cache: bool, audio_vae_config,
                vocoder_config, device, timings: LoadTimings) -> dict:
    """The audio VAE, the vocoder and the dual DiT (from the qcache's
    `av-{mode}` entry when a quantized one is there), on the host."""
    t0 = time.perf_counter()
    vae_state = audio_mod.load_audio_vae_params(load_safetensors(paths["audio_vae"]))
    voc_state = audio_mod.load_vocoder_params(load_safetensors(paths["vocoder"]))
    timings.read += time.perf_counter() - t0
    t0 = time.perf_counter()
    audio_vae = assign_(audio_mod.AudioVAE(audio_vae_config or AudioVAEConfig(), "meta"),
                        vae_state)
    vocoder = assign_(audio_mod.Vocoder(vocoder_config or VocoderConfig(), "meta"), voc_state)
    timings.build += time.perf_counter() - t0

    av = None
    sig = None
    if quantization.bits is not None:
        sig = _quant_signature("av", quantization, tcfg.num_layers)
        if quant_cache:
            t0 = time.perf_counter()
            tree = qcache.load_quantized_tree(unified_path, f"av-{quantization.mode}", sig)
            if tree is not None:
                av = convert.av_transformer_from_tree(
                    _cached_leaves(tree, device, torch.device("cpu")), tcfg)
            timings.cache += time.perf_counter() - t0
    if av is None:
        t0 = time.perf_counter()
        state = keymaps.load_av_transformer_params(load_safetensors(unified_path),
                                                   tcfg.num_layers)
        timings.key_map += time.perf_counter() - t0
        t0 = time.perf_counter()
        av = assign_(LTXAVTransformer(tcfg, "meta", state["patchify_proj.weight"].dtype),
                     state)
        timings.build += time.perf_counter() - t0
        del state
        if quantization.bits is not None:
            _fuse_and_quantize(av, [], 1.0, quantization, device, timings)
            if quant_cache:
                t0 = time.perf_counter()
                qcache.save_quantized_tree(convert.av_transformer_tree(av), unified_path,
                                           f"av-{quantization.mode}", sig)
                timings.cache += time.perf_counter() - t0
    return dict(av_transformer=av, audio_vae=audio_vae, vocoder=vocoder)


def load_pipeline(
    model: LTXModel = LTXModel.DISTILLED,
    models_dir: Optional[str] = None,
    hf_token: Optional[str] = None,
    gemma_path: Optional[str] = None,
    unified_weights_path: Optional[str] = None,
    quantization: QuantizationConfig = QuantizationConfig(),
    memory: MemoryConfig = MemoryConfig(),
    lora_path: Optional[str] = None,
    lora_scale: float = 1.0,
    distilled_lora: bool = False,
    include_audio: bool = False,
    include_upscaler: bool = False,
    gemma_quant: str = "w8a8",
    gemma_embed_int8: bool = False,
    quant_cache: bool = True,
    transformer_config: Optional[TransformerConfig] = None,
    vae_config=None,
    text_encoder_config=None,
    vision_config=None,
    audio_vae_config: Optional[AudioVAEConfig] = None,
    vocoder_config: Optional[VocoderConfig] = None,
    device="cuda",
    timings: Optional[LoadTimings] = None,
) -> LTXPipeline:
    """Load and assemble every component from a local models directory
    (the reference's layout, `weights.download.download_all_components`).

    The reference's arguments, in its order and with its defaults;
    `hf_token` is accepted and unused (nothing is downloaded).
    include_audio=True adds the audio components (the dual DiT, the audio
    connector, the audio VAE and the vocoder). quant_cache=True keeps a
    quantized DiT (and dual DiT) next to the unified file, and a quantized Gemma (gemma_quant other
    than "bf16") inside its snapshot, the first time (weights/qcache.py, in
    the JAX package's format) and maps them back on later loads; the
    staleness key is the source's size and mtime and the quantization (and
    LoRA) signature. `device` is where the pipeline runs and where the
    heavy load-time work runs (default: the card). The *_config overrides
    exist for checkpoints cut to size (tests, the smoke run; the vision
    tower's is the reference's SigLIPConfig() otherwise, the audio VAE's and
    the vocoder's their AudioVAEConfig() and VocoderConfig()). `timings`,
    when given, receives the seconds of each part."""
    t_start = time.perf_counter()
    timings = timings if timings is not None else LoadTimings()
    device = torch.device(device)
    tcfg = transformer_config or TransformerConfig()

    t0 = time.perf_counter()
    paths = download_all_components(model, models_dir=models_dir, hf_token=hf_token,
                                    include_audio=include_audio,
                                    include_upscaler=include_upscaler)
    unified_path = unified_weights_path or paths["unified"]
    gemma_dir = gemma_path or paths["gemma"]
    log.info("Loading unified weights: %s", unified_path)
    tensors = load_safetensors(unified_path)
    tr_raw, vae_raw, conn_raw = keymaps.split_unified(tensors, include_audio=include_audio)
    del tensors
    # the standalone files stand in when the unified split lacks a component
    if not any("conv_in" in k for k in vae_raw) and paths.get("vae"):
        vae_raw = load_safetensors(paths["vae"])
    if not conn_raw and paths.get("connector"):
        conn_raw = load_safetensors(paths["connector"])
    timings.read += time.perf_counter() - t0

    # --- transformer: a quantized load checks the cache first (a hit skips
    # the key map, the fusion and the quantization)
    fuse_path = (lora_path or paths.get("distilled_lora")
                 if (distilled_lora or lora_path) else None)
    transformer = None
    dit_sig = None
    if quantization.bits is not None:
        dit_sig = _quant_signature("dit", quantization, tcfg.num_layers, audio=False,
                                   lora_path=fuse_path, lora_scale=lora_scale)
        if quant_cache:
            t0 = time.perf_counter()
            tree = qcache.load_quantized_tree(unified_path, f"dit-{quantization.mode}",
                                              dit_sig)
            if tree is not None:
                transformer = convert.transformer_from_tree(
                    _cached_leaves(tree, device, torch.device("cpu")), tcfg)
                timings.cache_hit = True
            timings.cache += time.perf_counter() - t0
    if transformer is None:
        t0 = time.perf_counter()
        state = keymaps.load_transformer_params(tr_raw, tcfg.num_layers)
        timings.key_map += time.perf_counter() - t0
        t0 = time.perf_counter()
        transformer = assign_(LTXTransformer(tcfg, "meta", state["patchify_proj.weight"].dtype),
                              state)
        timings.build += time.perf_counter() - t0
        del state
        lora_layers = []
        if fuse_path is not None:
            from ltx_tpu_torch.lora.fuse import parse_lora

            log.info("Fusing LoRA: %s (scale %.2f)", fuse_path, lora_scale)
            t0 = time.perf_counter()
            lora_layers = parse_lora(load_safetensors(fuse_path))
            timings.read += time.perf_counter() - t0
        if lora_layers or quantization.bits is not None:
            _fuse_and_quantize(transformer, lora_layers, lora_scale, quantization, device,
                               timings)
        if quantization.bits is not None and quant_cache:
            t0 = time.perf_counter()
            qcache.save_quantized_tree(convert.transformer_tree(transformer), unified_path,
                                       f"dit-{quantization.mode}", dit_sig)
            timings.cache += time.perf_counter() - t0
    del tr_raw

    # --- VAE decoder (and its config flag), encoder
    vcfg = vae_config or vae.VAEConfig()
    cfg_path = paths.get("vae_config")
    if cfg_path and Path(cfg_path).exists():
        with open(cfg_path) as f:
            if json.load(f).get("timestep_conditioning"):
                vcfg = dataclasses.replace(vcfg, timestep_conditioning=True)
    t0 = time.perf_counter()
    dec_state = keymaps.load_vae_decoder_params(vae_raw)
    enc_state = None
    if any(k.startswith("encoder.") for k in vae_raw):
        enc_state = keymaps.load_vae_encoder_params(vae_raw)
    elif paths.get("vae") and Path(paths["vae"]).exists():
        # the encoder ships only in the standalone VAE file
        standalone = load_safetensors(paths["vae"])
        if any(k.startswith("encoder.") for k in standalone):
            enc_state = keymaps.load_vae_encoder_params(standalone)
        del standalone
    del vae_raw
    te_state = keymaps.load_text_encoder_params(conn_raw)
    del conn_raw
    timings.key_map += time.perf_counter() - t0

    t0 = time.perf_counter()
    vae_dtype = dec_state["conv_in.weight"].dtype
    decoder = assign_(vae.without_time_embedders(
        vae.VideoDecoder(vcfg, "meta", vae_dtype),
        lambda name: f"{name}.timestep_embedder.linear_1.weight" in dec_state), dec_state)
    encoder = None if enc_state is None else assign_(
        vae.VideoEncoder(vcfg, "meta", enc_state["conv_in.weight"].dtype), enc_state)
    tecfg = text_encoder_config or TextEncoderConfig()
    text_encoder = assign_(TextEncoder(
        tecfg, "meta", te_state["feature_extractor.aggregate_embed.weight"].dtype,
        include_audio="audio_embeddings_connector.learnable_registers" in te_state), te_state)
    timings.build += time.perf_counter() - t0
    del dec_state, enc_state, te_state

    # --- Gemma: prepared on the device in its mode (or mapped from its
    # cache), then kept there, or on the host under phase staging
    with open(Path(gemma_dir) / "config.json") as f:
        gcfg = Gemma3Config.from_hf_dict(json.load(f))
    gemma_home = torch.device("cpu") if memory.phase_staging else device
    gemma_sig = gemma_signature(gemma_quant, gcfg.hidden_layers, gemma_embed_int8)
    cached = quant_cache and gemma_quant != "bf16"
    gemma = None
    t0 = time.perf_counter()
    gemma_tensors = load_safetensors_dir(gemma_dir)
    timings.read += time.perf_counter() - t0
    if cached:
        t0 = time.perf_counter()
        tree = qcache.load_quantized_tree(gemma_dir, f"gemma-{gemma_quant}", gemma_sig)
        if tree is not None:
            gemma = convert.gemma_from_tree(_cached_leaves(tree, device, gemma_home), gcfg)
            timings.gemma_cache_hit = True
        del tree
        timings.cache += time.perf_counter() - t0
    if gemma is None:
        t0 = time.perf_counter()
        g_state = keymaps.load_gemma_params(gemma_tensors, gcfg.hidden_layers,
                                            mode=gemma_quant, embed_int8=gemma_embed_int8,
                                            device=device)
        gemma = Gemma3Model.from_state_dict(gcfg, g_state)
        del g_state
        _sync(device)
        timings.gemma += time.perf_counter() - t0
        if cached:
            t0 = time.perf_counter()
            qcache.save_quantized_tree(convert.gemma_tree(gemma), gemma_dir,
                                       f"gemma-{gemma_quant}", gemma_sig)
            timings.cache += time.perf_counter() - t0
    t0 = time.perf_counter()
    gemma.to(gemma_home)
    _sync(device)
    timings.gemma += time.perf_counter() - t0
    vision, vision_config = _load_vision(gemma_tensors, vision_config, device, gemma_home,
                                         timings)
    del gemma_tensors
    if vision is None:
        log.info("no vision tower in %s: I2V prompt enhancement will run text-only",
                 gemma_dir)
    tokenizer = load_tokenizer(gemma_dir)

    upscaler = None
    if include_upscaler and "upscaler" in paths:
        from ltx_tpu_torch.models import upscaler as upscaler_mod

        t0 = time.perf_counter()
        u_state = upscaler_mod.load_params(load_safetensors(paths["upscaler"]))
        # the reference's UpscalerConfig, its widths and depth read from the file
        mid, in_channels = u_state["initial_conv.weight"].shape[:2]
        ucfg = dataclasses.replace(
            upscaler_mod.UpscalerConfig(), in_channels=in_channels, mid_channels=mid,
            blocks_per_stage=sum(k.endswith(".conv1.weight") and k.startswith("res_blocks.")
                                 for k in u_state))
        upscaler = assign_(upscaler_mod.LatentUpscaler(ucfg, "meta", torch.float32), u_state)
        timings.build += time.perf_counter() - t0

    audio = {}
    if include_audio:
        audio = _load_audio(paths, unified_path, tcfg, quantization, quant_cache,
                            audio_vae_config, vocoder_config, device, timings)
    pipe = LTXPipeline(transformer=transformer, vae_decoder=decoder, gemma=gemma,
                       text_encoder=text_encoder, tokenizer=tokenizer, memory=memory,
                       is_distilled=model.is_distilled or distilled_lora, device=device,
                       vae_encoder=encoder, upscaler=upscaler, vision=vision,
                       vision_config=vision_config, **audio)
    timings.total = time.perf_counter() - t_start
    return pipe
