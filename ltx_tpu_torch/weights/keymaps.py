"""Checkpoint key maps: safetensors tensors -> the port's parameter names.

Port of ltx_tpu/weights/keymaps.py: the same key tables, the same order of consumption and the same errors (KeyError for a
missing or unconsumed block key, WeightLoadingFailedError for an unconsumed
top-level key under strict=True). Where the reference assembles a JAX tree
(every layer stacked on a leading axis, linear weights transposed to
(in, out), convolutions to channels-last), each loader here returns a flat
state dict {parameter name: CPU tensor} in the layout the port's modules
keep, which is the checkpoint's own: Linear (out, in), Conv3d
(O, I, kt, kh, kw), one `blocks.{i}.` / `layers.{i}.` name per layer. So
nothing is transposed, and a tensor that needs no dtype change is the
loaded tensor itself (a view of the mapped file, see safetensors_io).

Dtypes follow the reference: float32 weights round to bfloat16 (nearest
even) and other dtypes pass as they are; every scale_shift_table, the VAE
decoder's time embedders and its latent statistics are float32.
Gemma's linears and token table follow the reference's modes, computed on
the device the caller names and left there: an MLX 4-bit linear repacks
losslessly to int4 ("int4"), requantizes per output channel to int8
("w8a8") or dequantizes in float32 (q * scale + bias, one rounding to
bfloat16; "bf16"); `embed_int8` gives an int8 token table with per-row
scales. The audio VAE's and the vocoder's files keep their own names and
layouts (models/audio_vae.py reads them).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch

from ltx_tpu_torch.config import TransformerConfig
from ltx_tpu_torch.errors import WeightLoadingFailedError
from ltx_tpu_torch.kernels.quantization import pack_int4, requant_int8_channel

Tensors = Dict[str, torch.Tensor]


def _check_consumed(leftover, what: str, strict: bool):
    """A non-empty leftover means the key table and the checkpoint
    disagree: under strict=True that is a load error, never a silent drop."""
    if strict and leftover:
        sample = ", ".join(sorted(leftover)[:8])
        raise WeightLoadingFailedError(
            f"{len(leftover)} unconsumed {what} keys (table drift?): {sample}")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16, round to nearest even; other dtypes unchanged."""
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


# ---------------------------------------------------------------------------
# Video DiT and the dual audio-video DiT
# ---------------------------------------------------------------------------


def map_transformer_key(key: str, include_audio: bool = False) -> Optional[str]:
    """Diffusers/unified key -> canonical key; None to skip (the audio
    stream's keys, and the dual block's learnable norms, unless
    include_audio)."""
    if not include_audio:
        if (key.startswith("audio_") or ".audio_" in key
                or key.startswith("av_cross_attn_")
                or key.startswith("av_ca_")
                or "video_to_audio" in key or "video_a2v" in key
                or "a2v_ca" in key or "scale_shift_table_a2v" in key):
            return None
        # the video model's adaln norms carry no weights; a dual AV
        # checkpoint's learnable norm1/2/3 are dropped
        if re.search(r"(^|\.)norm[123]\.", key):
            return None

    k = key
    if k.startswith("proj_in."):
        k = "patchify_proj." + k[len("proj_in."):]
    if k.startswith("time_embed.emb.timestep_embedder."):
        k = "adaln_single.emb." + k[len("time_embed.emb.timestep_embedder."):]
    elif k.startswith("time_embed.linear."):
        k = "adaln_single." + k[len("time_embed."):]
    elif k.startswith("adaln_single.emb.timestep_embedder."):
        k = "adaln_single.emb." + k[len("adaln_single.emb.timestep_embedder."):]
    k = k.replace(".emb.timestep_embedder.", ".emb.")
    k = k.replace(".norm_q.", ".q_norm.")
    k = k.replace(".norm_k.", ".k_norm.")
    k = k.replace(".to_out.0.", ".to_out.")
    k = k.replace("ff.net.0.proj.", "ff.project_in.proj.")
    k = k.replace("ff.net.2.", "ff.project_out.")
    return k


_BLOCK_RE = re.compile(r"^transformer_blocks\.(\d+)\.(.+)$")


def _linear(d: Tensors, prefix: str, out: Tensors, name: str) -> None:
    out[f"{name}.weight"] = _bf16(d.pop(f"{prefix}.weight"))
    if f"{prefix}.bias" in d:
        out[f"{name}.bias"] = _bf16(d.pop(f"{prefix}.bias"))


def _split_blocks(raw: Tensors, num_layers: int):
    """(per-block canonical tensors, top-level tensors)."""
    per_layer: list = [dict() for _ in range(num_layers)]
    top: Tensors = {}
    for key, value in raw.items():
        m = _BLOCK_RE.match(key)
        if m:
            idx = int(m.group(1))
            if idx >= num_layers:
                raise KeyError(f"block index {idx} >= num_layers {num_layers}")
            per_layer[idx][m.group(2)] = value
        else:
            top[key] = value
    return per_layer, top


def assemble_transformer_params(raw: Tensors, num_layers: int,
                                include_audio: bool = False,
                                strict: bool = True) -> Tensors:
    """Canonical-keyed tensors -> the LTXTransformer state dict
    (include_audio is the reference's argument and changes nothing here:
    the dual DiT has `assemble_av_transformer_params`)."""
    per_layer, top = _split_blocks(raw, num_layers)
    out: Tensors = {}
    for i, d in enumerate(per_layer):
        p = f"blocks.{i}"
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v", "to_out"):
                _linear(d, f"{attn}.{proj}", out, f"{p}.{attn}.{proj}")
            for nrm in ("q_norm", "k_norm"):
                out[f"{p}.{attn}.{nrm}.weight"] = _bf16(d.pop(f"{attn}.{nrm}.weight"))
        _linear(d, "ff.project_in.proj", out, f"{p}.ff.project_in")
        _linear(d, "ff.project_out", out, f"{p}.ff.project_out")
        out[f"{p}.scale_shift_table"] = _f32(d.pop("scale_shift_table"))
        if d:
            raise KeyError(f"unconsumed block-{i} keys: {sorted(d)[:5]}")

    for name in ("patchify_proj", "adaln_single.emb.linear_1", "adaln_single.emb.linear_2",
                 "adaln_single.linear", "caption_projection.linear_1",
                 "caption_projection.linear_2", "proj_out"):
        _linear(top, name, out, name)
    out["scale_shift_table"] = _f32(top.pop("scale_shift_table"))
    _check_consumed(top, "top-level transformer", strict)
    return out


def _transformer_raw(tensors: Tensors, include_audio: bool = False) -> Tensors:
    diffusion = "model.diffusion_model."
    raw: Tensors = {}
    for key, value in tensors.items():
        if key.endswith(".weight_scale") or key.endswith(".input_scale"):
            continue
        k = key[len(diffusion):] if key.startswith(diffusion) else key
        if k.startswith(("video_embeddings_connector.", "audio_embeddings_connector.",
                         "text_embedding_projection.", "vae.", "vocoder")) \
                or "per_channel_statistics" in k:
            continue
        mapped = map_transformer_key(k, include_audio)
        if mapped is not None:
            raw[mapped] = value
    return raw


def load_transformer_params(tensors: Tensors, num_layers: int,
                            include_audio: bool = False,
                            strict: bool = True) -> Tensors:
    """Unified-file or pre-stripped tensors -> the LTXTransformer state dict."""
    return assemble_transformer_params(_transformer_raw(tensors), num_layers, include_audio,
                                       strict)


def assemble_av_transformer_params(raw: Tensors, num_layers: int,
                                   strict: bool = True) -> Tensors:
    """Canonical-keyed tensors -> the LTXAVTransformer state dict. The audio
    stream's top-level modules may carry either spelling the reference
    accepts (audio_proj_in | audio_patchify_proj, audio_time_embed |
    audio_adaln_single)."""
    per_layer, top = _split_blocks(raw, num_layers)
    out: Tensors = {}

    def lin(d: Tensors, prefix: str, name: str, alt: Optional[str] = None) -> None:
        pre = prefix if f"{prefix}.weight" in d else alt
        if pre is None or f"{pre}.weight" not in d:
            raise KeyError(f"missing linear {prefix} (alt {alt})")
        _linear(d, pre, out, name)

    def attn(d: Tensors, prefix: str, name: str) -> None:
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            lin(d, f"{prefix}.{proj}", f"{name}.{proj}")
        for nrm in ("q_norm", "k_norm"):
            out[f"{name}.{nrm}.weight"] = _bf16(d.pop(f"{prefix}.{nrm}.weight"))

    def norm(d: Tensors, prefix: str, name: str) -> None:
        out[f"{name}.weight"] = _bf16(d.pop(f"{prefix}.weight"))

    def ff(d: Tensors, prefix: str, name: str) -> None:
        lin(d, f"{prefix}.project_in.proj", f"{name}.project_in")
        lin(d, f"{prefix}.project_out", f"{name}.project_out")

    for i, d in enumerate(per_layer):
        p = f"blocks.{i}"
        for stream in ("", "audio_"):
            for n in ("1", "2", "3"):
                norm(d, f"{stream}norm{n}", f"{p}.{stream}norm{n}")
            attn(d, f"{stream}attn1", f"{p}.{stream}attn1")
            attn(d, f"{stream}attn2", f"{p}.{stream}attn2")
            ff(d, f"{stream}ff", f"{p}.{stream}ff")
            out[f"{p}.{stream}scale_shift_table"] = _f32(d.pop(f"{stream}scale_shift_table"))
        for cross in ("audio_to_video", "video_to_audio"):
            norm(d, f"{cross}_norm", f"{p}.{cross}_norm")
            attn(d, f"{cross}_attn", f"{p}.{cross}_attn")
        for side in ("video", "audio"):
            key = f"scale_shift_table_a2v_ca_{side}"
            out[f"{p}.{key}"] = _f32(d.pop(key))
        if d:
            raise KeyError(f"unconsumed AV block-{i} keys: {sorted(d)[:5]}")

    def adaln(prefix: str, alt: Optional[str] = None) -> None:
        pre = prefix if f"{prefix}.emb.linear_1.weight" in top else (alt or prefix)
        for sub in ("emb.linear_1", "emb.linear_2", "linear"):
            lin(top, f"{pre}.{sub}", f"{prefix}.{sub}")

    lin(top, "patchify_proj", "patchify_proj")
    adaln("adaln_single")
    lin(top, "caption_projection.linear_1", "caption_projection.linear_1")
    lin(top, "caption_projection.linear_2", "caption_projection.linear_2")
    lin(top, "proj_out", "proj_out")
    out["scale_shift_table"] = _f32(top.pop("scale_shift_table"))
    lin(top, "audio_patchify_proj", "audio_patchify_proj", alt="audio_proj_in")
    adaln("audio_adaln_single", alt="audio_time_embed")
    lin(top, "audio_caption_projection.linear_1", "audio_caption_projection.linear_1")
    lin(top, "audio_caption_projection.linear_2", "audio_caption_projection.linear_2")
    lin(top, "audio_proj_out", "audio_proj_out")
    out["audio_scale_shift_table"] = _f32(top.pop("audio_scale_shift_table"))
    for name in ("av_ca_video_scale_shift_adaln_single", "av_ca_a2v_gate_adaln_single",
                 "av_ca_audio_scale_shift_adaln_single", "av_ca_v2a_gate_adaln_single"):
        adaln(name)
    _check_consumed(top, "top-level AV transformer", strict)
    return out


def load_av_transformer_params(tensors: Tensors, num_layers: int,
                               strict: bool = True) -> Tensors:
    """Unified-file tensors -> the LTXAVTransformer state dict."""
    return assemble_av_transformer_params(_transformer_raw(tensors, include_audio=True),
                                          num_layers, strict)


def transformer_config_from_state_dict(sd: Tensors,
                                       base: TransformerConfig = TransformerConfig()
                                       ) -> TransformerConfig:
    """The TransformerConfig whose LTXTransformer has `sd`'s shapes: depth,
    widths and channels from the tensors, base's head_dim (128 for LTX-2)
    and constants."""
    layers = 1 + max((int(m.group(1)) for m in map(re.compile(r"^blocks\.(\d+)\.").match, sd)
                      if m), default=-1)
    inner, in_channels = sd["patchify_proj.weight"].shape
    if inner % base.head_dim:
        raise WeightLoadingFailedError(f"inner dim {inner} is not a multiple of head_dim "
                                       f"{base.head_dim}")
    ffn = sd["blocks.0.ff.project_in.weight"].shape[0] if layers else inner * base.ffn_mult
    return dataclasses.replace(
        base, num_layers=layers, num_heads=inner // base.head_dim, in_channels=in_channels,
        out_channels=sd["proj_out.weight"].shape[0],
        cross_attention_dim=(sd["blocks.0.attn2.to_k.weight"].shape[1] if layers
                             else base.cross_attention_dim),
        caption_channels=sd["caption_projection.linear_1.weight"].shape[1],
        ffn_mult=ffn // inner)


# ---------------------------------------------------------------------------
# VAE decoder
# ---------------------------------------------------------------------------


def map_vae_decoder_key(key: str) -> Optional[str]:
    """Diffusers 3-up-block decoder layout, or the unified file's flat
    7-block layout -> flat canonical keys."""
    if key.startswith("encoder."):
        return None
    if "per_channel_statistics" in key:
        base = key.split(".")[-1]
        if base == "mean-of-means":
            return "mean_of_means"
        if base == "std-of-means":
            return "std_of_means"
        return None
    if key == "latents_mean":
        return "mean_of_means"
    if key == "latents_std":
        return "std_of_means"

    k = key
    if k.startswith("decoder."):
        k = k[len("decoder."):]
    if k.startswith("mid_block."):
        k = "up_blocks_0." + k[len("mid_block."):]
    else:
        for i in range(3):
            up_pre = f"up_blocks.{i}.upsamplers.0."
            res_pre = f"up_blocks.{i}.resnets."
            if k.startswith(up_pre):
                k = f"up_blocks_{2 * i + 1}." + k[len(up_pre):]
                break
            if k.startswith(res_pre):
                k = f"up_blocks_{2 * i + 2}.resnets." + k[len(res_pre):]
                break
    for i in range(7):  # the unified file's flat up_blocks.{i}.
        pre = f"up_blocks.{i}."
        if k.startswith(pre):
            k = f"up_blocks_{i}." + k[len(pre):]
            break
    return k.replace(".resnets.", ".res_blocks.")


def _conv(d: Tensors, prefix: str, out: Tensors, name: str) -> None:
    """A causal conv nests its Conv3d as `.conv.` in the checkpoint."""
    out[f"{name}.weight"] = _bf16(d.pop(f"{prefix}.conv.weight"))
    b = d.pop(f"{prefix}.conv.bias", None)
    if b is not None:
        out[f"{name}.bias"] = _bf16(b)


def _time_embedder(d: Tensors, prefix: str, out: Tensors) -> None:
    for lin in ("linear_1", "linear_2"):
        name = f"{prefix}.timestep_embedder.{lin}"
        w = _f32(d.pop(f"{name}.weight"))
        out[f"{name}.weight"] = w
        b = d.pop(f"{name}.bias", None)
        out[f"{name}.bias"] = _f32(b) if b is not None else torch.zeros(w.shape[0])


def load_vae_decoder_params(tensors: Tensors, strict: bool = True) -> Tensors:
    """-> the VideoDecoder state dict. A group without time-embedder keys
    (the diffusers layout) has none in it: `vae.without_time_embedders`
    fits the module to that."""
    raw: Tensors = {}
    for key, value in tensors.items():
        mapped = map_vae_decoder_key(key)
        if mapped is not None:
            raw[mapped] = value

    out: Tensors = {}
    _conv(raw, "conv_in", out, "conv_in")
    _conv(raw, "conv_out", out, "conv_out")
    for gi in (0, 2, 4, 6):
        prefix = f"up_blocks_{gi}"
        j = 0
        while f"{prefix}.res_blocks.{j}.conv1.conv.weight" in raw:
            blk = f"{prefix}.res_blocks.{j}"
            _conv(raw, f"{blk}.conv1", out, f"{blk}.conv1")
            _conv(raw, f"{blk}.conv2", out, f"{blk}.conv2")
            out[f"{blk}.scale_shift_table"] = _f32(raw.pop(f"{blk}.scale_shift_table"))
            j += 1
        if f"{prefix}.time_embedder.timestep_embedder.linear_1.weight" in raw:
            _time_embedder(raw, f"{prefix}.time_embedder", out)
    for ui in (1, 3, 5):
        _conv(raw, f"up_blocks_{ui}.conv", out, f"up_blocks_{ui}.conv")
    if "last_time_embedder.timestep_embedder.linear_1.weight" in raw:
        _time_embedder(raw, "last_time_embedder", out)
    out["last_scale_shift_table"] = _f32(raw.pop("last_scale_shift_table"))
    out["mean_of_means"] = _f32(raw.pop("mean_of_means").squeeze())
    out["std_of_means"] = _f32(raw.pop("std_of_means").squeeze())
    raw.pop("timestep_scale_multiplier", None)  # a config constant (1000)
    _check_consumed(raw, "VAE decoder", strict)
    return out


# ---------------------------------------------------------------------------
# VAE encoder
# ---------------------------------------------------------------------------


def load_vae_encoder_params(tensors: Tensors, strict: bool = True) -> Tensors:
    """encoder.* keys -> the VideoEncoder state dict."""
    raw = {k[len("encoder."):]: v for k, v in tensors.items() if k.startswith("encoder.")}
    out: Tensors = {}
    _conv(raw, "conv_in", out, "conv_in")
    _conv(raw, "conv_out", out, "conv_out")
    for i in range(4):
        j = 0
        while f"down_blocks.{i}.resnets.{j}.conv1.conv.weight" in raw:
            for c in ("conv1", "conv2"):
                name = f"down_blocks.{i}.resnets.{j}.{c}"
                _conv(raw, name, out, name)
            j += 1
        _conv(raw, f"down_blocks.{i}.downsamplers.0.conv", out,
              f"down_blocks.{i}.downsamplers.conv")
    j = 0
    while f"mid_block.resnets.{j}.conv1.conv.weight" in raw:
        for c in ("conv1", "conv2"):
            name = f"mid_block.resnets.{j}.{c}"
            _conv(raw, name, out, name)
        j += 1
    _check_consumed(raw, "VAE encoder", strict)
    return out


# ---------------------------------------------------------------------------
# Text encoder (feature extractor + video connector)
# ---------------------------------------------------------------------------


def _connector_internal(key: str) -> str:
    k = key.replace("transformer_blocks.", "transformer_1d_blocks.")
    k = k.replace(".norm_q.", ".q_norm.")
    k = k.replace(".norm_k.", ".k_norm.")
    k = k.replace(".to_out.0.", ".to_out.")
    k = k.replace(".ff.net.0.proj.", ".ff.project_in.proj.")
    return k.replace(".ff.net.2.", ".ff.project_out.")


def map_text_encoder_key(key: str) -> Optional[str]:
    """The standalone connector file (format 1) or the unified file's split
    (format 2) -> canonical keys."""
    if key.startswith("text_proj_in."):
        return key.replace("text_proj_in.", "feature_extractor.aggregate_embed.")
    if key.startswith("video_connector."):
        return _connector_internal(key.replace("video_connector.", "embeddings_connector."))
    if key.startswith("audio_connector."):
        return _connector_internal(
            key.replace("audio_connector.", "audio_embeddings_connector."))
    if key.startswith("text_embedding_projection."):
        return key.replace("text_embedding_projection.", "feature_extractor.")
    if key.startswith("video_embeddings_connector."):
        return _connector_internal(
            key.replace("video_embeddings_connector.", "embeddings_connector."))
    if key.startswith("audio_embeddings_connector."):
        return _connector_internal(key)
    return None


def _assemble_connector(raw: Tensors, prefix: str, out: Tensors) -> bool:
    if f"{prefix}.learnable_registers" not in raw:
        return False
    i = 0
    while f"{prefix}.transformer_1d_blocks.{i}.attn1.to_q.weight" in raw:
        pre = f"{prefix}.transformer_1d_blocks.{i}"
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            _linear(raw, f"{pre}.attn1.{proj}", out, f"{pre}.attn1.{proj}")
        for nrm in ("q_norm", "k_norm"):
            out[f"{pre}.attn1.{nrm}.weight"] = _bf16(raw.pop(f"{pre}.attn1.{nrm}.weight"))
        _linear(raw, f"{pre}.ff.project_in.proj", out, f"{pre}.ff.project_in")
        _linear(raw, f"{pre}.ff.project_out", out, f"{pre}.ff.project_out")
        i += 1
    out[f"{prefix}.learnable_registers"] = _bf16(raw.pop(f"{prefix}.learnable_registers"))
    return True


def load_text_encoder_params(tensors: Tensors, strict: bool = True) -> Tensors:
    """-> the TextEncoder state dict: the feature extractor, the video
    connector and, when the tensors have it, the audio connector
    (`TextEncoder(include_audio=...)`)."""
    raw: Tensors = {}
    for key, value in tensors.items():
        mapped = map_text_encoder_key(key)
        if mapped is not None:
            raw[mapped] = value
    out = {"feature_extractor.aggregate_embed.weight":
           _bf16(raw.pop("feature_extractor.aggregate_embed.weight"))}
    if not _assemble_connector(raw, "embeddings_connector", out):
        raise WeightLoadingFailedError("missing video connector weights")
    _assemble_connector(raw, "audio_embeddings_connector", out)
    _check_consumed(raw, "text encoder", strict)
    return out


# ---------------------------------------------------------------------------
# Gemma-3
# ---------------------------------------------------------------------------


def _mlx_codes(tensors: Tensors, key: str, bits: int, device) -> torch.Tensor:
    """Pops {key}.weight, whose uint32 words pack 32/bits codes each
    (little-endian: code n of a word in bits n*bits...), and returns the
    (out, in) codes as int32 on `device` (default: the tensor's)."""
    packed = tensors.pop(f"{key}.weight")
    device = packed.device if device is None else device
    packed = packed.view(torch.int32).to(device)  # the same bits; int32 shifts and masks
    o, iw = packed.shape
    shifts = torch.arange(0, 32, bits, dtype=torch.int32, device=device)
    return ((packed[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(o, iw * (32 // bits))


def _maybe_dequant_mlx_4bit(tensors: Tensors, key: str, group_size: int = 64,
                            bits: int = 4, device=None) -> torch.Tensor:
    """An MLX-quantized linear: {key}.weight packs the codes (`_mlx_codes`),
    {key}.scales and {key}.biases hold each group's affine along the input;
    w[o, i] = q * scale + bias in float32 (a product, then a sum: two
    roundings, no fused multiply-add). Pops the three keys; computes on
    `device` (default: the weight's) and returns the (out, in) float32
    weight there."""
    q = _mlx_codes(tensors, key, bits, device)
    scales = tensors.pop(f"{key}.scales").to(q.device, torch.float32)
    biases = tensors.pop(f"{key}.biases").to(q.device, torch.float32)
    o, d_in = q.shape
    w = q.float().reshape(o, d_in // group_size, group_size) * scales[:, :, None]
    w = w + biases[:, :, None]
    return w.reshape(o, d_in)


def _repack_mlx_4bit(tensors: Tensors, key: str, bits: int = 4, device=None) -> Tensors:
    """An MLX-quantized (out, in) linear -> the int4 leaves {"w_q4" (in/2,
    out) block-plane packed, "scale", "bias" (in/g, out) float32}, exactly:
    the same codes and groups, transposed (no dequantization). Pops the
    three keys; computes on `device` (default: the weight's)."""
    q = _mlx_codes(tensors, key, bits, device)
    return {"w_q4": pack_int4(q.t().to(torch.uint8)),
            "scale": tensors.pop(f"{key}.scales").to(q.device).t().float().contiguous(),
            "bias": tensors.pop(f"{key}.biases").to(q.device).t().float().contiguous()}


_GEMMA_MODES = ("bf16", "int4", "w8a8")


def load_gemma_params(tensors: Tensors, num_layers: int, quant_group_size: int = 64,
                      quant_bits: int = 4, keep_quantized: bool = True, strict: bool = True,
                      mode: str = "int4", embed_int8: bool = False, device=None) -> Tensors:
    """HF or MLX Gemma-3 weights -> the Gemma3Model state dict
    (`Gemma3Model.from_state_dict` builds the model of its formats).

    The reference's sanitize rules: a `language_model.` prefix is stripped
    (and keys without it, the vision tower's, are not read), `lm_head` is
    dropped, float32 rounds to bfloat16. The reference's modes for the
    linears of an MLX 4-bit snapshot: "int4" repacks them losslessly
    (QuantizedLinear leaves), "w8a8" repacks and requantizes them per
    output channel (W8A8Linear leaves: `requant_int8_channel` of the
    dequantized values), "bf16" dequantizes them; a dense linear stays
    bfloat16 but in "w8a8". keep_quantized=False is "bf16". The token table
    dequantizes to bfloat16, or with `embed_int8` quantizes per row to int8
    ("w8r", "sr"). Whatever is computed is computed on `device` (default:
    where the tensors are) and left there; a tensor kept as it is stays
    where it was (a view of a mapped file)."""
    if not keep_quantized and mode == "int4":
        mode = "bf16"
    if mode not in _GEMMA_MODES:
        raise ValueError(f"Gemma mode {mode!r}: one of {_GEMMA_MODES}")
    src: Tensors = {}
    has_lm_prefix = any(k.startswith("language_model.") for k in tensors)
    for k, v in tensors.items():
        if has_lm_prefix:
            if not k.startswith("language_model."):
                continue
            k = k[len("language_model."):]
        if k.startswith("lm_head"):
            continue
        src[k] = v

    def dense(prefix: str) -> Tensors:
        """{leaf name: tensor} of one linear, the module's names."""
        if f"{prefix}.scales" in src:
            if mode == "int4":
                return _repack_mlx_4bit(src, prefix, quant_bits, device)
            if mode == "w8a8":
                return requant_int8_channel(_repack_mlx_4bit(src, prefix, quant_bits, device))
            w = _maybe_dequant_mlx_4bit(src, prefix, quant_group_size, quant_bits, device)
        else:
            w = src.pop(f"{prefix}.weight")
        if mode == "w8a8":
            return requant_int8_channel(w.to(device if device is not None else w.device).t())
        return {"weight": _bf16(w)}

    out: Tensors = {}

    def put(name: str, leaves: Tensors):
        out.update({f"{name}.{leaf}": t for leaf, t in leaves.items()})

    for i in range(num_layers):
        p, q = f"model.layers.{i}", f"layers.{i}"
        for name, key in (("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
                          ("v_proj", "self_attn.v_proj"), ("o_proj", "self_attn.o_proj")):
            put(f"{q}.{name}", dense(f"{p}.{key}"))
        for name in ("q_norm", "k_norm"):
            out[f"{q}.{name}.weight"] = _bf16(src.pop(f"{p}.self_attn.{name}.weight"))
        for name in ("gate_proj", "up_proj", "down_proj"):
            put(f"{q}.{name}", dense(f"{p}.mlp.{name}"))
        for name in ("input_layernorm", "post_attention_layernorm",
                     "pre_feedforward_layernorm", "post_feedforward_layernorm"):
            out[f"{q}.{name}.weight"] = _bf16(src.pop(f"{p}.{name}.weight"))
    if "model.embed_tokens.scales" in src:
        emb = _maybe_dequant_mlx_4bit(src, "model.embed_tokens", quant_group_size,
                                      quant_bits, device)
    else:
        emb = src.pop("model.embed_tokens.weight")
    if embed_int8:
        # per-row scales: each row of the (vocab, dim) table is a column of
        # its transpose, which requant_int8_channel scales per column
        rows = requant_int8_channel(emb.to(device if device is not None else emb.device).t())
        out["embed_tokens.w8r"], out["embed_tokens.sr"] = rows["w8"].t(), rows["sw"]
    else:
        out["embed_tokens.weight"] = _bf16(emb)
    out["norm.weight"] = _bf16(src.pop("model.norm.weight"))
    _check_consumed(src, "Gemma", strict)
    return out


# ---------------------------------------------------------------------------
# Unified file splitting
# ---------------------------------------------------------------------------


def split_unified(tensors: Tensors, include_audio: bool = False):
    """Classify unified-file keys into (transformer, vae, connector) buckets,
    with the prefixes the component loaders expect."""
    diffusion = "model.diffusion_model."
    vid_conn = diffusion + "video_embeddings_connector."
    aud_conn = diffusion + "audio_embeddings_connector."
    proj = diffusion + "text_embedding_projection."

    transformer: Tensors = {}
    vae: Tensors = {}
    connector: Tensors = {}
    for key, value in tensors.items():
        if key.endswith(".weight_scale") or key.endswith(".input_scale"):
            continue
        if not include_audio and ("audio" in key or key.startswith("vocoder")
                                  or "av_ca_" in key):
            continue
        if key.startswith(vid_conn):
            connector["video_embeddings_connector." + key[len(vid_conn):]] = value
        elif include_audio and key.startswith(aud_conn):
            connector["audio_embeddings_connector." + key[len(aud_conn):]] = value
        elif key.startswith(proj):
            connector["text_embedding_projection." + key[len(proj):]] = value
        elif key.startswith("text_embedding_projection."):
            connector[key] = value
        elif key.startswith(diffusion):
            transformer[key[len(diffusion):]] = value
        elif key.startswith("vae."):
            vae[key[len("vae."):]] = value
        elif "per_channel_statistics" in key:
            vae[key] = value
    return transformer, vae, connector
