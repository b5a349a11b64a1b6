"""Parameter trees of the JAX package -> the port's modules.

The one place where layouts change. A tree is nested dicts/lists of arrays
(jax or numpy), as `ltx_tpu.models.*.init_params` and the weight loaders
build them. The rules:
  * a dict meeting an nn.ModuleList is STACKED (the reference's scanned
    `blocks` / `layers`): leaf i along the leading axis goes to entry i;
    a list meets a ModuleList entry by entry;
  * "w" -> "weight", "b" -> "bias" on Linear, Conv3d, Conv2d, Conv1d,
    ConvTranspose1d, NormWeight, NormAffine, Embedding;
  * Linear weights transpose (in, out) -> (out, in); Conv3d weights permute
    DHWIO (kt, kh, kw, I, O) -> (O, I, kt, kh, kw), Conv2d weights HWIO ->
    (O, I, kh, kw), Conv1d weights (k, I, O) -> (O, I, k) and
    ConvTranspose1d weights (k, O, I) -> (I, O, k); everything else copies;
  * a quantized linear leaf ({"w_q4"|"w_q", "scale", "bias", "b"?}, or
    W8A8's {"w8", "sw", "b"?}) meeting a Linear turns it into a
    QuantizedLinear (a W8A8Linear) shaped from the leaf, whose parameters
    keep the JAX keys and layout; an int8 token table ({"w8r", "sr"})
    meeting an Embedding turns it into an Int8Embedding (`transformer`,
    `gemma`);
  * a linear leaf carrying a LoRA side path ({"lora_a" (in, r), "lora_b"
    (r, out), "lora_s" ()}, stacked (L, in, r), (L, r, out), (L,) in the
    blocks, as train.lora.add_lora inserts them) gives its linear the three
    parameters, of the leaf's rank and dtype, in the same layout
    (`transformer` only);
  * strict: a leaf with no parameter, a parameter with no leaf, or a shape or
    dtype that differs raises ValueError. Integer codes cast through float32
    and back, which is exact for uint8.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from ltx_tpu_torch.models.common import (
    Conv1d,
    Conv2d,
    Conv3d,
    ConvTranspose1d,
    Embedding,
    Linear,
    NormAffine,
    NormWeight,
    QuantizedLinear,
    W8A8Linear,
    for_leaves,
)

_RENAMED = (Linear, Conv3d, Conv2d, Conv1d, ConvTranspose1d, NormWeight, NormAffine,
            Embedding)


def _leaves(tree, module: nn.Module, prefix: str) -> Iterator[Tuple[str, object]]:
    """(torch parameter name, array) for every leaf of `tree` under
    `module`; raises ValueError for a key with no submodule or parameter."""
    if isinstance(module, nn.ModuleList):
        if isinstance(tree, dict):   # stacked along the leading axis
            for i, sub in enumerate(module):
                yield from _leaves(_index(tree, i, len(module), prefix), sub,
                                   f"{prefix}{i}.")
            return
        if len(tree) != len(module):
            raise ValueError(f"{prefix}: {len(tree)} entries, module has {len(module)}")
        for i, (item, sub) in enumerate(zip(tree, module)):
            yield from _leaves(item, sub, f"{prefix}{i}.")
        return
    for key, value in tree.items():
        if isinstance(value, (dict, list, tuple)):
            child = getattr(module, key, None)
            if not isinstance(child, nn.Module):
                raise ValueError(f"unconsumed subtree {prefix}{key}")
            yield from _leaves(value, child, f"{prefix}{key}.")
            continue
        name = {"w": "weight", "b": "bias"}.get(key, key) if isinstance(
            module, _RENAMED) else key
        yield f"{prefix}{name}", value


def _swap_quantized(module: nn.Module, tree) -> None:
    """Replace each Linear or Embedding that meets a quantized leaf in
    `tree` by an empty module of the leaf's format (`models.common.
    for_leaves`; a stacked leaf's group count is its second-to-last dim
    too), for load_tree to fill."""
    if isinstance(module, nn.ModuleList):
        items = [tree] * len(module) if isinstance(tree, dict) else tree
        for item, sub in zip(items, module):
            _swap_quantized(sub, item)
        return
    for key, value in tree.items():
        child = getattr(module, key, None)
        if not isinstance(value, (dict, list)) or not isinstance(child, nn.Module):
            continue
        new = for_leaves(child, value) if isinstance(value, dict) else child
        if new is not child:
            setattr(module, key, new)
        else:
            _swap_quantized(child, value)


def _add_lora_slots(module: nn.Module, tree) -> None:
    """Give each linear that meets a leaf with "lora_a" in `tree` empty
    LoRA parameters of that leaf's rank and dtype, for load_tree to fill."""
    if isinstance(module, nn.ModuleList):
        items = [tree] * len(module) if isinstance(tree, dict) else tree
        for item, sub in zip(items, module):
            _add_lora_slots(sub, item)
        return
    for key, value in tree.items():
        child = getattr(module, key, None)
        if not isinstance(value, (dict, list)) or not isinstance(child, nn.Module):
            continue
        if isinstance(child, (Linear, QuantizedLinear, W8A8Linear)) and "lora_a" in value:
            a = np.asarray(value["lora_a"])
            child.add_lora_params(a.shape[-1], getattr(torch, str(a.dtype)))
        else:
            _add_lora_slots(child, value)


def _index(tree, i: int, n: int, prefix: str):
    if isinstance(tree, dict):
        return {k: _index(v, i, n, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, i, n, prefix) for v in tree]
    if tree.shape[0] != n:
        raise ValueError(f"stacked leaf {prefix} has leading dim {tree.shape[0]}, "
                         f"the module has {n} entries")
    return tree[i]


def _to_numpy(tree):
    """Every leaf as a host numpy array, converted once (a stacked leaf is
    then sliced per entry without another device copy)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def _owner(module: nn.Module, name: str) -> nn.Module:
    owner = module
    for part in name.split(".")[:-1]:
        owner = owner[int(part)] if isinstance(owner, nn.ModuleList) else getattr(owner, part)
    return owner


def _to_torch(array, owner: nn.Module, leaf: str) -> Tuple[torch.Tensor, str]:
    """Host copy of one leaf in the port's layout, and its dtype name."""
    arr = np.asarray(array)
    dtype_name = str(arr.dtype)
    host = torch.from_numpy(np.array(arr, dtype=np.float32))  # 0-d stays 0-d
    if leaf == "weight" and isinstance(owner, Linear):
        host = host.t()
    elif leaf == "weight" and isinstance(owner, Conv3d):
        host = host.permute(4, 3, 0, 1, 2)
    elif leaf == "weight" and isinstance(owner, Conv2d):
        host = host.permute(3, 2, 0, 1)
    elif leaf == "weight" and isinstance(owner, (Conv1d, ConvTranspose1d)):
        host = host.permute(2, 1, 0)
    return host, dtype_name


@torch.no_grad()
def load_tree(module: nn.Module, tree) -> nn.Module:
    """Fill every parameter of `module` from `tree`, strictly. Returns it."""
    params: Dict[str, torch.Tensor] = dict(module.named_parameters())
    filled = set()
    for name, array in _leaves(_to_numpy(tree), module, ""):
        if name not in params:
            raise ValueError(f"unconsumed leaf {name}: no such parameter")
        target = params[name]
        host, dtype_name = _to_torch(array, _owner(module, name), name.rsplit(".", 1)[-1])
        if dtype_name != str(target.dtype).removeprefix("torch."):
            raise ValueError(f"{name}: leaf dtype {dtype_name}, parameter {target.dtype}")
        if tuple(host.shape) != tuple(target.shape):
            raise ValueError(f"{name}: leaf shape {tuple(host.shape)} (converted), "
                             f"parameter {tuple(target.shape)}")
        target.copy_(host)
        filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        raise ValueError(f"parameters with no leaf: {missing[:8]}"
                         + (" ..." if len(missing) > 8 else ""))
    return module


def port_config(cfg, cls):
    """A reference config dataclass -> the port's class of the same fields."""
    return cls(**dataclasses.asdict(cfg))


def tree_dtype(tree) -> torch.dtype:
    """The torch dtype of a tree's first leaf."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    if isinstance(tree, torch.Tensor):
        return tree.dtype
    return getattr(torch, str(np.asarray(tree).dtype))


def transformer(tree, cfg, device=None):
    """dit.init_params tree, plain or quantized by
    quantize_transformer_params, with or without LoRA side paths from
    train.lora.add_lora -> LTXTransformer (cfg: TransformerConfig)."""
    from ltx_tpu_torch.models.dit import LTXTransformer

    tree = _to_numpy(tree)
    dtype = tree_dtype(tree["patchify_proj"]["w"])
    model = LTXTransformer(cfg, device=device, dtype=dtype)
    _swap_quantized(model, tree)
    _add_lora_slots(model, tree)
    return load_tree(model, tree)


def vae_decoder(tree, cfg, device=None):
    """vae.init_decoder_params or keymaps.load_vae_decoder_params tree ->
    VideoDecoder (cfg: a VAEConfig); a tree without a group's time embedder
    (the diffusers layout) gives a decoder without it."""
    from ltx_tpu_torch.models.vae import VAEConfig, VideoDecoder, without_time_embedders

    dtype = tree_dtype(tree["conv_in"]["w"])
    model = VideoDecoder(port_config(cfg, VAEConfig), device=device, dtype=dtype)

    def present(name):
        node = tree
        for part in name.split("."):
            if part not in node:
                return False
            node = node[part]
        return True

    return load_tree(without_time_embedders(model, present), tree)


def _layout(tensor: torch.Tensor, owner: nn.Module, leaf: str):
    """A DiT leaf between the JAX layout and the module's, either way: a
    Linear weight transposes (a view), everything else stays."""
    return tensor.t() if leaf == "weight" and isinstance(owner, Linear) else tensor


def transformer_tree(model: nn.Module) -> dict:
    """The JAX package's tree of an LTXTransformer, plain or quantized: the
    blocks stacked along a leading axis, Linear weights (in, out), "w" / "b"
    for Linear and NormWeight parameters, QuantizedLinear and W8A8Linear
    leaves as they are; contiguous tensors where the parameters are (the
    inverse of `transformer`)."""
    return _module_tree(model, "blocks")


def gemma_tree(model: nn.Module) -> dict:
    """The JAX package's tree of a Gemma3Model in any of its formats (the
    layers stacked along a leading axis), as `transformer_tree`."""
    return _module_tree(model, "layers")


def _module_tree(model: nn.Module, stacked_name: str) -> dict:
    tree: dict = {}
    stacked: Dict[Tuple[str, ...], list] = {}
    for name, p in model.named_parameters():
        owner, leaf = _owner(model, name), name.rsplit(".", 1)[-1]
        key = {"weight": "w", "bias": "b"}.get(leaf, leaf) if isinstance(
            owner, _RENAMED) else leaf
        value = _layout(p.detach(), owner, leaf).contiguous()
        parts = name.split(".")[:-1] + [key]
        if parts[0] == stacked_name:
            stacked.setdefault((stacked_name,) + tuple(parts[2:]), []).append(value)
        else:
            _set_path(tree, tuple(parts), value)
    for path in list(stacked):
        _set_path(tree, path, torch.stack(stacked.pop(path)))
    return tree


def _set_path(tree: dict, path: Tuple[str, ...], value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def transformer_from_tree(tree, cfg) -> nn.Module:
    """A JAX-layout DiT tree of torch tensors (e.g. a quantized-weight
    cache) -> LTXTransformer whose parameters are the tree's tensors (a
    stacked leaf's entries are views; plain Linear weights are copied,
    transposed, and so is a W8A8 weight not stored column-major), checked
    by `models.common.assign_`."""
    from ltx_tpu_torch.models.dit import LTXTransformer

    return _from_tree(LTXTransformer(cfg, device="meta",
                                     dtype=tree["patchify_proj"]["w"].dtype), tree)


def gemma_from_tree(tree, cfg) -> nn.Module:
    """A JAX-layout Gemma tree of torch tensors in any of its formats (a
    quantized-weight cache) -> Gemma3Model, as `transformer_from_tree`."""
    from ltx_tpu_torch.models.gemma3 import Gemma3Model

    return _from_tree(Gemma3Model(cfg, device="meta", dtype=_gemma_dtype(tree)), tree)


def _from_tree(model: nn.Module, tree) -> nn.Module:
    from ltx_tpu_torch.models.common import assign_

    _swap_quantized(model, tree)
    return assign_(model, {name: _layout(leaf, _owner(model, name), name.rsplit(".", 1)[-1])
                           for name, leaf in _leaves(tree, model, "")})


def _gemma_dtype(tree) -> torch.dtype:
    """The reference's `embed_dtype`: the token table's, bf16 for an int8
    table."""
    emb = tree["embed_tokens"]
    return tree_dtype(emb["w"]) if "w" in emb else torch.bfloat16


def vae_encoder(tree, cfg, device=None):
    """vae.init_encoder_params tree -> VideoEncoder (cfg: a VAEConfig)."""
    from ltx_tpu_torch.models.vae import VAEConfig, VideoEncoder

    dtype = tree_dtype(tree["conv_in"]["w"])
    return load_tree(VideoEncoder(port_config(cfg, VAEConfig), device=device,
                                  dtype=dtype), tree)


def upscaler(tree, cfg, device=None):
    """upscaler.init_params / load_params tree -> LatentUpscaler (cfg: an
    UpscalerConfig)."""
    from ltx_tpu_torch.models.upscaler import LatentUpscaler, UpscalerConfig

    dtype = tree_dtype(tree["initial_conv"]["w"])
    return load_tree(LatentUpscaler(port_config(cfg, UpscalerConfig), device=device,
                                    dtype=dtype), tree)


def gemma(tree, cfg, device=None):
    """gemma3.init_params or keymaps.load_gemma_params tree, in any of its
    modes (bf16, int4 or W8A8 layers, an int8 token table) -> Gemma3Model
    (cfg: a Gemma3Config)."""
    from ltx_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model

    tree = _to_numpy(tree)
    model = Gemma3Model(port_config(cfg, Gemma3Config), device=device,
                        dtype=_gemma_dtype(tree))
    _swap_quantized(model, tree)
    return load_tree(model, tree)


def text_encoder(tree, cfg, device=None):
    """text_encoder.init_params tree, with or without the audio connector ->
    TextEncoder (cfg: a TextEncoderConfig)."""
    from ltx_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig

    dtype = tree_dtype(tree["feature_extractor"]["aggregate_embed"]["w"])
    return load_tree(TextEncoder(port_config(cfg, TextEncoderConfig), device=device,
                                 dtype=dtype,
                                 include_audio="audio_embeddings_connector" in tree), tree)


def av_transformer(tree, cfg, device=None):
    """dit_av.init_params tree, plain or quantized by
    quantize_transformer_params, with or without LoRA side paths from
    train.lora.add_lora -> LTXAVTransformer (cfg: TransformerConfig)."""
    from ltx_tpu_torch.models.dit_av import LTXAVTransformer

    tree = _to_numpy(tree)
    model = LTXAVTransformer(cfg, device=device, dtype=tree_dtype(tree["patchify_proj"]["w"]))
    _swap_quantized(model, tree)
    _add_lora_slots(model, tree)
    return load_tree(model, tree)


def av_transformer_tree(model: nn.Module) -> dict:
    """The JAX package's tree of an LTXAVTransformer, as `transformer_tree`."""
    return _module_tree(model, "blocks")


def av_transformer_from_tree(tree, cfg) -> nn.Module:
    """A JAX-layout dual DiT tree of torch tensors (a quantized-weight
    cache) -> LTXAVTransformer, as `transformer_from_tree`."""
    from ltx_tpu_torch.models.dit_av import LTXAVTransformer

    return _from_tree(LTXAVTransformer(cfg, device="meta",
                                       dtype=tree["patchify_proj"]["w"].dtype), tree)


def audio_vae(tree, cfg, device=None):
    """audio_vae.init_audio_vae_params / load_audio_vae_params tree ->
    AudioVAE (cfg: an AudioVAEConfig)."""
    from ltx_tpu_torch.config import AudioVAEConfig
    from ltx_tpu_torch.models.audio_vae import AudioVAE

    dtype = tree_dtype(tree["decoder"]["conv_in"]["w"])
    return load_tree(AudioVAE(port_config(cfg, AudioVAEConfig), device=device,
                              dtype=dtype), tree)


def vocoder(tree, cfg, device=None):
    """audio_vae.init_vocoder_params / load_vocoder_params tree -> Vocoder
    (cfg: a VocoderConfig)."""
    from ltx_tpu_torch.config import VocoderConfig
    from ltx_tpu_torch.models.audio_vae import Vocoder

    dtype = tree_dtype(tree["conv_in"]["w"])
    return load_tree(Vocoder(port_config(cfg, VocoderConfig), device=device, dtype=dtype),
                     tree)


def siglip(tree, cfg, device=None):
    """siglip.init_params / load_vision_params tree -> SigLIPModel (cfg: a
    SigLIPConfig)."""
    from ltx_tpu_torch.models.siglip import SigLIPConfig, SigLIPModel

    dtype = tree_dtype(tree["patch_embedding"]["w"])
    return load_tree(SigLIPModel(port_config(cfg, SigLIPConfig), device=device,
                                 dtype=dtype), tree)
