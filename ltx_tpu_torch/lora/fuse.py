"""LoRA: parse, key-map, and fuse into the DiT's linears.

Port of ltx_tpu/lora/fuse.py on an LTXTransformer instead of a stacked
tree:
  * pairs: `lora_down`/`lora_up` (ComfyUI) or `lora_A`/`lora_B`
    (Diffusers/PEFT), an optional per-layer `.alpha`;
  * delta = scale * (alpha / rank) * (up @ down), float32, (out, in): the
    `Linear` weight's own layout, so nothing is transposed;
  * fusion is a permanent merge W' = W + delta, in float32 with one
    rounding to the weight's dtype; a quantized linear (int4 or int8
    `QuantizedLinear`) is dequantized in float32, merged and quantized
    again with `quantize_weight`.

The merge runs on the device the caller names (default: where the weight
lives) and the result goes back where the weight lived. `fuse_lora`
leaves the caller's module as it was unless asked (`inplace=True`): it
returns a copy of the module's structure that shares every parameter
except the merged ones, which are new tensors (copy on write per leaf).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ltx_tpu_torch.kernels.quantization import dequantize_weight, quantize_weight
from ltx_tpu_torch.models.common import Linear, QuantizedLinear, W8A8Linear

log = logging.getLogger("ltx_tpu_torch")


@dataclasses.dataclass(frozen=True)
class LoRALayer:
    original_key: str     # canonical model key, e.g. transformer_blocks.0.attn1.to_q
    down: torch.Tensor    # (rank, in)
    up: torch.Tensor      # (out, rank)
    alpha: Optional[float]

    @property
    def rank(self) -> int:
        return self.down.shape[0]

    @property
    def effective_scale(self) -> float:
        return (self.alpha / self.rank) if self.alpha is not None else 1.0

    def delta(self, scale: float = 1.0, device=None) -> torch.Tensor:
        """(out, in) float32 delta, computed on `device` (default: the CPU)."""
        d = self.up.to(device, torch.float32) @ self.down.to(device, torch.float32)
        return d * (scale * self.effective_scale)


def map_lora_key(key: str) -> str:
    """LoRA key -> canonical transformer key (without `.weight`)."""
    k = key
    if k.startswith("diffusion_model."):
        k = k[len("diffusion_model."):]
    k = k.replace(".emb.timestep_embedder.", ".emb.")
    k = k.replace(".to_out.0", ".to_out")
    k = k.replace(".ff.net.0.proj", ".ff.project_in.proj")
    return k.replace(".ff.net.2", ".ff.project_out")


def _tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))


def parse_lora(tensors: Dict[str, object]) -> List[LoRALayer]:
    """Find the down/up pairs and their alphas ({key: tensor or array})."""
    layers = []
    for key in list(tensors):
        if "lora_down" in key:
            up_key = key.replace("lora_down", "lora_up")
            original = key.replace(".lora_down.weight", "").replace(".lora_down", "")
        elif "lora_A" in key:
            up_key = key.replace("lora_A", "lora_B")
            original = key.replace(".lora_A.weight", "").replace(".lora_A", "")
        else:
            continue
        if up_key not in tensors:
            continue
        alpha_t = tensors.get(original + ".alpha")
        alpha = float(_tensor(alpha_t).reshape(())) if alpha_t is not None else None
        layers.append(LoRALayer(original_key=map_lora_key(original),
                                down=_tensor(tensors[key]), up=_tensor(tensors[up_key]),
                                alpha=alpha))
    return layers


_BLOCK_KEY = re.compile(r"^transformer_blocks\.(\d+)\.(.+)$")

# canonical suffix -> the linear's module path inside a block
_BLOCK_PATHS = {
    "attn1.to_q": "attn1.to_q", "attn1.to_k": "attn1.to_k",
    "attn1.to_v": "attn1.to_v", "attn1.to_out": "attn1.to_out",
    "attn2.to_q": "attn2.to_q", "attn2.to_k": "attn2.to_k",
    "attn2.to_v": "attn2.to_v", "attn2.to_out": "attn2.to_out",
    "ff.project_in.proj": "ff.project_in", "ff.project_out": "ff.project_out",
}

_TOP_PATHS = {
    "proj_in": "patchify_proj", "patchify_proj": "patchify_proj",
    "proj_out": "proj_out",
    "caption_projection.linear_1": "caption_projection.linear_1",
    "caption_projection.linear_2": "caption_projection.linear_2",
    "adaln_single.emb.linear_1": "adaln_single.emb.linear_1",
    "adaln_single.emb.linear_2": "adaln_single.emb.linear_2",
    "adaln_single.linear": "adaln_single.linear",
    "time_embed.emb.linear_1": "adaln_single.emb.linear_1",
    "time_embed.emb.linear_2": "adaln_single.emb.linear_2",
    "time_embed.linear": "adaln_single.linear",
}


def module_path(key: str, num_blocks: int) -> Optional[str]:
    """A canonical LoRA key -> the path of its linear in an LTXTransformer
    of `num_blocks` blocks, or None when the model has no such linear."""
    m = _BLOCK_KEY.match(key)
    if m:
        suffix = _BLOCK_PATHS.get(m.group(2))
        if suffix is None or int(m.group(1)) >= num_blocks:
            return None
        return f"blocks.{m.group(1)}.{suffix}"
    return _TOP_PATHS.get(key)


@torch.no_grad()
def _merge_leaf(linear: nn.Module, delta: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{parameter name: merged tensor} of a Linear or QuantizedLinear and
    an (out, in) float32 delta on the device where the merge runs; the
    results are on that device."""
    device = delta.device
    if isinstance(linear, QuantizedLinear):
        codes = "w_q4" if hasattr(linear, "w_q4") else "w_q"
        leaf = {k: getattr(linear, k).to(device) for k in (codes, "scale", "bias")}
        w = dequantize_weight(leaf, torch.float32) + delta.t()
        group = w.shape[0] // leaf["scale"].shape[0]
        return quantize_weight(w, 4 if codes == "w_q4" else 8, group)
    weight = linear.weight
    merged = weight.to(device, torch.float32) + delta
    return {"weight": merged.to(weight.dtype)}


def _structure_copy(model: nn.Module) -> nn.Module:
    """A copy of the module tree sharing every parameter and buffer."""
    memo = {id(t): t for t in list(model.parameters()) + list(model.buffers())}
    return copy.deepcopy(model, memo)


def fuse_lora(model: nn.Module, layers: List[LoRALayer], scale: float = 1.0,
              num_layers: Optional[int] = None, device=None,
              inplace: bool = False) -> nn.Module:
    """Merge LoRA deltas into an LTXTransformer's linears; returns the
    fused model. Each delta and merge runs on `device` (default: where the
    linear's weight lives), the result lands where the weight lived.
    Without `inplace` the caller's model is untouched: the result shares
    every parameter it does not change. Layers whose linear the model does
    not have (another key, a block past its depth) are skipped.
    `num_layers` is the reference's argument, unused there too."""
    out = model if inplace else _structure_copy(model)
    blocks = len(out.blocks)
    fused = skipped = 0
    for layer in layers:
        path = module_path(layer.original_key, blocks)
        linear = out.get_submodule(path) if path is not None else None
        if isinstance(linear, W8A8Linear):
            raise TypeError(f"{path}: a W8A8 linear takes no fused LoRA; fuse before "
                            "quantizing, as load_pipeline does")
        if not isinstance(linear, (Linear, QuantizedLinear)):
            skipped += 1
            log.debug("LoRA fuse: no model weight for %s", layer.original_key)
            continue
        home = linear.scale.device if isinstance(linear, QuantizedLinear) \
            else linear.weight.device
        new = _merge_leaf(linear, layer.delta(scale, device if device is not None else home))
        for name, value in new.items():
            old = getattr(linear, name)
            setattr(linear, name, nn.Parameter(value.to(home), requires_grad=old.requires_grad))
        fused += 1
    log.info("LoRA: fused %d layers (%d skipped)", fused, skipped)
    return out


def fuse_multi_lora(model: nn.Module, loras: List[Tuple[List[LoRALayer], float]],
                    device=None) -> nn.Module:
    """Additive multi-LoRA: each (layers, scale) in turn."""
    for layers, scale in loras:
        model = fuse_lora(model, layers, scale, device=device)
    return model


def fuse_lora_file(model: nn.Module, path, scale: float = 1.0,
                   num_layers: Optional[int] = None, device=None,
                   inplace: bool = False) -> nn.Module:
    from ltx_tpu_torch.weights.download import load_safetensors

    return fuse_lora(model, parse_lora(load_safetensors(path)), scale, num_layers,
                     device=device, inplace=inplace)


@dataclasses.dataclass(frozen=True)
class LoRASchedulerOverrides:
    """Scheduler overrides for specialized (Turbo-style) LoRAs; `apply_to`
    sets them on a GenerationConfig."""

    num_steps: Optional[int] = None
    guidance_scale: Optional[float] = None
    sigmas: Optional[Tuple[float, ...]] = None

    def apply_to(self, config):
        """GenerationConfig -> GenerationConfig with the overrides."""
        updates = {}
        if self.num_steps is not None:
            updates["num_steps"] = self.num_steps
        if self.guidance_scale is not None:
            updates["cfg_scale"] = self.guidance_scale
        if self.sigmas is not None:
            updates["sigmas_override"] = tuple(float(s) for s in self.sigmas)
        return dataclasses.replace(config, **updates) if updates else config


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """One LoRA to load."""

    weights_path: str
    scale: float = 1.0
    fused: bool = True   # only fused inference exists, as in the reference
    name: Optional[str] = None
    scheduler_overrides: Optional[LoRASchedulerOverrides] = None


@dataclasses.dataclass(frozen=True)
class LoRAInfo:
    """What a LoRA file holds."""

    name: str
    path: str
    layer_count: int
    rank: int
    target_modules: Tuple[str, ...]
    has_scheduler_overrides: bool
    file_size_bytes: Optional[int]


def lora_info(path, name: Optional[str] = None, scheduler_overrides=None) -> LoRAInfo:
    """Inspect a LoRA safetensors file without fusing it."""
    from ltx_tpu_torch.weights.download import load_safetensors

    layers = parse_lora(load_safetensors(path))
    modules = sorted({layer.original_key.rsplit(".", 1)[-1] for layer in layers})
    return LoRAInfo(
        name=name or os.path.basename(str(path)), path=str(path),
        layer_count=len(layers), rank=max((la.rank for la in layers), default=0),
        target_modules=tuple(modules),
        has_scheduler_overrides=scheduler_overrides is not None,
        file_size_bytes=os.path.getsize(path) if os.path.exists(str(path)) else None)


def fuse_lora_configs(model: nn.Module, configs, num_layers=None, device=None) -> nn.Module:
    """Fuse a sequence of LoRAConfig in order."""
    for cfg in configs:
        log.info("Fusing LoRA %s (scale %.2f)", cfg.name or cfg.weights_path, cfg.scale)
        model = fuse_lora_file(model, cfg.weights_path, cfg.scale, num_layers, device=device)
    return model
