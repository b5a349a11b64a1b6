"""Export trained LoRA adapters to the interchange safetensors format.

Port of ltx_tpu/train/export.py: the ComfyUI key schema that the inference
fusion path parses (ltx_tpu/lora/fuse.py::parse_lora), one entry per block:

    diffusion_model.transformer_blocks.{i}.attn1.to_q.lora_down.weight  (r, in)
    diffusion_model.transformer_blocks.{i}.attn1.to_q.lora_up.weight    (out, r)
    diffusion_model.transformer_blocks.{i}.attn1.to_q.alpha             ()

in torch's layout ((r, in), (out, r): the (in, r) / (r, out) leaves
transpose), alpha = lora_s * rank, all float32, in a file written by the
port's own safetensors writer (weights/safetensors_io.py).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ltx_tpu_torch.weights import safetensors_io

# the block-relative path of a LoRA leaf -> the exported key's suffix
_EXPORT_SUFFIX = {
    ("attn1", "to_q"): "attn1.to_q",
    ("attn1", "to_k"): "attn1.to_k",
    ("attn1", "to_v"): "attn1.to_v",
    ("attn1", "to_out"): "attn1.to_out.0",
    ("attn2", "to_q"): "attn2.to_q",
    ("attn2", "to_k"): "attn2.to_k",
    ("attn2", "to_v"): "attn2.to_v",
    ("attn2", "to_out"): "attn2.to_out.0",
    ("ff", "project_in"): "ff.net.0.proj",
    ("ff", "project_out"): "ff.net.2",
}

_PREFIX = "diffusion_model.transformer_blocks"


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def lora_state_dict(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{export key: f32 array} for every LoRA leaf of the blocks in `params`
    ({parameter name: tensor}, e.g. the trainable or the EMA dict, or
    dict(model.named_parameters())); other entries are ignored."""
    out: Dict[str, np.ndarray] = {}
    for name in params:
        parts = name.split(".")
        if parts[0] != "blocks" or parts[-1] != "lora_a":
            continue
        base, i, path = name[:-len(".lora_a")], int(parts[1]), tuple(parts[2:-1])
        suffix = _EXPORT_SUFFIX.get(path)
        if suffix is None:
            raise ValueError(f"no export key mapping for the LoRA leaf at {base}: "
                             "extend _EXPORT_SUFFIX")
        a, b = _np(params[name]), _np(params[base + ".lora_b"])
        s = float(_np(params[base + ".lora_s"]))
        key = f"{_PREFIX}.{i}.{suffix}"
        out[key + ".lora_down.weight"] = np.ascontiguousarray(a.T)  # (r, in)
        out[key + ".lora_up.weight"] = np.ascontiguousarray(b.T)    # (out, r)
        out[key + ".alpha"] = np.asarray(s * a.shape[-1], np.float32)
    return out


def write_safetensors(tensors: Mapping[str, np.ndarray], path) -> None:
    """float32 arrays in the safetensors file format, written atomically."""
    for key, arr in tensors.items():
        if arr.dtype != np.float32:
            raise ValueError(f"{key}: {arr.dtype}, the adapter format here is float32")
    safetensors_io.save(tensors, path)


def read_safetensors(path) -> Dict[str, np.ndarray]:
    """The float32 tensors of an adapter file, as numpy arrays."""
    out = {}
    for key, tensor in safetensors_io.load(path).items():
        if tensor.dtype != torch.float32:
            raise ValueError(f"{key}: dtype {tensor.dtype}, not an adapter's float32")
        out[key] = tensor.numpy().copy()
    return out


def save_lora(params: Mapping[str, torch.Tensor], path) -> int:
    """Write the adapter to `path` (.safetensors). Returns the tensor count."""
    sd = lora_state_dict(params)
    write_safetensors(sd, path)
    return len(sd)
