"""Trainable LoRA adapters on the DiT's linears.

Port of ltx_tpu/train/lora.py on the module instead of the tree: each
targeted `Linear`, `QuantizedLinear` or `W8A8Linear` gets `lora_a` (d_in,
r), `lora_b` (r, d_out) and `lora_s` () beside its base weight, the JAX leaves' names and
layout (the reference stacks them over the blocks, (L, in, r) ...; here
each block's module holds its own). `lora_b` starts at zero, so the adapted
model is the base model at step 0. The side path is read by the linears
themselves (models/common.py, kernels/quantization.py::linear_any), on the
bf16, int8, int4 and W8A8 bases alike: QLoRA needs no requantization.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

from ltx_tpu_torch.models.common import LORA_KEYS, Linear, QuantizedLinear, W8A8Linear

_LINEARS = (Linear, QuantizedLinear, W8A8Linear)

# every linear the distilled-LoRA checkpoint itself targets: the attention
# projections and both FFN linears inside the blocks
DEFAULT_TARGETS = (
    "to_q", "to_k", "to_v", "to_out", "project_in", "project_out",
)


def lora_targets(model: nn.Module, targets: Sequence[str] = DEFAULT_TARGETS
                 ) -> Iterator[Tuple[str, nn.Module]]:
    """(name, linear) of every Linear, QuantizedLinear or W8A8Linear whose own name is in
    `targets`, in module order."""
    for name, module in model.named_modules():
        if name.rsplit(".", 1)[-1] in targets and isinstance(module, _LINEARS):
            yield name, module


@torch.no_grad()
def add_lora(model: nn.Module, generator: torch.Generator, rank: int = 16,
             alpha: Optional[float] = None, targets: Sequence[str] = DEFAULT_TARGETS,
             dtype=torch.float32) -> nn.Module:
    """Insert zero-initialised LoRA side paths into the targeted linears, in
    place: lora_a ~ N(0, 1/d_in) drawn in f32 from `generator` (one draw per
    linear, in module order), lora_b = 0, lora_s = alpha / rank (alpha
    defaults to rank: scale 1). Returns `model`."""
    if alpha is None:
        alpha = float(rank)
    scale = alpha / rank
    for _, linear in lora_targets(model, targets):
        d_in, _ = linear.dims
        linear.add_lora_params(rank, dtype)
        draw = torch.randn(d_in, rank, generator=generator, dtype=torch.float32,
                           device=generator.device)
        linear.lora_a.copy_(draw.mul_(d_in**-0.5))
        linear.lora_b.zero_()
        linear.lora_s.fill_(scale)
    return model


def lora_param_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: is a LoRA leaf}, for the trainable partition and the
    optimizer."""
    return {name: name.rsplit(".", 1)[-1] in LORA_KEYS
            for name, _ in model.named_parameters()}


def strip_lora(model: nn.Module) -> nn.Module:
    """Remove every LoRA side path (recover the frozen base), in place."""
    for module in model.modules():
        if isinstance(module, _LINEARS) and module.has_lora:
            module.remove_lora_params()
    return model


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """Fold each trained adapter of a plain Linear into its weight, in
    place: W' = W + s * (A @ B) in f32, rounded to W's dtype once. Quantized
    bases keep their side path, as in the reference (requantizing would
    quantize the learned delta away). Returns `model`."""
    for module in model.modules():
        if isinstance(module, Linear) and module.has_lora:
            delta = (module.lora_a.float() @ module.lora_b.float()) * module.lora_s.float()
            module.weight.copy_((module.weight.float() + delta.t()).to(module.weight.dtype))
            module.remove_lora_params()
    return model
