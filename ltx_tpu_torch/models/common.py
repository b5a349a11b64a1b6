"""Shared layers: Linear, Conv3d, norm weights, embeddings, activations.

Port of ltx_tpu/models/common.py and of the linears of
ltx_tpu/kernels/quantization.py::linear_any: `Linear` for plain weights,
`QuantizedLinear` for int8 / int4 ones, `W8A8Linear` for per-channel int8
weights with int8 activations. Each may carry a trainable LoRA side path
(`add_lora_params`): `lora_a` (d_in, r), `lora_b` (r, d_out) and `lora_s`
(), the JAX tree's leaf names and layout, f32 by default. `Int8Embedding`
is the int8 token table of ltx_tpu/models/gemma3.py::_embed_lookup.

Parameters are created empty on an explicit device and dtype; nothing is
initialised at construction. `convert.py` fills them from a JAX parameter
tree, or `init_random_` draws them from a torch.Generator with the JAX
package's init scales. Each module's parameter names follow the JAX tree's
keys, with "w" -> "weight" and "b" -> "bias" (QuantizedLinear keeps the
JAX keys as they are).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ltx_tpu_torch.kernels import quantization as qz
from ltx_tpu_torch.kernels.quantization import f32_linear, linear_any, lora_delta, quantize_weight

LORA_KEYS = ("lora_a", "lora_b", "lora_s")


def gelu_tanh(x):
    """GELU with the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


class _LoRAHost(nn.Module):
    """The LoRA side path's parameters, None until `add_lora_params`. A
    linear that `parallel.sharding` sliced carries its style ("column" or
    "row") and mesh, and its forward runs the collectives
    (`parallel.sharding.linear_forward`)."""

    tp_style = None
    tp_mesh = None

    def __init__(self):
        super().__init__()
        for key in LORA_KEYS:
            self.register_parameter(key, None)

    @property
    def has_lora(self) -> bool:
        return self.lora_a is not None

    def add_lora_params(self, rank: int, dtype=torch.float32) -> None:
        """Empty `lora_a` (d_in, rank), `lora_b` (rank, d_out) and `lora_s` ()
        on the module's device, trainable; the caller fills them."""
        d_in, d_out = self.dims
        device = next(self.parameters()).device
        self.lora_a = nn.Parameter(torch.empty(d_in, rank, device=device, dtype=dtype))
        self.lora_b = nn.Parameter(torch.empty(rank, d_out, device=device, dtype=dtype))
        self.lora_s = nn.Parameter(torch.empty((), device=device, dtype=dtype))

    def remove_lora_params(self) -> None:
        for key in LORA_KEYS:
            setattr(self, key, None)


class Linear(_LoRAHost):
    """weight (d_out, d_in) in torch's layout (the JAX tree is (d_in, d_out)),
    optional bias (d_out,). `f32_linear`: with a LoRA side path the product
    is accumulated in f32 and the delta and the bias added in f32 before one
    rounding (the reference's plain `linear_any` route); without one,
    `F.linear`, whose bias epilogue does the same."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 device=None, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in, device=device, dtype=dtype),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(d_out, device=device, dtype=dtype),
                                  requires_grad=False) if bias else None)

    @property
    def dims(self):
        """(d_in, d_out)."""
        return self.weight.shape[1], self.weight.shape[0]

    def forward(self, x):
        if self.tp_style is not None:
            return _tensor_parallel().linear_forward(self, x)
        return self.local_forward(x)

    def local_forward(self, x):
        """The product on this module's own weights (a shard's, under TP)."""
        lora = (lora_delta({k: getattr(self, k) for k in LORA_KEYS}, x)
                if self.has_lora else None)
        return f32_linear(x, self.weight.t(), self.bias, lora)

    def reset_parameters(self, gen: torch.Generator):
        """normal * d_in**-0.5, zero bias (the reference's linear_init)."""
        _normal_(self.weight, gen, self.weight.shape[1] ** -0.5)
        if self.bias is not None:
            self.bias.zero_()


class _LeafLinear(_LoRAHost):
    """A linear whose parameters are the JAX package's leaf dict, by name
    and layout: `forward` is `linear_any` on them. Frozen parameters, so
    that phase staging moves them; a dtype cast of the module raises, since
    it would change the format. A LoRA side path's leaves join the dict
    under their JAX names."""

    def forward(self, x):
        if self.tp_style is not None:
            return _tensor_parallel().linear_forward(self, x)
        return self.local_forward(x)

    def local_forward(self, x):
        return linear_any(self.leaves(), x)

    def leaves(self) -> dict:
        return dict(self.named_parameters(recurse=False))

    def _f32_leaf(self) -> nn.Parameter:
        """A float32 parameter of the format, which a dtype cast would change."""
        raise NotImplementedError

    def _apply(self, fn, recurse=True):
        if fn(torch.empty(0, device=self._f32_leaf().device)).dtype != torch.float32:
            raise TypeError(f"{type(self).__name__} keeps its format: cast the "
                            "activations, not the module")
        return super()._apply(fn, recurse)


class QuantizedLinear(_LeafLinear):
    """A weight-only quantized linear, in the JAX package's layout and with
    its leaf names, not transposed (the int4 packing runs along d_in):
    codes `w_q4` (d_in/2, d_out) uint8 for 4 bits or `w_q` (d_in, d_out)
    uint8 for 8, `scale` and `bias` (d_in/group, d_out) f32 (the per-group
    affine), and the linear's own bias `b` (d_out,) or None."""

    def __init__(self, d_in: int, d_out: int, bits: int, group_size: int = 64,
                 bias: bool = True, device=None, dtype=torch.bfloat16):
        super().__init__()
        if bits not in (4, 8) or d_in % group_size:
            raise ValueError(f"bits {bits}, d_in {d_in}, group {group_size}")
        codes = "w_q4" if bits == 4 else "w_q"
        rows = d_in // 2 if bits == 4 else d_in
        setattr(self, codes, param(rows, d_out, device=device, dtype=torch.uint8))
        self.scale = param(d_in // group_size, d_out, device=device)
        self.bias = param(d_in // group_size, d_out, device=device)
        self.b = param(d_out, device=device, dtype=dtype) if bias else None

    @property
    def dims(self):
        """(d_in, d_out); int4 packs two input rows a byte."""
        d_in = self.w_q4.shape[0] * 2 if hasattr(self, "w_q4") else self.w_q.shape[0]
        return d_in, self.scale.shape[1]

    def _f32_leaf(self):
        return self.scale

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: Linear, bits: int, group_size: int = 64,
                    device=None) -> "QuantizedLinear":
        """`linear` quantized on `device` (default: where it lives, as
        quantize_weight on its (d_in, d_out) weight); the result lives where
        `linear` lived."""
        d_out, d_in = linear.weight.shape
        home = linear.weight.device
        qp = quantize_weight(linear.weight.to(device or home).t(), bits, group_size)
        out = cls(d_in, d_out, bits, group_size, bias=linear.bias is not None,
                  device=home, dtype=linear.weight.dtype)
        for name, value in qp.items():
            getattr(out, name).copy_(value)
        if linear.bias is not None:
            out.b.copy_(linear.bias)
        return out


class W8A8Linear(_LeafLinear):
    """A W8A8 linear in the JAX package's layout and with its leaf names:
    `w8` (d_in, d_out) int8, per output channel `sw` (d_out,) f32, and the
    linear's own bias `b` (d_out,) or None; activations are quantized per
    row at every call (`linear_any` -> `int8_matmul`). `w8` is stored
    column-major (`kernels.quantization.w8_layout`), as the card's int8
    product wants it."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.w8 = nn.Parameter(torch.empty(d_out, d_in, device=device, dtype=torch.int8).t(),
                               requires_grad=False)
        self.sw = param(d_out, device=device)
        self.b = param(d_out, device=device, dtype=dtype) if bias else None

    @property
    def dims(self):
        return tuple(self.w8.shape)

    def _f32_leaf(self):
        return self.sw

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: Linear, device=None) -> "W8A8Linear":
        """`linear` requantized per output channel on `device` (default:
        where it lives; `requant_int8_channel` of its (d_in, d_out) weight);
        the result lives where `linear` lived."""
        d_out, d_in = linear.weight.shape
        home = linear.weight.device
        qp = qz.requant_int8_channel(linear.weight.to(device or home).t())
        out = cls(d_in, d_out, bias=linear.bias is not None, device=home,
                  dtype=linear.weight.dtype)
        out.w8.copy_(qp["w8"])
        out.sw.copy_(qp["sw"])
        if linear.bias is not None:
            out.b.copy_(linear.bias)
        return out


def linear_many(linears, x) -> tuple:
    """Several linears applied to the same x (q/k/v; gate/up), as the
    reference's `linear_many`: W8A8 linears share one quantization of x;
    any other mix runs each linear on its own."""
    if all(isinstance(m, W8A8Linear) and not m.has_lora for m in linears):
        return qz.linear_many([m.leaves() for m in linears], x)
    return tuple(m(x) for m in linears)


class Conv3d(nn.Module):
    """weight (C_out, C_in, kt, kh, kw) (the JAX tree is DHWIO), bias
    (C_out,). Padding is the caller's (see vae.causal_conv3d)."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(c_out, c_in, k, k, k, device=device, dtype=dtype),
            requires_grad=False)
        self.bias = nn.Parameter(torch.empty(c_out, device=device, dtype=dtype),
                                 requires_grad=False)

    def reset_parameters(self, gen: torch.Generator):
        """normal * (c_in * k^3)**-0.5, zero bias (vae.conv3d_init)."""
        fan_in = self.weight[0].numel()
        _normal_(self.weight, gen, fan_in**-0.5)
        self.bias.zero_()


class Conv2d(nn.Module):
    """weight (C_out, C_in, kh, kw) (the JAX tree is HWIO), bias (C_out,)."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = param(c_out, c_in, k, k, device=device, dtype=dtype)
        self.bias = param(c_out, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator):
        """normal * (c_in * k^2)**-0.5, zero bias."""
        _normal_(self.weight, gen, self.weight[0].numel()**-0.5)
        self.bias.zero_()


class NormAffine(nn.Module):
    """A norm's weight and bias vectors (the upscaler's GroupNorms): ones
    and zeros at random init."""

    def __init__(self, dim: int, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = param(dim, device=device, dtype=dtype)
        self.bias = param(dim, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()


class Conv1d(nn.Module):
    """weight (C_out, C_in, k) (the JAX tree is (k, C_in, C_out)), bias
    (C_out,)."""

    def __init__(self, c_in: int, c_out: int, k: int, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = param(c_out, c_in, k, device=device, dtype=dtype)
        self.bias = param(c_out, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator):
        """normal * (c_in * k)**-0.5, zero bias."""
        _normal_(self.weight, gen, self.weight[0].numel()**-0.5)
        self.bias.zero_()


class ConvTranspose1d(nn.Module):
    """A transposed 1D convolution: weight (C_in, C_out, k), torch's layout
    (the JAX tree keeps the forward convolution's (k, C_out, C_in)), bias
    (C_out,)."""

    def __init__(self, c_in: int, c_out: int, k: int, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = param(c_in, c_out, k, device=device, dtype=dtype)
        self.bias = param(c_out, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator):
        """normal * (c_in * k)**-0.5, zero bias."""
        _normal_(self.weight, gen, (self.weight.shape[0] * self.weight.shape[2])**-0.5)
        self.bias.zero_()


class NormWeight(nn.Module):
    """A norm's weight vector; `init` is its random-init value (1 for the
    DiT and connector QK norms, 0 for Gemma's (1 + w) norms)."""

    def __init__(self, dim: int, init: float, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.empty(dim, device=device, dtype=dtype),
                                   requires_grad=False)

    def reset_parameters(self, gen: torch.Generator):
        self.weight.fill_(self.init)


class Embedding(nn.Module):
    """Token table (vocab, dim), the same layout in both packages."""

    def __init__(self, vocab: int, dim: int, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(vocab, dim, device=device, dtype=dtype),
            requires_grad=False)

    tp_mesh = None

    def forward(self, ids):
        if self.tp_mesh is not None:
            return _tensor_parallel().embedding_forward(self, ids)
        return self.local_forward(ids)

    def local_forward(self, ids):
        return self.weight[ids.long()]

    def reset_parameters(self, gen: torch.Generator):
        _normal_(self.weight, gen, 0.02)


class Int8Embedding(nn.Module):
    """An int8 token table with per-row scales: `w8r` (vocab, dim) int8 and
    `sr` (vocab,) f32 (the reference's `embed_int8` leaves). A lookup
    dequantizes the rows in f32 and rounds them to bf16 once."""

    def __init__(self, vocab: int, dim: int, device=None):
        super().__init__()
        self.w8r = param(vocab, dim, device=device, dtype=torch.int8)
        self.sr = param(vocab, device=device)

    tp_mesh = None

    def forward(self, ids):
        if self.tp_mesh is not None:
            return _tensor_parallel().embedding_forward(self, ids)
        return self.local_forward(ids)

    def local_forward(self, ids):
        ids = ids.long()
        return (self.w8r[ids].float() * self.sr[ids][..., None]).to(torch.bfloat16)


def _tensor_parallel():
    """parallel.sharding, imported where a sharded module first runs (it
    imports this module)."""
    from ltx_tpu_torch.parallel import sharding

    return sharding


def for_leaves(module: nn.Module, leaves: dict) -> nn.Module:
    """An empty module of the format that `leaves` (a JAX leaf dict, or its
    shapes: arrays, tensors, stacked or not) hold, of `module`'s widths,
    device and dtype: a QuantizedLinear, W8A8Linear or Int8Embedding where
    `module` is a Linear or Embedding and the leaves are quantized; else
    `module` itself."""
    if isinstance(module, Embedding) and "w8r" in leaves:
        vocab, dim = module.weight.shape
        return Int8Embedding(vocab, dim, device=module.weight.device)
    if not isinstance(module, Linear) or not qz.is_quantized(leaves):
        return module
    d_out, d_in = module.weight.shape
    kw = dict(bias="b" in leaves, device=module.weight.device, dtype=module.weight.dtype)
    if "w8" in leaves:
        return W8A8Linear(d_in, d_out, **kw)
    if "scale" not in leaves:
        raise ValueError(f"quantized leaves with no scale: {sorted(leaves)}")
    groups = tuple(leaves["scale"].shape)[-2]
    return QuantizedLinear(d_in, d_out, 4 if "w_q4" in leaves else 8, d_in // groups, **kw)


def swap_for_state(root: nn.Module, state: dict) -> nn.Module:
    """Replace, in place, each Linear or Embedding under `root` whose
    parameters in the flat `state` ({name: tensor}) are of another format by
    an empty module of that format (`for_leaves`), for `assign_` to fill.
    Returns `root`."""
    groups: dict = {}
    for key, value in state.items():
        owner, _, leaf = key.rpartition(".")
        groups.setdefault(owner, {})[leaf] = value
    for name, module in list(root.named_modules()):
        new = for_leaves(module, groups.get(name, {}))
        if new is not module:
            parent, _, child = name.rpartition(".")
            setattr(root.get_submodule(parent), child, new)
    return root


def param(*shape, device=None, dtype=torch.float32) -> nn.Parameter:
    """An empty, frozen parameter for a module's own tables."""
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype),
                        requires_grad=False)


def _normal_(t, gen: torch.Generator, scale: float):
    """t <- normal(0, 1) * scale drawn in float32 on the generator's device,
    then cast to t's dtype (the reference draws f32 then casts)."""
    draw = torch.randn(t.shape, generator=gen, dtype=torch.float32,
                       device=gen.device)
    t.copy_(draw.mul_(scale))


def uniform_(t, gen: torch.Generator, low: float, high: float):
    draw = torch.rand(t.shape, generator=gen, dtype=torch.float32,
                      device=gen.device)
    t.copy_(draw.mul_(high - low).add_(low))


def assign_(module: nn.Module, state: dict) -> nn.Module:
    """Make the tensors of `state` ({parameter name: tensor}) the parameters
    of `module` (typically built on the "meta" device), strictly: every
    parameter once, no other name, each of the parameter's shape and dtype.
    No copy: a parameter becomes its tensor (a view of a mapped file
    stays one), unless the tensor is not in the parameter's order
    (contiguous, or W8A8Linear's column-major `w8`): then a copy in that
    order. Returns `module`."""
    params = dict(module.named_parameters())
    unknown = sorted(set(state) - set(params))
    missing = sorted(set(params) - set(state))
    if unknown or missing:
        raise ValueError(f"state dict does not fit {type(module).__name__}: no such "
                         f"parameter {unknown[:8]}, no tensor for {missing[:8]}")
    for name, target in params.items():
        tensor = state[name]
        if tuple(tensor.shape) != tuple(target.shape) or tensor.dtype != target.dtype:
            raise ValueError(f"{name}: {tensor.dtype}{tuple(tensor.shape)}, the parameter is "
                             f"{target.dtype}{tuple(target.shape)}")
        if not (tensor.is_contiguous() if target.is_contiguous()
                else tensor.stride() == target.stride()):
            # stored in the parameter's order: contiguous, or column-major
            # (W8A8Linear.w8)
            tensor = torch.empty_strided(target.shape, target.stride(), dtype=tensor.dtype,
                                         device=tensor.device).copy_(tensor)
        owner = module.get_submodule(name.rpartition(".")[0])
        setattr(owner, name.rpartition(".")[2],
                nn.Parameter(tensor, requires_grad=target.requires_grad))
    return module


@torch.no_grad()
def init_random_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw every parameter of `module` from `gen`, with the JAX package's
    init scales: each submodule's `reset_parameters(gen)` fills its own
    parameters. Returns the module."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(gen)
    return module
