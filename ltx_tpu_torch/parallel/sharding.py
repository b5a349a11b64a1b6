"""Megatron tensor parallelism of the DiTs and Gemma, in place.

Port of ltx_tpu/parallel/sharding.py. The reference places each leaf of a
parameter tree on the mesh under a PartitionSpec and lets XLA insert the
collectives; here `shard_transformer` and `shard_gemma` slice this rank's
shard out of each parameter of a full module, in place, under the same
rules, and mark the modules so that their forwards run the collectives:

* linears named in COLUMN_PARALLEL shard their output dim (every leaf:
  the weight, its bias, int4/int8 codes and per-group scale/bias, W8A8's
  w8 and per-channel sw; LoRA's lora_b, while lora_a and lora_s stay
  whole). Their replicated input's gradient is summed over the model group;
* linears named in ROW_PARALLEL shard their input dim (the weight, the
  codes' packed rows and the per-group scale/bias rows; LoRA's lora_a,
  while lora_b and lora_s stay whole); their f32 partial products are
  summed over the model group and the bias is added after the sum. A W8A8
  row-parallel linear takes its per-row activation scale as the max over
  the group (`all_reduce_max`) and sums the exact int32 products: bit for
  bit the unsharded product;
* a q_norm / k_norm that spans the flat attention dim (the DiT's; the norm
  comes before the head split) shards with it, and its sum of squares is
  summed over the model group (`sharded_rms_norm`, counted in
  `sharded_rms_norm.calls`): the rms_norm kernel would normalise over the
  shard alone. Gemma's per-head-dim norms stay whole;
* attention runs on H / model heads (Gemma: its key/value heads too);
* `shard_gemma` also shards the token table over the vocabulary: a lookup
  is a masked local lookup summed over the group, and the tied head's
  logits are gathered whole before sampling;
* everything else (tables, norms, embeddings, the small heads) stays whole
  on every rank, each process holding its own full copy.

An int4 row shard must hold whole packing planes (PACK_BLOCK input rows):
one that would split a plane raises, as would a shard that splits a
quantization group or a head. int4 linears on a shard take the dequantize
route (`dequant_int4`, then one product), as the reference turns its fused
kernel off on a mesh (`set_tensor_parallel`). On a model axis of size 1
nothing is sliced and the forwards are the plain ones, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ltx_tpu_torch.errors import InvalidConfigurationError
from ltx_tpu_torch.kernels import quantization as qz
from ltx_tpu_torch.models.common import (
    Embedding,
    Int8Embedding,
    Linear,
    QuantizedLinear,
    W8A8Linear,
)
from ltx_tpu_torch.parallel import collectives as col

COLUMN_PARALLEL = frozenset({
    "to_q", "to_k", "to_v", "project_in",
    "q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
})
ROW_PARALLEL = frozenset({
    "to_out", "project_out", "o_proj", "down_proj",
})
_LINEARS = (Linear, QuantizedLinear, W8A8Linear)
AXIS = "model"


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------


def linear_leaf_dims(style: str, linear: nn.Module) -> dict:
    """{parameter name: the dim this rank's shard cuts, or None (whole)} of
    one linear under `style` ("column" or "row"), in the port's layouts:
    Linear.weight is (out, in); the quantized leaves keep the reference's
    (in, out); lora_a (in, r), lora_b (r, out)."""
    dims = {}
    for name, p in linear.named_parameters(recurse=False):
        if name in ("lora_s",):
            dims[name] = None
        elif name == "lora_a":
            dims[name] = 0 if style == "row" else None
        elif name == "lora_b":
            dims[name] = 1 if style == "column" else None
        elif isinstance(linear, Linear):
            if name == "weight":
                dims[name] = 0 if style == "column" else 1
            else:  # bias: the output dim
                dims[name] = 0 if style == "column" else None
        elif name in ("b", "sw"):
            # the output dim; a row-parallel bias adds after the sum and the
            # W8A8 per-channel scale follows the (whole) output dim
            dims[name] = 0 if style == "column" else None
        else:  # w_q4, w_q, scale, bias, w8: (in, out)
            dims[name] = p.ndim - 1 if style == "column" else 0
    return dims


def _attention_scope(module: nn.Module) -> Optional[int]:
    """The flat attention dim of a module holding to_q or q_proj."""
    for probe in ("to_q", "q_proj"):
        lin = getattr(module, probe, None)
        if isinstance(lin, _LINEARS):
            return lin.dims[1]
    return None


def transformer_param_dims(module: nn.Module) -> dict:
    """{parameter name: sharded dim or None} of a whole DiT, dual DiT or
    Gemma under the rules (the reference's `transformer_param_specs`)."""
    dims = {}
    for prefix, mod in module.named_modules():
        own = f"{prefix}." if prefix else ""
        name = prefix.rsplit(".", 1)[-1]
        if isinstance(mod, _LINEARS) and name in COLUMN_PARALLEL | ROW_PARALLEL:
            style = "column" if name in COLUMN_PARALLEL else "row"
            for leaf, d in linear_leaf_dims(style, mod).items():
                dims[own + leaf] = d
        flat = _attention_scope(mod)
        for norm in ("q_norm", "k_norm"):
            child = getattr(mod, norm, None)
            if flat is not None and child is not None:
                dims[f"{own}{norm}.weight"] = 0 if child.weight.shape[-1] == flat else None
    for name, _ in module.named_parameters():
        dims.setdefault(name, None)
    return dims


def gemma_param_dims(module: nn.Module) -> dict:
    """`transformer_param_dims` plus the token table over the vocabulary."""
    dims = transformer_param_dims(module)
    for name, _ in module.embed_tokens.named_parameters():
        dims[f"embed_tokens.{name}"] = 0
    return dims


# ---------------------------------------------------------------------------
# Slicing
# ---------------------------------------------------------------------------


def _slice_param(owner: nn.Module, leaf: str, dim: int, mesh) -> None:
    p = getattr(owner, leaf)
    n, i = mesh.shape[AXIS], mesh.index(AXIS)
    if p.shape[dim] % n:
        raise InvalidConfigurationError(
            f"{type(owner).__name__}.{leaf}: dim {dim} of {tuple(p.shape)} does not split "
            f"over a model axis of {n}")
    size = p.shape[dim] // n
    part = p.data.narrow(dim, i * size, size)
    part = qz.w8_layout(part) if leaf == "w8" else part.contiguous()
    setattr(owner, leaf, nn.Parameter(part, requires_grad=p.requires_grad))


def _check_quantized_rows(linear: nn.Module, n: int, what: str) -> None:
    """A row shard of int4 codes holds whole packing planes and whole
    quantization groups."""
    if not isinstance(linear, QuantizedLinear):
        return
    d_in = linear.dims[0]
    group = d_in // linear.scale.shape[0]
    shard = d_in // n
    if shard % group:
        raise InvalidConfigurationError(
            f"{what}: a row shard of {shard} inputs splits a quantization group of {group}")
    if hasattr(linear, "w_q4") and (d_in % qz.PACK_BLOCK or shard % qz.PACK_BLOCK):
        raise InvalidConfigurationError(
            f"{what}: a row shard of {shard} of {d_in} int4 inputs splits a packing plane "
            f"of {qz._effective_pack_block(d_in)} rows")


def _mark_linear(linear: nn.Module, style: str, mesh) -> None:
    linear.tp_style, linear.tp_mesh = style, mesh


def _check_heads(what: str, heads: int, n: int) -> None:
    if heads % n:
        raise InvalidConfigurationError(
            f"{what}: {heads} heads do not split over a model axis of {n}")


@torch.no_grad()
def _shard(module: nn.Module, mesh, dims: dict) -> nn.Module:
    n = mesh.shape[AXIS]
    module.tp_mesh = mesh
    module.tp_dims = {k: d for k, d in dims.items() if d is not None} if n > 1 else {}
    module.tp_partial = set()
    if n == 1:
        return module
    for prefix, mod in list(module.named_modules()):
        name = prefix.rsplit(".", 1)[-1]
        if getattr(mod, "tp_style", None) is not None or (
                mod is not module and getattr(mod, "tp_mesh", None) is not None):
            continue  # sliced already (a part sharded on its own first)
        if isinstance(mod, _LINEARS) and name in COLUMN_PARALLEL | ROW_PARALLEL:
            style = "column" if name in COLUMN_PARALLEL else "row"
            if style == "row":
                _check_quantized_rows(mod, n, prefix)
            for leaf, d in linear_leaf_dims(style, mod).items():
                if d is not None:
                    _slice_param(mod, leaf, d, mesh)
                elif leaf in ("lora_a", "lora_b", "lora_s"):
                    module.tp_partial.add(f"{prefix}.{leaf}")
            _mark_linear(mod, style, mesh)
        if hasattr(mod, "num_heads") and hasattr(mod, "q_norm"):  # a DiT attention
            _check_heads(prefix, mod.num_heads, n)
            for norm in ("q_norm", "k_norm"):
                if dims.get(f"{prefix}.{norm}.weight") is not None:
                    _slice_param(getattr(mod, norm), "weight", 0, mesh)
            mod.num_heads //= n
            mod.tp_mesh = mesh
        if hasattr(mod, "n_kv"):  # a Gemma decoder layer
            _check_heads(prefix, mod.n_kv, n)
            _check_heads(prefix, mod.n_heads, n)
            mod.n_heads //= n
            mod.n_kv //= n
            mod.tp_mesh = mesh
    return module


def shard_transformer(module: nn.Module, mesh) -> nn.Module:
    """Slice this rank's megatron shard of a whole video DiT or dual DiT (bf16,
    int4/int8 or W8A8 linears, with or without LoRA) in place, and mark it
    for the collectives (module docstring). Records `module.tp_mesh`,
    `module.tp_dims` ({parameter: sharded dim}) and `module.tp_partial`
    (the whole LoRA leaves of sharded linears, whose gradients are partial
    sums). Returns `module`."""
    return _shard(module, mesh, transformer_param_dims(module))


@torch.no_grad()
def shard_gemma(module: nn.Module, mesh) -> nn.Module:
    """`shard_transformer` for Gemma, with the token table sharded over the
    vocabulary (a masked lookup and a sum; the tied head's logits gathered
    whole). Returns `module`."""
    _shard(module, mesh, gemma_param_dims(module))
    emb = module.embed_tokens
    n = mesh.shape[AXIS]
    if n > 1:
        vocab = emb.weight.shape[0] if isinstance(emb, Embedding) else emb.w8r.shape[0]
        for leaf, _ in list(emb.named_parameters(recurse=False)):
            _slice_param(emb, leaf, 0, mesh)
        emb.tp_mesh = mesh
        emb.vocab_start = mesh.index(AXIS) * (vocab // n)
    return module


# ---------------------------------------------------------------------------
# Forwards under tensor parallelism
# ---------------------------------------------------------------------------


def sharded_rms_norm(x, weight, mesh, eps: float = 1e-6):
    """RMSNorm over a dim sharded across the model group: the f32 sum of
    squares of this shard summed over the group, divided by the whole dim,
    then x * rsqrt(mean + eps) * weight in f32 and one cast (the arithmetic
    of `rms_norm_reference`). Counted in `sharded_rms_norm.calls`."""
    dtype = x.dtype
    xf = x.float()
    ss = col.reduce_both(torch.sum(xf * xf, dim=-1, keepdim=True), mesh, AXIS)
    inv = torch.rsqrt(ss / (x.shape[-1] * mesh.shape[AXIS]) + eps)
    out = xf * inv
    if weight is not None:
        out = out * weight.float()
    sharded_rms_norm.calls += 1
    return out.to(dtype)


sharded_rms_norm.calls = 0


def _local_weight_t(linear, dtype):
    """A row-parallel shard's (K_local, N) weight in `dtype`: a Linear's
    transpose, or the codes dequantized (`dequant_int4`: the kernel on the
    card; int8 codes by `dequantize_weight`)."""
    if isinstance(linear, Linear):
        return linear.weight.t()
    if hasattr(linear, "w_q4"):
        return qz.dequant_int4(linear.w_q4, linear.scale, linear.bias).to(dtype)
    return qz.dequantize_weight(linear.leaves(), torch.bfloat16).to(dtype)


def _mm_f32(x, w_t):
    """x (..., K) @ w_t (K, N) with an f32 result: the bf16 products read once
    and written in f32 on the card (no rounding of the partial sum); f32
    products elsewhere and wherever autograd records."""
    lead, k = x.shape[:-1], x.shape[-1]
    if x.is_cuda and x.dtype == w_t.dtype == torch.bfloat16 and not (
            torch.is_grad_enabled() and x.requires_grad):
        return torch.mm(x.reshape(-1, k), w_t, out_dtype=torch.float32).reshape(*lead, -1)
    return torch.matmul(x.float(), w_t.float())


def _lora_f32(linear, x):
    """The LoRA side path s * (x A) B in f32, unrounded (a partial sum on a
    row shard)."""
    d = torch.matmul(torch.matmul(x.float(), linear.lora_a.float()), linear.lora_b.float())
    return d * linear.lora_s.float()


class _W8A8RowFn(torch.autograd.Function):
    """A W8A8 row shard's product summed over the model group: the per-row
    activation scale is max |x| over the WHOLE row (a max over the group),
    the int32 products of the shards are summed exactly, then rescaled in
    f32 as `_int8_dot`: bit for bit the unsharded product. Backward
    straight through the rounding for x (`_Int8MatmulSTE`'s formula on the
    shard)."""

    @staticmethod
    def forward(ctx, x, w8, sw, mesh):
        ctx.save_for_backward(w8, sw)
        s = torch.linalg.vector_norm(x, float("inf"), dim=-1, keepdim=True,
                                     dtype=torch.float32)
        s = col.all_reduce_max(s, mesh, AXIS)
        s = s / torch.full_like(s, 127.0)
        s = torch.where(s == 0, torch.ones_like(s), s)
        x8 = torch.div(x, s).round_().clamp_(-127, 127).to(torch.int8)
        lead, k = x8.shape[:-1], x8.shape[-1]
        acc = qz.int8_mm(x8.reshape(-1, k), w8).reshape(*lead, -1)
        acc = col.all_reduce(acc.contiguous(), mesh, AXIS)
        return torch.mul(acc, s * sw).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        w8, sw = ctx.saved_tensors
        gw = (g.float() * sw).to(torch.bfloat16)
        compute = torch.bfloat16 if g.dtype == torch.bfloat16 else torch.float32
        gx = torch.matmul(gw.to(compute), w8.to(compute).t())
        return gx.to(g.dtype), None, None, None


def _row_forward(linear, x):
    mesh = linear.tp_mesh
    b = linear.bias if isinstance(linear, Linear) else linear.b
    if isinstance(linear, W8A8Linear):
        out = _W8A8RowFn.apply(x, linear.w8, linear.sw, mesh)
        if linear.has_lora:
            out = out + col.reduce_from(_lora_f32(linear, x), mesh, AXIS).to(x.dtype)
        return out if b is None else out + b.to(x.dtype)
    partial = _mm_f32(x, _local_weight_t(linear, x.dtype))
    if linear.has_lora:
        partial = partial + _lora_f32(linear, x)
    out = col.reduce_from(partial, mesh, AXIS)
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def _column_forward(linear, x):
    x = col.copy_to(x, linear.tp_mesh, AXIS)
    if isinstance(linear, QuantizedLinear) and hasattr(linear, "w_q4"):
        # the reference's mesh route: dequantize, then one product
        w = qz.dequant_int4(linear.w_q4, linear.scale, linear.bias).to(x.dtype)
        lora = (qz.lora_delta({k: getattr(linear, k) for k in ("lora_a", "lora_b", "lora_s")},
                              x) if linear.has_lora else None)
        return qz.f32_linear(x, w, linear.b, lora)
    return linear.local_forward(x)


def linear_forward(linear, x):
    """The forward of a linear marked by `shard_transformer`/`shard_gemma`."""
    if linear.tp_style == "row":
        return _row_forward(linear, x)
    return _column_forward(linear, x)


def embedding_forward(emb, ids):
    """A vocabulary shard's lookup: the ids this shard holds read locally,
    the others zero, summed over the model group (exact: one nonzero term)."""
    mesh = emb.tp_mesh
    ids = ids.long()
    local = ids - emb.vocab_start
    rows = emb.w8r.shape[0] if isinstance(emb, Int8Embedding) else emb.weight.shape[0]
    hit = (local >= 0) & (local < rows)
    out = emb.local_forward(torch.where(hit, local, torch.zeros_like(local)))
    out = torch.where(hit[..., None], out, torch.zeros_like(out))
    return col.all_reduce(out.float(), mesh, AXIS).to(out.dtype)


def gather_logits(logits, mesh):
    """A vocabulary shard's logits (..., V / model) -> (..., V), whole on
    every rank."""
    return col.all_gather(logits, mesh, AXIS, dim=logits.ndim - 1)


# ---------------------------------------------------------------------------
# Guidance rows over the data axis
# ---------------------------------------------------------------------------


def data_rows(module: nn.Module, rows: int) -> Optional[tuple]:
    """(mesh, lo, hi): this rank's rows [lo, hi) of `rows` guidance rows
    when the module's mesh has a data axis of more than one rank that
    divides them; None otherwise (every rank computes every row)."""
    mesh = getattr(module, "tp_mesh", None)
    if mesh is None:
        return None
    n = mesh.shape.get("data", 1)
    if n == 1 or rows % n:
        return None
    per = rows // n
    lo = mesh.index("data") * per
    return mesh, lo, lo + per


def gather_rows(x, mesh):
    """The data group's row chunks concatenated, whole on every rank."""
    return col.all_gather(x, mesh, "data", dim=0)


# ---------------------------------------------------------------------------
# Whole leaves for checkpoints and exports
# ---------------------------------------------------------------------------


def gather_params(params: dict, module: nn.Module) -> dict:
    """{name: tensor} of a sharded module's parameters (or their optimizer
    moments) -> the whole tensors, the same on every rank: each sharded
    leaf (`module.tp_dims`) gathered over the model group."""
    dims = getattr(module, "tp_dims", {})
    mesh = getattr(module, "tp_mesh", None)
    return {n: col.all_gather(t.detach(), mesh, AXIS, dims[n]) if n in dims else t
            for n, t in params.items()}


@torch.no_grad()
def scatter_params_(params: dict, whole: dict, module: nn.Module) -> dict:
    """Copy this rank's shard of each whole tensor into `params`, in place
    (a checkpoint in the reference's whole layout resumed on a mesh)."""
    dims = getattr(module, "tp_dims", {})
    mesh = getattr(module, "tp_mesh", None)
    for n, t in params.items():
        src = whole[n]
        t.copy_(col.chunk_of(src, mesh, AXIS, dims[n]) if n in dims else src)
    return params

