"""SigLIP vision tower and Gemma-3's multimodal projector (I2V enhancement).

Port of ltx_tpu/models/siglip.py. The conditioning image of an I2V prompt
enhancement goes through SigLIP-So400m/14 at 896x896 (27 layers of width
1152, 16 heads of 72, MLP 4304, learned position embeddings over the 64x64
patch grid), then Gemma-3's projector: 4x4 average pooling of the patch
grid down to 256 soft tokens, Gemma's RMSNorm and a 1152 -> 3840
projection. The soft tokens are spliced into the prompt's embeddings
without the sqrt(hidden) text scaling (pipeline/enhance.py).

Numerics follow the reference: projections accumulate in f32 and add their
bias in f32 before one rounding (`Linear`), the MLP's GELU runs on the f32
product, layer norms compute in f32. The patch embedding is a convolution
(F.conv2d) in f32 on the bf16 values, as XLA's conv accumulated them.
Attention goes through `ops.attention.sdpa`: on the card the
flash-attention kernel (B1) at head dim 72, reading the heads as views of
the (B, T, H * 72) projections; on the CPU its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ltx_tpu_torch.models.common import Conv2d, Embedding, Linear, NormAffine, NormWeight
from ltx_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    """gemma-3-12b's vision_config (the reference's defaults)."""

    hidden_size: int = 1152
    image_size: int = 896
    patch_size: int = 14
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    layer_norm_eps: float = 1e-6
    # projector
    text_hidden_size: int = 3840
    mm_tokens_per_image: int = 256
    rms_norm_eps: float = 1e-6

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.patches_per_side ** 2

    @property
    def pool_kernel(self) -> int:
        tokens_per_side = int(round(self.mm_tokens_per_image ** 0.5))
        return self.patches_per_side // tokens_per_side

    def tiny(self) -> "SigLIPConfig":
        return dataclasses.replace(
            self, hidden_size=32, image_size=56, patch_size=14, num_layers=2,
            num_heads=4, intermediate_size=64, text_hidden_size=48,
            mm_tokens_per_image=4)


def layer_norm(norm: NormAffine, x, eps: float):
    """(x - mean) / sqrt(var + eps) * w + b in f32, rounded to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * norm.weight.float() + norm.bias.float()).to(x.dtype)


class SigLIPLayer(nn.Module):
    def __init__(self, cfg: SigLIPConfig, device, dtype):
        super().__init__()
        d = cfg.hidden_size

        def dense(d_in, d_out):
            return Linear(d_in, d_out, device=device, dtype=dtype)

        self.layer_norm1 = NormAffine(d, device=device, dtype=dtype)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (dense(d, d) for _ in range(4))
        self.layer_norm2 = NormAffine(d, device=device, dtype=dtype)
        self.fc1 = dense(d, cfg.intermediate_size)
        self.fc2 = dense(cfg.intermediate_size, d)
        self.num_heads = cfg.num_heads

    def attention(self, x):
        b, t, d = x.shape
        hd = d // self.num_heads
        q, k, v = (proj(x).reshape(b, t, self.num_heads, hd).transpose(1, 2)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        out = sdpa(q, k, v, scale=hd ** -0.5)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))

    def mlp(self, x):
        """fc2(gelu_tanh(fc1(x))), the GELU on fc1's f32 product plus bias."""
        h = torch.matmul(x.float(), self.fc1.weight.float().t()) + self.fc1.bias.float()
        return self.fc2(F.gelu(h, approximate="tanh").to(x.dtype))

    def forward(self, h, eps: float):
        h = h + self.attention(layer_norm(self.layer_norm1, h, eps))
        return h + self.mlp(layer_norm(self.layer_norm2, h, eps))


class Projector(nn.Module):
    def __init__(self, cfg: SigLIPConfig, device, dtype):
        super().__init__()
        self.mm_soft_emb_norm = NormWeight(cfg.hidden_size, 0.0, device=device, dtype=dtype)
        self.mm_input_projection = Linear(cfg.hidden_size, cfg.text_hidden_size, bias=False,
                                          device=device, dtype=dtype)


class SigLIPModel(nn.Module):
    """Parameter names follow ltx_tpu.models.siglip.init_params; the JAX
    tree's stacked `layers` axis is the ModuleList index here."""

    def __init__(self, cfg: SigLIPConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch_embedding = Conv2d(3, d, k=cfg.patch_size, device=device, dtype=dtype)
        self.position_embedding = Embedding(cfg.num_patches, d, device=device, dtype=dtype)
        self.layers = nn.ModuleList(SigLIPLayer(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.post_layernorm = NormAffine(d, device=device, dtype=dtype)
        self.projector = Projector(cfg, device, dtype)


def vision_forward(model: SigLIPModel, pixels):
    """pixels (B, H, W, 3) in [-1, 1] -> patch features (B, N, D) in the
    tower's dtype."""
    cfg = model.cfg
    w, bias = model.patch_embedding.weight, model.patch_embedding.bias
    px = torch.as_tensor(pixels).to(w.device, w.dtype).permute(0, 3, 1, 2)
    x = F.conv2d(px.float(), w.float(), bias.float(), stride=cfg.patch_size)
    b, d = x.shape[:2]
    x = x.reshape(b, d, -1).transpose(1, 2).to(w.dtype)
    h = x + model.position_embedding.weight[None]
    for layer in model.layers:
        h = layer(h, cfg.layer_norm_eps)
    return layer_norm(model.post_layernorm, h, cfg.layer_norm_eps)


def project_to_soft_tokens(model: SigLIPModel, features):
    """(B, N, D) patch features -> (B, mm_tokens, text_hidden) f32 soft
    tokens: average pooling over pool_kernel x pool_kernel patches, Gemma's
    (1 + w) RMSNorm and the projection, all in f32."""
    cfg = model.cfg
    b, _, d = features.shape
    side, k = cfg.patches_per_side, cfg.pool_kernel
    grid = features.reshape(b, side, side, d).float()
    pooled = grid.reshape(b, side // k, k, side // k, k, d).mean(dim=(2, 4)).reshape(b, -1, d)
    proj = model.projector
    inv = torch.rsqrt(torch.mean(pooled * pooled, -1, keepdim=True) + cfg.rms_norm_eps)
    normed = pooled * inv * (1.0 + proj.mm_soft_emb_norm.weight.float())
    return torch.matmul(normed, proj.mm_input_projection.weight.float().t())


def preprocess_image(path: str, cfg: SigLIPConfig) -> np.ndarray:
    """Image file -> (1, S, S, 3) float32 in [-1, 1]: a bilinear resize to
    image_size, 1/255, then mean and std 0.5."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((cfg.image_size, cfg.image_size),
                                                 Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return ((arr - 0.5) / 0.5)[None]


@torch.inference_mode()
def embed_image_for_gemma(model: SigLIPModel, image_path: str,
                          cfg: Optional[SigLIPConfig] = None):
    """Image file -> (1, mm_tokens, text_hidden) f32 soft tokens on the
    tower's device, for splicing into the Gemma prompt (not scaled by
    sqrt(hidden)). `cfg` defaults to the tower's."""
    cfg = cfg or model.cfg
    pixels = torch.from_numpy(preprocess_image(image_path, cfg))
    return project_to_soft_tokens(model, vision_forward(model, pixels))


# ---------------------------------------------------------------------------
# Weights (a Hugging Face / MLX Gemma-3 VLM checkpoint)
# ---------------------------------------------------------------------------

_VT = "vision_tower.vision_model."


def load_vision_params(tensors: dict, cfg: Optional[SigLIPConfig] = None, device=None):
    """The SigLIPModel state dict of a checkpoint's `vision_tower.*` and
    `multi_modal_projector.*` tensors, or None for a text-only checkpoint.
    MLX 4-bit linears ({k}.scales / .biases beside the packed weight) are
    dequantized by `weights.keymaps._maybe_dequant_mlx_4bit` (popped from
    `tensors`, computed on `device`); float32 rounds to bfloat16."""
    if not any(k.startswith("vision_tower.") for k in tensors):
        return None
    from ltx_tpu_torch.weights.keymaps import _bf16, _maybe_dequant_mlx_4bit

    cfg = cfg or SigLIPConfig()

    def get(k):
        full = _VT + k
        base = full[: -len(".weight")] if full.endswith(".weight") else full
        if base + ".scales" in tensors:
            return _maybe_dequant_mlx_4bit(tensors, base, device=device)
        return tensors[full]

    out = {}

    def put(name, prefix):  # a linear (out, in) or a norm's weight and bias
        out[f"{name}.weight"] = _bf16(get(prefix + ".weight"))
        out[f"{name}.bias"] = _bf16(get(prefix + ".bias"))

    for i in range(cfg.num_layers):
        lp, q = f"encoder.layers.{i}.", f"layers.{i}."
        for name in ("layer_norm1", "layer_norm2"):
            put(q + name, lp + name)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(q + name, lp + "self_attn." + name)
        for name in ("fc1", "fc2"):
            put(q + name, lp + "mlp." + name)
    pe = get("embeddings.patch_embedding.weight")
    # HF's conv weight is (O, I, kh, kw), torch's; an MLX export's (O, kh, kw, I)
    out["patch_embedding.weight"] = _bf16(pe if pe.shape[1] == 3 else pe.permute(0, 3, 1, 2))
    out["patch_embedding.bias"] = _bf16(get("embeddings.patch_embedding.bias"))
    out["position_embedding.weight"] = _bf16(get("embeddings.position_embedding.weight"))
    put("post_layernorm", "post_layernorm")
    out["projector.mm_soft_emb_norm.weight"] = _bf16(
        tensors["multi_modal_projector.mm_soft_emb_norm.weight"])
    proj_w = tensors["multi_modal_projector.mm_input_projection_weight"]
    out["projector.mm_input_projection.weight"] = _bf16(
        proj_w.t() if proj_w.shape[0] == cfg.hidden_size else proj_w)
    return out
