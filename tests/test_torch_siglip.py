"""Port parity: the SigLIP vision tower and Gemma-3's projector
(ltx_tpu_torch.models.siglip) against ltx_tpu.models.siglip, on the tiny
config and on a head-dim-72 one (SigLIP-So400m's head width, the flash
kernel's new case on the card; the CPU runs its plain version).

Tolerances: f32 features and soft tokens within 1e-5 of the reference's
largest value; bf16 within 5e-2; the preprocessed pixels and the loaded
parameters (`load_vision_params`, dense and MLX 4-bit) bit for bit
`convert` of the reference's tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.models import siglip as js
from ltx_tpu_torch import convert
from ltx_tpu_torch.models import siglip as ps
from ltx_tpu_torch.models.common import assign_
from torch_parity import assert_rel
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CFG = js.SigLIPConfig().tiny()
# SigLIP-So400m's head width at a small size: 2 heads of 72
CFG72 = dataclasses.replace(CFG, hidden_size=144, num_heads=2, intermediate_size=96)


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def _pixels(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (1, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    init = jax.jit(js.init_params, static_argnums=1)
    return {"tiny": init(jax.random.key(0), CFG), "d72": init(jax.random.key(2), CFG72)}


def test_config_matches_reference():
    for cfg in (js.SigLIPConfig(), CFG):
        port = convert.port_config(cfg, ps.SigLIPConfig)
        assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
        assert (port.patches_per_side, port.num_patches, port.pool_kernel) == (
            cfg.patches_per_side, cfg.num_patches, cfg.pool_kernel)
    assert ps.SigLIPConfig().hidden_size // ps.SigLIPConfig().num_heads == 72


@pytest.mark.parametrize("which,dtype,tol", [("tiny", "f32", 1e-5), ("tiny", "bf16", 5e-2),
                                             ("d72", "f32", 1e-5), ("d72", "bf16", 5e-2)])
def test_vision_forward_and_soft_tokens(trees, which, dtype, tol):
    cfg = CFG if which == "tiny" else CFG72
    tree = trees[which] if dtype == "bf16" else _f32(trees[which])
    px = _pixels(cfg)
    want = js.vision_forward(tree, jnp.asarray(px), cfg)
    model = convert.siglip(tree, cfg)
    got = ps.vision_forward(model, torch.from_numpy(px))
    assert got.shape == (1, cfg.num_patches, cfg.hidden_size)
    assert_rel(got, want, tol, f"vision_forward {which} {dtype}")
    soft = ps.project_to_soft_tokens(model, got)
    want_soft = js.project_to_soft_tokens(tree, want, cfg)
    assert soft.shape == (1, cfg.mm_tokens_per_image, cfg.text_hidden_size)
    assert_rel(soft, want_soft, tol, f"project_to_soft_tokens {which} {dtype}")


def test_projector_pools_to_mm_tokens(trees):
    """Constant features pool to identical soft tokens; the f32 projection
    of given features matches the reference's."""
    model = convert.siglip(_f32(trees["tiny"]), CFG)
    const = torch.ones(1, CFG.num_patches, CFG.hidden_size)
    a = ps.project_to_soft_tokens(model, const)
    np.testing.assert_allclose(a[0, 0].numpy(), a[0, -1].numpy(), atol=1e-6)
    feats = np.random.default_rng(2).standard_normal(
        (2, CFG.num_patches, CFG.hidden_size)).astype(np.float32)
    assert_rel(ps.project_to_soft_tokens(model, torch.from_numpy(feats)),
               js.project_to_soft_tokens(_f32(trees["tiny"]), jnp.asarray(feats), CFG),
               1e-5, "projector f32")


@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    from PIL import Image

    arr = np.random.default_rng(1).integers(0, 256, (30, 44, 3), dtype=np.uint8)
    path = tmp_path_factory.mktemp("img") / "vision.png"
    Image.fromarray(arr).save(path)
    return str(path)


def test_preprocess_and_embed_image_for_gemma(trees, image_file):
    px = ps.preprocess_image(image_file, CFG)
    np.testing.assert_array_equal(px, js.preprocess_image(image_file, CFG))
    assert px.shape == (1, CFG.image_size, CFG.image_size, 3)
    assert px.min() >= -1.0 and px.max() <= 1.0
    tree = _f32(trees["tiny"])
    got = ps.embed_image_for_gemma(convert.siglip(tree, CFG), image_file)
    assert_rel(got, js.embed_image_for_gemma(tree, image_file, CFG), 1e-5,
               "embed_image_for_gemma f32")


# ---------------------------------------------------------------------------
# load_vision_params
# ---------------------------------------------------------------------------

VT = "vision_tower.vision_model."
# every linear's input is a multiple of MLX's group of 64
MLX_CFG = dataclasses.replace(CFG, hidden_size=64, intermediate_size=128, text_hidden_size=48)


def _hf_tensors(cfg, mlx: bool, seed: int = 0) -> dict:
    """A VLM checkpoint's vision keys (the HF layout, or MLX 4-bit linears
    with an (O, kh, kw, I) patch embedding) and a text key."""
    rng = np.random.default_rng(seed)
    d, mlp, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    t = {"language_model.model.norm.weight": np.ones((4,), np.float32)}

    def normal(*shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def dense(prefix, di, do):
        if mlx:
            t[f"{VT}{prefix}.weight"] = rng.integers(0, 2**32, (do, di // 8), dtype=np.uint32)
            scales = (0.02 / 7.5 * (1 + rng.random((do, di // 64)))).astype(np.float32)
            t[f"{VT}{prefix}.scales"] = scales
            t[f"{VT}{prefix}.biases"] = (-7.5 * scales).astype(np.float32)
        else:
            t[f"{VT}{prefix}.weight"] = normal(do, di)
        t[f"{VT}{prefix}.bias"] = normal(do)

    def ln(prefix):
        t[f"{VT}{prefix}.weight"] = 1 + normal(d)
        t[f"{VT}{prefix}.bias"] = normal(d)

    t[f"{VT}embeddings.patch_embedding.weight"] = normal(d, p, p, 3) if mlx \
        else normal(d, 3, p, p)
    t[f"{VT}embeddings.patch_embedding.bias"] = normal(d)
    t[f"{VT}embeddings.position_embedding.weight"] = normal(cfg.num_patches, d)
    for i in range(cfg.num_layers):
        lp = f"encoder.layers.{i}."
        ln(lp + "layer_norm1")
        ln(lp + "layer_norm2")
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(lp + f"self_attn.{name}", d, d)
        dense(lp + "mlp.fc1", d, mlp)
        dense(lp + "mlp.fc2", mlp, d)
    ln("post_layernorm")
    t["multi_modal_projector.mm_soft_emb_norm.weight"] = normal(d)
    t["multi_modal_projector.mm_input_projection_weight"] = normal(d, cfg.text_hidden_size)
    return t


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("mlx", [False, True], ids=["dense", "mlx_4bit"])
def test_load_vision_params_equals_convert_of_reference(mlx):
    cfg = MLX_CFG if mlx else CFG
    tensors = _hf_tensors(cfg, mlx)
    tree = js.load_vision_params(dict(tensors), cfg)
    state = ps.load_vision_params({k: torch.from_numpy(v) for k, v in tensors.items()}, cfg)
    got = assign_(ps.SigLIPModel(convert.port_config(cfg, ps.SigLIPConfig), "meta"), state)
    want = dict(convert.siglip(tree, cfg).named_parameters())
    assert sorted(dict(got.named_parameters())) == sorted(want)
    for name, p in got.named_parameters():
        assert p.dtype == want[name].dtype == torch.bfloat16, name
        assert torch.equal(_bits(p), _bits(want[name])), name
    px = _pixels(cfg, seed=3)
    assert_rel(ps.project_to_soft_tokens(got, ps.vision_forward(got, torch.from_numpy(px))),
               js.project_to_soft_tokens(tree, js.vision_forward(tree, jnp.asarray(px), cfg),
                                         cfg), 5e-2, "loaded tower bf16")


def test_text_only_checkpoint_has_no_tower():
    assert ps.load_vision_params({"model.embed_tokens.weight": torch.zeros(2)}) is None
