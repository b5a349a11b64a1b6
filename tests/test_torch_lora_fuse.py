"""LoRA fusion (ltx_tpu_torch.lora.fuse) against ltx_tpu.lora.fuse, on
tests/test_lora.py's cases: key map, both pair formats, the delta, fusion
into a bf16 / f32 DiT (several blocks' linears and a top-level one),
quantized int4 and int8 leaves, unknown layers skipped, multi-LoRA, LoRA
configs with scheduler overrides, lora_info. The reference fuses host
(numpy) trees, as its loader does; the port fuses the module `convert`
builds from the same tree, and the results are compared parameter for
parameter.

At these ranks the port's float32 delta (torch) equals the reference's
(numpy) bit for bit, so every fused leaf does too, quantized ones
included; at larger ranks the two products may sum in another order
(ltx_tpu_torch.checks.lora_fuse_bound says by how much). The round trip:
an adapter written by train/export.py::save_lora and fused equals
train/lora.py::merge_lora.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

from ltx_tpu.core import config as jconfig
from ltx_tpu.kernels.quantization import quantize_transformer_params
from ltx_tpu.lora import fuse as jfuse
from ltx_tpu.models import dit as jdit
from ltx_tpu_torch import checks, convert
from ltx_tpu_torch.config import GenerationConfig, TransformerConfig
from ltx_tpu_torch.lora import fuse
from ltx_tpu_torch.train import export, lora
from ltx_tpu_torch.weights import safetensors_io

CFG = TransformerConfig().tiny()
JCFG = jconfig.TransformerConfig().tiny()


def _bits(t):
    t = torch.as_tensor(t).detach().contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else (
        t.view(torch.int32) if t.dtype == torch.float32 else t)


def assert_same_params(got: torch.nn.Module, want: torch.nn.Module):
    a, b = dict(got.named_parameters()), dict(want.named_parameters())
    assert sorted(a) == sorted(b)
    for n in b:
        assert a[n].dtype == b[n].dtype and torch.equal(_bits(a[n]), _bits(b[n])), n


@pytest.fixture(scope="module")
def trees():
    """The reference's DiT trees as its loaders deliver them (host numpy):
    f32, bf16, and the bf16 one quantized to int4 and to int8."""
    out = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        out[name] = jax.tree.map(np.asarray, jdit.init_params(jax.random.key(0), JCFG, dtype))
    for bits in (4, 8):
        out[f"int{bits}"] = quantize_transformer_params(out["bf16"], bits, 64)
    return out


def _copy(tree):
    return jax.tree.map(lambda x: x.copy(), tree)


def _lora_tensors(rank=4, alpha=8.0, fmt="down_up", seed=0, keys=None, scale=0.1):
    """A LoRA over `keys` ({LoRA key prefix: (out, in)})."""
    rng = np.random.default_rng(seed)
    d, f = CFG.inner_dim, CFG.ffn_dim
    keys = keys or {
        "diffusion_model.transformer_blocks.1.attn1.to_q": (d, d),
        "diffusion_model.transformer_blocks.0.attn2.to_out.0": (d, d),
        "diffusion_model.transformer_blocks.0.ff.net.0.proj": (f, d),
        "diffusion_model.transformer_blocks.1.ff.net.2": (d, f),
        "diffusion_model.proj_in": (d, CFG.in_channels),
        "diffusion_model.time_embed.emb.timestep_embedder.linear_1": (d, 256),
    }
    t = {}
    for key, (o, i) in keys.items():
        down = (rng.standard_normal((rank, i)) * scale).astype(np.float32)
        up = (rng.standard_normal((o, rank)) * scale).astype(np.float32)
        if fmt == "down_up":
            t[f"{key}.lora_down.weight"], t[f"{key}.lora_up.weight"] = down, up
            t[f"{key}.alpha"] = np.float32(alpha)
        else:
            t[f"{key}.lora_A.weight"], t[f"{key}.lora_B.weight"] = down, up
    return t


def test_key_map_parse_and_delta_match_reference():
    for src in ("diffusion_model.transformer_blocks.0.attn1.to_out.0",
                "diffusion_model.transformer_blocks.3.ff.net.0.proj",
                "diffusion_model.transformer_blocks.3.ff.net.2",
                "diffusion_model.time_embed.emb.timestep_embedder.linear_1",
                "transformer_blocks.1.attn2.to_q"):
        assert fuse.map_lora_key(src) == jfuse.map_lora_key(src)
    for fmt in ("down_up", "AB"):
        t = _lora_tensors(fmt=fmt)
        got, want = fuse.parse_lora(t), jfuse.parse_lora(t)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert (g.original_key, g.rank, g.alpha, g.effective_scale) == \
                (w.original_key, w.rank, w.alpha, w.effective_scale)
            for s in (1.0, 0.5):
                assert torch.equal(_bits(g.delta(s)), _bits(torch.from_numpy(w.delta(s))))


@pytest.mark.parametrize("base", ["f32", "bf16", "int4", "int8"])
def test_fuse_matches_reference(trees, base):
    tree = trees[base]
    layers_np = jfuse.parse_lora(_lora_tensors())
    want = jfuse.fuse_lora(_copy(tree), layers_np, scale=0.7)
    model = convert.transformer(tree, CFG)
    before = {n: p.clone() for n, p in model.named_parameters()}
    got = fuse.fuse_lora(model, fuse.parse_lora(_lora_tensors()), scale=0.7)
    assert_same_params(got, convert.transformer(want, CFG))
    changed = {n for n, p in got.named_parameters() if not torch.equal(p, before[n])}
    assert any(".ff.project_in." in n for n in changed) and "patchify_proj.weight" in changed
    # the caller's model is untouched; what was not fused is shared
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    assert got.blocks[0].attn1.to_q.weight is model.blocks[0].attn1.to_q.weight
    # in place on request
    fused_in_place = fuse.fuse_lora(model, fuse.parse_lora(_lora_tensors()), scale=0.7,
                                    inplace=True)
    assert fused_in_place is model
    assert_same_params(model, got)


def test_quantized_fuse_moves_the_weight_by_the_delta(trees):
    """As tests/test_lora.py: the requantized leaf moves by the delta (the
    codes change only by the quantization step)."""
    model = convert.transformer(trees["int4"], CFG)
    t = _lora_tensors(keys={"diffusion_model.transformer_blocks.0.ff.net.0.proj":
                            (CFG.ffn_dim, CFG.inner_dim)}, scale=0.3)
    got = fuse.fuse_lora(model, fuse.parse_lora(t))
    from ltx_tpu_torch.kernels.quantization import dequantize_weight

    def w(m):
        q = m.blocks[0].ff.project_in
        return dequantize_weight({"w_q4": q.w_q4, "scale": q.scale, "bias": q.bias},
                                 torch.float32)
    moved = (w(got) - w(model)).numpy().ravel()
    layer = fuse.parse_lora(t)[0]
    expected = layer.delta().t().numpy().ravel()
    assert np.corrcoef(moved, expected)[0, 1] > 0.95
    assert torch.equal(got.blocks[1].ff.project_in.w_q4, model.blocks[1].ff.project_in.w_q4)


def test_unknown_layers_are_skipped_and_multi_lora_adds(trees):
    tree = trees["bf16"]
    model = convert.transformer(tree, CFG)
    junk = {"diffusion_model.nonexistent.layer.lora_down.weight": np.zeros((2, 4), np.float32),
            "diffusion_model.nonexistent.layer.lora_up.weight": np.zeros((4, 2), np.float32),
            "diffusion_model.transformer_blocks.9.attn1.to_q.lora_down.weight":
                np.ones((2, CFG.inner_dim), np.float32),
            "diffusion_model.transformer_blocks.9.attn1.to_q.lora_up.weight":
                np.ones((CFG.inner_dim, 2), np.float32)}
    assert_same_params(fuse.fuse_lora(model, fuse.parse_lora(junk)), model)

    a, b = _lora_tensors(seed=1), _lora_tensors(seed=2, rank=2, alpha=1.0)
    want = jfuse.fuse_multi_lora(_copy(tree), [(jfuse.parse_lora(a), 0.5),
                                              (jfuse.parse_lora(b), 1.5)])
    got = fuse.fuse_multi_lora(model, [(fuse.parse_lora(a), 0.5), (fuse.parse_lora(b), 1.5)])
    assert_same_params(got, convert.transformer(want, CFG))


def test_configs_overrides_and_info_match_reference(trees, tmp_path):
    tree = trees["bf16"]
    paths = []
    for i, kw in enumerate((dict(seed=3), dict(seed=4, fmt="AB"))):
        p = tmp_path / f"l{i}.safetensors"
        safetensors_io.save(_lora_tensors(**kw), p)
        paths.append(str(p))
    ov = fuse.LoRASchedulerOverrides(num_steps=4, guidance_scale=1.0, sigmas=(1.0, 0.6, 0.3))
    jov = jfuse.LoRASchedulerOverrides(num_steps=4, guidance_scale=1.0, sigmas=(1.0, 0.6, 0.3))
    base = dict(width=64, height=64, num_frames=9, num_steps=40, cfg_scale=4.0)
    assert dataclasses.asdict(ov.apply_to(GenerationConfig(**base))) == dataclasses.asdict(
        jov.apply_to(jconfig.GenerationConfig(**base)))
    configs = [fuse.LoRAConfig(paths[0], 0.8, name="turbo", scheduler_overrides=ov),
               fuse.LoRAConfig(paths[1], 1.2)]
    jconfigs = [jfuse.LoRAConfig(paths[0], 0.8, name="turbo", scheduler_overrides=jov),
                jfuse.LoRAConfig(paths[1], 1.2)]
    got = fuse.fuse_lora_configs(convert.transformer(tree, CFG), configs)
    want = jfuse.fuse_lora_configs(_copy(tree), jconfigs)
    assert_same_params(got, convert.transformer(want, CFG))
    for p in paths:
        assert dataclasses.asdict(fuse.lora_info(p, scheduler_overrides=ov)) == \
            dataclasses.asdict(jfuse.lora_info(p, scheduler_overrides=jov))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_exported_adapter_fuses_to_merge_lora(trees, tmp_path, dtype):
    """save_lora's file fused into the base equals merge_lora of the model
    carrying that adapter, bit for bit (rank 4: alpha / rank is exact)."""
    model = convert.transformer(trees["f32" if dtype == jnp.float32 else "bf16"], CFG)
    lora.add_lora(model, torch.Generator().manual_seed(0), rank=4, alpha=2.0)
    for p in model.parameters():
        if p.requires_grad:  # lora_b starts at zero: give it values
            p.data.normal_(0, 0.05, generator=torch.Generator().manual_seed(p.numel()))
    path = tmp_path / "adapter.safetensors"
    export.save_lora(dict(model.named_parameters()), path)
    base = lora.strip_lora(copy.deepcopy(model))
    fused = fuse.fuse_lora_file(base, path)
    assert_same_params(fused, lora.merge_lora(model))


def test_fused_dit_matches_the_side_path():
    """One DiT call of the fused bf16 DiT against the unfused DiT carrying
    the same adapter as a LoRA side path (checks.lora_side_path_check, what
    the smoke run holds at full width), within its stated tolerance."""
    tree = jax.tree.map(np.asarray, jdit.init_params(jax.random.key(1), JCFG, jnp.bfloat16))
    model = convert.transformer(tree, CFG)
    layers = fuse.parse_lora(_lora_tensors(rank=8, alpha=8.0, scale=0.2))
    res = checks.lora_side_path_check(model, layers, 0.7, tokens=(2, 4, 4), text_tokens=8,
                                      device="cpu")
    print(f"[parity] fused DiT vs LoRA side path, bf16: {res['rel_err']:.3e} "
          f"(tol {checks.LORA_SIDE_PATH_TOL:.0e})")
    assert res["finite"] and res["rel_err"] <= checks.LORA_SIDE_PATH_TOL
