"""Port parity: Gemma-3's quantized modes (ltx_tpu_torch.weights.keymaps.
load_gemma_params and models.gemma3 against ltx_tpu's) on the same
checkpoint tensors (tests/weight_fixtures.py specs at small widths, MLX
4-bit and dense), and the card-sized registry rule.

Tolerances:
* load_gemma_params in "int4" (a lossless repack), "w8a8" (from MLX 4-bit
  and from a dense f32 file), "w8a8" with the int8 token table, "bf16" and
  keep_quantized=False: the port's state dict, built into the model
  (`Gemma3Model.from_state_dict`), equals `convert.gemma` of the
  reference's tree bit for bit.
* forward_hidden_states in each mode: the port's bf16 run must be as close
  to the reference's float32 run on the same leaves as the reference's own
  bf16 run is, within 1.5x (test_torch_text's rule: the same bf16 math
  rounded at other places), and within 5e-2 of the reference's bf16 run
  (test_torch_text's Gemma bound). The MLX scales and biases are a QAT checkpoint's
  (positive scales, biases -7.5 scales, as chip_smoke writes them): with
  the fixture's own (normal, 0.01) the weights are several times a
  checkpoint's and the seven layers amplify rounding so that the
  reference's own bf16 error reaches 0.19 of the largest state. The "int4" mode at the tiny
  widths takes the dequantize-then-product route on both sides; a 256-wide
  model takes the int4 kernel route (the port's plain version, the
  reference's Pallas kernel in interpret mode).
* the int8 table's lookup and tied head (`_embed_lookup`, `_lm_head`):
  bitwise (exact int32 products, the same f32 scaling order); the bf16
  table's head 1e-5 relative (f32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.weight_fixtures as wf
from ltx_tpu.models import gemma3 as jgemma
from ltx_tpu.weights import keymaps as jk
from ltx_tpu.weights import registry as jreg
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import LTXModel
from ltx_tpu_torch.models import gemma3
from ltx_tpu_torch.models.common import (
    Embedding,
    Int8Embedding,
    Linear,
    QuantizedLinear,
    W8A8Linear,
)
from ltx_tpu_torch.weights import keymaps, registry
from torch_parity import assert_rel, reference_int4_kernel_route, rel_err
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

TINY = jgemma.Gemma3Config().tiny()
WIDE = dataclasses.replace(TINY, hidden_size=256, hidden_layers=2, intermediate_size=512,
                           attention_heads=8, kv_heads=4, head_dim=64,
                           query_pre_attn_scalar=64.0)
# the port's bf16 error against the reference's f32 run, over the
# reference's own (test_torch_text's rule)
OWN_ERROR_FACTOR = 1.5
BF16_TOL = 5e-2  # test_torch_text's Gemma bound against the reference's bf16 run
T = 16

# (mode, embed_int8, keep_quantized, MLX 4-bit file)
CASES = {
    "int4": ("int4", False, True, True),
    "w8a8": ("w8a8", False, True, True),
    "w8a8_embed_int8": ("w8a8", True, True, True),
    "w8a8_dense_file": ("w8a8", False, True, False),
    "bf16": ("bf16", False, True, True),
    "keep_quantized_false": ("int4", False, False, True),
}
# the port's module of each block linear and of the token table, by case
FORMATS = {"int4": (QuantizedLinear, Embedding), "w8a8": (W8A8Linear, Embedding),
           "w8a8_embed_int8": (W8A8Linear, Int8Embedding),
           "w8a8_dense_file": (W8A8Linear, Embedding), "bf16": (Linear, Embedding),
           "keep_quantized_false": (Linear, Embedding)}


def _tensors(cfg, mlx: bool, seed: int = 7) -> dict:
    spec = wf.gemma_spec(layers=cfg.hidden_layers, hidden=cfg.hidden_size,
                         heads=cfg.attention_heads, kv_heads=cfg.kv_heads,
                         head_dim=cfg.head_dim, intermediate=cfg.intermediate_size,
                         vocab=cfg.vocab_size, mlx_4bit=mlx)
    tensors = wf.materialize(spec, seed=seed)
    for key in [k for k in tensors if k.endswith(".scales")]:
        # a QAT checkpoint's groups: positive scales around 0.0027 and biases
        # -7.5 scales, weights within +-0.02 (the fixture's own are normal)
        scales = 0.02 / 7.5 * (1.0 + 0.25 * np.abs(tensors[key]) / 0.01)
        tensors[key] = scales.astype(np.float32)
        tensors[key[:-len("scales")] + "biases"] = (-7.5 * scales).astype(np.float32)
    return tensors


def _load_both(cfg, case):
    mode, embed_int8, keep, mlx = CASES[case]
    tensors = _tensors(cfg, mlx)
    kw = dict(mode=mode, embed_int8=embed_int8, keep_quantized=keep)
    tree = jk.load_gemma_params(dict(tensors), cfg.hidden_layers, **kw)
    state = keymaps.load_gemma_params({k: torch.from_numpy(v) for k, v in tensors.items()},
                                      cfg.hidden_layers, **kw)
    pcfg = convert.port_config(cfg, gemma3.Gemma3Config)
    return tree, gemma3.Gemma3Model.from_state_dict(pcfg, state), pcfg


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.fixture(scope="module")
def loaded():
    """Each case's reference tree and port model, built once."""
    return {case: _load_both(TINY, case) for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_gemma_params_equals_convert_of_reference(loaded, case):
    tree, model, pcfg = loaded[case]
    want = dict(convert.gemma(tree, pcfg).named_parameters())
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(_bits(g), _bits(w)), name
    linear, table = FORMATS[case]
    assert type(model.layers[0].down_proj) is linear and type(model.embed_tokens) is table


def _ids_and_mask(cfg):
    rng = np.random.default_rng(0)
    ids = np.zeros((1, T), np.int32)
    mask = np.zeros((1, T), np.int32)
    ids[0, 4:] = rng.integers(2, cfg.vocab_size, T - 4)
    mask[0, 4:] = 1
    return ids, mask


def _check_hidden_states(tree, model, cfg, what: str):
    """The port's states against the reference's f32 run on the same
    leaves (bf16 leaves widened, an int8 table's rows dequantized in f32,
    integer codes as they are), within
    OWN_ERROR_FACTOR of the reference's own bf16 run."""
    ids, mask = _ids_and_mask(cfg)

    def reference(leaves):
        return jgemma.forward_hidden_states(jax.tree.map(jnp.asarray, leaves),
                                            jnp.asarray(ids), jnp.asarray(mask), cfg)

    want = reference(tree)
    wide = jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else a,
                        tree)
    if "w8r" in tree["embed_tokens"]:  # an int8 table implies bf16: widen its rows
        emb = tree["embed_tokens"]
        wide["embed_tokens"] = {"w": emb["w8r"].astype(np.float32) * emb["sr"][:, None]}
    exact = reference(wide)
    with torch.inference_mode():
        got = model.forward_hidden_states(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (cfg.hidden_layers + 1, 1, T, cfg.hidden_size)
    assert got.dtype == torch.bfloat16
    own = rel_err(want, exact)
    print(f"[parity] {what}: the reference's own bf16 error {own:.3e}")
    assert_rel(got, exact, OWN_ERROR_FACTOR * own, f"{what} vs the reference's f32 run")
    assert_rel(got, want, BF16_TOL, f"{what} vs the reference's bf16 run")


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_hidden_states_each_mode(loaded, case):
    tree, model, _ = loaded[case]
    _check_hidden_states(tree, model, TINY, f"Gemma hidden states, {case}")


def test_forward_hidden_states_int4_kernel_route(monkeypatch):
    """256 wide: every projection passes the int4 kernel route's shape rule
    on both sides."""
    calls = reference_int4_kernel_route(monkeypatch)
    tree, model, _ = _load_both(WIDE, "int4")
    _check_hidden_states(tree, model, WIDE, "Gemma hidden states, int4 kernel route")
    assert len(calls) == 14  # one traced layer body (q, k, v, o, gate, up, down) a run


@pytest.mark.parametrize("case", ["w8a8_embed_int8", "w8a8"])
def test_embed_lookup_and_lm_head(loaded, case):
    tree, model, _ = loaded[case]
    ids, _ = _ids_and_mask(TINY)
    jtree = jax.tree.map(jnp.asarray, tree)
    assert gemma3.embed_dtype(model) == torch.bfloat16
    rows = model.embed_tokens(torch.from_numpy(ids))
    np.testing.assert_array_equal(rows.float().numpy(), np.asarray(
        jgemma._embed_lookup(jtree, jnp.asarray(ids)), np.float32))
    h = np.asarray(jnp.asarray(np.random.default_rng(3).standard_normal(
        (1, T, TINY.hidden_size)), jnp.bfloat16))
    want = jgemma._lm_head(jtree, jnp.asarray(h))
    got = gemma3.lm_head(model, torch.from_numpy(h.astype(np.float32)).bfloat16())
    assert got.dtype == torch.float32 and got.shape == (1, T, TINY.vocab_size)
    if case == "w8a8_embed_int8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert_rel(got, want, 1e-5, "lm_head, bf16 table")


@pytest.mark.parametrize("n_devices,memory_gb", [(1, 80.0), (1, 15.5), (8, 15.5), (0, 0.0)])
def test_recommended_model_by_device_memory(n_devices, memory_gb):
    """The reference's rule at the card's 80 GB: one H100 runs the dev
    model in bf16, where one 15.5 GB TPU chip needs the distilled int4."""
    got = registry.recommended_model(n_devices, memory_gb)
    want = jreg.recommended_model(n_devices=n_devices, hbm_per_chip_gb=memory_gb)
    assert (got[0].value, got[1]) == (want[0].value, want[1])
    if (n_devices, memory_gb) == (1, 80.0):
        assert got == (LTXModel.DEV, None)
    if not torch.cuda.is_available():  # here: no devices, the quantized model
        assert registry.recommended_model() == (LTXModel.DISTILLED, "int4")
