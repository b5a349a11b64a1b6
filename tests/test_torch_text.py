"""Port parity: the Gemma-3 tower (forward_hidden_states) and the text
encoder (encode_from_hidden_states) of ltx_tpu_torch against ltx_tpu, on
the tiny configs of the reference's random_tiny pipeline.

Tolerances: float32 1e-5 relative. bf16: the port must be as close to the
reference's float32 run on the same bf16 weights as the reference's own
bf16 run is (within 1.5x), and within the stated bound of the reference's
bf16 output (Gemma 5e-2 over seven layers, the text encoder 5e-2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.models import gemma3 as jgemma
from ltx_tpu.models import text_encoder as jte
from ltx_tpu.models import vae as jvae
from ltx_tpu_torch import convert
from ltx_tpu_torch.models import gemma3, text_encoder, vae
from torch_parity import as_torch, assert_rel, rel_err
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

GCFG = jgemma.Gemma3Config().tiny()
TECFG = dataclasses.replace(
    jte.TextEncoderConfig().tiny(), hidden_dim=GCFG.hidden_size,
    num_gemma_layers=GCFG.hidden_layers + 1, connector_heads=4,
    connector_head_dim=GCFG.hidden_size // 4)
T = TECFG.max_length


def _to_f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _randomize_norms(tree, rng):
    """Redraw every norm weight ({"w"} of a 1-D leaf) so that they matter."""
    return jax.tree.map(
        lambda a: (rng.uniform(-0.5, 0.5, a.shape).astype(np.asarray(a).dtype)
                   if a.ndim == 1 else np.asarray(a)), tree)


def _ids_and_mask():
    rng = np.random.default_rng(0)
    ids = np.zeros((1, T), np.int32)
    mask = np.zeros((1, T), np.int32)
    ids[0, 5:] = rng.integers(2, GCFG.vocab_size, T - 5)
    mask[0, 5:] = 1
    return ids, mask


def test_configs_match_reference():
    for port_cls, ref in ((gemma3.Gemma3Config, jgemma.Gemma3Config()),
                          (text_encoder.TextEncoderConfig, jte.TextEncoderConfig()),
                          (vae.VAEConfig, jvae.VAEConfig())):
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(ref)
        assert dataclasses.asdict(port_cls().tiny()) == dataclasses.asdict(ref.tiny())
    assert text_encoder.TextEncoderConfig().inner_dim == 3840


@pytest.fixture(scope="module")
def gemma_tree():
    tree = jgemma.init_params(jax.random.key(1), GCFG, jnp.bfloat16)
    return _randomize_norms(tree, np.random.default_rng(2))


def _gemma_states(tree, ids, mask, port: bool):
    if port:
        model = convert.gemma(tree, GCFG)
        return model.forward_hidden_states(torch.from_numpy(ids), torch.from_numpy(mask))
    return jgemma.forward_hidden_states(jax.tree.map(jnp.asarray, tree),
                                        jnp.asarray(ids), jnp.asarray(mask), GCFG)


def test_gemma_hidden_states_f32(gemma_tree):
    ids, mask = _ids_and_mask()
    tree = _to_f32(gemma_tree)
    got = _gemma_states(tree, ids, mask, port=True)
    assert got.shape == (GCFG.hidden_layers + 1, 1, T, GCFG.hidden_size)
    assert_rel(got, _gemma_states(tree, ids, mask, port=False), 1e-5,
               "gemma forward_hidden_states float32")


def test_gemma_hidden_states_bf16(gemma_tree):
    ids, mask = _ids_and_mask()
    got = _gemma_states(gemma_tree, ids, mask, port=True)
    want = _gemma_states(gemma_tree, ids, mask, port=False)
    exact = _gemma_states(_to_f32(gemma_tree), ids, mask, port=False)
    assert got.dtype == torch.bfloat16
    assert_rel(got, exact, 1.5 * rel_err(want, exact),
               "gemma forward_hidden_states bf16 vs f32 reference")
    assert_rel(got, want, 5e-2, "gemma forward_hidden_states bf16")


@pytest.fixture(scope="module")
def te_tree():
    return jte.init_params(jax.random.key(4), TECFG, jnp.bfloat16)


def _hidden(dtype_np=np.float32):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((TECFG.num_gemma_layers, 1, T, TECFG.hidden_dim)) * 4
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _encode(tree, hidden, mask, dtype, port: bool):
    if port:
        model = convert.text_encoder(tree, TECFG)
        out = model.encode_from_hidden_states(as_torch(hidden, dtype),
                                              torch.from_numpy(mask))
    else:
        out = jte.encode_from_hidden_states(jax.tree.map(jnp.asarray, tree),
                                            jnp.asarray(hidden, dtype),
                                            jnp.asarray(mask), TECFG)
    return out["video"], out["mask"]


def test_text_encoder_f32(te_tree):
    _, mask = _ids_and_mask()
    tree = _to_f32(te_tree)
    got, got_mask = _encode(tree, _hidden(), mask, torch.float32, port=True)
    want, want_mask = _encode(tree, _hidden(), mask, jnp.float32, port=False)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert_rel(got, want, 1e-5, "encode_from_hidden_states float32")


def test_text_encoder_bf16(te_tree):
    _, mask = _ids_and_mask()
    got, _ = _encode(te_tree, _hidden(), mask, torch.bfloat16, port=True)
    want, _ = _encode(te_tree, _hidden(), mask, jnp.bfloat16, port=False)
    exact, _ = _encode(_to_f32(te_tree), _hidden(), mask, jnp.float32, port=False)
    assert got.dtype == torch.bfloat16
    assert_rel(got, exact, 1.5 * rel_err(want, exact),
               "encode_from_hidden_states bf16 vs f32 reference")
    assert_rel(got, want, 5e-2, "encode_from_hidden_states bf16")


def test_norm_and_concat_and_registers_f32():
    """The two masked, layout-heavy steps alone, exactly as the reference."""
    _, mask = _ids_and_mask()
    hidden = _hidden()
    assert_rel(text_encoder.norm_and_concat(torch.from_numpy(hidden), torch.from_numpy(mask)),
               jte.norm_and_concat(jnp.asarray(hidden), jnp.asarray(mask)),
               1e-6, "norm_and_concat float32")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, T, 8)).astype(np.float32)
    regs = rng.standard_normal((4, 8)).astype(np.float32)
    got = text_encoder.replace_padded_with_registers(
        torch.from_numpy(x), torch.from_numpy(mask).bool(), torch.from_numpy(regs))
    want = jte.replace_padded_with_registers(jnp.asarray(x), jnp.asarray(mask).astype(bool),
                                             jnp.asarray(regs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
