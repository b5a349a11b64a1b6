"""Port parity: the VAE decoder (ltx_tpu_torch.models.vae against
ltx_tpu.models.vae.decoder_forward / decode_video) on the tiny config, the
reference's channels-last weights converted to NCDHW.

Tolerances: float32 1e-5 relative (convolution summation order). bf16
convolutions: the port must be as close to the reference's float32 run on
the same weights as the reference's own bf16 run is (within 1.5x), and
within 5e-2 of it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.models import vae as jvae
from ltx_tpu_torch import convert
from ltx_tpu_torch.models import vae
from torch_parity import as_torch, assert_rel, rel_err

CFG = jvae.VAEConfig().tiny()
COND_CFG = dataclasses.replace(CFG, timestep_conditioning=True)
_init = jax.jit(jvae.init_decoder_params, static_argnums=(1, 2))
_decode = jax.jit(jvae.decoder_forward, static_argnums=(2, 3))


def _tree(dtype):
    tree = jax.tree.map(np.asarray, _init(jax.random.key(7), CFG, dtype))
    rng = np.random.default_rng(8)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "scale_shift_table" in name or "of_means" in name or name.endswith("['b']"):
            return rng.uniform(0.5, 1.0, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(redraw, tree)


def _latent(dtype=np.float32):
    x = np.random.default_rng(9).standard_normal((1, CFG.latent_channels, 2, 3, 4))
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


@pytest.mark.parametrize("cfg", [CFG, COND_CFG], ids=["plain", "timestep_noise"])
def test_decoder_forward_f32(cfg):
    tree = _tree(jnp.float32)
    latent = _latent()
    ts, key, noise = None, None, None
    if cfg.timestep_conditioning:
        ts, key = 0.05, jax.random.key(10)
        # the reference draws its decode noise channels-last from the key
        noise = np.asarray(jax.random.normal(key, (1, 2, 3, 4, CFG.latent_channels)))
        noise = torch.from_numpy(noise.copy()).permute(0, 4, 1, 2, 3)
    want = _decode(jax.tree.map(jnp.asarray, tree), jnp.asarray(latent), cfg, ts, key)
    decoder = convert.vae_decoder(tree, cfg)
    got = decoder(torch.from_numpy(latent), ts, noise)
    assert got.shape == (1, 3, 9, 96, 128)
    assert_rel(got, want, 1e-5, f"decoder_forward float32 {cfg.timestep_conditioning=}")


def test_decoder_forward_bf16_and_decode_video():
    tree = _tree(jnp.bfloat16)
    latent = _latent()
    want = _decode(jax.tree.map(jnp.asarray, tree), jnp.asarray(latent, jnp.bfloat16),
                   CFG, None, None)
    tree32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    exact = _decode(jax.tree.map(jnp.asarray, tree32), jnp.asarray(latent), CFG, None, None)
    decoder = convert.vae_decoder(tree, CFG)
    got = decoder(as_torch(latent, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_rel(got, exact, 1.5 * rel_err(want, exact), "decoder_forward bf16 vs f32 reference")
    assert_rel(got, want, 5e-2, "decoder_forward bf16")

    frames = vae.decode_video(decoder, as_torch(latent, torch.bfloat16))
    assert frames.shape == (9, 96, 128, 3)
    ref_frames = jnp.clip((want + 1.0) / 2.0, 0.0, 1.0)[0].transpose(1, 2, 3, 0)
    assert_rel(frames, ref_frames, 5e-2, "decode_video bf16")
