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


# ---------------------------------------------------------------------------
# The encoder, and the temporally tiled decode
# ---------------------------------------------------------------------------

_init_encoder = jax.jit(jvae.init_encoder_params, static_argnums=(1, 2))
_encode = jax.jit(jvae.encoder_forward, static_argnums=2)


def _encoder_tree(dtype):
    tree = jax.tree.map(np.asarray, _init_encoder(jax.random.key(11), CFG, dtype))
    rng = np.random.default_rng(12)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(-0.5, 0.5, a.shape).astype(a.dtype)
                         if jax.tree_util.keystr(path).endswith("['b']") else a), tree)


@pytest.mark.parametrize("frames", [1, 9, 12], ids=lambda f: f"{f}f")
def test_encoder_forward_f32(frames):
    """One image (the I2V conditioning), a clip of 8n+1 frames, and a frame
    count that space-to-depth has to pad; causal in time, zero padding in
    space."""
    tree = _encoder_tree(jnp.float32)
    px = np.random.default_rng(13).uniform(-1, 1, (1, 3, frames, 64, 96)).astype(np.float32)
    want = _encode(jax.tree.map(jnp.asarray, tree), jnp.asarray(px), CFG)
    encoder = convert.vae_encoder(tree, CFG)
    got = encoder(torch.from_numpy(px))
    assert got.shape == want.shape and got.shape[1] == CFG.latent_channels
    assert_rel(got, want, 1e-5, f"encoder_forward float32 {frames} frames")


def test_encoder_forward_bf16_and_patchify():
    tree = _encoder_tree(jnp.bfloat16)
    px = np.random.default_rng(14).uniform(-1, 1, (1, 3, 9, 64, 64)).astype(np.float32)
    px = np.asarray(jnp.asarray(px, jnp.bfloat16), np.float32)
    want = _encode(jax.tree.map(jnp.asarray, tree), jnp.asarray(px, jnp.bfloat16), CFG)
    tree32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    exact = _encode(jax.tree.map(jnp.asarray, tree32), jnp.asarray(px), CFG)
    got = convert.vae_encoder(tree, CFG)(as_torch(px, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_rel(got, exact, 1.5 * rel_err(want, exact), "encoder_forward bf16 vs f32 reference")
    assert_rel(got, want, 5e-2, "encoder_forward bf16")
    # the patchify's channel order (c, pw, ph) and space_to_depth's (c, ft, fh, fw)
    x = np.arange(3 * 2 * 8 * 12, dtype=np.float32).reshape(1, 3, 2, 8, 12)
    want_p = jvae.encoder_patchify(jnp.asarray(x).transpose(0, 2, 3, 4, 1), 4)
    np.testing.assert_array_equal(vae.encoder_patchify(torch.from_numpy(x), 4).numpy(),
                                  np.asarray(want_p).transpose(0, 4, 1, 2, 3))
    y = np.arange(2 * 3 * 4 * 6, dtype=np.float32).reshape(1, 2, 3, 4, 6)
    want_s = jvae.space_to_depth(jnp.asarray(y).transpose(0, 2, 3, 4, 1), (2, 2, 2))
    np.testing.assert_array_equal(
        vae.space_to_depth(torch.from_numpy(y), (2, 2, 2)).numpy(),
        np.asarray(want_s).transpose(0, 4, 1, 2, 3))


TILINGS = [(3, 1), (4, 2), (3, 2), (5, 3)]


@pytest.mark.parametrize("tile,overlap", TILINGS, ids=lambda v: str(v))
@pytest.mark.parametrize("uint8", [False, True], ids=["f32", "uint8"])
def test_tiled_decode_matches_reference(tile, overlap, uint8):
    """Frame-aligned temporal tiling against the reference's, 7 latent
    frames (a ragged last tile): exactly 8 * (F - 1) + 1 frames. f32 tiles
    within the decoder's 1e-5; uint8 tiles may round a value on a .5
    boundary the other way: one step of 1/255."""
    tree = _tree(jnp.float32)
    latent = np.random.default_rng(15).standard_normal(
        (1, CFG.latent_channels, 7, 2, 2)).astype(np.float32)
    want = np.asarray(jvae.decode_video(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(latent), CFG, timestep=None,
        tile_size=tile, tile_overlap=overlap, transfer_uint8=uint8))
    decoder = convert.vae_decoder(tree, CFG)
    got = vae.decode_video(decoder, torch.from_numpy(latent), None, None, tile, overlap,
                           uint8)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (49, 64, 64, 3)
    err = float(np.abs(got - want).max())
    print(f"[parity] tiled decode tile {tile} overlap {overlap} uint8={uint8}: {err:.3e}")
    assert err <= (1.0 / 255 + 1e-6 if uint8 else 1e-5)
    if uint8:
        assert np.mean(got != want) < 1e-3
        np.testing.assert_array_equal(got * 255, np.round(got * 255))
    frames = vae.tile_latent_frames(7, tile, overlap)
    assert frames[0] == tile and 0 < frames[-1] <= tile


def test_tiled_decode_against_untiled_and_per_tile_noise():
    """A tile that holds the whole clip is the untiled decode, bit for bit;
    shorter tiles give the same frame count (the decoder is not causal, so
    their values differ from the untiled ones); with timestep conditioning
    each tile takes its own noise tensor, the reference's fold_in(key, tile)
    draw."""
    tree = _tree(jnp.float32)
    latent = np.random.default_rng(16).standard_normal(
        (1, CFG.latent_channels, 5, 2, 2)).astype(np.float32)
    decoder = convert.vae_decoder(tree, COND_CFG)
    lt = torch.from_numpy(latent)
    untiled = vae.decode_video(decoder, lt, None, None).numpy()
    one_tile = vae.decode_video(decoder, lt, None, None, tile_size=5, tile_overlap=1)
    assert torch.is_tensor(one_tile) and one_tile.shape == (33, 64, 64, 3)
    np.testing.assert_array_equal(one_tile.numpy(), untiled)
    tiled = vae.decode_video(decoder, lt, None, None, tile_size=3, tile_overlap=1)
    assert tiled.shape == untiled.shape
    assert np.isfinite(tiled).all() and tiled.min() >= 0 and tiled.max() <= 1
    assert float(np.abs(tiled - untiled).mean()) < 0.25

    key = jax.random.key(17)
    starts = (0, 2)
    noises = []
    for i, s in enumerate(starts):
        n = jax.random.normal(jax.random.fold_in(key, i), (1, 3, 2, 2, CFG.latent_channels))
        noises.append(torch.from_numpy(np.asarray(n).copy()).permute(0, 4, 1, 2, 3))
    want = np.asarray(jvae.decode_video(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(latent), COND_CFG, timestep=0.05,
        noise_key=key, tile_size=3, tile_overlap=1))
    got = vae.decode_video(decoder, lt, 0.05, noises, tile_size=3, tile_overlap=1)
    assert_rel(got, want, 1e-5, "tiled decode with per-tile noise")
    with pytest.raises(ValueError, match="one noise tensor per tile"):
        vae.decode_video(decoder, lt, 0.05, noises[0], tile_size=3, tile_overlap=1)
    with pytest.raises(ValueError, match="must be <"):
        vae.decode_video(decoder, lt, None, None, tile_size=2, tile_overlap=2)
    with pytest.raises(NotImplementedError, match="A4b"):
        vae.decode_video(decoder, lt, None, None, tile_size=3, transfer_uint8="yuv420")
