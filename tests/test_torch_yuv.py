"""Port parity: the tiled decode's yuv420 transfer (ltx_tpu_torch.models.vae:
`rgb_to_yuv420_u8`, `yuv420_to_rgb_np`, the packed-frame stitch) against
ltx_tpu.models.vae, and the pipeline with `decode_transfer="yuv420"`.

Tolerances: the packed I420 planes bit for bit the reference's from the
same f32 frames, and the host inverse equal; the round trip of a flat
field within the reference's 3e-2; the tiled yuv420 decode's luma within
the reference's bounds of the exact f32 tiled decode (mean 5e-3, max 0.15:
Y travels at full resolution, chroma is 2x2-averaged).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.models import vae as jvae
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import GenerationConfig, MemoryConfig
from ltx_tpu_torch.models import vae as pvae
from ltx_tpu_torch.models.common import init_random_
from ltx_tpu_torch.pipeline.generate import LTXPipeline
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CFG = jvae.VAEConfig().tiny()


def _luma(x):
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


@pytest.mark.parametrize("shape", [(1, 3, 2, 8, 8), (2, 3, 3, 8, 12)])
def test_packed_planes_bit_for_bit(shape):
    """Frames past [-1, 1] too (the clip), from the same f32 values."""
    px = np.random.default_rng(0).uniform(-1.3, 1.3, shape).astype(np.float32)
    want = np.asarray(jax.jit(jvae._rgb_to_yuv420_u8)(jnp.asarray(px)))
    got = pvae.rgb_to_yuv420_u8(torch.from_numpy(px))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pvae.yuv420_to_rgb_np(want), jvae._yuv420_to_rgb_np(want))


def test_flat_field_round_trip():
    flat = torch.ones(1, 3, 2, 8, 8) * torch.tensor([0.2, -0.4, 0.6]).reshape(1, 3, 1, 1, 1)
    packed = pvae.rgb_to_yuv420_u8(flat)
    assert tuple(packed.shape) == (1, 2, 12, 8)  # I420: 3H/2 rows, one tensor
    rgb = pvae.yuv420_to_rgb_np(packed.numpy())
    np.testing.assert_allclose(rgb, np.clip((flat.numpy() + 1.0) / 2.0, 0, 1), atol=3e-2)


@pytest.mark.parametrize("overlap", [1, 2])
def test_tiled_yuv420_decode(overlap):
    """The tiled yuv420 decode against the exact f32 tiled decode of the
    same decoder (the reference's test: a seeded tiny decoder, 7 latent
    frames in tiles of 3, overlap 1) within the reference's luma bounds;
    at overlap 2 (a blended seam of 8 frames, which the reference's test
    does not bound) the luma error is printed; at both, the stitch of the
    packed tiles bit for bit the reference's `_stitch_tiled_yuv`."""
    dec = init_random_(pvae.VideoDecoder(convert.port_config(CFG, pvae.VAEConfig)),
                       torch.Generator().manual_seed(0))
    lat = torch.randn(1, CFG.latent_channels, 7, 4, 4, generator=torch.Generator().manual_seed(1))
    kw = dict(timestep=None, tile_size=3, tile_overlap=overlap)
    exact = pvae.decode_video(dec, lat, **kw)
    yuv = pvae.decode_video(dec, lat, transfer_uint8="yuv420", **kw)
    assert yuv.shape == exact.shape == (49, 128, 128, 3)
    assert yuv.dtype == np.float32 and np.isfinite(yuv).all()
    assert yuv.min() >= 0 and yuv.max() <= 1
    lerr = np.abs(_luma(yuv) - _luma(exact))
    print(f"[parity] yuv420 tiled decode (overlap {overlap}) luma vs f32: mean "
          f"{lerr.mean():.3e}, max {lerr.max():.3e} (tol 5e-3, 0.15 at overlap 1)")
    if overlap == 1:
        assert lerr.mean() < 5e-3 and lerr.max() < 0.15
    packed = []
    launch = lambda i: (lambda: packed[i])  # noqa: E731
    starts = pvae._tile_starts(7, 3, 3 - overlap)
    for s in starts:
        packed.append(pvae.rgb_to_yuv420_u8(dec(lat[:, :, s:s + 3], None, None)).numpy())
    stitched = pvae._stitch_tiled_yuv(launch, starts, 7, 8 * (overlap - 1))
    np.testing.assert_array_equal(stitched, yuv)
    want = jvae._stitch_tiled_yuv(lambda i: jnp.asarray(packed[i]), starts, 7,
                                  8 * (overlap - 1))
    np.testing.assert_array_equal(stitched, np.asarray(want))


def test_pipeline_decode_transfer_yuv420_untiled_and_tiled():
    """`memory.decode_transfer="yuv420"` runs: untiled it decodes exact
    frames (as the reference's untiled decode), tiled through the packed
    transfer, within the luma bound of the uint8 tiled run."""
    config = GenerationConfig(width=64, height=64, num_frames=25, num_steps=2, seed=3)
    noise = torch.randn(1, 16, 4, 2, 2, generator=torch.Generator().manual_seed(0))
    frames = {}
    for name, memory in (("untiled", MemoryConfig(decode_transfer="yuv420")),
                         ("uint8", MemoryConfig(vae_tile_size=2)),
                         ("yuv420", MemoryConfig(vae_tile_size=2, decode_transfer="yuv420"))):
        pipe = LTXPipeline.random_tiny(device="cpu", seed=1, memory=memory)
        frames[name] = pipe.generate_video("yuv", config, noise).frames
        assert frames[name].shape == (25, 64, 64, 3) and np.isfinite(frames[name]).all()
        assert frames[name].min() >= 0.0 and frames[name].max() <= 1.0
    exact = LTXPipeline.random_tiny(device="cpu", seed=1).generate_video(
        "yuv", config, noise).frames
    np.testing.assert_array_equal(frames["untiled"], exact)
    lerr = np.abs(_luma(frames["yuv420"]) - _luma(frames["uint8"]))
    assert lerr.mean() < 5e-3 and lerr.max() < 0.15
