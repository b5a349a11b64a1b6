"""Port parity for utils/diagnostics.py and the denoise resume: `diag_stats`
gives the reference's [DIAG] line character for character; a
DenoiseCheckpoint file written by either package resumes in the other's
loop; a tiny `generate_video` interrupted and resumed equals its
uninterrupted run, bit for bit; and the port resumed from the reference's
saved state at step k finishes within FRAME_ATOL of the reference's
uninterrupted frames.

Tolerances: the loops over a toy f32 step 1e-6 (the same f32 arithmetic in
both packages); frames 2e-2 absolute on [0, 1], the single-row tolerance of
test_torch_pipeline (the bf16 DiT rounds at other places in the two
frameworks)."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.core import config as jconfig
from ltx_tpu.pipeline import denoise as jdenoise
from ltx_tpu.utils import diagnostics as jdiag
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import GenerationConfig, MemoryConfig
from ltx_tpu_torch.pipeline import denoise as pdenoise
from ltx_tpu_torch.pipeline import generate
from ltx_tpu_torch.pipeline.generate import LTXPipeline
from ltx_tpu_torch.utils import diagnostics as pdiag
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

FRAME_ATOL = 2e-2
SIGMAS = np.asarray([1.0, 0.8, 0.55, 0.3, 0.1, 0.0], np.float32)


class _Stop(Exception):
    pass


def _stop_after(k):
    def on_step(i, n, sigma):
        if i == k:
            raise _Stop
    return on_step


@pytest.mark.parametrize("shape", [(3,), (2, 3, 4)])
def test_diag_stats_line_matches_reference(monkeypatch, caplog, shape):
    monkeypatch.setattr(jdiag, "DIAG_ENABLED", True)
    monkeypatch.setattr(pdiag, "DIAG_ENABLED", True)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jdiag.diag_stats("denoise step 3 latent", jnp.asarray(x))
    with caplog.at_level(logging.INFO, logger="ltx_tpu_torch"):
        got = pdiag.diag_stats("denoise step 3 latent", torch.from_numpy(x))
    assert got == want and got.startswith("[DIAG] denoise step 3 latent: shape=")
    assert want in caplog.text
    monkeypatch.setattr(pdiag, "DIAG_ENABLED", False)
    assert pdiag.diag_stats("x", torch.zeros(3)) is None


def _toy_step(latent, sigma, sigma_next, velocity, has_prev):
    """An Euler-like f32 step both loops can run: the velocity is the
    latent blended with the carried one once there is one."""
    v = latent * 0.5 + (velocity * 0.25 if has_prev else 0.0)
    return latent + (sigma_next - sigma) * v, v


def _port_loop(latent, **kw):
    def step(latent, s, sn, velocity, has_prev, noise):
        return _toy_step(latent, s, sn, velocity, has_prev)
    return pdenoise.run_denoise_loop(step, torch.from_numpy(latent), SIGMAS, **kw).numpy()


def _ref_loop(latent, **kw):
    def step(latent, s, sn, velocity, has_prev, key):
        return _toy_step(latent, s, sn, velocity, has_prev)
    return np.asarray(jdenoise.run_denoise_loop(step, jnp.asarray(latent), SIGMAS, **kw))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_written_by_one_package_resumes_in_the_other(tmp_path, writer):
    latent = np.random.default_rng(1).standard_normal((1, 4, 2, 2, 2)).astype(np.float32)
    full = _port_loop(latent)
    np.testing.assert_allclose(_ref_loop(latent), full, atol=1e-6)
    path = str(tmp_path / "state.pkl")
    write, resume = (_port_loop, _ref_loop) if writer == "port" else (_ref_loop, _port_loop)
    ckpt = (pdiag if writer == "port" else jdiag).DenoiseCheckpoint(path, every_n_steps=1)
    with pytest.raises(_Stop):
        write(latent, on_step=_stop_after(1), checkpoint=ckpt, seed=9)
    state = (jdiag if writer == "port" else pdiag).DenoiseCheckpoint(path).load()
    assert set(state) == {"step", "latent", "velocity", "sigmas", "seed", "extra"}
    assert state["step"] == 1 and state["seed"] == 9
    assert isinstance(state["latent"], np.ndarray) and state["latent"].dtype == np.float32
    other = (jdiag if writer == "port" else pdiag).DenoiseCheckpoint(path, every_n_steps=1)
    np.testing.assert_allclose(resume(latent, checkpoint=other), full, atol=1e-6)


def test_checkpoint_of_other_sigmas_is_ignored(tmp_path):
    latent = np.ones((1, 4, 1, 2, 2), np.float32)
    ckpt = pdiag.DenoiseCheckpoint(str(tmp_path / "s.pkl"), every_n_steps=1)
    ckpt.save(0, torch.zeros(latent.shape), torch.zeros(latent.shape),
              np.asarray([1.0, 0.0], np.float32), seed=1)
    np.testing.assert_array_equal(_port_loop(latent, checkpoint=ckpt), _port_loop(latent))
    ckpt.clear()
    assert ckpt.load() is None


def test_tiny_generate_video_resumes_bit_for_bit(tmp_path):
    """Interrupted after step 2 of the distilled schedule (every_n_steps 1),
    resumed from the file: the uninterrupted frames, the resumed run timing
    only the steps it ran."""
    pipe = LTXPipeline.random_tiny(device="cpu", seed=1,
                                   memory=MemoryConfig(offload_text_encoder=False))
    config = GenerationConfig(width=64, height=64, num_frames=9, seed=4)
    noise = torch.randn(pipe._shape(config).shape, generator=torch.Generator().manual_seed(4))
    full = pipe.generate_video("a fox", config, noise)
    ckpt = pdiag.DenoiseCheckpoint(str(tmp_path / "ckpt.pkl"), every_n_steps=1)
    with pytest.raises(_Stop):
        pipe.generate_video("a fox", config, noise, on_progress=_stop_after(2),
                            checkpoint=ckpt)
    resumed = pipe.generate_video("a fox", config, noise, checkpoint=ckpt)
    np.testing.assert_array_equal(resumed.frames, full.frames)
    assert len(resumed.timings.denoise_steps) == len(full.timings.denoise_steps) - 3


@pytest.fixture(scope="module")
def dit_and_vae():
    """The reference's tiny DiT (bf16) and VAE decoder (f32) trees, jitted
    inits compiled without XLA's backend optimizations, and the port's
    modules converted from them."""
    from ltx_tpu.models import dit as jdit
    from ltx_tpu.models import vae as jvae

    tcfg, vcfg, _, _ = generate.tiny_configs()
    jt = convert.port_config(tcfg, jconfig.TransformerConfig)
    jv = convert.port_config(vcfg, jvae.VAEConfig)
    k1, k2 = jax.random.split(jax.random.key(7))
    fast = {"xla_backend_optimization_level": 0}  # a tenth of the compile
    tp = jax.jit(lambda k: jdit.init_params(k, jt, jnp.bfloat16)).lower(k1).compile(
        compiler_options=fast)(k1)
    vp = jax.jit(jvae.init_decoder_params, static_argnums=1).lower(k2, jv).compile(
        compiler_options=fast)(k2)
    return (jt, tp, jv, vp), (convert.transformer(tp, tcfg), convert.vae_decoder(vp, vcfg))


def test_resume_from_the_reference_state_matches_its_frames(dit_and_vae, tmp_path):
    """The reference's generate_video (precomputed text rows, injected
    noise) stopped after step k = 3 of 8; the port resumes from the
    reference's file and lands within FRAME_ATOL of the reference's
    uninterrupted frames."""
    from ltx_tpu.pipeline.generate import LTXPipeline as JaxPipeline

    (jt, tp, jv, vp), (transformer, decoder) = dit_and_vae
    ref = JaxPipeline(transformer_params=tp, transformer_config=jt, vae_decoder_params=vp,
                      vae_config=jv)
    port = LTXPipeline(transformer=transformer, vae_decoder=decoder, device="cpu")
    config = GenerationConfig(width=64, height=64, num_frames=9, seed=2)
    rng = np.random.default_rng(3)
    noise = rng.standard_normal(port._shape(config).shape).astype(np.float32)
    rows = rng.standard_normal((1, 16, port.tcfg.caption_channels)).astype(np.float32)
    mask = np.ones((1, 16), np.int32)
    mask[:, :5] = 0
    jemb = {"video": jnp.asarray(rows, jnp.bfloat16), "mask": jnp.asarray(mask)}
    pemb = {"video": torch.from_numpy(rows).to(torch.bfloat16), "mask": torch.from_numpy(mask)}
    jcfg = convert.port_config(config, jconfig.GenerationConfig)

    want = ref.generate_video("x", jcfg, precomputed_embeddings=jemb, initial_noise=noise)
    path = str(tmp_path / "ref.pkl")
    with pytest.raises(_Stop):
        ref.generate_video("x", jcfg, precomputed_embeddings=jemb, initial_noise=noise,
                           on_progress=_stop_after(3),
                           checkpoint=jdiag.DenoiseCheckpoint(path, every_n_steps=1))
    got = port.generate_video("x", config, torch.from_numpy(noise),
                              precomputed_embeddings=pemb,
                              checkpoint=pdiag.DenoiseCheckpoint(path, every_n_steps=0))
    assert len(got.timings.denoise_steps) == len(want.timings.denoise_steps) - 4
    frames, wf = got.frames, np.asarray(want.frames, np.float32)
    err = float(np.abs(frames - wf).max())
    print(f"[parity] resumed from the reference's step 3: max abs {err:.3e} "
          f"(tol {FRAME_ATOL:.0e})")
    assert frames.shape == wf.shape and err <= FRAME_ATOL
    # and uninterrupted, the port stays as close
    full = port.generate_video("x", config, torch.from_numpy(noise), precomputed_embeddings=pemb)
    assert float(np.abs(full.frames - wf).max()) <= FRAME_ATOL
