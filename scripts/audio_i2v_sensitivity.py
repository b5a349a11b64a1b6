"""How sensitive is the audio I2V parity comparison, and where do the two
packages part? (CPU only; the JAX package is the reference.)

    python scripts/audio_i2v_sensitivity.py

Runs tests/test_torch_audio_pipeline.py::test_i2v_with_audio_matches_live_reference's
case (64x64, 9 frames, seed 11, image_cond_noise_scale 0.15, the distilled
8-step schedule) on `torch_parity.reference_and_port(include_audio=True)`
with torch on one thread, as the test runs, and prints:

* the port's frames against the reference's (the test's number);
* each denoise step's video and audio latent after the step, port against
  reference, and the port's step run on the reference's own input of that
  step (its local error, and that error over |sigma_next - sigma|: the
  velocity's);
* the reference against itself after its f32 trees (VAE, audio VAE,
  vocoder, upscaler) move by one or two f32 ulps, at most 6e-8: its frames,
  waveform and each step's latents;
* the port against itself under the same move.
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import ltx_tpu.pipeline.denoise as jden  # noqa: E402
import ltx_tpu_torch.pipeline.generate as pgen  # noqa: E402
from ltx_tpu.core import config as jconfig  # noqa: E402
from ltx_tpu.ops.latents import VideoLatentShape as JShape  # noqa: E402
from ltx_tpu_torch import convert  # noqa: E402
from ltx_tpu_torch.config import GenerationConfig  # noqa: E402
from torch_parity import jax_normal, loop_draws, reference_and_port  # noqa: E402

CONFIG = GenerationConfig(width=64, height=64, num_frames=9, num_steps=3, seed=11,
                          image_cond_noise_scale=0.15)
PROMPT = "an image sings"
PIXELS = np.random.default_rng(0).uniform(-1, 1, (1, 3, 1, 64, 64)).astype(np.float32)
F32_TREES = ("vae_decoder_params", "vae_encoder_params", "audio_vae_params",
             "vocoder_params", "upscaler_params")


def gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def port_draws(port, cond_shape):
    """The reference's draws from CONFIG.seed, as the test takes them."""
    key = jax.random.key(CONFIG.seed)
    key, vkey, akey, dkey = jax.random.split(key, 4)
    shape = JShape.from_pixels(1, CONFIG.num_frames, CONFIG.height, CONFIG.width,
                               channels=port.tcfg.in_channels)
    steps = len(port._sigmas(CONFIG, shape)) - 1
    return dict(initial_noise=jax_normal(vkey, shape.shape),
                audio_noise=jax_normal(akey, port.audio_noise_shape(CONFIG)),
                cond_noise=loop_draws(dkey, steps, cond_shape))


def recording_steps(log: dict):
    """Wrap both packages' make_av_denoise_step so that every step's inputs
    and outputs land in log["ref"] / log["port"] (and the port's step
    functions with their draws in log["port_steps"])."""
    ref_make, port_make = jden.make_av_denoise_step, pgen.make_av_denoise_step

    def ref_wrapper(*a, **k):
        step = ref_make(*a, **k)

        def wrapped(v, au, s, sn, key):
            vin, ain = np.array(v), np.array(au)
            nv, na = step(jnp.array(vin), jnp.array(ain), s, sn, key)
            log.setdefault("ref", []).append((vin, ain, np.array(nv), np.array(na)))
            return nv, na

        wrapped._jit, wrapped._ropes = step._jit, step._ropes
        return wrapped

    def port_wrapper(*a, **k):
        step = port_make(*a, **k)

        def wrapped(v, au, s, sn, cn=None, acn=None):
            vin, ain = v.clone(), au.clone()
            nv, na = step(v, au, s, sn, cn, acn)
            log.setdefault("port", []).append(
                tuple(t.float().numpy() for t in (vin, ain, nv, na)))
            log.setdefault("port_steps", []).append((step, cn))
            return nv, na

        for attr in ("needs_noise", "needs_audio_noise"):
            if hasattr(step, attr):
                setattr(wrapped, attr, getattr(step, attr))
        return wrapped

    jden.make_av_denoise_step, pgen.make_av_denoise_step = ref_wrapper, port_wrapper


def run_ref(ref):
    latent = ref.encode_image(jnp.asarray(PIXELS))
    jcfg = convert.port_config(CONFIG, jconfig.GenerationConfig)
    return np.array(latent), ref.generate_video_with_audio(PROMPT, jcfg, image_latent=latent)


def run_port(port):
    latent = port.encode_image(PIXELS)
    return latent.numpy(), port.generate_video_with_audio(
        PROMPT, CONFIG, image_latent=latent, **port_draws(port, tuple(latent.shape)))


def move_f32_trees(ref, rng) -> dict:
    """Each f32 leaf of the reference's F32_TREES moved by -1, 0 or +1 ulp,
    clipped to 3e-8; returns the largest move per tree."""
    moved = {}
    for name in F32_TREES:
        tree = getattr(ref, name)
        if tree is None:
            continue

        def move(x):
            x = np.asarray(x)
            if x.dtype != np.float32:
                return jnp.asarray(x)
            step = rng.integers(-1, 2, x.shape).astype(np.float32) * np.spacing(np.abs(x))
            return jnp.asarray(x + np.clip(step, -3e-8, 3e-8))

        new = jax.tree.map(move, tree)
        moved[name] = max(gap(a, b) for a, b in zip(jax.tree.leaves(new), jax.tree.leaves(tree)))
        setattr(ref, name, new)
    return moved


def main() -> None:
    torch.set_num_threads(1)
    log = {}
    recording_steps(log)
    ref, port = reference_and_port(include_audio=True)

    ref_latent, r0 = run_ref(ref)
    port_latent, p0 = run_port(port)
    print(f"port vs reference: frames {gap(p0.frames, r0.frames):.3e}, waveform "
          f"{gap(p0.audio, r0.audio):.3e}, image latent {gap(port_latent, ref_latent):.3e}")
    shape = JShape.from_pixels(1, CONFIG.num_frames, CONFIG.height, CONFIG.width,
                               channels=port.tcfg.in_channels)
    sigmas = port._sigmas(CONFIG, shape)
    for i, ((jv, ja, jnv, jna), (_, _, pnv, pna), (step, cn)) in enumerate(
            zip(log["ref"], log["port"], log["port_steps"])):
        lv, la = step(torch.from_numpy(jv.copy()), torch.from_numpy(ja.copy()),
                      float(sigmas[i]), float(sigmas[i + 1]), cn, None)
        dt = abs(float(sigmas[i + 1]) - float(sigmas[i]))
        local = gap(lv.numpy(), jnv)
        print(f"  step {i} (sigma {sigmas[i]:.4f}, dt {dt:.4f}): after the step video "
              f"{gap(pnv, jnv):.3e}, audio {gap(pna, jna):.3e}; the port's step on the "
              f"reference's input: video {local:.3e} (velocity {local / dt:.3e}), audio "
              f"{gap(la.numpy(), jna):.3e}; |reference latent| {np.abs(jnv).max():.2f}")
    ref_steps = log.pop("ref")
    log.pop("port"), log.pop("port_steps")

    moved = move_f32_trees(ref, np.random.default_rng(123))
    print("the reference's f32 trees moved by at most " +
          ", ".join(f"{k} {v:.1e}" for k, v in moved.items()))
    _, r1 = run_ref(ref)
    print(f"reference vs itself, moved: frames {gap(r1.frames, r0.frames):.3e} (mean "
          f"{float(np.abs(r1.frames - r0.frames).mean()):.3e}), waveform "
          f"{gap(r1.audio, r0.audio):.3e}")
    for i, ((_, _, a0, b0), (_, _, a1, b1)) in enumerate(zip(ref_steps, log.pop("ref"))):
        print(f"  reference step {i}: video {gap(a1, a0):.3e}, audio {gap(b1, b0):.3e}")
    port.vae_decoder = convert.vae_decoder(ref.vae_decoder_params, port.vcfg)
    port.vae_encoder = convert.vae_encoder(ref.vae_encoder_params, port.vcfg)
    _, p1 = run_port(port)
    print(f"port vs itself, moved: frames {gap(p1.frames, p0.frames):.3e}; port vs "
          f"reference, both moved: frames {gap(p1.frames, r1.frames):.3e}")


if __name__ == "__main__":
    main()
