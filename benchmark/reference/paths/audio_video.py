"""The audio-video pipeline's reference: prompt and noises -> frames and a
waveform. T2V with sound, one guidance row: the text and both connectors,
8 Euler steps of the dual DiT (the plain audio Euler beside the video's),
the tiled VAE decode, the audio VAE and the vocoder
(benchmark.reference.pipeline's steps)."""

from __future__ import annotations

import torch

from benchmark.reference import decoders, dit
from benchmark.reference import pipeline as steps


def clip_shapes(config: dict, traffic: dict) -> dict:
    """The draws of one clip: the video latent noise (1, C, F', H', W') and
    the raw audio latent (1, 8, T_a, mel latent bins)."""
    t, a = config["transformer"], config["audio_vae"]
    return {"noise": steps.video_latent_shape(config, traffic),
            "audio_noise": (1, a["latent_channels"],
                            steps.audio_frame_count(traffic["frames"], traffic["fps"]),
                            t["audio_in_channels"] // a["latent_channels"])}


def build(config: dict, weights: dict, precision: str = "f32") -> dict:
    """The reference's modules for `config`, holding `weights`, in `precision`."""
    modules = steps.text_and_decoder(config, include_audio=True)
    modules["av_transformer"] = dit.AVDiT(steps.transformer_dims(config["transformer"]))
    modules["audio_vae"] = decoders.AudioVAE(config["audio_vae"])
    modules["vocoder"] = decoders.Vocoder(config["vocoder"])
    return steps.hold(modules, weights, precision)


@torch.inference_mode()
def generate(modules: dict, config: dict, traffic: dict, clip: dict) -> dict:
    """{"frames": (F, H, W, 3) float32 in [0, 1], "audio": (2, samples)} on
    the host, for `clip` (its prompt, noise and audio noise)."""
    with steps.full_f32():
        noise, audio_noise = clip["noise"], clip["audio_noise"]
        enc, bias = steps.encode_text(modules, config, clip["prompt"], noise.device)
        latent, sigmas = steps.initial_latent(noise)
        audio = audio_noise.float().transpose(1, 2).reshape(1, audio_noise.shape[2], -1) \
            * float(sigmas[0])
        latent, audio = steps.denoise_av(modules["av_transformer"],
                                         steps.transformer_dims(config["transformer"]),
                                         latent, audio, enc, bias, sigmas, traffic["fps"])
        frames = steps.decode(modules, config, latent, traffic["frames"])
        wave = modules["vocoder"](modules["audio_vae"](audio))[0].cpu().numpy()
        return {"frames": frames, "audio": wave}
