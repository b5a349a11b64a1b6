"""The video pipeline's reference: prompt and noise -> frames. T2V with one
guidance row: the text, 8 Euler steps of the DiT, the tiled VAE decode
(benchmark.reference.pipeline's steps)."""

from __future__ import annotations

import torch

from benchmark.reference import dit
from benchmark.reference import pipeline as steps


def clip_shapes(config: dict, traffic: dict) -> dict:
    """The draws of one clip: the video latent noise (1, C, F', H', W')."""
    return {"noise": steps.video_latent_shape(config, traffic)}


def build(config: dict, weights: dict, precision: str = "f32") -> dict:
    """The reference's modules for `config`, holding `weights`, in `precision`."""
    modules = steps.text_and_decoder(config, include_audio=False)
    modules["transformer"] = dit.VideoDiT(steps.transformer_dims(config["transformer"]))
    return steps.hold(modules, weights, precision)


@torch.inference_mode()
def generate(modules: dict, config: dict, traffic: dict, clip: dict) -> dict:
    """{"frames": (F, H, W, 3) float32 in [0, 1], "audio": None} on the
    host, for `clip` (its prompt and noise)."""
    with steps.full_f32():
        noise = clip["noise"]
        enc, bias = steps.encode_text(modules, config, clip["prompt"], noise.device)
        latent, sigmas = steps.initial_latent(noise)
        latent = steps.denoise_video(modules["transformer"],
                                     steps.transformer_dims(config["transformer"]), latent,
                                     enc["video"], bias, sigmas, traffic["fps"])
        return {"frames": steps.decode(modules, config, latent, traffic["frames"]),
                "audio": None}
