"""The audio-video pipeline's program side: LTX-2's distilled joint
text-to-video-with-sound, `LTXPipeline.generate_video_with_audio`, one
guidance row, the dual DiT on the video and audio tokens, the audio VAE and
the vocoder. Imports the port only inside functions."""

from __future__ import annotations

import torch

from benchmark import flops, program
from benchmark.reference.pipeline import audio_frame_count, transformer_dims, video_tokens


def meta_modules(config: dict) -> dict:
    """The port's components of `config`, built on "meta" (no memory)."""
    from ltx_tpu_torch.config import AudioVAEConfig, TransformerConfig, VocoderConfig
    from ltx_tpu_torch.models.audio_vae import AudioVAE, Vocoder
    from ltx_tpu_torch.models.dit_av import LTXAVTransformer

    modules = program.text_and_decoder(config, include_audio=True)
    modules["av_transformer"] = LTXAVTransformer(
        TransformerConfig(**program.tuples(config["transformer"])), "meta",
        getattr(torch, config["dtype"]))
    modules["audio_vae"] = AudioVAE(AudioVAEConfig(**program.tuples(config["audio_vae"])),
                                    "meta")
    modules["vocoder"] = Vocoder(VocoderConfig(**program.tuples(config["vocoder"])), "meta")
    return modules


build_pipeline = program.resident_pipeline
generation_config = program.generation_config


def run_clip(pipe, gen_config, clip: dict, on_progress=None):
    """One clip through the pipeline: (frames, audio, GenerationTimings),
    both on the host. on_progress(i, n, sigma) runs after each denoise
    step, once the device has finished it."""
    result = pipe.generate_video_with_audio(clip["prompt"], gen_config, clip["noise"],
                                            clip["audio_noise"], on_progress=on_progress)
    return result.frames, result.audio, result.timings


def clip_work(config: dict, traffic) -> dict:
    """One clip's counted work (benchmark.flops.clip_work): the dual DiT's
    blocks on the video and audio tokens each step, and both connectors."""
    t = transformer_dims(config["transformer"])
    te = config["text_encoder"]
    s, steps, layers = te["max_length"], traffic["steps"], t["num_layers"]
    ta = audio_frame_count(traffic["frames"], traffic["fps"])
    block_flops, attns, norms = flops._av_block(t, video_tokens(traffic), ta, s)
    c_attns, c_norms = flops._connector(te, s)
    return flops.work(block_flops * layers, steps,
                      attns * (layers * steps) + c_attns * 2,
                      norms * (layers * steps) + c_norms * 2, rope_tables=4)
