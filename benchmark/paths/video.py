"""The video pipeline's program side: LTX-2's distilled text-to-video,
`LTXPipeline.generate_video`, one guidance row, the DiT on the video
tokens. Imports the port only inside functions."""

from __future__ import annotations

import torch

from benchmark import flops, program
from benchmark.reference.pipeline import transformer_dims, video_tokens


def meta_modules(config: dict) -> dict:
    """The port's components of `config`, built on "meta" (no memory)."""
    from ltx_tpu_torch.config import TransformerConfig
    from ltx_tpu_torch.models.dit import LTXTransformer

    modules = program.text_and_decoder(config, include_audio=False)
    modules["transformer"] = LTXTransformer(
        TransformerConfig(**program.tuples(config["transformer"])), "meta",
        getattr(torch, config["dtype"]))
    return modules


build_pipeline = program.resident_pipeline
generation_config = program.generation_config


def run_clip(pipe, gen_config, clip: dict, on_progress=None):
    """One clip through the pipeline: (frames, None, GenerationTimings),
    frames on the host. on_progress(i, n, sigma) runs after each denoise
    step, once the device has finished it."""
    result = pipe.generate_video(clip["prompt"], gen_config, clip["noise"],
                                 on_progress=on_progress)
    return result.frames, result.audio, result.timings


def clip_work(config: dict, traffic) -> dict:
    """One clip's counted work (benchmark.flops.clip_work): the DiT's blocks
    on the video tokens each step, and the connector once."""
    t = transformer_dims(config["transformer"])
    te = config["text_encoder"]
    s, steps, layers = te["max_length"], traffic["steps"], t["num_layers"]
    block_flops, attns, norms = flops._video_block(t, video_tokens(traffic), s)
    c_attns, c_norms = flops._connector(te, s)
    return flops.work(block_flops * layers, steps,
                      attns * (layers * steps) + c_attns, norms * (layers * steps) + c_norms,
                      rope_tables=1)
