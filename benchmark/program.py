"""What every pipeline's program side shares: the port's components resident
on the device, the generation settings, a clip's phases, the port's launch
counters and its kernels' build. Each pipeline's own calls are in its file
under `benchmark/paths/`.

The components are resident on the device, as a server keeps them: no
phase staging, the text encoder kept, the decode tiled in time as the
configuration says with uint8 transfers, the byte tokens of the pipeline's
own tokenizer-less path. Everything here imports the port, and nothing else
of the repository.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.weights import assign


def tuples(d: dict) -> dict:
    """A configuration group with its lists as tuples, as the port's configs take them."""
    return {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
            if isinstance(v, list) else v for k, v in d.items()}


def text_and_decoder(config: dict, include_audio: bool) -> dict:
    """Gemma, the text encoder (with the audio connector when
    `include_audio`) and the VAE decoder of `config`, built on "meta" (no
    memory), in this order: the weights are drawn in the inventory's order."""
    from ltx_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model
    from ltx_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
    from ltx_tpu_torch.models.vae import VAEConfig, VideoDecoder

    dtype = getattr(torch, config["dtype"])
    return {
        "gemma": Gemma3Model(Gemma3Config(**config["gemma"]), "meta", dtype),
        "text_encoder": TextEncoder(TextEncoderConfig(**tuples(config["text_encoder"])),
                                    "meta", dtype, include_audio=include_audio),
        "vae_decoder": VideoDecoder(VAEConfig(**tuples(config["vae"])), "meta", dtype),
    }


def resident_pipeline(config: dict, modules: dict, weights: dict, device):
    """The LTXPipeline over `modules` holding `weights`, resident on
    `device`; each module is passed as the pipeline's argument of its name."""
    from ltx_tpu_torch.config import MemoryConfig
    from ltx_tpu_torch.pipeline.generate import LTXPipeline

    for name, module in modules.items():
        assign(module, weights[name])
    memory = MemoryConfig(vae_tile_size=config["decode"]["tile"],
                          vae_tile_overlap=config["decode"]["overlap"],
                          decode_transfer="uint8", offload_text_encoder=False,
                          phase_staging=False)
    return LTXPipeline(**{"transformer": None, **modules}, tokenizer=None, memory=memory,
                       is_distilled=True, device=device)


def generation_config(traffic):
    """One clip's GenerationConfig from the traffic's size, steps, guidance and fps."""
    from ltx_tpu_torch.config import GenerationConfig

    return GenerationConfig(width=traffic["width"], height=traffic["height"],
                            num_frames=traffic["frames"], num_steps=traffic["steps"],
                            cfg_scale=traffic["cfg_scale"], fps=traffic["fps"], seed=0)


def phase_seconds(timings) -> dict:
    """A clip's GenerationTimings as {phase: seconds}."""
    t = dataclasses.asdict(timings)
    return {"total": t["total"], "text": t["gemma"] + t["connector"],
            "steps": list(t["denoise_steps"]), "decode": t["vae_decode"] + t["audio_decode"],
            "other_phases": t["staging"] + t["enhancement"] + t["image_encode"] + t["upscale"]}


def reset_counters() -> None:
    from ltx_tpu_torch.kernels import flash_attention, quantization, rms_norm, rope
    from ltx_tpu_torch.ops import normalization

    flash_attention.flash_attention.launches = 0
    flash_attention.flash_attention.launches_by_head_dim = {}
    rms_norm.rms_norm.launches = 0
    normalization.rms_chain_on_cuda = 0
    quantization.int4_matmul.launches = 0
    quantization.dequant_int4.launches = 0
    rope.rope_tables.launches = 0


def read_counters() -> dict:
    """The port's launch counters since `reset_counters`."""
    from ltx_tpu_torch.kernels import flash_attention, quantization, rms_norm, rope
    from ltx_tpu_torch.ops import normalization

    return {"flash_attention": flash_attention.flash_attention.launches,
            "flash_attention_by_head_dim": dict(
                flash_attention.flash_attention.launches_by_head_dim),
            "rms_norm": rms_norm.rms_norm.launches,
            "rms_chain_on_cuda": normalization.rms_chain_on_cuda,
            "int4_matmul": quantization.int4_matmul.launches,
            "dequant_int4": quantization.dequant_int4.launches,
            "rope_tables": rope.rope_tables.launches}


def build_kernels() -> dict:
    """Build (or find built) every CUDA kernel of the port: seconds each."""
    from ltx_tpu_torch.kernels import build

    return build.build_all()
