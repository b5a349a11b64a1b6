"""The system under test: the port's LTXPipeline, built from the benchmark's
weights, and the port's launch counters.

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


def _tuples(d: dict) -> dict:
    return {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
            if isinstance(v, list) else v for k, v in d.items()}


def meta_modules(config: dict) -> dict:
    """The port's components of `config`, built on "meta" (no memory)."""
    from ltx_tpu_torch.config import AudioVAEConfig, TransformerConfig, VocoderConfig
    from ltx_tpu_torch.models.audio_vae import AudioVAE, Vocoder
    from ltx_tpu_torch.models.dit import LTXTransformer
    from ltx_tpu_torch.models.dit_av import LTXAVTransformer
    from ltx_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model
    from ltx_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
    from ltx_tpu_torch.models.vae import VAEConfig, VideoDecoder

    dtype = getattr(torch, config["dtype"])
    audio = config["pipeline"] == "audio_video"
    tcfg = TransformerConfig(**_tuples(config["transformer"]))
    modules = {
        "gemma": Gemma3Model(Gemma3Config(**config["gemma"]), "meta", dtype),
        "text_encoder": TextEncoder(TextEncoderConfig(**_tuples(config["text_encoder"])),
                                    "meta", dtype, include_audio=audio),
        "vae_decoder": VideoDecoder(VAEConfig(**_tuples(config["vae"])), "meta", dtype),
    }
    if audio:
        modules["av_transformer"] = LTXAVTransformer(tcfg, "meta", dtype)
        modules["audio_vae"] = AudioVAE(AudioVAEConfig(**_tuples(config["audio_vae"])), "meta")
        modules["vocoder"] = Vocoder(VocoderConfig(**_tuples(config["vocoder"])), "meta")
    else:
        modules["transformer"] = LTXTransformer(tcfg, "meta", dtype)
    return modules


def build_pipeline(config: dict, modules: dict, weights: dict, device):
    """The LTXPipeline over `modules` holding `weights`, resident on `device`."""
    from ltx_tpu_torch.config import MemoryConfig
    from ltx_tpu_torch.pipeline.generate import LTXPipeline

    for name, module in modules.items():
        assign(module, weights[name])
    memory = MemoryConfig(vae_tile_size=config["decode"]["tile"],
                          vae_tile_overlap=config["decode"]["overlap"],
                          decode_transfer="uint8", offload_text_encoder=False,
                          phase_staging=False)
    return LTXPipeline(
        transformer=modules.get("transformer"), vae_decoder=modules["vae_decoder"],
        gemma=modules["gemma"], text_encoder=modules["text_encoder"], tokenizer=None,
        memory=memory, is_distilled=True, device=device,
        av_transformer=modules.get("av_transformer"), audio_vae=modules.get("audio_vae"),
        vocoder=modules.get("vocoder"))


def generation_config(traffic):
    from ltx_tpu_torch.config import GenerationConfig

    return GenerationConfig(width=traffic["width"], height=traffic["height"],
                            num_frames=traffic["frames"], num_steps=traffic["steps"],
                            cfg_scale=traffic["cfg_scale"], fps=traffic["fps"], seed=0)


def run_clip(pipe, gen_config, clip: dict, on_progress=None):
    """One clip through the pipeline: (frames, audio or None, GenerationTimings),
    frames and audio on the host. on_progress(i, n, sigma) runs after each
    denoise step, once the device has finished it."""
    if pipe.av_transformer is not None:
        result = pipe.generate_video_with_audio(clip["prompt"], gen_config, clip["noise"],
                                                clip["audio_noise"], on_progress=on_progress)
    else:
        result = pipe.generate_video(clip["prompt"], gen_config, clip["noise"],
                                     on_progress=on_progress)
    return result.frames, result.audio, result.timings


def phase_seconds(timings) -> dict:
    """A clip's GenerationTimings as {phase: seconds}."""
    t = dataclasses.asdict(timings)
    return {"total": t["total"], "text": t["gemma"] + t["connector"],
            "steps": list(t["denoise_steps"]), "decode": t["vae_decode"] + t["audio_decode"],
            "other_phases": t["staging"] + t["enhancement"] + t["image_encode"] + t["upscale"]}


def reset_counters() -> None:
    from ltx_tpu_torch.kernels import flash_attention, quantization, rms_norm
    from ltx_tpu_torch.ops import normalization

    flash_attention.flash_attention.launches = 0
    flash_attention.flash_attention.launches_by_head_dim = {}
    rms_norm.rms_norm.launches = 0
    normalization.rms_chain_on_cuda = 0
    quantization.int4_matmul.launches = 0
    quantization.dequant_int4.launches = 0


def read_counters() -> dict:
    """The port's launch counters since `reset_counters`."""
    from ltx_tpu_torch.kernels import flash_attention, quantization, rms_norm
    from ltx_tpu_torch.ops import normalization

    return {"flash_attention": flash_attention.flash_attention.launches,
            "flash_attention_by_head_dim": dict(
                flash_attention.flash_attention.launches_by_head_dim),
            "rms_norm": rms_norm.rms_norm.launches,
            "rms_chain_on_cuda": normalization.rms_chain_on_cuda,
            "int4_matmul": quantization.int4_matmul.launches,
            "dequant_int4": quantization.dequant_int4.launches}


def build_kernels() -> dict:
    """Build (or find built) every CUDA kernel of the port: seconds each."""
    from ltx_tpu_torch.kernels import build

    return build.build_all()
