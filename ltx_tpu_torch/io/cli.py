"""`ltx-video-torch` CLI: generate / download / info / enhance / serve /
train / prepare-data.

Port of ltx_tpu/io/cli.py: the same subcommands, flags, defaults and
choices, plus `--device` (default cuda: the card; cpu when asked). Every
generation goes through `SeededPipeline`, which draws the noise from
`--seed` (other numbers than the reference's for a seed; the same frames
for the same seed on the same device). Weights come from the local models
directory (nothing is downloaded); `--dry-run` validates the configuration
without loading. `--mesh DATA,MODEL` shards the pipeline over a mesh of
processes (`LTXPipeline.shard`), `--mesh-pp DATA,PIPE` splits its DiTs
into pipeline stages (`LTXPipeline.shard_pp`): every process runs the same
command, started by torchrun or with `--coordinator HOST:PORT
--num-processes N --process-id I`, and rank 0 writes the outputs.

Run it as `python -m ltx_tpu_torch.io.cli ...` or `ltx-video-torch ...`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

log = logging.getLogger("ltx_tpu_torch")


def _add_device(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda: the card)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ltx-video-torch",
                                description="LTX-2 video generation on CUDA (PyTorch)")
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="Generate a video from a text prompt")
    g.add_argument("prompt", help="Text prompt describing the video")
    g.add_argument("-o", "--output", default="output.mp4")
    g.add_argument("-w", "--width", type=int, default=512)
    g.add_argument("-H", "--height", type=int, default=512)
    g.add_argument("-f", "--frames", type=int, default=25)
    g.add_argument("-s", "--steps", type=int, default=None)
    g.add_argument("-g", "--guidance", type=float, default=None,
                   help="CFG scale (1.0 = no CFG)")
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("-m", "--model", choices=["distilled", "dev", "auto"],
                   default="distilled",
                   help="auto = pick by hardware (weights/registry.py: dev "
                        "bf16 when the devices' memory fits 19B bf16, else "
                        "distilled int4)")
    g.add_argument("--lora", default=None, help="Path to LoRA safetensors")
    g.add_argument("--lora-scale", type=float, default=1.0)
    g.add_argument("--hf-token", default=None)
    g.add_argument("--models-dir", default=None)
    g.add_argument("--gemma-path", default=None)
    g.add_argument("--ltx-weights", default=None,
                   help="Path to unified LTX-2 safetensors")
    g.add_argument("--image", default=None, help="Image path for I2V")
    g.add_argument("--video", default=None,
                   help="Input clip for VIDEO-to-video (frames resampled "
                        "to --frames and resized; composes with --strength)")
    g.add_argument("--strength", type=float, default=0.6,
                   help="V2V: fraction of the schedule re-run (1.0 = full "
                        "noise == plain T2V; small keeps the clip's "
                        "structure)")
    g.add_argument("--extend-video", default=None,
                   help="EXTEND a clip: condition on its last --cond-frames "
                        "frames and generate the continuation")
    g.add_argument("--cond-frames", type=int, default=9,
                   help="Extension: pixel frames taken from the input's "
                        "tail (8k+1, < --frames)")
    g.add_argument("--keyframe", action="append", default=None,
                   metavar="IDX:PATH",
                   help="Condition on an image at pixel frame IDX (multiple "
                        "of 8); repeatable — e.g. --keyframe 0:a.png "
                        "--keyframe 112:b.png interpolates between anchors")
    g.add_argument("--chain", type=int, default=1, metavar="N",
                   help="CHAINED long video: autoregressively generate N "
                        "segments, each conditioned on the previous tail "
                        "in latent space (overlap = --cond-frames; total "
                        "frames = F + (N-1)*(F - cond_frames))")
    g.add_argument("--chain-prompt", action="append", default=None,
                   help="Continuation prompt for chain segment i (repeat "
                        "N-1 times; segment 0 uses the positional prompt)")
    g.add_argument("--chain-anchor", action="append", default=None,
                   metavar="SEG:IDX:PATH",
                   help="Keyframe anchor for chain segment SEG: condition "
                        "its (segment-local) pixel frame IDX (multiple of "
                        "8; past the carried overlap for SEG > 0) on an "
                        "image — the anti-drift tool; repeatable")
    g.add_argument("--chain-tail-renorm", type=float, default=0.0,
                   metavar="FACTOR",
                   help="Chain drift mitigation: AdaIN each carried tail's "
                        "per-channel stats toward segment 0's tail by "
                        "FACTOR in [0, 1] (0 = off)")
    g.add_argument("--chain-audio-cond", action="store_true",
                   help="AV chain: carry the previous segment's AUDIO tail "
                        "latents through the dual step's audio conditioning "
                        "(crossfade-only is the default)")
    g.add_argument("--image-cond-noise", type=float, default=0.15)
    g.add_argument("--negative-prompt", default=None)
    g.add_argument("--guidance-rescale", type=float, default=0.0)
    g.add_argument("--cross-attn-scale", type=float, default=1.0)
    g.add_argument("--ge-gamma", type=float, default=0.0)
    g.add_argument("--stg-scale", type=float, default=0.0)
    g.add_argument("--stg-blocks", default="29",
                   help="Comma-separated block indices")
    g.add_argument("--transformer-quant",
                   choices=["bf16", "qint8", "int4", "w8a8"],
                   default="bf16",
                   help="w8a8 = per-channel int8 weights + int8 activations "
                        "(1 B/param; activation quantization is a numerics "
                        "change — opt-in)")
    g.add_argument("--gemma-quant", choices=["int4", "w8a8", "bf16"],
                   default="w8a8",
                   help="Gemma runtime format: w8a8 = per-channel int8 "
                        "weights + int8 activations; int4 = smallest")
    g.add_argument("--two-stage", action="store_true")
    g.add_argument("--distilled-lora", action="store_true")
    g.add_argument("--enhance-prompt", action="store_true")
    g.add_argument("--spec-k", type=int, default=8, metavar="K",
                   help="Prompt-lookup speculative decoding for enhancement"
                        " (K drafts per verify step, 0 = sequential; exact:"
                        " the sampler distribution is unchanged)")
    g.add_argument("--audio", action="store_true")
    g.add_argument("--audio-gain", type=float, default=1.0)
    g.add_argument("--fps", type=float, default=24.0)
    g.add_argument("--codec", choices=["h264", "hevc"], default="h264",
                   help="MP4 video codec (VideoExportConfig: h264 default / "
                        "hevc high-quality preset)")
    g.add_argument("--export-quality", type=float, default=0.8,
                   metavar="0..1")
    g.add_argument("--vae-tile-size", type=int, default=0)
    g.add_argument("--decode-transfer", choices=("uint8", "yuv420"),
                   default="uint8",
                   help="Tiled-decode device->host format: yuv420 halves "
                        "uint8's bytes (the codec's own chroma subsample, "
                        "moved before the copy)")
    g.add_argument("--vae-tile-overlap", type=int, default=1)
    g.add_argument("--memory", choices=["disabled", "light", "moderate",
                                        "aggressive"], default=None,
                   help="Memory preset (overrides the vae-tile flags)")
    g.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                   help="Shard over a (data, model) mesh of processes: TP "
                        "over the model axis, guidance rows over the data axis")
    g.add_argument("--mesh-pp", default=None, metavar="DATA,PIPE",
                   help="Pipeline-parallel (data, pipe) mesh of processes: "
                        "the DiTs' blocks in stages over the pipe axis, "
                        "guidance rows over the data axis")
    g.add_argument("--mesh-slices", type=int, default=None, metavar="N",
                   help="Slices of a --mesh: contiguous rank groups the model "
                        "axis may not cross")
    g.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="Process-group address (tcp://HOST:PORT or HOST:PORT); "
                        "torchrun's environment needs none")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)
    g.add_argument("--no-quant-cache", action="store_true",
                   help="Skip the quantized-weight cache (weights/qcache."
                        "py): always re-quantize at load")
    g.add_argument("--debug", action="store_true")
    g.add_argument("--profile", action="store_true",
                   help="Print the phase timings and write a torch.profiler "
                        "Chrome trace beside the output")
    g.add_argument("--dry-run", action="store_true")
    _add_device(g)

    d = sub.add_parser("download", help="Resolve the model weights locally")
    d.add_argument("-m", "--model", choices=["distilled", "dev"],
                   default="distilled")
    d.add_argument("--hf-token", default=None)
    d.add_argument("--models-dir", default=None)
    d.add_argument("--force", action="store_true")
    d.add_argument("--audio", action="store_true",
                   help="Also the audio VAE + vocoder")

    i = sub.add_parser("info", help="Show model and system information")
    i.add_argument("--models-dir", default=None)

    e = sub.add_parser(
        "enhance",
        help="Batch-enhance prompts with Gemma (all prompts through batched "
             "decodes)")
    e.add_argument("prompts", nargs="*", help="Prompts to enhance")
    e.add_argument("--file", default=None,
                   help="File with one prompt per line (appended to "
                        "positional prompts)")
    e.add_argument("--i2v", action="store_true",
                   help="Use the image-to-video system prompt")
    e.add_argument("--max-tokens", type=int, default=512)
    e.add_argument("--temperature", type=float, default=0.7)
    e.add_argument("--seed", type=int, default=42)
    e.add_argument("--spec-k", type=int, default=8, metavar="K",
                   help="Per-row prompt-lookup speculative drafts "
                        "(0 disables)")
    e.add_argument("--json", action="store_true",
                   help="Emit a JSON list instead of one prompt per line")
    e.add_argument("--kv-quant", choices=["bf16", "int8"], default="bf16",
                   help="int8 halves the KV cache per row (opt-in numerics "
                        "change)")
    e.add_argument("--embed-int8", action="store_true",
                   help="int8 Gemma embedding table")
    e.add_argument("--max-batch", type=int, default=0,
                   help="Rows per micro-batch (0 = auto: the device's memory "
                        "less Gemma's weights over one row's KV cache)")
    e.add_argument("--gemma-quant", choices=["int4", "w8a8", "bf16"],
                   default="w8a8")
    e.add_argument("--gemma-path", default=None)
    e.add_argument("--models-dir", default=None)
    e.add_argument("--hf-token", default=None)
    e.add_argument("--debug", action="store_true")
    _add_device(e)

    s = sub.add_parser(
        "serve",
        help="Run the HTTP serving front-end (enhance micro-batching + "
             "generation job queue)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8571)
    s.add_argument("--output-dir", default="serve_outputs",
                   help="Where generation jobs write <job_id>.mp4")
    s.add_argument("--image-root", default=None,
                   help="Confine i2v request 'image_path's to this "
                        "directory (default: any server-readable path — "
                        "trusted local use only)")
    s.add_argument("--model", default="auto",
                   choices=["auto", "distilled", "dev"])
    s.add_argument("--transformer-quant",
                   choices=["bf16", "qint8", "int4", "w8a8"], default="int4")
    s.add_argument("--gemma-quant", choices=["int4", "w8a8", "bf16"],
                   default="w8a8")
    s.add_argument("--audio", action="store_true",
                   help="Load the AV transformer + audio VAE + vocoder "
                        "(enables kind=audio/audio_two_stage jobs)")
    s.add_argument("--upscaler", action="store_true",
                   help="Load the spatial upscaler (enables two-stage jobs)")
    s.add_argument("--memory", choices=["light", "moderate", "aggressive"],
                   default="moderate")
    s.add_argument("--max-batch", type=int, default=0,
                   help="Enhance rows per micro-batch (0 = auto from the "
                        "device's memory)")
    s.add_argument("--spec-k", type=int, default=8)
    s.add_argument("--kv-quant", choices=["bf16", "int8"], default="bf16",
                   help="int8 halves the enhance KV cache per row (opt-in "
                        "numerics change)")
    s.add_argument("--embed-int8", action="store_true",
                   help="int8 Gemma embedding TABLE (per-token-row scales)")
    s.add_argument("--batch-window-ms", type=float, default=50.0,
                   help="How long the first enhance request waits to "
                        "coalesce with concurrent arrivals")
    s.add_argument("--gen-batch", type=int, default=1,
                   help="Coalesce queued SAME-CONFIG t2v jobs into one "
                        "batched denoise (per-job seeds/outputs preserved); "
                        "device memory grows with the batch")
    s.add_argument("--warmup", action="append", default=None,
                   metavar="WxHxF[:two_stage]",
                   help="Pay this shape's first-use costs BEFORE accepting "
                        "jobs (e.g. 768x512x25, or 768x512x25:two_stage "
                        "through the upscaler); repeatable")
    s.add_argument("--gemma-path", default=None)
    s.add_argument("--ltx-weights", default=None)
    s.add_argument("--models-dir", default=None)
    s.add_argument("--hf-token", default=None)
    s.add_argument("--no-quant-cache", action="store_true")
    s.add_argument("--debug", action="store_true")
    _add_device(s)

    t = sub.add_parser(
        "train",
        help="LoRA/QLoRA fine-tune of the video DiT on latent shards "
             "(flow matching; docs/TRAINING.md)")
    from ltx_tpu_torch.train.cli import add_train_arguments

    add_train_arguments(t)
    t.add_argument("--debug", action="store_true")

    pd = sub.add_parser(
        "prepare-data",
        help="Encode video clips + captions into latent training shards")
    from ltx_tpu_torch.train.prepare import add_prepare_arguments

    add_prepare_arguments(pd)
    pd.add_argument("--debug", action="store_true")

    return p


def _effective_model(args):
    """--distilled-lora forces the dev model (the LoRA fuses into dev
    weights). --model auto applies the registry's hardware recommendation
    (weights/registry.py::recommended_model)."""
    from ltx_tpu_torch.config import LTXModel

    distilled_lora = getattr(args, "distilled_lora", False)  # serve has none
    if args.model == "auto" and not distilled_lora:
        from ltx_tpu_torch.weights.registry import recommended_model

        model, quant = recommended_model()
        if quant is not None and args.transformer_quant == "bf16":
            args.transformer_quant = quant
        log.info("--model auto: %s (transformer_quant=%s)",
                 model.value, args.transformer_quant)
        return model
    return LTXModel("dev" if distilled_lora else args.model)


def _generation_config(args):
    from ltx_tpu_torch.config import GenerationConfig

    model = _effective_model(args)
    if args.distilled_lora:
        # dev + distilled LoRA runs the distilled recipe: 8 steps, no CFG
        # unless explicitly overridden
        steps = args.steps if args.steps is not None else 8
        cfg_scale = args.guidance if args.guidance is not None else 1.0
    else:
        steps = args.steps if args.steps is not None else model.default_steps
        cfg_scale = (args.guidance if args.guidance is not None
                     else model.default_guidance)
    stg_blocks = tuple(int(b) for b in str(args.stg_blocks).split(",") if b)
    return GenerationConfig(
        width=args.width,
        height=args.height,
        num_frames=args.frames,
        num_steps=steps,
        cfg_scale=cfg_scale,
        seed=args.seed,
        negative_prompt=args.negative_prompt,
        guidance_rescale=args.guidance_rescale,
        cross_attention_scale=args.cross_attn_scale,
        ge_gamma=args.ge_gamma,
        stg_scale=args.stg_scale,
        stg_blocks=stg_blocks,
        two_stage=args.two_stage,
        enhance_prompt=args.enhance_prompt,
        enhancement_spec_k=args.spec_k,
        image_path=args.image,
        # injection noise applies to EVERY conditioned-frame mode (I2V,
        # extension, keyframes) — same mechanism, same default
        image_cond_noise_scale=(
            args.image_cond_noise
            if (args.image or getattr(args, "extend_video", None)
                or getattr(args, "keyframe", None))
            else 0.0),
        fps=args.fps,
    )


def memory_budget_gb(device="cuda") -> float:
    """The memory (GB) a generation on `device` may use: a CUDA device's
    total memory, or the host's physical memory for the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        from ltx_tpu_torch.ops.latents import device_memory_gb

        return device_memory_gb(device.index or 0)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 1e9


def _resolve_memory(args, config, budget_gb=None):
    """Map the flags to a MemoryConfig, applying the recommended preset
    when the memory estimate exceeds the budget (default: the memory of
    args.device, `memory_budget_gb`) and the user made no memory choice."""
    import dataclasses as _dc

    from ltx_tpu_torch.config import MemoryConfig, QuantizationConfig
    from ltx_tpu_torch.ops.latents import (
        VideoLatentShape,
        estimate_memory_gb,
        recommended_memory_preset,
    )

    if budget_gb is None:
        budget_gb = memory_budget_gb(getattr(args, "device", "cuda"))
    if args.memory:
        memory = MemoryConfig.preset(args.memory)
    else:
        memory = MemoryConfig(
            vae_tile_size=args.vae_tile_size,
            vae_tile_overlap=args.vae_tile_overlap,
        )
    shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height,
                                         config.width)
    bits = QuantizationConfig(mode=args.transformer_quant).bits
    rows = 1 + (config.cfg_scale > 1.0) + (config.stg_scale > 0)
    est = estimate_memory_gb(shape, rows, bits,
                             vae_tile_size=memory.vae_tile_size,
                             audio=args.audio)
    # --mesh-pp does not suppress it: only the DiTs' blocks split, Gemma and
    # the VAE stay whole on every rank (TP shards Gemma too)
    if est > budget_gb and not args.mesh:
        rec = recommended_memory_preset(shape, rows, bits, audio=args.audio,
                                        budget_gb=budget_gb)
        if args.memory is None and args.vae_tile_size == 0:
            # no explicit memory choice from the user: apply the
            # recommendation instead of just warning
            memory = MemoryConfig.preset(rec)
            log.info(
                "estimated peak device memory %.1f GB exceeds the device's "
                "~%.1f GB; auto-applying --memory %s (pass --memory light to "
                "disable)", est, budget_gb, rec)
        else:
            log.warning(
                "estimated peak device memory %.1f GB exceeds the device's "
                "~%.1f GB; consider --memory %s%s",
                est, budget_gb, rec,
                "" if bits else " or --transformer-quant int4")
    if getattr(args, "decode_transfer", "uint8") != "uint8":
        # applied LAST so an auto-selected preset keeps the user's wire
        # format choice
        memory = _dc.replace(memory, decode_transfer=args.decode_transfer)
    return memory


def _shared_seed(seed):
    """One seed for every process of the group: the given one, or rank 0's
    clock."""
    import torch.distributed as dist

    if seed is not None or not dist.is_initialized():
        return seed if seed is not None else int(time.time())
    box = [int(time.time())]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _parse_mesh(spec: str):
    """"DATA,MODEL" -> (data, model), or None if malformed."""
    try:
        data, model = (int(x) for x in spec.split(","))
    except ValueError:
        return None
    return data, model


def _check_generate_flags(args):
    """The reference's flag checks of cmd_generate, in its order: an
    error message and exit code 2, or None."""
    if getattr(args, "chain", 1) < 1:
        # --chain 0 / negative would silently fall through to plain T2V
        return f"--chain must be >= 1, got {args.chain}"
    if getattr(args, "chain_prompt", None) and getattr(args, "chain", 1) <= 1:
        return "--chain-prompt requires --chain N (N > 1)"
    if getattr(args, "chain", 1) <= 1:
        # chain-only flags must not silently fall through to plain T2V
        for flag, val in (
            ("--chain-anchor", getattr(args, "chain_anchor", None)),
            ("--chain-tail-renorm", getattr(args, "chain_tail_renorm", 0.0)),
            ("--chain-audio-cond", getattr(args, "chain_audio_cond", False)),
        ):
            if val:
                return f"{flag} requires --chain N (N > 1)"
    if getattr(args, "chain_audio_cond", False) and not args.audio:
        return "--chain-audio-cond requires --audio"
    if getattr(args, "chain", 1) > 1:
        if args.two_stage or args.image or getattr(args, "video", None) or \
                getattr(args, "extend_video", None) or getattr(args, "keyframe", None):
            return ("--chain composes with neither --two-stage, --image, "
                    "--video, --extend-video nor --keyframe yet")
        if getattr(args, "chain_prompt", None) and \
                len(args.chain_prompt) != args.chain - 1:
            return (f"--chain {args.chain} needs {args.chain - 1} "
                    f"--chain-prompt entries, got {len(args.chain_prompt)}")
        for spec in getattr(args, "chain_anchor", None) or ():
            parts = spec.split(":", 2)
            if len(parts) != 3 or not parts[0].isdigit() \
                    or not parts[1].isdigit() or not parts[2]:
                return f"--chain-anchor {spec!r} is not SEG:IDX:PATH"
    elif getattr(args, "video", None):
        if args.audio or args.two_stage or args.image or \
                getattr(args, "extend_video", None) or getattr(args, "keyframe", None):
            return ("--video (v2v) composes with neither --audio, "
                    "--two-stage, --image, --extend-video nor --keyframe yet")
    elif getattr(args, "extend_video", None):
        if args.two_stage or args.image or getattr(args, "keyframe", None):
            return ("--extend-video composes with neither "
                    "--two-stage, --image nor --keyframe yet")
    elif getattr(args, "keyframe", None):
        if args.two_stage or args.image:
            return "--keyframe composes with neither --two-stage nor --image yet"
        for spec in args.keyframe:
            idx, sep, path = spec.partition(":")
            if not sep or not idx.isdigit() or not path:
                return f"--keyframe {spec!r} is not IDX:PATH"
    return None


def _run_generate(pipe, args, config, on_progress):
    """The entry point of the flags, in the reference's order of branches."""
    if getattr(args, "chain", 1) > 1:
        prompts = None
        if getattr(args, "chain_prompt", None):
            prompts = [args.prompt] + list(args.chain_prompt)
        anchors = None
        if getattr(args, "chain_anchor", None):
            anchors = {}
            for spec in args.chain_anchor:
                seg, idx, path = spec.split(":", 2)
                anchors.setdefault(int(seg), []).append((int(idx), path))
        if args.audio:
            # chained long video WITH a soundtrack (the audio crossfades
            # over each trimmed overlap window)
            return pipe.generate_video_chain_with_audio(
                args.prompt, config, segments=args.chain,
                cond_frames=args.cond_frames, prompts=prompts,
                audio_gain=args.audio_gain, on_progress=on_progress,
                audio_cond=getattr(args, "chain_audio_cond", False),
                anchors=anchors,
            )
        return pipe.generate_video_chain(
            args.prompt, config, segments=args.chain,
            cond_frames=args.cond_frames, prompts=prompts,
            on_progress=on_progress, anchors=anchors,
            tail_renorm=args.chain_tail_renorm,
        )
    if getattr(args, "video", None):
        return pipe.generate_video_from_video(
            args.prompt, config, video_path=args.video,
            strength=args.strength, on_progress=on_progress,
        )
    if getattr(args, "extend_video", None):
        if args.audio:
            # extend WITH a soundtrack: the dual DiT's twin
            return pipe.generate_video_with_audio(
                args.prompt, config, on_progress=on_progress,
                audio_gain=args.audio_gain, video_path=args.extend_video,
                cond_frames=args.cond_frames,
            )
        return pipe.generate_video_extension(
            args.prompt, config, video_path=args.extend_video,
            cond_frames=args.cond_frames, on_progress=on_progress,
        )
    if getattr(args, "keyframe", None):
        keyframes = []
        for spec in args.keyframe:
            idx, _, path = spec.partition(":")
            keyframes.append((int(idx), path))
        return pipe.generate_video_keyframes(
            args.prompt, config, keyframes, on_progress=on_progress,
            audio=args.audio, audio_gain=args.audio_gain,
        )
    if args.audio and args.two_stage:
        return pipe.generate_video_with_audio_two_stage(
            args.prompt, config, on_progress=on_progress,
            audio_gain=args.audio_gain,
        )
    if args.audio:
        return pipe.generate_video_with_audio(
            args.prompt, config, on_progress=on_progress,
            audio_gain=args.audio_gain,
        )
    if args.two_stage:
        return pipe.generate_video_two_stage(args.prompt, config, on_progress=on_progress)
    return pipe.generate_video(args.prompt, config, on_progress=on_progress)


def cmd_generate(args) -> int:
    import contextlib

    from ltx_tpu_torch.errors import LTXError

    config = _generation_config(args)
    try:
        config.validate()
    except (LTXError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.mesh and args.mesh_pp:
        print("error: --mesh and --mesh-pp are mutually exclusive",
              file=sys.stderr)
        return 2

    if args.dry_run:
        print("Configuration valid (dry run):")
        print(f"  {config}")
        return 0

    mesh_shape = None
    if args.mesh or args.mesh_pp:
        mesh_shape = _parse_mesh(args.mesh or args.mesh_pp)
        if mesh_shape is None:
            print(f"error: --mesh expects DATA,MODEL, got {args.mesh!r}" if args.mesh else
                  f"error: --mesh-pp expects DATA,PIPE, got {args.mesh_pp!r}", file=sys.stderr)
            return 2
    # the reference checks these after the load; same messages and code,
    # before minutes of loading
    err = _check_generate_flags(args)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2

    from ltx_tpu_torch.config import QuantizationConfig
    from ltx_tpu_torch.parallel import runtime
    from ltx_tpu_torch.pipeline import loader
    from ltx_tpu_torch.pipeline.seeded import SeededPipeline

    # before any device use: the flags, or a launcher's environment
    runtime.initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                   device=args.device)
    rank = runtime.world()[0]
    if mesh_shape is not None:
        config = dataclasses.replace(config, seed=_shared_seed(config.seed))
    memory = _resolve_memory(args, config)
    pipe = SeededPipeline(loader.load_pipeline(
        model=_effective_model(args),
        models_dir=args.models_dir,
        hf_token=args.hf_token,
        gemma_path=args.gemma_path,
        unified_weights_path=args.ltx_weights,
        quantization=QuantizationConfig(mode=args.transformer_quant),
        gemma_quant=args.gemma_quant,
        memory=memory,
        lora_path=args.lora,
        lora_scale=args.lora_scale,
        distilled_lora=args.distilled_lora,
        include_audio=args.audio,
        include_upscaler=args.two_stage,
        quant_cache=not args.no_quant_cache,
        device=args.device,
    ))
    if args.mesh:
        data, model = mesh_shape
        pipe.shard(runtime.make_hybrid_mesh(data=data, model=model,
                                            slices=args.mesh_slices))
    elif args.mesh_pp:
        data, stages = mesh_shape
        pipe.shard_pp(runtime.make_hybrid_mesh(data=data, model=stages,
                                               axis_names=("data", "pipe"),
                                               slices=args.mesh_slices))

    def on_progress(step, total, sigma):
        if rank == 0:
            print(f"  step {step + 1}/{total}  sigma={sigma:.4f}", flush=True)

    # I2V image encoding happens INSIDE the pipeline entry points (at each
    # stage's resolution) via config.image_path
    t0 = time.time()
    trace = contextlib.nullcontext()
    if args.profile:
        from ltx_tpu_torch.utils.diagnostics import profile_trace

        trace = profile_trace(args.output + ".trace")
    with trace:
        result = _run_generate(pipe, args, config, on_progress)
    if rank != 0:  # every rank holds the same frames; rank 0 writes them
        return 0

    from ltx_tpu_torch.io.video import VideoExportConfig, export_video, export_wav

    export_video(
        result.frames, args.output, fps=args.fps,
        audio=None if result.audio is None else result.audio,
        config=VideoExportConfig(fps=args.fps, codec=args.codec,
                                 quality=args.export_quality),
    )
    if result.audio is not None:
        export_wav(result.audio, args.output + ".wav")
    print(f"Saved {args.output} in {time.time() - t0:.1f}s (seed {result.seed})")
    if args.profile:
        print(result.timings.report())
    return 0


def cmd_download(args) -> int:
    from ltx_tpu_torch.config import LTXModel
    from ltx_tpu_torch.weights.download import download_all_components

    paths = download_all_components(
        LTXModel(args.model), models_dir=args.models_dir,
        hf_token=args.hf_token, force=args.force, include_audio=args.audio,
    )
    for name, p in paths.items():
        print(f"  {name}: {p}")
    return 0


def cmd_info(args) -> int:
    from pathlib import Path

    import torch

    import ltx_tpu_torch
    from ltx_tpu_torch.config import LTXModel
    from ltx_tpu_torch.weights.download import default_models_dir

    print(f"ltx-tpu-torch {ltx_tpu_torch.__version__}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = ", ".join(torch.cuda.get_device_name(i) for i in range(count)) or "none"
    print(f"torch {torch.__version__} | cuda {torch.version.cuda} | devices {count} "
          f"({names})")
    base = Path(args.models_dir or default_models_dir())
    print(f"models dir: {base}")

    from ltx_tpu_torch.weights.registry import (
        component_inventory,
        missing_files,
        recommended_model,
    )

    for m in (LTXModel.DISTILLED, LTXModel.DEV):
        for comp in component_inventory(m):
            if comp == "unified":
                name = f"ltx-{m.value} unified"
            elif m is not LTXModel.DISTILLED:
                continue  # model-independent components print once
            else:
                name = comp
            miss = missing_files(comp, str(base), m)
            status = "cached" if not miss else \
                f"not downloaded (missing: {', '.join(miss)})"
            print(f"  {name}: {status}")

    model, quant = recommended_model()
    extra = f" --transformer-quant {quant}" if quant else " bf16"
    print(f"recommended: {model.value}{extra}")
    return 0


def _enhance_max_batch(args, gemma) -> int:
    """--max-batch, or the rows the device's memory holds beside Gemma
    (pipeline/enhance.py::enhance_max_batch)."""
    if args.max_batch:
        return args.max_batch
    from ltx_tpu_torch.pipeline.enhance import enhance_max_batch

    return enhance_max_batch(gemma, memory_budget_gb(args.device),
                             kv_quant=getattr(args, "kv_quant", "bf16"))


def cmd_enhance(args) -> int:
    """Batched prompt enhancement (pipeline/enhance.py::enhance_prompts):
    the prompts in micro-batches of --max-batch rows (auto from the
    device's memory); a failed batch exits non-zero instead of printing
    the raw prompts."""
    from pathlib import Path

    prompts = list(args.prompts)
    if args.file:
        with open(args.file) as f:
            prompts += [ln.strip() for ln in f if ln.strip()]
    if not prompts:
        print("error: no prompts (positional or --file)", file=sys.stderr)
        return 2

    import torch

    from ltx_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model
    from ltx_tpu_torch.pipeline.enhance import enhance_prompts
    from ltx_tpu_torch.pipeline.loader import load_tokenizer
    from ltx_tpu_torch.weights import keymaps
    from ltx_tpu_torch.weights.download import download_gemma, load_safetensors_dir

    device = torch.device(args.device)
    gemma_dir = args.gemma_path or download_gemma(models_dir=args.models_dir,
                                                  hf_token=args.hf_token)
    with open(Path(gemma_dir) / "config.json") as f:
        gcfg = Gemma3Config.from_hf_dict(json.load(f))
    tokenizer = load_tokenizer(gemma_dir)
    log.info("Loading Gemma (%s) from %s", args.gemma_quant, gemma_dir)
    state = keymaps.load_gemma_params(
        load_safetensors_dir(gemma_dir), gcfg.hidden_layers, mode=args.gemma_quant,
        embed_int8=getattr(args, "embed_int8", False), device=device)
    gemma = Gemma3Model.from_state_dict(gcfg, state).to(device)
    max_batch = _enhance_max_batch(args, gemma)

    t0 = time.time()
    try:
        out = enhance_prompts(
            gemma, tokenizer, prompts, is_i2v=args.i2v,
            max_tokens=args.max_tokens, temperature=args.temperature,
            seed=args.seed, spec_k=args.spec_k, max_batch=max_batch,
            strict=True, kv_quant=getattr(args, "kv_quant", "bf16"))
    except Exception as e:  # noqa: BLE001 — surface, don't fake success
        print(f"error: enhancement failed: {e}", file=sys.stderr)
        return 1
    log.info("Enhanced %d prompts in %.1f s", len(out), time.time() - t0)
    if args.json:
        print(json.dumps(out, indent=1))
    else:
        for line in out:
            print(line)
    return 0


def parse_warmup(specs):
    """--warmup WxHxF[:two_stage] entries -> shapes, or the first bad entry
    as a string."""
    shapes = []
    for spec in specs:
        shape_part, _, kind = spec.lower().partition(":")
        parts = shape_part.split("x")
        if (len(parts) != 3 or not all(p.isdigit() for p in parts)
                or kind not in ("", "two_stage")):
            return spec
        t = tuple(int(p) for p in parts)
        shapes.append(t + ("two_stage",) if kind else t)
    return shapes


def cmd_serve(args) -> int:
    """HTTP serving front-end (ltx_tpu_torch/serve/): enhancement requests
    coalesce into micro-batches, generation requests run as polled jobs
    behind a single-device FIFO. Blocks until SIGINT."""
    from ltx_tpu_torch.config import MemoryConfig, QuantizationConfig
    from ltx_tpu_torch.pipeline import loader
    from ltx_tpu_torch.pipeline.seeded import SeededPipeline
    from ltx_tpu_torch.serve import app as serve_app

    # parse --warmup BEFORE the (minutes-long) weight load so a typo
    # fails immediately
    warmup_shapes = None
    if getattr(args, "warmup", None):
        warmup_shapes = parse_warmup(args.warmup)
        if isinstance(warmup_shapes, str):
            print(f"error: --warmup {warmup_shapes!r} is not WxHxF"
                  "[:two_stage]", file=sys.stderr)
            return 2

    pipe = loader.load_pipeline(
        model=_effective_model(args),
        models_dir=args.models_dir,
        hf_token=args.hf_token,
        gemma_path=args.gemma_path,
        unified_weights_path=args.ltx_weights,
        quantization=QuantizationConfig(mode=args.transformer_quant),
        gemma_quant=args.gemma_quant,
        gemma_embed_int8=args.embed_int8,
        memory=MemoryConfig.preset(args.memory),
        include_audio=args.audio,
        include_upscaler=args.upscaler,
        quant_cache=not args.no_quant_cache,
        device=args.device,
    )
    max_batch = _enhance_max_batch(args, pipe.gemma) if pipe.gemma is not None \
        else max(args.max_batch, 1)
    app = serve_app.build_app(
        SeededPipeline(pipe), output_dir=args.output_dir, host=args.host,
        port=args.port, max_batch=max_batch, spec_k=args.spec_k,
        kv_quant=args.kv_quant, batch_window_s=args.batch_window_ms / 1000.0,
        image_root=args.image_root, gen_batch=args.gen_batch,
        warmup_shapes=warmup_shapes,
        info={"model": args.model, "transformer_quant":
              args.transformer_quant, "gemma_quant": args.gemma_quant,
              "audio": args.audio, "upscaler": args.upscaler},
    )
    host, port = app.server.server_address[:2]
    log.info("Serving on http://%s:%d (enhance max_batch=%d, spec_k=%d)",
             host, port, max_batch, args.spec_k)
    try:
        app.server.serve_forever()
    except KeyboardInterrupt:
        log.info("Shutting down")
    finally:
        app.close()
    return 0


def cmd_train(args) -> int:
    """LoRA/QLoRA fine-tune (ltx_tpu_torch/train/): flow-matching steps over
    latent shards, the adapter exported in the LoRA schema `generate
    --lora` fuses."""
    from ltx_tpu_torch.train.cli import run

    return run(args)


def cmd_prepare_data(args) -> int:
    """Clips + captions -> latent shards (ltx_tpu_torch/train/prepare.py):
    each clip VAE-encoded, normalized and patchified, each caption through
    Gemma and the connector, written as LatentShardDataset shards."""
    from ltx_tpu_torch.train.prepare import run

    return run(args)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if getattr(args, "debug", False) else logging.INFO,
        format="%(message)s",
    )
    handler = {"generate": cmd_generate, "download": cmd_download,
               "info": cmd_info, "enhance": cmd_enhance,
               "serve": cmd_serve, "train": cmd_train,
               "prepare-data": cmd_prepare_data}[args.command]
    from ltx_tpu_torch.errors import LTXError

    try:
        return handler(args)
    except LTXError as e:
        # a user-facing message, not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
