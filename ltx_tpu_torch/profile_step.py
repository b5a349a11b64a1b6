"""Where a denoise step's, or a train step's, device time goes, on one
NVIDIA GPU.

    python -m ltx_tpu_torch.profile_step [--frames 25 --height 512 --width 768]
                                         [--norm auto|chain]
    python -m ltx_tpu_torch.profile_step --train [--frames ... as above]

Builds the full-width, full-depth DiT with random bf16 weights from a seed
on the card, runs one warm-up denoise step at the given clip size (a random
1024-token text context with 300 padded keys), then profiles two steps with
torch.profiler and prints, per step: the host time, the device time by
kernel group (the flash-attention, int4 and RMSNorm kernels of this package,
GEMMs, everything else) and the device's idle share. --norm picks how
ops.normalization.rms_norm is served in the denoise steps: "auto" (the
default) routes each call as the library does, which on the card is the
hand-written kernel; "chain" forces the plain chain (`forced_rms_chain`), to
measure the kernel against it. Then it quantizes the same
DiT to int4 on the card and does the same again. The last line is one JSON
object with both breakdowns. Fails without CUDA.

With --train it profiles one QLoRA train step instead: the same DiT
quantized to int4 and frozen, rank-16 LoRA on its 480 block linears, the
flow-matching loss with per-block remat, its backward and the optimizer, at
batch 1 and the given clip size, split into the flash forward (statistics)
and backward kernels, int4_matmul, dequant_int4, GEMMs, other and idle,
with the step's peak device memory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ltx_tpu_torch.config import GenerationConfig, TransformerConfig
from ltx_tpu_torch.models.common import init_random_
from ltx_tpu_torch.models.dit import LTXTransformer, quantize_transformer
from ltx_tpu_torch.ops.latents import VideoLatentShape, generate_noise
from ltx_tpu_torch.ops.normalization import forced_rms_chain
from ltx_tpu_torch.pipeline.denoise import GuidanceSpec, make_denoise_step

# kernel-name fragments of each group, matched in this order
GROUPS = (
    ("flash_attention", ("flash_fwd_kernel",)),
    ("flash_bwd", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("int4_matmul", ("int4_matmul_kernel",)),
    ("dequant_int4", ("dequant_int4_kernel",)),
    ("rms_norm", ("rms_norm_kernel",)),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "sm90_", "cublas")),
)
PROFILED_STEPS = 2
WALL_STEPS = 5


def group_of(name: str) -> str:
    for group, fragments in GROUPS:
        if any(f in name for f in fragments):
            return group
    return "other"


def profile_steps(step, latent=None) -> dict:
    """One warm-up step, then PROFILED_STEPS steps under the profiler;
    returns per-step host ms, device ms by group, and the idle share
    (1 - device ms / host ms, not floored: a negative share is a
    measurement error to look into), then the median wall ms of WALL_STEPS
    more steps without the profiler (which slows the host's launches), each
    synchronised.
    With `latent`, `step` is a denoise step run in inference mode; without,
    a train step taking no arguments."""
    def run():
        if latent is None:
            step()
        else:
            with torch.inference_mode():
                step(latent, 1.0, 0.9)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    device_ms = {name: 0.0 for name, _ in GROUPS}
    device_ms["other"] = 0.0
    for avg in prof.key_averages():
        if avg.device_type == DeviceType.CUDA:
            device_ms[group_of(avg.key)] += avg.self_device_time_total / 1e3 / PROFILED_STEPS
    busy = sum(device_ms.values())
    if busy <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    walls = []
    for _ in range(WALL_STEPS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"host_ms": host_ms, "device_ms": device_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / host_ms, "wall_ms": sorted(walls)[WALL_STEPS // 2],
            "wall_steps_ms": walls}


def profile_train(transformer, shape, context, bias, gen) -> dict:
    """One int4 QLoRA train step of `transformer` (quantized in place, LoRA
    added) on random clean latents of `shape`: device ms by group, idle
    share and peak memory."""
    from ltx_tpu_torch.ops.latents import patchify
    from ltx_tpu_torch.ops.rope import video_rope
    from ltx_tpu_torch.train.lora import add_lora
    from ltx_tpu_torch.train.step import TrainConfig, init_train_state, make_train_step

    cfg = transformer.cfg
    quantize_transformer(transformer, bits=4, group_size=64)
    add_lora(transformer, gen, rank=16)
    torch.cuda.empty_cache()
    tc = TrainConfig(lora_only=True, sdpa_impl="pallas")
    trainable, _, opt_state = init_train_state(transformer, tc)
    train_step = make_train_step(transformer, tc)
    tokens = patchify(generate_noise(shape, gen))
    cos, sin = video_rope(shape.frames, shape.height, shape.width, cfg.inner_dim,
                          cfg.num_heads)
    rope = (torch.as_tensor(cos, device=tokens.device), torch.as_tensor(sin, device=tokens.device))
    sigma = torch.full((1,), 0.5, device=tokens.device)
    noise = torch.randn(tokens.shape, generator=gen, device=tokens.device)

    def step():
        train_step(trainable, opt_state, tokens, context, rope, sigma, noise, bias)

    torch.cuda.reset_peak_memory_stats()
    res = profile_steps(step)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=25)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--width", type=int, default=768)
    parser.add_argument("--train", action="store_true",
                        help="profile one int4 QLoRA train step instead")
    parser.add_argument("--norm", choices=("auto", "chain"), default="auto",
                        help="rms_norm in the denoise steps: routed as the library "
                             "routes it, or forced onto the plain chain")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: CUDA is not available")
    device = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[profile] gpu: {gpu}, torch {torch.__version__}", flush=True)

    cfg = TransformerConfig()
    gen = torch.Generator(device=device).manual_seed(0)
    transformer = init_random_(LTXTransformer(cfg, device, torch.bfloat16), gen)
    config = GenerationConfig(width=args.width, height=args.height, num_frames=args.frames)
    shape = VideoLatentShape.from_pixels(1, args.frames, args.height, args.width,
                                         channels=cfg.in_channels)
    latent = generate_noise(shape, gen)
    context = torch.randn(1, 1024, cfg.caption_channels, generator=gen,
                          device=device).bfloat16()
    bias = torch.zeros(1, 1, 1, 1024, device=device)
    bias[..., :300] = -10000.0

    if args.train:
        res = profile_train(transformer, shape, context, bias, gen)
        groups = ", ".join(f"{k} {v:.2f}" for k, v in res["device_ms"].items())
        print(f"[profile] train int4 QLoRA {args.frames}f@{args.width}x{args.height} "
              f"({shape.token_count} tokens): host {res['host_ms']:.2f} ms/step, device "
              f"{res['device_busy_ms']:.2f} ms/step ({groups}), idle share "
              f"{res['idle_share']:.3f}, peak {res['peak_gib']:.2f} GiB; unprofiled wall "
              f"{res['wall_ms']:.2f} ms/step", flush=True)
        print(json.dumps({"gpu": gpu, "tokens": shape.token_count, "train": res}))
        return 0

    results = {}
    norm = forced_rms_chain() if args.norm == "chain" else contextlib.nullcontext()
    with norm:
        for mode in ("bf16", "int4"):
            if mode == "int4":
                quantize_transformer(transformer, bits=4, group_size=64)
                torch.cuda.empty_cache()
            step = make_denoise_step(transformer, GuidanceSpec.from_config(config), shape,
                                     context, bias, fps=config.fps)
            res = profile_steps(step, latent)
            results[mode] = res
            groups = ", ".join(f"{k} {v:.2f}" for k, v in res["device_ms"].items())
            print(f"[profile] {mode} norm={args.norm} {args.frames}f@{args.width}x{args.height} "
                  f"({shape.token_count} tokens): host {res['host_ms']:.2f} ms/step, device "
                  f"{res['device_busy_ms']:.2f} ms/step ({groups}), idle share "
                  f"{res['idle_share']:.3f}; unprofiled wall {res['wall_ms']:.2f} ms/step",
                  flush=True)
    print(json.dumps({"gpu": gpu, "tokens": shape.token_count, "norm": args.norm,
                      "steps": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
