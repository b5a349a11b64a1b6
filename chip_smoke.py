"""Smoke run of the PyTorch/CUDA port (ltx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: the card's name and power limit, torch and CUDA versions,
     and the nvcc build of every kernel from the sources in this checkout;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it and at ragged ones, each output element
     within its stated tolerance (ltx_tpu_torch.checks), with timings; then
     the tiny pipeline on the card against the same weights on the CPU;
  3. the main path: LTXPipeline.generate_video at full width and depth
     (Gemma-3-12B, the text connector, the 48-block DiT, the VAE decoder;
     random bf16 weights from a seeded generator) at 25 frames, 768x512,
     8 distilled steps, with the kernel launch counts read around it;
  4. a JSON line of the kernels: launches, max error, kernel and plain ms;
  5. the last line, {"ok": true, "device": {...}}.

There is no fallback: without CUDA, or when a kernel fails to build, launch
or agree, the script raises and exits non-zero before the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ltx_tpu_torch import checks
from ltx_tpu_torch.config import GenerationConfig
from ltx_tpu_torch.kernels import build
from ltx_tpu_torch.kernels import flash_attention as fa
from ltx_tpu_torch.ops.latents import VideoLatentShape, generate_noise
from ltx_tpu_torch.pipeline.generate import LTXPipeline

PROMPT = "A beaver builds a dam in a mountain stream at golden hour"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median milliseconds of fn() on the card, CUDA events around each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def phase_environment() -> dict:
    log(f"[env] gpu: {gpu_name_and_power()}")
    log(f"[env] torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    seconds = build.build_all()
    log(f"[env] kernel build: {time.perf_counter() - t0:.2f} s "
        + json.dumps({k: round(v, 2) for k, v in seconds.items()}))
    for name in build.SOURCES:
        info = (build.BUILD_DIR / f"{name}.log")
        if info.is_file():
            for line in info.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[env] ptxas {name}: {line.strip()}")
    return seconds


def phase_kernels(device) -> dict:
    """flash_attention against flash_attention_reference at the path's
    shapes and the ragged ones (checks.ATTN_CASES, element-wise tolerance);
    returns the kernels-line entry (without launches)."""
    max_err = 0.0
    timings = {}
    for case in checks.ATTN_CASES:
        res = checks.check_attention(case, device)
        max_err = max(max_err, res["max_abs_err"])
        q, k, v, bias = checks.attention_inputs(case, device)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, bias, case.scale))
        plain = cuda_ms(
            lambda: fa.flash_attention_reference(q, k, v, bias, case.scale))
        timings[case.name] = (ms, plain)
        log(f"[kernel] flash_attention {case.name} q{(case.b, case.h, case.tq, case.d)}"
            f" k{(case.b, case.h, case.tk, case.d)} bias={'yes' if bias is not None else 'no'}:"
            f" max_abs_err {res['max_abs_err']:.3e}, {res['tol_share']:.3f} of its"
            f" element's tolerance, {res['rel_to_max']:.3e} of max|plain|;"
            f" kernel {ms:.4f} ms, plain {plain:.4f} ms")
    ms, plain = timings["dit_self_attn"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "ltx_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "ltx_tpu/kernels/flash_attention.py:124",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain}


def phase_tiny_agreement(device) -> None:
    """The tiny pipeline on the card against the same weights on the CPU."""
    res = checks.check_tiny_pipeline(device)
    log(f"[tiny] pipeline on the card vs the CPU: max abs err "
        f"{res['max_abs_err']:.3e} (tol {checks.TINY_FRAME_ATOL:.0e}), "
        f"{res['launches']} kernel launches")


def phase_main_path(device) -> int:
    """generate_video at full width and depth; returns the kernel launches."""
    t0 = time.perf_counter()
    pipe = LTXPipeline.random_full(device, seed=0)
    log(f"[main] random full-size weights (seeded, on the card, staged to the "
        f"host): {time.perf_counter() - t0:.2f} s")
    config = GenerationConfig(width=768, height=512, num_frames=25, num_steps=8,
                              seed=0)
    shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height,
                                         config.width, channels=pipe.tcfg.in_channels)
    noise = generate_noise(shape, torch.Generator(device=device).manual_seed(0))
    expected = (len(pipe._sigmas(config, shape)) - 1) * pipe.tcfg.num_layers * 2 \
        + pipe.tecfg.connector_layers

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    fa.flash_attention.launches = 0
    result = pipe.generate_video(PROMPT, config, noise)
    launches = fa.flash_attention.launches
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30

    tm = result.timings
    log(f"[main] {config.num_frames}f@{config.width}x{config.height}, latent "
        f"{shape.shape}, {len(tm.denoise_steps)} steps")
    log(f"[main] phases (s): staging {tm.staging:.3f}, gemma {tm.gemma:.3f}, "
        f"connector {tm.connector:.3f}, denoise {sum(tm.denoise_steps):.3f}, "
        f"vae_decode {tm.vae_decode:.3f}, total {tm.total:.3f}")
    log("[main] denoise steps (s): "
        + ", ".join(f"{s:.4f}" for s in tm.denoise_steps))
    log(f"[main] peak device memory: {peak_gib:.2f} GiB")
    frames = result.frames
    log(f"[main] frames {frames.shape} {frames.dtype}, mean {frames.mean():.4f}, "
        f"std {frames.std():.4f}, min {frames.min():.4f}, max {frames.max():.4f}")
    log(f"[main] flash_attention launches {launches} (expected {expected})")
    if frames.shape != (config.num_frames, config.height, config.width, 3):
        raise AssertionError(f"frames shape {frames.shape}")
    if not (np.isfinite(frames).all() and frames.min() >= 0.0 and frames.max() <= 1.0):
        raise AssertionError("frames are not finite values in [0, 1]")
    if launches != expected:
        raise AssertionError(f"flash_attention launched {launches}, expected {expected}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    device = torch.device("cuda", 0)
    phase_environment()
    entry = phase_kernels(device)
    phase_tiny_agreement(device)
    entry["launches"] = phase_main_path(device)
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
