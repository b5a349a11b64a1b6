"""Smoke run of the PyTorch/CUDA port (ltx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: the card's name and power limit, torch and CUDA versions,
     and the nvcc build of every kernel from the sources in this checkout
     (one nvcc per source, all started together);
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the paths give it and at ragged ones, each output element
     within its stated tolerance (ltx_tpu_torch.checks; dequant_int4 with 0
     error), with kernel, plain and library times and the card's bound;
     then the tiny pipeline on the card against the same weights on the CPU;
  3. the bf16 main path: LTXPipeline.generate_video at full width and depth
     (Gemma-3-12B, the text connector, the 48-block DiT, the VAE decoder;
     random bf16 weights from a seeded generator) at 25 frames, 768x512,
     8 distilled steps, with the kernel launch counts read around it;
  4. the int4 main path: the same DiT quantized to int4 in place on the
     card, the same generate_video and noise; every block linear through
     int4_matmul (8 steps x 48 blocks x 10);
  5. the big-M route: one int4 DiT call at 121 frames, 1024x576 (9216
     tokens), where the 9216-row linears go through dequant_int4 and a
     plain product and the 1024-row text K/V through int4_matmul;
  6. a JSON line of the kernels: launches (each from the path that runs
     it), max error, kernel, plain and library ms, the bound and what sets it;
  7. the last line, {"ok": true, "device": {...}}.

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
import torch.nn.functional as F

from ltx_tpu_torch import checks
from ltx_tpu_torch.config import GenerationConfig
from ltx_tpu_torch.kernels import build
from ltx_tpu_torch.kernels import flash_attention as fa
from ltx_tpu_torch.kernels import quantization as qz
from ltx_tpu_torch.models.common import QuantizedLinear
from ltx_tpu_torch.models.dit import quantize_transformer
from ltx_tpu_torch.ops.latents import VideoLatentShape, generate_noise
from ltx_tpu_torch.pipeline.denoise import GuidanceSpec, make_denoise_step
from ltx_tpu_torch.pipeline.generate import GenerationTimings, LTXPipeline

PROMPT = "A beaver builds a dam in a mountain stream at golden hour"
NORTH_STAR = GenerationConfig(width=768, height=512, num_frames=25, num_steps=8, seed=0)
BIG_M = GenerationConfig(width=1024, height=576, num_frames=121, num_steps=8, seed=0)

# the published peaks of one H100 SXM (dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


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


def bound(flops: float, nbytes: float):
    """(ms, "operations" | "bytes"): the least time the card could take, the
    larger of flops at the bf16 tensor-core peak and bytes at HBM's rate."""
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_flash_kernel(device) -> dict:
    """flash_attention against flash_attention_reference at the path's
    shapes and the ragged ones (checks.ATTN_CASES, element-wise tolerance);
    returns the kernels-line entry (without launches), timed at the DiT's
    self-attention."""
    max_err = 0.0
    timings = {}
    for case in checks.ATTN_CASES:
        res = checks.check_attention(case, device)
        max_err = max(max_err, res["max_abs_err"])
        q, k, v, bias = checks.attention_inputs(case, device)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, bias, case.scale))
        plain = cuda_ms(
            lambda: fa.flash_attention_reference(q, k, v, bias, case.scale))
        mask = None if bias is None else bias.to(q.dtype)
        library = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=case.scale))
        flops = 4.0 * case.b * case.h * case.tq * case.tk * case.d
        nbytes = 2.0 * case.b * case.h * case.d * (2 * case.tq + 2 * case.tk) \
            + (0 if bias is None else 4.0 * case.b * case.tk)
        bound_ms, bound_by = bound(flops, nbytes)
        timings[case.name] = (ms, plain, library, bound_ms, bound_by)
        log(f"[kernel] flash_attention {case.name} q{(case.b, case.h, case.tq, case.d)}"
            f" k{(case.b, case.h, case.tk, case.d)} bias={'yes' if bias is not None else 'no'}:"
            f" max_abs_err {res['max_abs_err']:.3e}, {res['tol_share']:.3f} of its"
            f" element's tolerance, {res['rel_to_max']:.3e} of max|plain|;"
            f" kernel {ms:.4f} ms, plain {plain:.4f} ms, library (sdpa) {library:.4f} ms,"
            f" bound {bound_ms:.4f} ms ({bound_by})")
    ms, plain, library, bound_ms, bound_by = timings["dit_self_attn"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "ltx_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "ltx_tpu/kernels/flash_attention.py:124",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library}


def int4_bytes(m: int, k: int, n: int, group: int) -> float:
    """X read, packed codes, scale and bias read, Y written."""
    return 2.0 * m * k + k * n / 2 + 2 * 4.0 * (k // group) * n + 2.0 * m * n


def phase_int4_kernels(device):
    """The routed int4 product (int4_matmul below 8192 rows, dequant_int4
    then a product from there on) against int4_matmul_reference at the
    path's shapes, ragged ones and the big-M ones (checks.INT4_CASES), and
    dequant_int4 against its plain version with 0 error at every weight
    shape the path dequantizes; returns the kernels-line entries (without
    launches), int4_matmul timed at the FF-in shape (1536 x 4096 -> 16384),
    dequant_int4 at its (4096, 16384) weight.
    Also quantize_weight of one full-size weight on the card against the
    CPU, bit for bit."""
    max_err = 0.0
    timings = {}
    for case in checks.INT4_CASES:
        res = checks.check_int4(case, device)
        max_err = max(max_err, res["max_abs_err"])
        x, qp = checks.int4_inputs(case, device)
        args = (qp["w_q4"], qp["scale"], qp["bias"])
        w = qz.dequant_int4_reference(*args)
        ms = cuda_ms(lambda: qz.int4_mm(x, *args))
        plain = cuda_ms(lambda: qz.int4_matmul_reference(x, *args))
        library = cuda_ms(lambda: F.linear(x, w.t()))
        bound_ms, bound_by = bound(2.0 * case.m * case.k * case.n,
                                   int4_bytes(case.m, case.k, case.n, case.group))
        timings[case.name] = (ms, plain, library, bound_ms, bound_by)
        route = "int4_matmul" if res["int4_matmul_launches"] else "dequant_int4 + matmul"
        log(f"[kernel] int4 {case.name} ({case.m}, {case.k}) x ({case.k}, {case.n})"
            f" group {case.group} via {route}: max_abs_err {res['max_abs_err']:.3e},"
            f" {res['tol_share']:.3f} of its element's tolerance; kernel {ms:.4f} ms,"
            f" plain {plain:.4f} ms, library (F.linear, bf16 W) {library:.4f} ms,"
            f" bound {bound_ms:.4f} ms ({bound_by})")
        del x, qp, args, w
    ms, plain, library, bound_ms, bound_by = timings["dit_ff_in"]
    matmul = {"name": "int4_matmul", "route": "cuda",
              "source": "ltx_tpu_torch/csrc/int4_matmul.cu",
              "replaces": "ltx_tpu/kernels/quantization.py:333",
              "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library}

    t0 = time.perf_counter()
    res = checks.check_quantize_on_device(device)
    log(f"[kernel] quantize_weight int4 of a {checks.FF_IN_SHAPE} bf16 weight on the "
        f"card vs the CPU: differing values {json.dumps(res)} "
        f"({time.perf_counter() - t0:.2f} s)")

    max_err = 0.0
    for k, n in checks.DEQUANT_SHAPES:
        res = checks.check_dequant(device, (k, n))
        max_err = max(max_err, res["max_abs_err"])
        qp = checks.int4_weights(k, n, 64, device)
        args = (qp["w_q4"], qp["scale"], qp["bias"])
        ms = cuda_ms(lambda: qz.dequant_int4(*args))
        plain = cuda_ms(lambda: qz.dequant_int4_reference(*args))
        nbytes = k * n / 2 + 2 * 4.0 * (k // 64) * n + 2.0 * k * n
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        timings[(k, n)] = (ms, plain, bound_ms)
        log(f"[kernel] dequant_int4 ({k // 2}, {n}) -> ({k}, {n}) bf16: max_abs_err "
            f"{res['max_abs_err']:.3e}, {res['mismatches']} values differ; kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound_ms:.4f} ms (bytes), "
            f"no library call")
        del qp, args
    ms, plain, bound_ms = timings[checks.FF_IN_SHAPE]
    dequant = {"name": "dequant_int4", "route": "cuda",
               "source": "ltx_tpu_torch/csrc/int4_matmul.cu",
               "replaces": "ltx_tpu/kernels/quantization.py:378",
               "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
               "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
    return matmul, dequant


def phase_tiny_agreement(device) -> None:
    """The tiny pipeline on the card against the same weights on the CPU."""
    res = checks.check_tiny_pipeline(device)
    log(f"[tiny] pipeline on the card vs the CPU: max abs err "
        f"{res['max_abs_err']:.3e} (tol {checks.TINY_FRAME_ATOL:.0e}), "
        f"{res['launches']} kernel launches")


KERNELS = {"flash_attention": fa.flash_attention, "int4_matmul": qz.int4_matmul,
           "dequant_int4": qz.dequant_int4}


def run_counted(fn):
    """fn() with every kernel's launch count set to 0 just before it and
    read just after; returns (fn's result, {kernel: launches})."""
    for kernel in KERNELS.values():
        kernel.launches = 0
    out = fn()
    return out, {name: kernel.launches for name, kernel in KERNELS.items()}


def check_launches(tag: str, launches: dict, expected: dict) -> None:
    log(f"[{tag}] launches {json.dumps(launches)} (expected {json.dumps(expected)})")
    if launches != expected:
        raise AssertionError(f"{tag}: launches {launches}, expected {expected}")


def north_star_run(tag: str, pipe: LTXPipeline, noise, expected: dict, device):
    """generate_video at the north star with the counts read around it;
    checks the frames and the counts and prints the phases. Returns the
    launches, and the result with the peak device memory in GiB."""
    config = NORTH_STAR
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    result, launches = run_counted(lambda: pipe.generate_video(PROMPT, config, noise))
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30

    tm = result.timings
    log(f"[{tag}] {config.num_frames}f@{config.width}x{config.height}, latent "
        f"{tuple(noise.shape)}, {len(tm.denoise_steps)} steps")
    log(f"[{tag}] phases (s): staging {tm.staging:.3f}, gemma {tm.gemma:.3f}, "
        f"connector {tm.connector:.3f}, denoise {sum(tm.denoise_steps):.3f}, "
        f"vae_decode {tm.vae_decode:.3f}, total {tm.total:.3f}")
    log(f"[{tag}] denoise steps (s): " + ", ".join(f"{s:.4f}" for s in tm.denoise_steps))
    log(f"[{tag}] peak device memory: {peak_gib:.2f} GiB")
    frames = result.frames
    log(f"[{tag}] frames {frames.shape} {frames.dtype}, mean {frames.mean():.4f}, "
        f"std {frames.std():.4f}, min {frames.min():.4f}, max {frames.max():.4f}")
    check_launches(tag, launches, expected)
    if frames.shape != (config.num_frames, config.height, config.width, 3):
        raise AssertionError(f"{tag}: frames shape {frames.shape}")
    if not (np.isfinite(frames).all() and frames.min() >= 0.0 and frames.max() <= 1.0):
        raise AssertionError(f"{tag}: frames are not finite values in [0, 1]")
    return launches, (result, peak_gib)


def phase_main_path(device):
    """generate_video at full width and depth in bf16; returns the pipeline,
    the noise, the number of denoise steps and the launches."""
    t0 = time.perf_counter()
    pipe = LTXPipeline.random_full(device, seed=0)
    log(f"[main] random full-size weights (seeded, on the card, staged to the "
        f"host): {time.perf_counter() - t0:.2f} s")
    shape = VideoLatentShape.from_pixels(1, NORTH_STAR.num_frames, NORTH_STAR.height,
                                         NORTH_STAR.width, channels=pipe.tcfg.in_channels)
    noise = generate_noise(shape, torch.Generator(device=device).manual_seed(0))
    steps = len(pipe._sigmas(NORTH_STAR, shape)) - 1
    expected = {"flash_attention": steps * pipe.tcfg.num_layers * 2
                + pipe.tecfg.connector_layers, "int4_matmul": 0, "dequant_int4": 0}
    return pipe, noise, steps, north_star_run("main", pipe, noise, expected, device)


def phase_int4_main_path(pipe: LTXPipeline, noise, steps: int, bf16_run, device) -> dict:
    """The same seeded DiT quantized to int4 (group 64) in place, layer by
    layer on the card, then the same generate_video: every block linear
    (attn1 and attn2 q/k/v/out, ff in/out) through int4_matmul. Prints the
    phases beside the bf16 run's; returns the launches."""
    t0 = time.perf_counter()
    quantize_transformer(pipe.transformer, bits=4, group_size=64, device=device)
    quantized = sum(isinstance(m, QuantizedLinear) for m in pipe.transformer.modules())
    nbytes = sum(p.numel() * p.element_size() for p in pipe.transformer.parameters())
    log(f"[int4] DiT quantized on the card, kept on the host: {quantized} linears, "
        f"{time.perf_counter() - t0:.2f} s; DiT now {nbytes / 1e9:.2f} GB")
    layers = pipe.tcfg.num_layers
    expected = {"flash_attention": steps * layers * 2 + pipe.tecfg.connector_layers,
                "int4_matmul": steps * layers * 10, "dequant_int4": 0}
    launches, int4_run = north_star_run("int4", pipe, noise, expected, device)
    for name, (result, peak) in (("bf16", bf16_run), ("int4", int4_run)):
        tm, frames = result.timings, result.frames
        log(f"[int4] beside bf16: {name} staging {tm.staging:.3f} s, denoise "
            f"{sum(tm.denoise_steps):.3f} s, total {tm.total:.3f} s, peak {peak:.2f} GiB, "
            f"frames mean {frames.mean():.4f} std {frames.std():.4f}")
    diff = np.abs(int4_run[0].frames - bf16_run[0].frames)
    log(f"[int4] frames int4 - bf16: max abs {diff.max():.4f}, mean abs {diff.mean():.4f}")
    return launches


def phase_big_m(pipe: LTXPipeline, device) -> dict:
    """One int4 DiT call at 121f@1024x576 (9216 latent tokens, a random
    1024-token context): the 9216-row linears (attn1 q/k/v/out, attn2
    q/out, ff in/out) dequantize once and run one plain product, the
    1024-row text K/V go through int4_matmul. No VAE decode."""
    shape = VideoLatentShape.from_pixels(1, BIG_M.num_frames, BIG_M.height, BIG_M.width,
                                         channels=pipe.tcfg.in_channels)
    gen = torch.Generator(device=device).manual_seed(1)
    latent = generate_noise(shape, gen)
    context = torch.randn(1, 1024, pipe.tcfg.caption_channels, generator=gen,
                          device=device).bfloat16()
    bias = torch.zeros(1, 1, 1, 1024, device=device)
    bias[..., :300] = -10000.0  # left padding, as the tokenizer pads
    transformer = pipe._on_device("transformer", GenerationTimings())
    step = make_denoise_step(transformer, GuidanceSpec.from_config(BIG_M), shape,
                             context, bias, fps=BIG_M.fps)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        (out, velocity), launches = run_counted(lambda: step(latent, 1.0, 0.9))
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    pipe._release("transformer")
    layers = pipe.tcfg.num_layers
    log(f"[bigm] {BIG_M.num_frames}f@{BIG_M.width}x{BIG_M.height}: {shape.token_count} "
        f"tokens, one int4 DiT call {seconds:.3f} s; velocity {tuple(velocity.shape)}, "
        f"mean {velocity.mean().item():.4f}, std {velocity.std().item():.4f}")
    check_launches("bigm", launches, {"flash_attention": layers * 2,
                                      "int4_matmul": layers * 2,
                                      "dequant_int4": layers * 8})
    if shape.token_count < qz.BIG_M_DEQUANT_THRESHOLD or \
            not (torch.isfinite(out).all() and torch.isfinite(velocity).all()):
        raise AssertionError("bigm: not a big-M shape, or non-finite output")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    device = torch.device("cuda", 0)
    phase_environment()
    flash = phase_flash_kernel(device)
    matmul, dequant = phase_int4_kernels(device)
    phase_tiny_agreement(device)
    pipe, noise, steps, (launches, bf16_run) = phase_main_path(device)
    flash["launches"] = launches["flash_attention"]
    matmul["launches"] = phase_int4_main_path(pipe, noise, steps, bf16_run,
                                              device)["int4_matmul"]
    dequant["launches"] = phase_big_m(pipe, device)["dequant_int4"]
    log(json.dumps({"kernels": [flash, matmul, dequant]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
