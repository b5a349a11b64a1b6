"""Smoke run of the PyTorch/CUDA port (ltx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: the card's name and power limit, torch and CUDA versions,
     and the nvcc build of every kernel from the sources in this checkout
     (one nvcc per source, all started together), with ptxas's registers
     and spills per kernel and the flash libraries' HGMMA counts;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the paths give it and at ragged ones, each output element
     within its stated tolerance (ltx_tpu_torch.checks; dequant_int4 with 0
     error), with kernel, plain and library times and the card's bound;
     the backward pair also bit for bit equal from run to run, its
     gradients in the inputs' layouts, and timed queued beside sdpa's
     backward;
     then the tiny pipeline, the tiny two-stage I2V pipeline (its norms
     through the rms_norm kernel) and the tiny LoRA train on the card
     against the same weights and draws on the CPU;
  3. the bf16 main path: LTXPipeline.generate_video at full width and depth
     (Gemma-3-12B, the text connector, the 48-block DiT, the VAE decoder;
     random bf16 weights from a seeded generator) at 25 frames, 768x512,
     8 distilled steps, with the kernel launch counts read around it;
  3b. the two-stage path, every model norm through the rms_norm kernel:
     LTXPipeline.generate_video_two_stage at full width and depth, I2V from
     a seeded pixel array through encode_image at half and at full
     resolution (the full-width VAE encoder), 121 frames at 1024x576: a
     guided stage 1 at 512x288 (CFG 4, STG on block 29, rescale 0.7: three
     rows a step, 8 steps), the full-width latent upscaler and AdaIN, a
     3-step stage 2 at 9216 tokens (two rows: STG stays, CFG goes), the
     conditioned frame re-noised every
     step, and a temporally tiled decode (8 latent frames a tile, overlap
     2, uint8 tiles) to exactly 121 frames;
  3c. the batched path: generate_videos with two prompts at 25f@768x512,
     each sample against its solo generate_video on the same noise; then
     one denoise step timed under both norm choices;
  4. the int4 main path: the same DiT quantized to int4 in place on the
     card, the same generate_video and noise; every block linear through
     int4_matmul (8 steps x 48 blocks x 10);
  5. the big-M route: one int4 DiT call at 121 frames, 1024x576 (9216
     tokens), where the 9216-row linears go through dequant_int4 and a
     plain product and the 1024-row text K/V through int4_matmul;
  6. the training path: `python -m ltx_tpu_torch.train.cli`'s `run` at full
     width and depth (the 48-block DiT, random and seeded, quantized to
     int4 and frozen, rank-16 LoRA on its 480 block linears) on a latent
     shard of two 25f@768x512 rows (1536 tokens) with 1024-token,
     left-padded text contexts: 4 steps with checkpoints, then a resume leg
     to step 6; every attention through the statistics forward and the two
     backward kernels, the int4 base through int4_matmul forward and
     dequant_int4 in its straight-through backward, with the launch counts
     read around every step; the checkpoint and the exported adapter read
     back. (Phase 2 also holds the tiny LoRA train on the card against the
     CPU, and the statistics and backward kernels against their plain
     versions.)
  7. a JSON line of the seven kernels: launches (each from the path that runs
     it), max error, kernel, plain and library ms, the bound and what sets
     it, and `timing`, the clock that read the times ("idle": CUDA events
     around each call on an idle card; "queued": the launches queued behind
     other work, over buffers rotated past the L2's size);
  8. the last line, {"ok": true, "device": {...}}.

There is no fallback: without CUDA, or when a kernel fails to build, launch
or agree, the script raises and exits non-zero before the last line.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ltx_tpu_torch import checks
from ltx_tpu_torch.config import GenerationConfig, TransformerConfig
from ltx_tpu_torch.kernels import build
from ltx_tpu_torch.kernels import flash_attention as fa
from ltx_tpu_torch.kernels import quantization as qz
from ltx_tpu_torch.kernels import rms_norm as rk
from ltx_tpu_torch.models.common import QuantizedLinear
from ltx_tpu_torch.models.dit import quantize_transformer
from ltx_tpu_torch.ops import schedule
from ltx_tpu_torch.ops.latents import VideoLatentShape, generate_noise
from ltx_tpu_torch.ops.normalization import set_rms_impl
from ltx_tpu_torch.pipeline.denoise import GuidanceSpec, make_denoise_step
from ltx_tpu_torch.pipeline.generate import GenerationTimings, LTXPipeline
from ltx_tpu_torch.train import cli as train_cli
from ltx_tpu_torch.train.data import write_shard
from ltx_tpu_torch.train.export import read_safetensors

PROMPT = "A beaver builds a dam in a mountain stream at golden hour"
NORTH_STAR = GenerationConfig(width=768, height=512, num_frames=25, num_steps=8, seed=0)
BIG_M = GenerationConfig(width=1024, height=576, num_frames=121, num_steps=8, seed=0)
TWO_STAGE = GenerationConfig(width=1024, height=576, num_frames=121, num_steps=8, seed=0,
                             cfg_scale=4.0, stg_scale=1.0, stg_blocks=(29,),
                             guidance_rescale=0.7, image_cond_noise_scale=0.15,
                             two_stage=True)
TWO_STAGE_TILE, TWO_STAGE_OVERLAP = 8, 2
BATCH_PROMPTS = (PROMPT, "A paper boat drifts down a rain-soaked street at dusk")
# a batched sample against its solo run, on frames in [0, 1]: the same bf16
# arithmetic, but the products of 3072 rows may sum in another order than
# those of 1536
BATCH_FRAME_ATOL = 5e-2

# the published peaks of one H100 SXM (dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
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


# more than twice the H100's 50 MB L2: what one turn through the rotated
# buffers of `queued_ms` must touch, so that no call finds its rows in cache
ROTATE_BYTES = 128 * 2**20


def rotated_sets(tensors, out_bytes: int):
    """Tuples of copies of a call's inputs (clones keep each view's
    strides), as many as make one turn through them (each call reading its
    copies and writing out_bytes) touch ROTATE_BYTES; at least two."""
    size = sum(t.numel() * t.element_size() for t in tensors) + out_bytes
    n = max(2, -(-ROTATE_BYTES // size))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


# 8192^3 bf16 matrix products (about 1.5 ms each) queued ahead of a timed
# run of `queued_ms`: longer than the host takes to enqueue 50 calls of the
# slowest function timed so (sdpa's backward through autograd)
LEAD_PRODUCTS = 32


def queued_ms(calls, reps: int = 50) -> float:
    """Milliseconds of one call on the card when the launches queue up behind
    earlier work, as they do inside a model step. `calls` are closures of
    the same function over different input buffers (`rotated_sets`), taken in
    turn, each result kept until its turn comes again, so that inputs and
    outputs come from device memory and not from L2. LEAD_PRODUCTS matrix
    products go first, so that the host has enqueued all `reps` calls
    before the first one starts, then one pair of CUDA events
    around the run, over the count; a line warns when the host took longer
    to enqueue the calls than the lead gave it. `cuda_ms` on an idle card
    reads the host's time to launch instead, which is most of what it shows
    for a kernel of a few microseconds."""
    n = len(calls)
    kept = [None] * n
    for i in range(max(3, n)):
        kept[i % n] = calls[i % n]()
    blocker = torch.zeros(8192, 8192, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    lead_start = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    lead_start.record()
    for _ in range(LEAD_PRODUCTS):
        torch.matmul(blocker, blocker)
    start.record()
    t0 = time.perf_counter()
    for i in range(reps):
        kept[i % n] = calls[i % n]()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    if enqueue_ms > lead_start.elapsed_time(start):
        log(f"[warn] queued_ms: the host took {enqueue_ms:.2f} ms to enqueue {reps} calls, "
            f"longer than the lead of {lead_start.elapsed_time(start):.2f} ms: the reading "
            "may include host time")
    return start.elapsed_time(end) / reps


def sass_count(name: str, opcode: str):
    """How many instructions of `opcode` the built library of source `name`
    holds (cuobjdump -sass), or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))], check=True,
                              capture_output=True, text=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return sum(opcode in line for line in sass.splitlines())


def _kernel_name(mangled: str) -> str:
    """A kernel's name and integer or bool template arguments from its
    mangled name, e.g. flash_fwd_kernel<128,1,0,0>."""
    for m in re.finditer(r"\d+", mangled):
        # the length prefix may follow other digits (a hash in the namespace)
        idents = (mangled[m.end():m.end() + int(m.group()[i:])] for i in range(len(m.group())))
        ident = next((s for s in idents if s.endswith("kernel")), "")
        if ident:
            args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[m.end() + len(ident):])
            vals = re.findall(r"L[ib](\d+)E", args.group(1)) if args else []
            return ident + (f"<{','.join(vals)}>" if vals else "")
    return mangled


def ptxas_report(log: str) -> list:
    """(kernel, registers, stack and spills) of every entry function in an
    `nvcc -Xptxas -v` log."""
    out, name, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spills = _kernel_name(line.split("'")[1]), ""
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            out.append((name, line.split(":", 1)[1].strip(), spills))
            name = None
    return out


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
            text = info.read_text()
            for kernel, registers, spills in ptxas_report(text):
                log(f"[env] ptxas {name} {kernel}: {registers}; {spills}")
            for line in text.splitlines():
                if "Potential Performance Loss" in line:
                    log(f"[env] ptxas {name}: {line.strip()}")
    # the flash kernels' consumers run at setmaxnreg 240 (ptxas reports the
    # launch's 168 a thread): their spill figures above are theirs
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        text = (build.BUILD_DIR / f"{name}.log").read_text() \
            if (build.BUILD_DIR / f"{name}.log").is_file() else ""
        report = ptxas_report(text)
        spilling = [k for k, _, spills in report
                    if not spills.startswith("0 bytes stack frame, 0 bytes spill")] \
            if report else ["(no build log)"]
        log(f"[env] {name}: {sass_count(name, 'HGMMA')} HGMMA instructions in its SASS "
            f"(wgmma), over its {len(report)} kernel instantiations; instantiations that "
            f"spill: {spilling or 'none'}")
    return seconds


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(ms, "operations" | "bytes"): the least time the card could take, the
    larger of flops at their type's peak (the bf16 tensor cores unless
    given) and bytes at HBM's rate."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_flash_kernel(device) -> dict:
    """flash_attention against flash_attention_reference at the path's
    shapes and the ragged ones (checks.ATTN_CASES, element-wise tolerance);
    returns the kernels-line entry (without launches), timed at the DiT's
    self-attention."""
    res = checks.check_pv_handoff(device)
    log(f"[kernel] flash_attention P hand-off (bf16(q k^T) as wgmma's register operand"
        f" of P V, one 128 x 128 tile): max_abs_err {res['max_abs_err']:.3e} of max"
        f" {res['max_abs']:.1f}, {res['tol_share']:.3f} of its element's tolerance")
    max_err = 0.0
    timings = {}
    for case in checks.ATTN_CASES:
        res = checks.check_attention(case, device)
        max_err = max(max_err, res["max_abs_err"])
        q, k, v, bias = checks.attention_inputs(case, device)
        flops = 4.0 * case.b * case.h * case.tq * case.tk * case.d
        # fewer turns at the shapes that take milliseconds
        turns = dict(warmup=1, iters=5) if flops > 1e11 else {}
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, bias, case.scale), **turns)
        plain = cuda_ms(lambda: checks.attention_reference_by_heads(q, k, v, bias,
                                                                    case.scale), **turns)
        mask = None if bias is None else bias.to(q.dtype)
        library = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=case.scale), **turns)
        nbytes = 2.0 * case.b * case.h * case.d * (2 * case.tq + 2 * case.tk) \
            + (0 if bias is None else 4.0 * case.b * case.tk)
        bound_ms, bound_by = bound(flops, nbytes)
        timings[case.name] = (ms, plain, library, bound_ms, bound_by)
        log(f"[kernel] flash_attention {case.name} q{(case.b, case.h, case.tq, case.d)}"
            f" k{(case.b, case.h, case.tk, case.d)} masked keys={case.pad}"
            f"{' (head)' if case.pad_left else ''} layout {case.layout}:"
            f" max_abs_err {res['max_abs_err']:.3e}, {res['tol_share']:.3f} of its"
            f" element's tolerance, {res['rel_to_max']:.3e} of max|plain|;"
            f" kernel {ms:.4f} ms, plain {plain:.4f} ms, library (sdpa) {library:.4f} ms,"
            f" bound {bound_ms:.4f} ms ({bound_by}); {flops / ms * 1e-9:.1f} TFLOP/s,"
            f" {bound_ms / ms:.3f} of the bound, {ms / library:.2f}x sdpa")
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


def sdpa_backward_calls(sets, mask, scale) -> list:
    """The library yardstick of the backward: one closure per input set
    (q, k, v, dO) running scaled_dot_product_attention's backward alone, its
    forward run once beforehand with the graph kept, for `queued_ms`."""
    calls = []
    for q, k, v, do in sets:
        ins = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(*ins, attn_mask=mask, scale=scale)
        calls.append(lambda out=out, ins=ins, do=do: torch.autograd.grad(
            out, ins, do, retain_graph=True))
    return calls


def phase_flash_training_kernels(device):
    """The statistics forward (B2) and the two backward kernels (B3) against
    their plain versions at the training path's shapes and the ragged ones
    (checks.BWD_CASES, element-wise tolerances, exact zeros on -1e30 masked
    keys, gradients in the inputs' layouts; a miss of checks.STANDING_MISSES
    is printed as a standing failure and does not stop the run), and two
    runs of the backward bitwise equal at the path's shapes
    (checks.DETERMINISM_CASES); returns
    the kernels-line entries (without launches), timed at the DiT's
    self-attention. The backward kernels and sdpa's backward are timed by
    `queued_ms` (launches queued as in a train step, over inputs rotated
    past the L2's size), each kernel's idle-card `cuda_ms` beside them; the
    plain time is the whole plain backward's (one function computing dQ, dK
    and dV together), on an idle card."""
    errs = {"stats": 0.0, "dq": 0.0, "dkv": 0.0}
    timings = {}
    for case in checks.BWD_CASES:
        st = checks.check_stats(case, device, hold_out=case.name not in checks.STANDING_MISSES)
        if st["tol_share"] > 1.0:
            log(f"[FAIL, standing] flash_attention_stats {case.name}: out at "
                f"{st['tol_share']:.3f} of the element bound 2**-8 * (P @ |V|) + 2 ulp, which "
                "takes each bf16 rounding of P as 2**-9 (checks.STANDING_MISSES)")
        bw = checks.check_backward(case, device)
        errs["stats"] = max(errs["stats"], st["max_abs_err"])
        errs["dq"] = max(errs["dq"], bw["dq"]["max_abs_err"])
        errs["dkv"] = max(errs["dkv"], bw["dk"]["max_abs_err"], bw["dv"]["max_abs_err"])
        q, k, v, do, bias, o, lse = checks.backward_inputs(case, device)
        b, h, tq, tk, d = case.b, case.h, case.tq, case.tk, case.d
        scale = case.scale if case.scale is not None else d**-0.5
        mask = None if bias is None else bias.to(q.dtype)
        work = b * h * tq * tk * d
        io = 2.0 * b * h * d * (tq + tk) + (0 if bias is None else 4.0 * b * tk)
        # the forward: read q, k, v, write o; the statistics 8 bytes a row
        s_ms = cuda_ms(lambda: fa.flash_attention_stats(q, k, v, bias, case.scale))
        s_plain = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, bias, case.scale,
                                                               return_stats=True))
        s_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                               scale=case.scale))
        s_bound = bound(4.0 * work, io + 2.0 * b * h * tq * d + 8.0 * b * h * tq)
        # the backward: delta as the wrapper computes it, then each kernel;
        # dq reads q, k, v, dO, lse, delta and writes dQ (S, dP, dQ: 6 flops
        # per (q, k, d)); dkv reads the same and writes dK, dV (S, dP, dV,
        # dK: 8); the pair's essential work is 10 (S and dP once)
        kb = fa.key_bias(bias, b, tk)
        kb = None if kb is None else kb.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        rows = 2.0 * b * h * tq * d + 8.0 * b * h * tq
        sets = rotated_sets((q, k, v, do, lse, delta), 2 * q.numel() + 4 * k.numel())
        dq_ms = queued_ms([lambda s=s: fa.flash_attention_bwd_dq(*s[:3], kb, *s[3:], scale)
                           for s in sets])
        dkv_ms = queued_ms([lambda s=s: fa.flash_attention_bwd_dkv(*s[:3], kb, *s[3:], scale)
                            for s in sets])
        dq_idle = cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, kb, do, lse, delta, scale))
        dkv_idle = cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, kb, do, lse, delta,
                                                              scale))
        b_plain = cuda_ms(lambda: fa.flash_attention_backward_reference(
            q, k, v, bias, o, lse, do, case.scale))
        b_lib = queued_ms(sdpa_backward_calls([s[:4] for s in sets], mask, case.scale))
        del sets
        dq_bound = bound(6.0 * work, io + rows + 2.0 * b * h * tq * d)
        dkv_bound = bound(8.0 * work, io + rows + 4.0 * b * h * tk * d)
        pair_bound = bound(10.0 * work, io + rows + 2.0 * b * h * d * (tq + 2 * tk))
        timings[case.name] = (s_ms, s_plain, s_lib, s_bound, dq_ms, dkv_ms, b_plain, b_lib,
                              dq_bound, dkv_bound, dq_idle, dkv_idle)
        pair = dq_ms + dkv_ms
        log(f"[kernel] flash_attention_stats {case.name} q{(b, h, tq, d)} k{(b, h, tk, d)} "
            f"bias={case.bias} layout {case.layout}: max_abs_err {st['max_abs_err']:.3e}, out "
            f"{st['tol_share']:.3f}, m {st['m_share']:.3f}, l {st['l_share']:.3f} of their "
            f"tolerances; kernel {s_ms:.4f} ms, plain {s_plain:.4f} ms, library (sdpa fwd) "
            f"{s_lib:.4f} ms, bound {s_bound[0]:.4f} ms ({s_bound[1]});"
            f" {4.0 * work / s_ms * 1e-9:.1f} TFLOP/s, {s_bound[0] / s_ms:.3f} of the bound,"
            f" {s_ms / s_lib:.2f}x sdpa's forward")
        log(f"[kernel] flash_attention backward {case.name} layout {case.layout}: dq err "
            f"{bw['dq']['max_abs_err']:.3e} ({bw['dq']['tol_share']:.3f} of its tolerance),"
            f" dk {bw['dk']['max_abs_err']:.3e} ({bw['dk']['tol_share']:.3f}), dv "
            f"{bw['dv']['max_abs_err']:.3e} ({bw['dv']['tol_share']:.3f})"
            + (f", masked keys nonzero {bw['masked_nonzero']}" if "masked_nonzero" in bw
               else "")
            + f"; queued: dq kernel {dq_ms:.4f} ms ({dq_idle:.4f} from an idle card; bound "
            f"{dq_bound[0]:.4f}, {dq_bound[0] / dq_ms:.3f} of it, "
            f"{6.0 * work / dq_ms * 1e-9:.1f} TFLOP/s), dkv kernel {dkv_ms:.4f} ms "
            f"({dkv_idle:.4f}; bound {dkv_bound[0]:.4f}, {dkv_bound[0] / dkv_ms:.3f} of it, "
            f"{8.0 * work / dkv_ms * 1e-9:.1f} TFLOP/s), pair {pair:.4f} ms (bound "
            f"{pair_bound[0]:.4f}, {pair_bound[1]}; {10.0 * work / pair * 1e-9:.1f} TFLOP/s of"
            f" essential work); library (sdpa's backward, queued) {b_lib:.4f} ms: dq "
            f"{dq_ms / b_lib:.2f}x, dkv {dkv_ms / b_lib:.2f}x, pair {pair / b_lib:.2f}x; plain"
            f" backward {b_plain:.4f} ms")
        del q, k, v, do, bias, o, lse, delta
    for name in checks.DETERMINISM_CASES:
        case = next(c for c in checks.BWD_CASES if c.name == name)
        res = checks.check_backward_deterministic(case, device)
        log(f"[kernel] flash_attention backward {name}: two runs, differing values "
            f"{json.dumps(res)} (bitwise equal)")
    (s_ms, s_plain, s_lib, s_bound, dq_ms, dkv_ms, b_plain, b_lib, dq_bound,
     dkv_bound, dq_idle, dkv_idle) = timings["dit_self_attn"]
    src = "ltx_tpu_torch/csrc/flash_attention_bwd.cu"
    return [
        {"name": "flash_attention_stats", "route": "cuda",
         "source": "ltx_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "ltx_tpu/kernels/flash_attention.py:124", "max_abs_err": errs["stats"],
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound[0], "bound_by": s_bound[1],
         "library_ms": s_lib},
        {"name": "flash_attention_bwd_dq", "route": "cuda", "source": src,
         "replaces": "ltx_tpu/kernels/flash_attention.py:347", "max_abs_err": errs["dq"],
         "ms": dq_ms, "plain_ms": b_plain, "bound_ms": dq_bound[0], "bound_by": dq_bound[1],
         "library_ms": b_lib, "timing": "queued", "idle_ms": dq_idle},
        {"name": "flash_attention_bwd_dkv", "route": "cuda", "source": src,
         "replaces": "ltx_tpu/kernels/flash_attention.py:347", "max_abs_err": errs["dkv"],
         "ms": dkv_ms, "plain_ms": b_plain, "bound_ms": dkv_bound[0],
         "bound_by": dkv_bound[1], "library_ms": b_lib, "timing": "queued",
         "idle_ms": dkv_idle},
    ]


RMS_LINE_CASE = "dit_stage1_qk"  # the kernels line's shape: three rows of 2304 tokens


def phase_rms_kernel(device) -> dict:
    """rms_norm against rms_norm_reference at the two-stage and north-star
    paths' shapes and at ragged ones (checks.RMS_CASES, element-wise
    tolerance), each with kernel, plain and library (F.rms_norm, timed and
    never called by the port) times and the bound by bytes: x read once, the
    output written once. The times are `queued_ms`'s (the device's, the
    launches queued as in a DiT step, over buffers rotated past the L2's
    size); the kernel's `cuda_ms` on an idle card, which adds the host's
    launch time, is printed beside them and kept as `idle_ms`.
    Returns the kernels-line entry (without launches), timed at stage 1's
    weighted norm."""
    max_err = 0.0
    timings = {}
    for case in checks.RMS_CASES:
        res = checks.check_rms(case, device)
        max_err = max(max_err, res["max_abs_err"])
        x, w = checks.rms_inputs(case, device)
        xs = [s[0] for s in rotated_sets((x,), x.numel() * x.element_size())]
        ms = queued_ms([lambda t=t: rk.rms_norm(t, w) for t in xs])
        idle_ms = cuda_ms(lambda: rk.rms_norm(x, w))
        plain = queued_ms([lambda t=t: rk.rms_norm_reference(t, w) for t in xs])
        w_lib = None if w is None else w.to(x.dtype)
        library = queued_ms([lambda t=t: F.rms_norm(t, (case.d,), w_lib, 1e-6) for t in xs])
        del xs
        nbytes = 2.0 * x.numel() * x.element_size() \
            + (0 if w is None else w.numel() * w.element_size())
        # a square and an add, then one or two products a value, all f32
        bound_ms, bound_by = bound(4.0 * x.numel(), nbytes, PEAK_F32_FLOPS)
        timings[case.name] = (ms, plain, library, bound_ms, bound_by, idle_ms)
        log(f"[kernel] rms_norm {case.name} ({case.rows}, {case.d}) {case.dtype} "
            f"weight={case.weight}: max_abs_err {res['max_abs_err']:.3e}, "
            f"{res['tol_share']:.3f} of its element's tolerance, "
            f"{res['differ_share']:.3e} of the elements differ from plain; kernel "
            f"{ms:.4f} ms ({idle_ms:.4f} ms from an idle card), plain {plain:.4f} ms, "
            f"library (F.rms_norm) {library:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    ms, plain, library, bound_ms, bound_by, idle_ms = timings[RMS_LINE_CASE]
    return {"name": "rms_norm", "route": "cuda",
            "source": "ltx_tpu_torch/csrc/rms_norm.cu",
            "replaces": "ltx_tpu/kernels/rms_norm.py:48",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library,
            "timing": "queued", "idle_ms": idle_ms}


def phase_tiny_agreement(device) -> None:
    """The tiny pipeline, the tiny two-stage I2V pipeline and the tiny LoRA
    train on the card against the same weights on the CPU."""
    res = checks.check_tiny_pipeline(device)
    log(f"[tiny] pipeline on the card vs the CPU: max abs err "
        f"{res['max_abs_err']:.3e} (tol {checks.TINY_FRAME_ATOL:.0e}), "
        f"{res['launches']} kernel launches")
    res = checks.check_tiny_two_stage(device)
    log(f"[tiny] two-stage I2V pipeline (guided stage 1, upscaler, refine, tiled uint8 "
        f"decode; norms through the rms_norm kernel) on the card vs the CPU: max abs err "
        f"{res['max_abs_err']:.3e}, mean {res['mean_abs_err']:.3e} (tol "
        f"{checks.TINY_FRAME_ATOL:.0e}); launches {json.dumps(res['launches'])}")
    for dtype, how in ((torch.bfloat16, "bf16"),
                       (torch.float32, "f32 compute, attention cast to bf16 on the card")):
        res = checks.check_tiny_train(device, dtype)
        log(f"[tiny] LoRA train ({checks.TINY_TRAIN_STEPS} steps, {how}) on the card vs the "
            f"CPU: first-backward LoRA gradients {res['grad_rel']:.3e}, losses "
            f"{res['loss_rel']:.3e}, LoRA leaves after the steps {res['lora_rel']:.3e} "
            f"(relative, tol {checks.TINY_TRAIN_TOL:.0e}, the bf16 run's); launches "
            f"{json.dumps(res['launches'])}")


KERNELS = {"flash_attention": fa.flash_attention,
           "flash_attention_stats": fa.flash_attention_stats,
           "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
           "int4_matmul": qz.int4_matmul, "dequant_int4": qz.dequant_int4,
           "rms_norm": rk.rms_norm}


NO_LAUNCHES = {name: 0 for name in KERNELS}


def reset_counts() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def read_counts() -> dict:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def run_counted(fn):
    """fn() with every kernel's launch count set to 0 just before it and
    read just after; returns (fn's result, {kernel: launches})."""
    reset_counts()
    out = fn()
    return out, read_counts()


def check_launches(tag: str, launches: dict, expected: dict) -> None:
    log(f"[{tag}] launches {json.dumps(launches)} (expected {json.dumps(expected)})")
    if launches != expected:
        raise AssertionError(f"{tag}: launches {launches}, expected {expected}")


def check_frames(tag: str, frames, config: GenerationConfig) -> None:
    log(f"[{tag}] frames {frames.shape} {frames.dtype}, mean {frames.mean():.4f}, "
        f"std {frames.std():.4f}, min {frames.min():.4f}, max {frames.max():.4f}")
    if frames.shape != (config.num_frames, config.height, config.width, 3):
        raise AssertionError(f"{tag}: frames shape {frames.shape}")
    if not (np.isfinite(frames).all() and frames.min() >= 0.0 and frames.max() <= 1.0):
        raise AssertionError(f"{tag}: frames are not finite values in [0, 1]")
    if not frames.std() > 0.0:
        raise AssertionError(f"{tag}: frames are constant")


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
    check_launches(tag, launches, expected)
    check_frames(tag, result.frames, config)
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
    expected = {**NO_LAUNCHES, "flash_attention": steps * pipe.tcfg.num_layers * 2
                + pipe.tecfg.connector_layers}
    return pipe, noise, steps, north_star_run("main", pipe, noise, expected, device)


def phase_two_stage(pipe: LTXPipeline, device) -> dict:
    """generate_video_two_stage at full width and depth, I2V, guided stage
    1, tiled decode, with every model norm through the rms_norm kernel.
    Checks the launches of flash_attention and rms_norm against the counts
    the code implies, and the frames. Returns the launches."""
    config = TWO_STAGE
    tcfg, tecfg = pipe.tcfg, pipe.tecfg
    c = tcfg.in_channels
    s1 = VideoLatentShape.from_pixels(1, config.num_frames, config.height // 2,
                                      config.width // 2, channels=c)
    s2 = VideoLatentShape.from_pixels(1, config.num_frames, config.height, config.width,
                                      channels=c)
    n1 = len(schedule.get_sigmas(config.num_steps, distilled=False,
                                 token_count=s1.token_count)) - 1
    n2 = len(schedule.STAGE_2_SIGMAS) - 1
    dit_calls = n1 + n2
    expected = {**NO_LAUNCHES,
                "flash_attention": dit_calls * tcfg.num_layers * 2 + tecfg.connector_layers,
                "rms_norm": dit_calls * checks.rms_launches_per_dit_call(tcfg)
                + checks.rms_launches_per_encode(tecfg)}
    gen = torch.Generator(device=device).manual_seed(7)
    image = torch.rand(1, 3, 1, config.height, config.width, generator=gen,
                       device=device) * 2 - 1
    half_image = F.interpolate(image[:, :, 0], scale_factor=0.5, mode="bilinear")[:, :, None]
    memory = pipe.memory
    pipe.memory = dataclasses.replace(memory, vae_tile_size=TWO_STAGE_TILE,
                                      vae_tile_overlap=TWO_STAGE_OVERLAP)
    tiles = pipe.decode_tile_frames(s2.frames)
    log(f"[two-stage] {config.num_frames}f@{config.width}x{config.height} I2V: stage 1 "
        f"{s1.token_count} tokens x {GuidanceSpec.from_config(config).num_rows} rows, {n1} "
        f"steps; stage 2 {s2.token_count} tokens x "
        f"{GuidanceSpec.from_config(config, use_cfg=False).num_rows} rows (no CFG, STG "
        f"kept), {n2} steps; decode tiles of "
        f"{tiles} latent frames; expected launches {json.dumps(expected)}")
    set_rms_impl("cuda")
    try:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        enc = GenerationTimings()
        half = pipe.encode_image(half_image, enc)
        full = pipe.encode_image(image, enc)
        draws = dict(
            stage1_noise=generate_noise(s1, gen), stage2_noise=generate_noise(s2, gen),
            stage1_cond_noise=[torch.randn(half.shape, generator=gen, device=device)
                               for _ in range(n1)],
            stage2_cond_noise=[torch.randn(full.shape, generator=gen, device=device)
                               for _ in range(n2)])
        result, launches = run_counted(lambda: pipe.generate_video_two_stage(
            PROMPT, config, image_latent=half, full_res_image_latent=full, **draws))
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    finally:
        set_rms_impl("torch")
        pipe.memory = memory
    tm = result.timings
    log(f"[two-stage] image latents {tuple(half.shape)} and {tuple(full.shape)}: encoder "
        f"staging {enc.staging:.3f} s, image encode {enc.image_encode:.3f} s")
    log(f"[two-stage] phases (s): staging {tm.staging:.3f}, gemma {tm.gemma:.3f}, "
        f"connector {tm.connector:.3f}, stage 1 {sum(tm.denoise_steps[:n1]):.3f}, upscale "
        f"{tm.upscale:.3f}, stage 2 {sum(tm.denoise_steps[n1:]):.3f}, vae_decode "
        f"{tm.vae_decode:.3f}, total {tm.total:.3f}")
    log("[two-stage] denoise steps (s): "
        + ", ".join(f"{s:.4f}" for s in tm.denoise_steps))
    log(f"[two-stage] peak device memory: {peak_gib:.2f} GiB")
    check_launches("two-stage", launches, expected)
    if len(tm.denoise_steps) != dit_calls:
        raise AssertionError(f"two-stage: {len(tm.denoise_steps)} denoise steps")
    check_frames("two-stage", result.frames, config)
    return launches


def phase_batched(pipe: LTXPipeline, device) -> None:
    """generate_videos with two prompts at the north star, then each prompt
    alone through generate_video on the same noise: each batched sample
    within BATCH_FRAME_ATOL of its solo run; the norms through the rms_norm
    kernel in all three."""
    config = NORTH_STAR
    shape = VideoLatentShape.from_pixels(len(BATCH_PROMPTS), config.num_frames,
                                         config.height, config.width,
                                         channels=pipe.tcfg.in_channels)
    noise = generate_noise(shape, torch.Generator(device=device).manual_seed(3))
    steps = len(pipe._sigmas(config, shape)) - 1
    expected = {**NO_LAUNCHES, "flash_attention": steps * pipe.tcfg.num_layers * 2
                + pipe.tecfg.connector_layers,
                "rms_norm": steps * checks.rms_launches_per_dit_call(pipe.tcfg)
                + checks.rms_launches_per_encode(pipe.tecfg)}
    set_rms_impl("cuda")
    try:
        _batched_and_solo(pipe, config, noise, expected, device)
    finally:
        set_rms_impl("torch")


def _batched_and_solo(pipe, config, noise, expected, device) -> None:
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    results, launches = run_counted(
        lambda: pipe.generate_videos(BATCH_PROMPTS, config, noise))
    seconds = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    tm = results[0].timings
    log(f"[batched] {len(BATCH_PROMPTS)} prompts, {config.num_frames}f@{config.width}x"
        f"{config.height}: {seconds:.3f} s in all; per prompt staging {tm.staging:.3f}, "
        f"gemma {tm.gemma:.3f}, connector {tm.connector:.3f}, denoise "
        f"{sum(tm.denoise_steps):.3f}, vae_decode {tm.vae_decode:.3f}; peak "
        f"{peak_gib:.2f} GiB")
    check_launches("batched", launches, expected)
    for i, (prompt, batched) in enumerate(zip(BATCH_PROMPTS, results)):
        check_frames(f"batched {i}", batched.frames, config)
        solo = pipe.generate_video(prompt, config, noise[i:i + 1])
        diff = np.abs(batched.frames - solo.frames)
        log(f"[batched] sample {i} vs its solo generate_video ({solo.timings.total:.3f} s):"
            f" max abs {diff.max():.3e}, mean abs {diff.mean():.3e} "
            f"(tol {BATCH_FRAME_ATOL:.0e})")
        if not diff.max() <= BATCH_FRAME_ATOL:
            raise AssertionError(f"batched sample {i} differs from its solo run by "
                                 f"{diff.max()}")
    first_differing_sublayer(pipe, config, device)


def _recorded(name: str) -> bool:
    """The sub-layers whose solo outputs `first_difference` keeps: everything
    outside a model's layer list, every module of its first layer, and each
    layer's output (a few GB at most)."""
    parts = name.split(".")
    index = next((i for i, part in enumerate(parts) if part.isdigit()), None)
    return index is None or parts[index] == "0" or len(parts) == index + 1


def first_difference(models: dict, solo, batched):
    """Forward hooks on every sub-layer of `models` ({prefix: module}); runs
    solo() and then batched(), which must give row 0 the same inputs, and
    returns (the first sub-layer, in the order they finish, whose row-0
    output is not bit for bit the solo one, as (name, output shape, max abs
    diff, max abs of the solo output, how many recorded outputs came before
    it), or None; solo's result; batched's result)."""
    names = {m: f"{prefix}.{n}" if n else prefix
             for prefix, model in models.items() for n, m in model.named_modules()}
    kept, order, first = {}, [], []

    def keep(module, _, out):
        out = out[0] if isinstance(out, tuple) else out
        name = names[module]
        if isinstance(out, torch.Tensor) and _recorded(name):
            kept[name] = out.detach().clone()
            order.append(name)

    def compare(module, _, out):
        out = out[0] if isinstance(out, tuple) else out
        name = names[module]
        if first or name not in kept or not isinstance(out, torch.Tensor):
            return
        want = kept[name]
        got = out[:want.shape[0]]  # row 0's part, whether (B, ...) or (B * T, ...)
        if got.shape == want.shape and not torch.equal(got, want):
            first.append((name, tuple(out.shape),
                          (got.float() - want.float()).abs().max().item(),
                          want.float().abs().max().item(), order.index(name)))

    results = []
    for hook, run in ((keep, solo), (compare, batched)):
        handles = [m.register_forward_hook(hook) for m in names]
        try:
            with torch.inference_mode():
                results.append(run())
        finally:
            for h in handles:
                h.remove()
    return (first[0] if first else None), results[0], results[1]


def _log_difference(what: str, first, tail: str) -> None:
    if first is None:
        log(f"[batched] {what}: no recorded sub-layer output differs, batched vs solo; {tail}")
        return
    name, out_shape, diff, scale, index = first
    log(f"[batched] {what}: first sub-layer whose row-0 output differs, batched vs solo: "
        f"{name} (output {out_shape}, max abs diff {diff:.3e} of max {scale:.3e}; the "
        f"{index} recorded sub-layer outputs before it equal bit for bit); {tail}")


def first_differing_sublayer(pipe: LTXPipeline, config: GenerationConfig, device) -> None:
    """Where batched and solo first part, on one line each: the text pass
    (Gemma and the connector) on the two prompts against the first alone,
    and one bf16 DiT call (a denoise step) on two rows, two latents and two
    text contexts against the first row alone, with forward hooks on every
    sub-layer."""
    first, solo, both = first_difference(
        {"gemma": pipe.gemma, "text_encoder": pipe.text_encoder},
        lambda: pipe.encode_prompts(BATCH_PROMPTS[:1]),
        lambda: pipe.encode_prompts(BATCH_PROMPTS))
    diff = (both[0]["video"].float() - solo[0]["video"].float()).abs().max().item()
    _log_difference("text pass", first, f"the first prompt's context differs by {diff:.3e}")

    tcfg = pipe.tcfg
    shape = VideoLatentShape.from_pixels(2, config.num_frames, config.height, config.width,
                                         channels=tcfg.in_channels)
    gen = torch.Generator(device=device).manual_seed(5)
    latent = generate_noise(shape, gen)
    context = torch.randn(2, 1024, tcfg.caption_channels, generator=gen,
                          device=device).bfloat16()
    bias = torch.zeros(2, 1, 1, 1024, device=device)
    bias[0, ..., :300] = -10000.0
    bias[1, ..., :500] = -10000.0
    transformer = pipe._on_device("transformer", GenerationTimings())
    guidance = GuidanceSpec.from_config(config)
    try:
        first, (_, v_solo), (_, v_both) = first_difference(
            {"dit": transformer},
            lambda: make_denoise_step(transformer, guidance,
                                      dataclasses.replace(shape, batch=1), context[:1],
                                      bias[:1], fps=config.fps)(latent[:1], 1.0, 0.9),
            lambda: make_denoise_step(transformer, guidance, shape, context, bias,
                                      fps=config.fps)(latent, 1.0, 0.9))
        torch.cuda.synchronize(device)
    finally:
        pipe._release("transformer")
    diff = (v_both[:1].float() - v_solo.float()).abs().max().item()
    _log_difference("one DiT call", first, f"the velocity differs by {diff:.3e}")


def phase_norm_choice(pipe: LTXPipeline, device) -> None:
    """One bf16 north-star denoise step under both norm choices: the plain
    chain, the kernel, the kernel, the plain chain; three synchronised
    steps each after one warm-up, with the rms_norm launches of a step."""
    config = NORTH_STAR
    shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height,
                                         config.width, channels=pipe.tcfg.in_channels)
    gen = torch.Generator(device=device).manual_seed(1)
    latent = generate_noise(shape, gen)
    context = torch.randn(1, 1024, pipe.tcfg.caption_channels, generator=gen,
                          device=device).bfloat16()
    bias = torch.zeros(1, 1, 1, 1024, device=device)
    bias[..., :300] = -10000.0
    transformer = pipe._on_device("transformer", GenerationTimings())
    step = make_denoise_step(transformer, GuidanceSpec.from_config(config), shape,
                             context, bias, fps=config.fps)
    times = {"torch": [], "cuda": []}
    outs = {}
    try:
        for impl in ("torch", "cuda", "cuda", "torch"):
            set_rms_impl(impl)
            with torch.inference_mode():
                step(latent, 1.0, 0.9)
                torch.cuda.synchronize(device)
                for _ in range(3):
                    t0 = time.perf_counter()
                    (_, velocity), launches = run_counted(lambda: step(latent, 1.0, 0.9))
                    torch.cuda.synchronize(device)
                    times[impl].append(time.perf_counter() - t0)
            outs[impl] = velocity
            want = checks.rms_launches_per_dit_call(pipe.tcfg) if impl == "cuda" else 0
            if launches["rms_norm"] != want:
                raise AssertionError(f"norm choice {impl}: {launches['rms_norm']} rms_norm "
                                     f"launches in a step, expected {want}")
    finally:
        set_rms_impl("torch")
        pipe._release("transformer")
    diff = (outs["cuda"] - outs["torch"]).abs().max().item()
    scale = outs["torch"].abs().max().item()
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    log(f"[norm] one bf16 denoise step at {shape.token_count} tokens: plain chain "
        f"{med['torch'] * 1e3:.2f} ms, rms_norm kernel {med['cuda'] * 1e3:.2f} ms (medians "
        f"of 6 synchronised steps each; all: "
        + json.dumps({k: [round(t * 1e3, 2) for t in v] for k, v in times.items()})
        + f"); velocity differs by {diff:.3e} of max {scale:.3e}")
    if not (np.isfinite(diff) and diff <= 5e-2 * scale):
        raise AssertionError(f"norm choice: velocities differ by {diff} (max {scale})")


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
    expected = {**NO_LAUNCHES, "flash_attention": steps * layers * 2
                + pipe.tecfg.connector_layers, "int4_matmul": steps * layers * 10}
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
    check_launches("bigm", launches, {**NO_LAUNCHES, "flash_attention": layers * 2,
                                      "int4_matmul": layers * 2,
                                      "dequant_int4": layers * 8})
    if shape.token_count < qz.BIG_M_DEQUANT_THRESHOLD or \
            not (torch.isfinite(out).all() and torch.isfinite(velocity).all()):
        raise AssertionError("bigm: not a big-M shape, or non-finite output")
    return launches


TRAIN_GRID = (4, 16, 24)   # 25f@768x512: 1536 latent tokens
TRAIN_TEXT = 1024
TRAIN_PADS = (300, 500)    # left padding of each row's text context
TRAIN_STEPS, TRAIN_RESUMED_STEPS, TRAIN_CKPT_EVERY, TRAIN_RANK = 4, 6, 2, 16


def train_step_launches(cfg: TransformerConfig) -> dict:
    """Launches in one QLoRA train step, from the code: per-block remat runs
    each block forward twice (the step's forward, then its recompute in the
    backward), each with two statistics launches (self- and
    cross-attention) and its 10 int4 block linears through int4_matmul (1536
    latent and 1024 text rows, both under 8192); the backward runs each
    attention's dq and dkv kernels once, and the straight-through backward
    dequantizes once per int4 linear whose input needs a gradient: not
    block 0's attn1 q/k/v (their input is the frozen patchify projection's)
    nor any attn2 to_k/to_v (the frozen caption projection's)."""
    layers = cfg.num_layers
    return {**NO_LAUNCHES, "flash_attention_stats": 2 * 2 * layers,
            "flash_attention_bwd_dq": 2 * layers, "flash_attention_bwd_dkv": 2 * layers,
            "int4_matmul": 2 * 10 * layers, "dequant_int4": 10 * layers - 3 - 2 * layers}


def write_train_shard(directory) -> None:
    """Two rows of 1536 latent tokens x 128 channels and 1024 x 3840 text
    contexts with left-padded masks, from a seed."""
    cfg = TransformerConfig()
    rng = np.random.default_rng(0)
    f, h, w = TRAIN_GRID
    mask = np.ones((2, TRAIN_TEXT), np.int64)
    for row, pad in enumerate(TRAIN_PADS):
        mask[row, :pad] = 0
    write_shard(directory / "shard0.npz",
                rng.standard_normal((2, f * h * w, cfg.in_channels), dtype=np.float32),
                rng.standard_normal((2, TRAIN_TEXT, cfg.caption_channels),
                                    dtype=np.float32), TRAIN_GRID, mask)


def train_leg(tag: str, argv, expected: dict) -> list:
    """train.cli.run on `argv`, the counts set to 0 just before it; each
    step's launches read from the counts in the run's per-step report.
    Returns the report's entries with the step launches added."""
    reports = []

    def report(entry):
        if "step" in entry:
            entry["launches"] = read_counts()
            log(f"[{tag}] step {entry['step']}: loss {entry['loss']:.6f}, grad_norm "
                f"{entry['grad_norm']:.6f}, {entry['seconds']:.3f} s (synchronised), peak "
                f"{entry['peak_gib'] or 0.0:.2f} GiB")
        else:
            log(f"[{tag}] setup (s): {json.dumps(entry['setup'])}; starts at step "
                f"{entry['start']}")
        reset_counts()
        reports.append(entry)

    reset_counts()
    if train_cli.main(argv, report) != 0:
        raise AssertionError(f"{tag}: train.cli returned non-zero")
    for entry in reports[1:]:
        check_launches(f"{tag} step {entry['step']}", entry["launches"], expected)
        if not np.isfinite(entry["loss"]) or not np.isfinite(entry["grad_norm"]):
            raise AssertionError(f"{tag}: non-finite loss or grad_norm at step {entry['step']}")
    return reports


def phase_train(device) -> dict:
    """The training path at full width and depth through train.cli: 4 steps
    with a checkpoint every 2, then a resume leg to step 6. Asserts the
    launches of every step, finite losses, lora_b moved from 0 by the first
    steps, the resume starting at step 4 and an adapter of 480 x 3 tensors
    that reads back. Returns the summed launches of the first leg."""
    cfg = TransformerConfig()
    work = build.BUILD_DIR.parent / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    (work / "data").mkdir(parents=True)
    write_train_shard(work / "data")
    ckpt, out = work / "train.npz", work / "adapter.safetensors"
    argv = ["--data", str(work / "data"), "--out", str(out), "--random-init", "full",
            "--quant", "int4", "--rank", str(TRAIN_RANK), "--sdpa", "pallas",
            "--steps", str(TRAIN_STEPS), "--ckpt-every", str(TRAIN_CKPT_EVERY),
            "--log-every", "1", "--ckpt", str(ckpt), "--device", str(device)]
    expected = train_step_launches(cfg)
    log(f"[train] {cfg.num_layers} blocks, int4 base, rank {TRAIN_RANK} LoRA, grid "
        f"{TRAIN_GRID}, {TRAIN_TEXT} text tokens; expected launches per step "
        f"{json.dumps(expected)}")
    first = train_leg("train", argv, expected)
    with np.load(ckpt) as z:
        step = int(z["__step__"])
        lora_b = [z[k] for k in z.files if k.startswith("t[") and k.endswith("['lora_b']")]
    moved = float(np.mean([np.mean(b != 0) for b in lora_b]))
    log(f"[train] checkpoint at step {step}: {len(lora_b)} stacked lora_b leaves, "
        f"{moved:.4f} of their values nonzero")
    if step != TRAIN_STEPS or moved < 0.5:
        raise AssertionError(f"train: checkpoint step {step}, nonzero lora_b share {moved}")

    resumed = train_leg("resume", argv[:argv.index("--steps")] + [
        "--steps", str(TRAIN_RESUMED_STEPS), "--resume"] + argv[argv.index("--steps") + 2:],
        expected)
    if resumed[0]["start"] != TRAIN_STEPS or len(resumed) != 1 + TRAIN_RESUMED_STEPS - TRAIN_STEPS:
        raise AssertionError(f"resume: started at {resumed[0]['start']}, "
                             f"{len(resumed) - 1} steps")
    adapter = read_safetensors(out)
    linears = cfg.num_layers * 10
    up = [v for k, v in adapter.items() if k.endswith("lora_up.weight")]
    log(f"[train] adapter {out.name}: {len(adapter)} tensors ({linears} linears x 3), "
        f"{out.stat().st_size / 2**20:.1f} MiB; lora_up nonzero share "
        f"{float(np.mean([np.mean(u != 0) for u in up])):.4f}")
    if len(adapter) != 3 * linears or not all(np.isfinite(v).all() for v in adapter.values()) \
            or not any(np.any(u != 0) for u in up):
        raise AssertionError(f"train: adapter of {len(adapter)} tensors, or non-finite, "
                             "or lora_up all zero")
    steps = first[1:] + resumed[1:]
    log("[train] seconds per step: " + ", ".join(f"{e['seconds']:.3f}" for e in steps)
        + f"; peak {max(e['peak_gib'] for e in steps):.2f} GiB")
    shutil.rmtree(work, ignore_errors=True)
    totals = {name: sum(e["launches"][name] for e in first[1:]) for name in KERNELS}
    log(f"[train] launches over the first leg's {TRAIN_STEPS} steps: {json.dumps(totals)}")
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    device = torch.device("cuda", 0)
    phase_environment()
    flash = phase_flash_kernel(device)
    stats, dq, dkv = phase_flash_training_kernels(device)
    matmul, dequant = phase_int4_kernels(device)
    rms = phase_rms_kernel(device)
    phase_tiny_agreement(device)
    pipe, noise, steps, (launches, bf16_run) = phase_main_path(device)
    flash["launches"] = launches["flash_attention"]
    rms["launches"] = phase_two_stage(pipe, device)["rms_norm"]
    phase_batched(pipe, device)
    phase_norm_choice(pipe, device)
    matmul["launches"] = phase_int4_main_path(pipe, noise, steps, bf16_run,
                                              device)["int4_matmul"]
    dequant["launches"] = phase_big_m(pipe, device)["dequant_int4"]
    del pipe, noise, bf16_run
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(device)
    for entry in (stats, dq, dkv):
        entry["launches"] = train[entry["name"]]
    kernels = [flash, stats, dq, dkv, matmul, dequant, rms]
    for entry in kernels:
        # which clock read ms, plain_ms and library_ms: `cuda_ms` on an idle
        # card unless the entry says `queued_ms`
        entry.setdefault("timing", "idle")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
