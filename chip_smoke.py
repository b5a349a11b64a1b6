"""Smoke run of the PyTorch/CUDA port (ltx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: the card's name and power limit, torch and CUDA versions,
     and the nvcc build of every kernel from the sources in this checkout
     (one nvcc per source, all started together), with ptxas's registers
     and spills per kernel and the wgmma libraries' HGMMA counts (the
     int4 library must show HGMMA, no HMMA.16816 and no spills);
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the paths give it (int4_matmul at Gemma-3-12B's projections
     too) and at ragged ones, each output element
     within its stated tolerance (ltx_tpu_torch.checks; attention against
     the exact product, dequant_int4 with 0 error), with kernel, plain and
     library times and the card's bound (the kernels and their library
     calls by `queued_ms` at the paths' shapes, each idle-card time
     beside); the backward pair and rms_norm also bit for bit equal from
     run to run, rms_norm row by row alone or in other batches, with the
     host's microseconds a call of its wrapper and of the plain chain;
     the W8A8 product (activation codes, the library's int32 accumulator,
     the bf16 output) bit for bit the CPU's at the DiT's and Gemma's
     shapes, timed beside F.linear in bf16 and the int8 bound (Gemma's
     decode rows, 1 and 9, among the int4 and W8A8 cases; flash attention
     at SigLIP's head dim 72 and at the dual audio-video DiT's head dim 64
     among the attention cases, rms_norm at its audio stream's 2048; both at
     the long-video modes' 6144 tokens and four-prompt text pass);
     then the tiny pipeline, the tiny two-stage I2V pipeline, the tiny
     joint-audio pipeline (CFG, then I2V; frames and waveform, the flash
     launches by head dim), the tiny long-video modes (video-to-video,
     extension, keyframes, an anchored two-prompt chain, and the audio
     chain, keyframes and extension), the tiny LoRA train, the tiny AV
     QLoRA step and the tiny cycle Gemma's greedy generation on the card
     against the same weights and draws on the CPU, the norms as the
     default route gives them;
  3. the bf16 main path: LTXPipeline.generate_video at full width and depth
     (Gemma-3-12B, the text connector, the 48-block DiT, the VAE decoder;
     random bf16 weights from a seeded generator) at 25 frames, 768x512,
     8 distilled steps, with the kernel launch counts read around it.
     On every inference path below as here, nothing overrides the norm
     route: every norm of the DiT and the connector launches rms_norm and
     none takes the plain chain (`ops.normalization.rms_chain_on_cuda` read
     beside the launch counts);
  3b. the two-stage path: LTXPipeline.generate_video_two_stage at full width and depth, I2V from
     a seeded pixel array through encode_image at half and at full
     resolution (the full-width VAE encoder), 121 frames at 1024x576: a
     guided stage 1 at 512x288 (CFG 4, STG on block 29, rescale 0.7: three
     rows a step, 8 steps), the full-width latent upscaler and AdaIN, a
     3-step stage 2 at 9216 tokens (two rows: STG stays, CFG goes), the
     conditioned frame re-noised every
     step, and a temporally tiled decode (8 latent frames a tile, overlap
     2, uint8 tiles) to exactly 121 frames;
  3c. the batched path, the phase-3 components resident on the card,
     placed once for 3c, 3f, 3g and 3h, which run after 3e (phase 3
     measures the staging): generate_videos with two
     prompts at 25f@768x512, each sample against its solo generate_video on
     the same noise, and one DiT call on two rows bit for bit its solo
     call; then one denoise step timed under the default dispatch and under
     `forced_rms_chain()`, in turns;
  3f. the long-video modes at 121f@768x512 (6144 tokens, 8 steps), the
     phase-3 components resident on the card for the phase (no per-phase
     staging, as a server keeps them) and the decode tiled: the README's
     road-trip chain (four segments, four prompts in one text pass, an
     anchor at frame 16 of segment 2, tail renormalisation 0.5, 9 frames
     carried: 457 frames), its first 121 frames bit for bit generate_video
     on segment 0's draws and the chain's text rows, the extension of its
     last 9 frames, keyframes at frames 0 and 112, video-to-video at
     strength 0.6 on its first 121 frames; each run's launches, seconds by
     phase, steady step and peak;
  3e. prompt enhancement: the cycle Gemma at Gemma-3-12B's shapes (bf16,
     built on the card; the byte-fallback tokenizer of phase 5b): greedy
     generate_tokens with 8 drafts token for token the sequential run, its
     tokens a forward (> 0.9 of the drafts), two prompts batched row for
     row their solo runs, an int8 cache the same tokens. Then
     generate_video with enhance_prompt=True on the phase-3 pipeline (the
     default 512 tokens, 8 drafts, temperature 0.7): the enhanced text, not
     the fallback (its warning fails the phase), the north star's launch
     counts (Gemma's decode launches no flash attention: grouped-query,
     plain), its seconds, tokens, forwards and peak memory, and a few
     decode forwards under the profiler (host and device ms, idle share);
     enhance_prompts(strict=True) on two prompts. Then I2V enhancement's
     image path at full size: SigLIP-So400m (random, seeded, bf16) on a
     seeded 896x896 pixel array, 27 flash launches at head dim 72, its
     features against the same tower on the plain attention, the 256 soft
     tokens spliced into the I2V prompt and decoded by generate_tokens;
  3g. the surfaces at the north star on the phase-3 pipeline, its
     components resident (a server's deployment): serve/app.py's
     build_app on a SeededPipeline with the north star's warmup, served
     on 127.0.0.1 from a thread; /healthz; two concurrent /v1/enhance
     requests of 32 tokens coalesced into one batch; three T2V jobs at
     seeds 7, 8, 7 (jobs 1 and 3 the same pixels bit for bit, job 2 not;
     /metrics counts three done jobs), each with its latency and launches;
     one more job under utils.diagnostics.profile_trace, whose Chrome trace
     names flash_fwd_kernel and rms_norm_kernel as often as the counts;
     io/cli.py's `generate --seed 7 --profile` with load_pipeline swapped
     for this pipeline (its GenerationConfig job 1's field for field, its
     pixels job 1's); generate_video with a DenoiseCheckpoint stopped after
     4 steps and resumed (the uninterrupted frames bit for bit, 4 steps'
     launches). The pixels are compared as the exports hand them to the
     MP4 writer (checks.recorded_mp4); on a machine with no MP4 encoder the
     writer is chip_smoke's npy_mp4_writer stand-in, and the log says so
     (phase 1 lists the encoders found). Phase 2 runs the same identities
     on the tiny pipeline (checks.check_tiny_surfaces);
  3h. prepare-data: four 25-frame 768x512 clips written here with OpenCV
     (mp4v) and their captions, as a JSONL manifest and as .mp4 + .txt
     sidecars; io/cli.py's `prepare-data` on each (load_pipeline swapped
     for the phase-3 pipeline, its Gemma, connector and VAE resident):
     two shards of two rows each, grid (4, 16, 24), finite tokens and
     contexts, the two runs' shards bit for bit each other, each clip's
     tokens bit for bit train.prepare.encode_clip of that clip alone, the
     connector's flash and rms_norm launches of one text pass; the seconds
     a clip and of the text pass. Phase 6 trains on these shards;
  3d. the W8A8 main path: the same bf16 DiT requantized per channel to
     W8A8 on the card into a copy (quantize_transformer(w8a8=True)), the
     same generate_video and noise; every block linear through the
     library's int8 product (8 steps x 48 blocks x 10 `int8_mm` calls),
     its frames held against the bf16 run's no further than the int4 run's
     are, its steady step and peak memory printed;
  4. the int4 main path: the same DiT quantized to int4 in place on the
     card, the same generate_video and noise; every block linear through
     int4_matmul (8 steps x 48 blocks x 10);
  5. the big-M route: one int4 DiT call at 121 frames, 1024x576 (9216
     tokens), where the 9216-row linears go through dequant_int4 and a
     plain product and the 1024-row text K/V through int4_matmul;
  5c. joint audio: the 48-block dual audio-video DiT drawn on the card
     beside the phase-3 pipeline's Gemma, VAE and upscaler, after the video
     DiT is dropped, every component resident on the card for 5c and 5d
     (as a server keeps them; phase 3 measures staging); then
     generate_video_with_audio at the north star (8 x 48 x 6 flash
     launches in the dual DiT, 1536 of them at head dim 64, and both
     connectors'; 20 rms_norm launches a dual block; the frames and the
     waveform: finite, in [-1, 1], 240 x (4T - 3) samples) with one dual
     step under the profiler, and generate_video_with_audio_two_stage at
     241f@1024x640 (the flagship: I2V through encode_image at half and full
     resolution, 8 distilled steps at 4960 tokens, the upscaler, 3 plain
     Euler steps at 19840 tokens, 251 audio tokens, a tiled decode), each
     with its launches, phases and peak memory; then a 3-segment
     generate_video_chain_with_audio carrying the
     audio tail (57 frames, the waveform's crossfaded length checked),
     keyframes at frames 0 and 24 with audio, and generate_video_with_audio
     extending the chain's last 9 frames, at 25f@768x512;
  5d. the AV QLoRA step: 5c's dual DiT, still resident on the card,
     quantized to int4 there (quantize_transformer) and frozen, rank-16 LoRA on its 1344
     block linears, then 4 steps of train.step.make_av_train_step with
     per-block remat at 25f@768x512 (1536 video tokens) and 26 audio
     tokens, 1024-token text contexts left-padded by 300 (video) and 500
     (audio): each step's launches against checks.av_train_step_launches
     (B2 2 x 48 x 6, B3a and B3b 48 x 6, B4 on every int4 linear twice,
     B5 in the straight-through backward), finite losses with both streams'
     terms above 0, the base bit for bit, every lora_b moved from 0; the
     seconds a step, the peak memory, and the last step under
     torch.profiler (host and device ms by kernel group, idle share);
  5b. files to frames: a models directory written under build/ in the
     layout weights.download resolves, from seeded generators on the card
     by the port's own safetensors writer: the unified file (the dual DiT's
     keys at full width with 8 of its 48 blocks, the one cut; the
     connectors in format 2, the audio one too; the VAE decoder), the audio
     VAE's and the vocoder's files, the standalone VAE file with the encoder,
     the Gemma-3-12B snapshot at full width and depth in MLX 4-bit with the
     `language_model.` prefix (four shards, config.json, a byte-fallback
     BPE tokenizer.json), the upscaler in f32 and a rank-384 LoRA over the
     8 blocks' linears; its bytes and seconds printed. load_pipeline in
     bf16, its seconds by part and the host's resident memory printed, then
     the north star from it (launches checked); one Gemma linear's MLX
     dequantization against numpy from the file's arrays, bit for bit;
     every loaded component's values and bytes against its files'; then
     load_pipeline(include_audio=True) in bf16 and one
     generate_video_with_audio at the north star from it. The
     LoRA fused on the card against the CPU's fusion of blocks 0 and 7
     (checks.check_fused_leaves) and the fused DiT against the adapter as
     a side path (checks.lora_side_path_check). load_pipeline in int4 with
     the LoRA: the quantized cache misses, the DiT is fused and quantized
     on the card, the north star runs (8 x 8 x 10 int4_matmul launches);
     loaded again, the cache hits with no quantize_weight call and a DiT
     bit for bit the first's. Gemma comes in "int4" with the int4 loads
     (repacked on the card, only its quantized leaves brought to the host
     for phase staging; 48 x 7 int4_matmul launches a text pass), and its
     49 hidden states are held against the bf16 load's. Then the
     reference's defaults, W8A8 Gemma and a W8A8 DiT, without phase
     staging: Gemma prepared and kept on the card, staging copies nothing
     for it, the caches of both written; its hidden states against the
     bf16 load's (correlation, the reference's check); loaded again, both
     caches hit with no requantization. The int4 and the W8A8 Gemma each
     decode 32 greedy tokens with and without speculation: every forward's
     seven linears a layer through int4_matmul (48 x 7 launches, at 1 and
     9 rows) or the int8 product. train.cli --weights on the unified
     file (W8A8, the reference's default, rank 16, one step, its launches
     checked). The directory is deleted;
  6. the training path: `python -m ltx_tpu_torch.train.cli`'s `run` at full
     width and depth (the 48-block DiT, random and seeded, quantized to
     int4 and frozen, rank-16 LoRA on its 480 block linears) on phase 3h's
     shards (four 25f@768x512 rows, 1536 tokens, with their 1024-token,
     left-padded text contexts): 4 steps with checkpoints, then a resume leg
     to step 5; every attention through the statistics forward and the two
     backward kernels, the int4 base through int4_matmul forward and
     dequant_int4 in its straight-through backward, with the launch counts
     read around every step (the norms as the route gives them under
     autograd: checks.rms_train_counts); the checkpoint and the exported
     adapter read back. (Phase 2 also holds the tiny LoRA train and the
     tiny AV QLoRA step on the card against the CPU, and the statistics
     and backward kernels against their plain versions, the dual DiT's
     head-dim-64 shapes among them.)
  7. a JSON line of the seven kernels: launches (each from the paths that
     run it, by path where there are several, the long-video modes' among
     them; B1's and B6's times at their shapes in `long_video_cases`), max
     error, kernel, plain and library ms, the bound and what sets
     it, and `timing`, the clock that read the times ("idle": CUDA events
     around each call on an idle card; "queued": the launches queued behind
     other work, over buffers rotated past the L2's size);
  8. the last line, {"ok": true, "device": {...}}.

There is no fallback: without CUDA, or when a kernel fails to build, launch
or agree, the script raises and exits non-zero before the last line.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import logging
import re
import resource
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ltx_tpu_torch import checks
from ltx_tpu_torch.config import GenerationConfig, QuantizationConfig, TransformerConfig
from ltx_tpu_torch.kernels import build
from ltx_tpu_torch.kernels import flash_attention as fa
from ltx_tpu_torch.kernels import quantization as qz
from ltx_tpu_torch.kernels import rms_norm as rk
from ltx_tpu_torch.models import gemma3
from ltx_tpu_torch.models.common import QuantizedLinear, W8A8Linear
from ltx_tpu_torch.models.dit import quantize_transformer
from ltx_tpu_torch.ops import normalization, schedule
from ltx_tpu_torch.ops.latents import VideoLatentShape, generate_noise
from ltx_tpu_torch.ops.normalization import forced_rms_chain
from ltx_tpu_torch.pipeline.denoise import GuidanceSpec, make_denoise_step
from ltx_tpu_torch.pipeline import enhance
from ltx_tpu_torch.pipeline.generate import GenerationTimings, LTXPipeline
from ltx_tpu_torch.profile_step import profile_steps
from ltx_tpu_torch.tokenizer import Tokenizer
from ltx_tpu_torch.train import cli as train_cli
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

# the published peaks of one H100 SXM (dense bf16 and int8 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
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


# template type arguments as the kernels' mangled names spell them (S1_: the
# repeated __nv_bfloat16 of rms_norm_kernel<bf16, bf16, ...>)
MANGLED_TYPES = {"13__nv_bfloat16": "bf16", "f": "f32", "S1_": "bf16"}


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, e.g.
    flash_fwd_kernel<128,1,0,0> or rms_norm_kernel<bf16,f32,1>."""
    for m in re.finditer(r"\d+", mangled):
        # the length prefix may follow other digits (a hash in the namespace)
        idents = (mangled[m.end():m.end() + int(m.group()[i:])] for i in range(len(m.group())))
        ident = next((s for s in idents if s.endswith("kernel")), "")
        if ident:
            args = re.match(r"I((?:L[ib]\d+E|13__nv_bfloat16|f|S1_)+)E",
                            mangled[m.end() + len(ident):])
            vals = [MANGLED_TYPES.get(a) or re.sub(r"L[ib](\d+)E", r"\1", a) for a in
                    re.findall(r"L[ib]\d+E|13__nv_bfloat16|f|S1_", args.group(1))] \
                if args else []
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
    # the wgmma kernels' consumers run at setmaxnreg 240 (ptxas reports the
    # launch's 168 a thread): their spill figures above are theirs
    for name in ("flash_attention_fwd", "flash_attention_bwd", "int4_matmul"):
        text = (build.BUILD_DIR / f"{name}.log").read_text() \
            if (build.BUILD_DIR / f"{name}.log").is_file() else ""
        report = ptxas_report(text)
        spilling = [k for k, _, spills in report
                    if not spills.startswith("0 bytes stack frame, 0 bytes spill")] \
            if report else ["(no build log)"]
        hgmma, hmma = sass_count(name, "HGMMA"), sass_count(name, "HMMA.16816")
        log(f"[env] {name}: {hgmma} HGMMA instructions in its SASS (wgmma), {hmma} "
            f"HMMA.16816 (mma.sync), over its {len(report)} kernel instantiations; "
            f"instantiations that spill: {spilling or 'none'}")
        if name == "int4_matmul" and (not hgmma or hmma is None or hmma or spilling):
            raise AssertionError(f"int4_matmul: {hgmma} HGMMA, {hmma} HMMA.16816, spilling "
                                 f"{spilling}: the kernel must be wgmma without spills")
    log(f"[env] MP4 encoders: {json.dumps(mp4_encoders())}")
    return seconds


def mp4_encoders() -> dict:
    """Which of the export's encoders this machine has: imageio with
    imageio-ffmpeg (H.264), OpenCV (mp4v), PIL (PNG), an ffmpeg binary."""
    import importlib.util

    found = {name: importlib.util.find_spec(name) is not None
             for name in ("imageio", "imageio_ffmpeg", "cv2", "PIL")}
    found["ffmpeg binary"] = shutil.which("ffmpeg") is not None
    return found


def npy_mp4_writer(pixels: np.ndarray, path: str, config) -> None:
    """Stand-in for io.video._write_mp4 where no MP4 encoder is installed:
    the uint8 (F, H, W, 3) pixels it is handed, saved in .npy format at
    `path`. frames_to_uint8 and everything before it run as shipped."""
    with open(path, "wb") as f:
        np.save(f, pixels)


def mp4_writer():
    """The MP4 writer the surfaces' checks hand their exports: None (the
    package's own) when imageio-ffmpeg or OpenCV can write MP4 here, else
    the .npy stand-in, which is logged."""
    found = mp4_encoders()
    if (found["imageio"] and found["imageio_ffmpeg"]) or found["cv2"]:
        return None
    log("[env] no MP4 encoder on this machine (no imageio-ffmpeg, no OpenCV): the "
        "surfaces' MP4 files are written by chip_smoke's npy_mp4_writer, the uint8 "
        "pixels in .npy format, in place of io.video._write_mp4")
    return npy_mp4_writer


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(ms, "operations" | "bytes"): the least time the card could take, the
    larger of flops at their type's peak (the bf16 tensor cores unless
    given) and bytes at HBM's rate."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def flash_calls(fn, q, k, v, bias, scale) -> list:
    """Closures of fn(q, k, v, bias, scale) over copies of the inputs rotated
    past the L2's size (`rotated_sets`), for `queued_ms`."""
    ins = (q, k, v) if bias is None else (q, k, v, bias)
    sets = rotated_sets(ins, q.numel() * q.element_size())
    return [lambda s=s: fn(s[0], s[1], s[2], None if bias is None else s[3], scale)
            for s in sets]


def phase_flash_kernel(device) -> dict:
    """flash_attention against the exact product (checks.attention_exact)
    at the path's shapes and the ragged ones (checks.ATTN_CASES,
    element-wise tolerance); at the path's shapes (1024 queries and more)
    the kernel and sdpa timed by `queued_ms` too; returns the kernels-line
    entry (without launches), timed at the DiT's self-attention by
    `queued_ms`, its idle-card `cuda_ms` beside it."""
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
        queued = ""
        if case.tq >= 1024 or case.name.startswith("av_"):
            q_ms = queued_ms(flash_calls(fa.flash_attention, q, k, v, bias, case.scale))
            q_lib = queued_ms(flash_calls(
                lambda *a: F.scaled_dot_product_attention(
                    *a[:3], attn_mask=None if a[3] is None else a[3].to(q.dtype), scale=a[4]),
                q, k, v, bias, case.scale))
            timings[case.name] = (q_ms, plain, q_lib, bound_ms, bound_by, ms, library)
            queued = (f"; queued: kernel {q_ms:.4f} ms ({bound_ms / q_ms:.3f} of the bound, "
                      f"{flops / q_ms * 1e-9:.1f} TFLOP/s), sdpa {q_lib:.4f} ms, kernel "
                      f"{q_ms / q_lib:.2f}x sdpa")
        log(f"[kernel] flash_attention {case.name} q{(case.b, case.h, case.tq, case.d)}"
            f" k{(case.b, case.h, case.tk, case.d)} masked keys={case.pad}"
            f"{' (head)' if case.pad_left else ''} layout {case.layout}:"
            f" max_abs_err {res['max_abs_err']:.3e}, {res['tol_share']:.3f} of its"
            f" element's tolerance, {res['rel_to_max']:.3e} of max|exact|;"
            f" idle: kernel {ms:.4f} ms, plain {plain:.4f} ms, library (sdpa) {library:.4f} ms,"
            f" bound {bound_ms:.4f} ms ({bound_by}); {flops / ms * 1e-9:.1f} TFLOP/s,"
            f" {bound_ms / ms:.3f} of the bound, {ms / library:.2f}x sdpa" + queued)
    ms, plain, library, bound_ms, bound_by, idle_ms, idle_lib = timings["dit_self_attn"]
    # the dual DiT's head-dim-64 shapes and the long-video modes' beside the
    # line's self-attention
    def cases(prefix):
        return {name: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                "idle_ms", "idle_library_ms"), t))
                for name, t in timings.items() if name.startswith(prefix)}

    return {"name": "flash_attention", "route": "cuda",
            "source": "ltx_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "ltx_tpu/kernels/flash_attention.py:124",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library,
            "timing": "queued", "idle_ms": idle_ms, "idle_library_ms": idle_lib,
            "av_cases": cases("av_"), "long_video_cases": cases("long_")}


def int4_bytes(m: int, k: int, n: int, group: int) -> float:
    """X read, packed codes, scale and bias read, Y written."""
    return 2.0 * m * k + k * n / 2 + 2 * 4.0 * (k // group) * n + 2.0 * m * n


# the int4 product's path shapes (checks.INT4_CASES), timed on both clocks:
# the DiT's and Gemma's
INT4_PATH_CASES = ("dit_attn_proj", "dit_ff_in", "dit_ff_out", "dit_text_kv") \
    + checks.GEMMA_INT4_CASES
INT4_LINE_CASE = "dit_ff_in"  # the kernels line's shape


def phase_int4_kernels(device):
    """The routed int4 product (int4_matmul below 8192 rows, dequant_int4
    then a product from there on) against int4_matmul_reference at the
    path's shapes, ragged ones and the big-M ones (checks.INT4_CASES), and
    dequant_int4 against its plain version with 0 error at every weight
    shape the path dequantizes. Each is timed on an idle card (`cuda_ms`)
    beside its plain version and the library call (F.linear on the
    dequantized bf16 weight); at the four path shapes and the three weight
    shapes also by `queued_ms` over rotated buffers, with the share of the
    bound. Returns the kernels-line entries (without launches),
    int4_matmul at the FF-in shape (1536 x 4096 -> 16384), dequant_int4 at
    its (4096, 16384) weight, both by `queued_ms`. Also quantize_weight of
    one full-size weight on the card against the CPU, bit for bit."""
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
        flops = 2.0 * case.m * case.k * case.n
        bound_ms, bound_by = bound(flops, int4_bytes(case.m, case.k, case.n, case.group))
        route = "int4_matmul" if res["int4_matmul_launches"] else "dequant_int4 + matmul"
        queued = ""
        if case.name in INT4_PATH_CASES:
            sets = rotated_sets((x, *args), 2 * case.m * case.n)
            q_ms = queued_ms([lambda s=s: qz.int4_mm(*s) for s in sets])
            del sets
            lib_sets = rotated_sets((x, w), 2 * case.m * case.n)
            q_lib = queued_ms([lambda s=s: F.linear(s[0], s[1].t()) for s in lib_sets])
            del lib_sets
            timings[case.name] = (q_ms, plain, q_lib, bound_ms, bound_by, ms, library)
            queued = (f"; queued: kernel {q_ms:.4f} ms ({bound_ms / q_ms:.3f} of the bound, "
                      f"{flops / q_ms * 1e-9:.1f} TFLOP/s), library {q_lib:.4f} ms "
                      f"({bound_ms / q_lib:.3f}), kernel {q_ms / q_lib:.2f}x library")
        log(f"[kernel] int4 {case.name} ({case.m}, {case.k}) x ({case.k}, {case.n})"
            f" group {case.group} via {route}: max_abs_err {res['max_abs_err']:.3e},"
            f" {res['tol_share']:.3f} of its element's tolerance; idle: kernel {ms:.4f} ms"
            f" ({bound_ms / ms:.3f} of the bound), plain {plain:.4f} ms, library (F.linear,"
            f" bf16 W) {library:.4f} ms ({ms / library:.2f}x); bound {bound_ms:.4f} ms"
            f" ({bound_by})" + queued)
        del x, qp, args, w
    ms, plain, library, bound_ms, bound_by, idle_ms, idle_lib = timings[INT4_LINE_CASE]
    matmul = {"name": "int4_matmul", "route": "cuda",
              "source": "ltx_tpu_torch/csrc/int4_matmul.cu",
              "replaces": "ltx_tpu/kernels/quantization.py:333",
              "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library,
              "timing": "queued", "idle_ms": idle_ms, "idle_library_ms": idle_lib}

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
        sets = rotated_sets(args, 2 * k * n)
        q_ms = queued_ms([lambda s=s: qz.dequant_int4(*s) for s in sets])
        del sets
        nbytes = k * n / 2 + 2 * 4.0 * (k // 64) * n + 2.0 * k * n
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        timings[(k, n)] = (q_ms, plain, bound_ms, ms)
        log(f"[kernel] dequant_int4 ({k // 2}, {n}) -> ({k}, {n}) bf16: max_abs_err "
            f"{res['max_abs_err']:.3e}, {res['mismatches']} values differ; queued: kernel "
            f"{q_ms:.4f} ms ({bound_ms / q_ms:.3f} of the bound, "
            f"{nbytes / q_ms * 1e-6:.0f} GB/s); idle: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms; bound {bound_ms:.4f} ms (bytes), no library call")
        del qp, args
    ms, plain, bound_ms, idle_ms = timings[checks.FF_IN_SHAPE]
    dequant = {"name": "dequant_int4", "route": "cuda",
               "source": "ltx_tpu_torch/csrc/int4_matmul.cu",
               "replaces": "ltx_tpu/kernels/quantization.py:378",
               "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
               "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
               "timing": "queued", "idle_ms": idle_ms}

    return matmul, dequant


def phase_w8a8_products(device) -> None:
    """The W8A8 product at the DiT's and Gemma's path shapes
    (checks.W8A8_CASES): activation codes, the library's int32 accumulator
    and the bf16 output bit for bit the CPU's (checks.check_w8a8); then by
    `queued_ms` the whole W8A8 linear (`int8_matmul`: the activation
    quantization, the int8 product, the rescale), the library's int8
    product alone (`int8_mm`, torch._int_mm) and F.linear on the bf16
    weight w8 * sw, beside the int8 product's bound (operations at 1979
    TOPS, or its bytes) and the whole linear's."""
    for case in checks.W8A8_CASES:
        t0 = time.perf_counter()
        res = checks.check_w8a8(case, device)
        check_s = time.perf_counter() - t0
        x, p = checks.w8a8_inputs(case, device)
        x8, _ = qz.quantize_act_int8(x)
        w = (p["w8"].float() * p["sw"]).bfloat16()
        m, k, n = case.m, case.k, case.n
        sets = rotated_sets((x, p["w8"], p["sw"]), 2 * m * n)
        linear_ms = queued_ms([lambda s=s: qz.int8_matmul({"w8": s[1], "sw": s[2]}, s[0])
                               for s in sets])
        del sets
        sets = rotated_sets((x8, p["w8"]), 4 * m * n)
        product_ms = queued_ms([lambda s=s: qz.int8_mm(*s) for s in sets])
        del sets
        sets = rotated_sets((x, w), 2 * m * n)
        library_ms = queued_ms([lambda s=s: F.linear(s[0], s[1].t()) for s in sets])
        del sets
        ops = 2.0 * m * k * n
        product_bound, product_by = bound(ops, m * k + k * n + 4.0 * m * n, PEAK_INT8_OPS)
        linear_bound, linear_by = bound(ops, 2.0 * m * k + k * n + 4.0 * n + 2.0 * m * n,
                                        PEAK_INT8_OPS)
        log(f"[w8a8] {case.name} ({m}, {k}) x ({k}, {n}): card vs CPU differing values "
            f"{json.dumps(res)} ({check_s:.2f} s); queued: int8_matmul {linear_ms:.4f} ms "
            f"({linear_bound / linear_ms:.3f} of its bound {linear_bound:.4f} ms, {linear_by}), "
            f"the library's int8 product (torch._int_mm) {product_ms:.4f} ms "
            f"({product_bound / product_ms:.3f} of its bound {product_bound:.4f} ms, "
            f"{product_by}; {ops / product_ms * 1e-9:.1f} TOPS), F.linear bf16 "
            f"{library_ms:.4f} ms; int8_matmul {linear_ms / library_ms:.2f}x F.linear")
        del x, p, x8, w


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
    (checks.BWD_CASES, element-wise tolerances, the output against the
    exact product, exact zeros on -1e30 masked keys, gradients in the
    inputs' layouts), and two runs of the backward bitwise equal at the
    path's shapes
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
        st = checks.check_stats(case, device)
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
        s_idle = cuda_ms(lambda: fa.flash_attention_stats(q, k, v, bias, case.scale))
        s_ms = queued_ms(flash_calls(fa.flash_attention_stats, q, k, v, bias, case.scale))
        s_plain = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, bias, case.scale,
                                                               return_stats=True))
        s_lib = queued_ms(flash_calls(
            lambda *a: F.scaled_dot_product_attention(*a[:3], attn_mask=mask, scale=a[4]),
            q, k, v, bias, case.scale))
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
                              dq_bound, dkv_bound, dq_idle, dkv_idle, s_idle)
        pair = dq_ms + dkv_ms
        log(f"[kernel] flash_attention_stats {case.name} q{(b, h, tq, d)} k{(b, h, tk, d)} "
            f"bias={case.bias} layout {case.layout}: max_abs_err {st['max_abs_err']:.3e}, out "
            f"{st['tol_share']:.3f}, m {st['m_share']:.3f}, l {st['l_share']:.3f} of their "
            f"tolerances; queued: kernel {s_ms:.4f} ms ({s_idle:.4f} from an idle card), "
            f"library (sdpa fwd) {s_lib:.4f} ms; plain {s_plain:.4f} ms (idle), bound "
            f"{s_bound[0]:.4f} ms ({s_bound[1]});"
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
     dkv_bound, dq_idle, dkv_idle, s_idle) = timings["dit_self_attn"]
    src = "ltx_tpu_torch/csrc/flash_attention_bwd.cu"

    def av_cases(kernel):
        """The dual DiT's head-dim-64 shapes beside the line's
        self-attention: the kernel's queued ms, plain, library (sdpa's
        forward or backward, queued), bound and idle-card ms."""
        out = {}
        for name, t in timings.items():
            if name.startswith("av_"):
                row = {"stats": (t[0], t[1], t[2], *t[3], t[12]),
                       "dq": (t[4], t[6], t[7], *t[8], t[10]),
                       "dkv": (t[5], t[6], t[7], *t[9], t[11])}[kernel]
                out[name] = dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                      "idle_ms"), row))
        return out

    return [
        {"name": "flash_attention_stats", "route": "cuda",
         "source": "ltx_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "ltx_tpu/kernels/flash_attention.py:124", "max_abs_err": errs["stats"],
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound[0], "bound_by": s_bound[1],
         "library_ms": s_lib, "timing": "queued", "idle_ms": s_idle,
         "av_cases": av_cases("stats")},
        {"name": "flash_attention_bwd_dq", "route": "cuda", "source": src,
         "replaces": "ltx_tpu/kernels/flash_attention.py:347", "max_abs_err": errs["dq"],
         "ms": dq_ms, "plain_ms": b_plain, "bound_ms": dq_bound[0], "bound_by": dq_bound[1],
         "library_ms": b_lib, "timing": "queued", "idle_ms": dq_idle,
         "av_cases": av_cases("dq")},
        {"name": "flash_attention_bwd_dkv", "route": "cuda", "source": src,
         "replaces": "ltx_tpu/kernels/flash_attention.py:347", "max_abs_err": errs["dkv"],
         "ms": dkv_ms, "plain_ms": b_plain, "bound_ms": dkv_bound[0],
         "bound_by": dkv_bound[1], "library_ms": b_lib, "timing": "queued",
         "idle_ms": dkv_idle, "av_cases": av_cases("dkv")},
    ]


RMS_LINE_CASE = "dit_stage1_qk"  # the kernels line's shape: three rows of 2304 tokens
RMS_HOST_CASE = "north_star_qk"  # the host's microseconds a call, at (1536, 4096)
HOST_CALLS = 100  # calls a timed run of `host_us`


def host_us(fn) -> float:
    """Host microseconds a call of fn() while the card is busy with earlier
    work (LEAD_PRODUCTS matrix products queued ahead, longer than the host
    takes for HOST_CALLS calls), so that the host never waits for the card:
    the median of five runs of HOST_CALLS calls."""
    fn()
    blocker = torch.zeros(8192, 8192, dtype=torch.bfloat16, device="cuda")
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        for _ in range(LEAD_PRODUCTS):
            torch.matmul(blocker, blocker)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        runs.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
    torch.cuda.synchronize()
    return sorted(runs)[2]


def phase_rms_kernel(device) -> dict:
    """rms_norm against rms_norm_reference at the inference paths' shapes
    and at ragged, wide and chunked ones (checks.RMS_CASES, element-wise
    tolerance), each with kernel, plain and library (F.rms_norm, timed and
    never called by the port) times and the bound by bytes: x read once, the
    output written once. The times are `queued_ms`'s (the device's, the
    launches queued as in a DiT step, over buffers rotated past the L2's
    size); the kernel's `cuda_ms` on an idle card, which adds the host's
    launch time, is printed beside them and kept as `idle_ms`. Then the
    kernel twice and row by row (checks.RMS_BITWISE_CASES, bit for bit), and
    the host's microseconds a call at (1536, 4096): the wrapper, the routed
    `ops.normalization.rms_norm`, and the plain chain it replaces.
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
        g = rk.geometry(case.rows, case.d, x.element_size(),
                        0 if w is None else w.element_size(),
                        torch.cuda.get_device_properties(device).multi_processor_count)
        log(f"[kernel] rms_norm {case.name} ({case.rows}, {case.d}) {case.dtype} "
            f"weight={case.weight}: max_abs_err {res['max_abs_err']:.3e}, "
            f"{res['tol_share']:.3f} of its element's tolerance, "
            f"{res['differ_share']:.3e} of the elements differ from plain; kernel "
            f"{ms:.4f} ms ({idle_ms:.4f} ms from an idle card), plain {plain:.4f} ms, "
            f"library (F.rms_norm) {library:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"{bound_ms / ms:.3f} of the bound, {ms / library:.2f}x F.rms_norm, "
            f"{nbytes / ms * 1e-6:.0f} GB/s; grid {g.grid} x {g.warps} warps, "
            f"{g.stages} stages of {g.stage_bytes} B, {g.chunks} chunk(s) a row")
    for name in checks.RMS_BITWISE_CASES:
        case = next(c for c in checks.RMS_CASES if c.name == name)
        res = checks.check_rms_bitwise(case, device)
        log(f"[kernel] rms_norm {name}: two runs and rows alone or in other batches, "
            f"differing values {json.dumps(res)} (bitwise equal)")
    case = next(c for c in checks.RMS_CASES if c.name == RMS_HOST_CASE)
    x, w = checks.rms_inputs(case, device)
    with torch.inference_mode():
        wrapper = host_us(lambda: rk.rms_norm(x, w))
        routed = host_us(lambda: normalization.rms_norm(x, w))
        with forced_rms_chain():
            chain = host_us(lambda: normalization.rms_norm(x, w))
    log(f"[kernel] rms_norm host time a call at ({case.rows}, {case.d}), the card busy: "
        f"wrapper {wrapper:.1f} us, routed ops.normalization.rms_norm {routed:.1f} us, "
        f"forced plain chain {chain:.1f} us")
    ms, plain, library, bound_ms, bound_by, idle_ms = timings[RMS_LINE_CASE]
    return {"name": "rms_norm", "route": "cuda",
            "source": "ltx_tpu_torch/csrc/rms_norm.cu",
            "replaces": "ltx_tpu/kernels/rms_norm.py:48",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library,
            "timing": "queued", "idle_ms": idle_ms, "host_us": wrapper,
            "chain_host_us": chain,
            # the dual DiT's audio stream at 2048 wide, and the long-video
            # modes' 6144 tokens and four-prompt connector
            **{key: {name: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                     "idle_ms"), t))
                     for name, t in timings.items() if name.startswith(prefix)}
               for key, prefix in (("av_cases", "av_"), ("long_video_cases", "long_"))}}


def phase_tiny_agreement(device) -> None:
    """The tiny pipeline, the tiny two-stage I2V pipeline, the tiny LoRA
    train and the tiny AV QLoRA step on the card against the same weights
    on the CPU."""
    res = checks.check_tiny_pipeline(device)
    log(f"[tiny] pipeline on the card vs the CPU: max abs err "
        f"{res['max_abs_err']:.3e} (tol {checks.TINY_FRAME_ATOL:.0e}), "
        f"{res['launches']} kernel launches")
    res = checks.check_tiny_two_stage(device)
    log(f"[tiny] two-stage I2V pipeline (guided stage 1, upscaler, refine, tiled uint8 "
        f"decode; norms through the rms_norm kernel) on the card vs the CPU: max abs err "
        f"{res['max_abs_err']:.3e}, mean {res['mean_abs_err']:.3e} (tol "
        f"{checks.TINY_FRAME_ATOL:.0e}); launches {json.dumps(res['launches'])}")
    res = checks.check_tiny_generate(device)
    log(f"[tiny] cycle Gemma greedy generation on the card vs the CPU, token for token: "
        f"{json.dumps(res)}")
    res = checks.check_tiny_av_pipeline(device)
    log(f"[tiny] joint-audio pipeline (CFG; I2V re-noised) on the card vs the CPU: "
        f"{json.dumps(res)} (tol {checks.TINY_FRAME_ATOL:.0e} frames, "
        f"{checks.TINY_AUDIO_ATOL:.0e} waveform)")
    res = checks.check_tiny_long_video(device)
    log(f"[tiny] long-video modes (v2v, extension, keyframes, anchored chain; the audio "
        f"chain, keyframes and extension; re-noised) on the card vs the CPU: "
        f"{json.dumps(res)} (tol {checks.TINY_FRAME_ATOL:.0e} frames, "
        f"{checks.TINY_AUDIO_ATOL:.0e} waveform)")
    res = checks.check_tiny_surfaces(device, mp4_writer())
    log(f"[tiny] surfaces: SeededPipeline twice at one seed bit for bit, a served job's "
        f"pixels the direct call's bit for bit, a run resumed from its DenoiseCheckpoint "
        f"after step 1 of 4 the uninterrupted frames bit for bit: {json.dumps(res)}")
    for dtype, how in ((torch.bfloat16, "bf16"),
                       (torch.float32, "f32 compute, attention cast to bf16 on the card")):
        res = checks.check_tiny_train(device, dtype)
        log(f"[tiny] LoRA train ({checks.TINY_TRAIN_STEPS} steps, {how}) on the card vs the "
            f"CPU: first-backward LoRA gradients {res['grad_rel']:.3e}, losses "
            f"{res['loss_rel']:.3e}, LoRA leaves after the steps {res['lora_rel']:.3e} "
            f"(relative, tol {checks.TINY_TRAIN_TOL:.0e}, the bf16 run's); launches "
            f"{json.dumps(res['launches'])}")
    res = checks.check_tiny_av_train(device)
    log(f"[tiny] AV QLoRA step (int4 dual DiT, head dim 64, {checks.TINY_TRAIN_STEPS} steps) "
        f"on the card vs the CPU: first-backward LoRA gradients {res['grad_rel']:.3e}, losses "
        f"{res['loss_rel']:.3e}, LoRA leaves {res['lora_rel']:.3e} (relative, tol "
        f"{checks.TINY_TRAIN_TOL:.0e}); base bit for bit; launches "
        f"{json.dumps(res['launches'])}")


KERNELS = {"flash_attention": fa.flash_attention,
           "flash_attention_stats": fa.flash_attention_stats,
           "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
           "int4_matmul": qz.int4_matmul, "dequant_int4": qz.dequant_int4,
           "rms_norm": rk.rms_norm}


# the kernels' launches and, beside them, the CUDA calls of rms_norm that
# took the plain chain (ops.normalization.rms_chain_on_cuda) and the calls of
# the library's int8 product, the W8A8 linears' (kernels.quantization.int8_mm)
CHAIN = "rms_chain_on_cuda"
INT8 = "int8_mm"
NO_LAUNCHES = {**{name: 0 for name in KERNELS}, CHAIN: 0, INT8: 0}


def reset_counts() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0
    fa.flash_attention.launches_by_head_dim.clear()
    normalization.rms_chain_on_cuda = 0
    qz.int8_mm.calls = 0


def read_counts() -> dict:
    return {**checks.read_kernel_counts(), INT8: qz.int8_mm.calls}


def norm_launches(tcfg, tecfg, dit_calls: int, text_passes: int) -> dict:
    """The rms_norm launches of a full-width inference path on the card:
    every norm of the DiT and the connector through the kernel, none
    through the chain."""
    return {"rms_norm": checks.rms_inference_counts(tcfg, tecfg, dit_calls, text_passes)[0],
            CHAIN: 0}


def expected_launches(pipe: LTXPipeline, dit_calls: int, text_passes: int) -> dict:
    """The launch counts of a video inference path on the card: the DiT's
    and the connector's flash attentions and norms."""
    return {**NO_LAUNCHES, "flash_attention": checks.flash_inference_counts(
        pipe.tcfg, pipe.tecfg, dit_calls, text_passes),
            **norm_launches(pipe.tcfg, pipe.tecfg, dit_calls, text_passes)}


def run_counted(fn):
    """fn() with every kernel's launch count (and the chain count) set to 0
    just before it and read just after; returns (fn's result, {kernel:
    launches})."""
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
    return pipe, noise, steps, north_star_run("main", pipe, noise,
                                              expected_launches(pipe, steps, 1), device)


def phase_two_stage(pipe: LTXPipeline, device) -> dict:
    """generate_video_two_stage at full width and depth, I2V, guided stage
    1, tiled decode; every model norm through the rms_norm kernel by the
    default route. Checks the launches of flash_attention and rms_norm (and
    no norm through the chain) against the counts the code implies, and the
    frames. Returns the launches."""
    config = TWO_STAGE
    c = pipe.tcfg.in_channels
    s1 = VideoLatentShape.from_pixels(1, config.num_frames, config.height // 2,
                                      config.width // 2, channels=c)
    s2 = VideoLatentShape.from_pixels(1, config.num_frames, config.height, config.width,
                                      channels=c)
    n1 = len(schedule.get_sigmas(config.num_steps, distilled=False,
                                 token_count=s1.token_count)) - 1
    n2 = len(schedule.STAGE_2_SIGMAS) - 1
    dit_calls = n1 + n2
    expected = expected_launches(pipe, dit_calls, 1)
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
    kernel in all three, by the default route."""
    config = NORTH_STAR
    shape = VideoLatentShape.from_pixels(len(BATCH_PROMPTS), config.num_frames,
                                         config.height, config.width,
                                         channels=pipe.tcfg.in_channels)
    noise = generate_noise(shape, torch.Generator(device=device).manual_seed(3))
    steps = len(pipe._sigmas(config, shape)) - 1
    expected = expected_launches(pipe, steps, 1)
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
    sub-layer. The DiT call, its norms through the rms_norm kernel, must be
    bit for bit its solo call."""
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
    if first is not None or diff != 0.0:
        raise AssertionError(f"batched: one DiT call on two rows is not bit for bit its "
                             f"solo call ({first}, velocity {diff})")


def phase_norm_choice(pipe: LTXPipeline, device) -> dict:
    """One bf16 north-star denoise step under the default dispatch (every
    norm through the rms_norm kernel) and under `forced_rms_chain()`, in
    turns: the chain, the default, the default, the chain; three
    synchronised steps each after one warm-up, with each step's kernel
    launches and chain calls checked. The two velocities within 5e-2 of the
    largest. Returns the medians in ms."""
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
    norms = checks.rms_launches_per_dit_call(pipe.tcfg)
    want = {"chain": {"rms_norm": 0, CHAIN: norms}, "default": {"rms_norm": norms, CHAIN: 0}}
    times = {"chain": [], "default": []}
    outs = {}
    try:
        for choice in ("chain", "default", "default", "chain"):
            with forced_rms_chain() if choice == "chain" else contextlib.nullcontext(), \
                    torch.inference_mode():
                step(latent, 1.0, 0.9)
                torch.cuda.synchronize(device)
                for _ in range(3):
                    t0 = time.perf_counter()
                    (_, velocity), launches = run_counted(lambda: step(latent, 1.0, 0.9))
                    torch.cuda.synchronize(device)
                    times[choice].append(time.perf_counter() - t0)
                    got = {k: launches[k] for k in want[choice]}
                    if got != want[choice]:
                        raise AssertionError(f"norm choice {choice}: {got} in a step, expected "
                                             f"{want[choice]}")
            outs[choice] = velocity
    finally:
        pipe._release("transformer")
    diff = (outs["default"] - outs["chain"]).abs().max().item()
    scale = outs["chain"].abs().max().item()
    med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in times.items()}
    log(f"[norm] one bf16 denoise step at {shape.token_count} tokens: forced chain "
        f"{med['chain']:.2f} ms, default (rms_norm kernel, {norms} launches) "
        f"{med['default']:.2f} ms (medians of 6 synchronised steps each; all: "
        + json.dumps({k: [round(t * 1e3, 2) for t in v] for k, v in times.items()})
        + f"); velocity differs by {diff:.3e} of max {scale:.3e}")
    if not (np.isfinite(diff) and diff <= 5e-2 * scale):
        raise AssertionError(f"norm choice: velocities differ by {diff} (max {scale})")
    return med


# ---------------------------------------------------------------------------
# Long video (phase 3f): chains, extension, keyframes, video-to-video
# ---------------------------------------------------------------------------

# 121 frames at 768x512: 16 x 16 x 24 = 6144 latent tokens a segment
LONG_VIDEO = GenerationConfig(width=768, height=512, num_frames=121, num_steps=8, seed=0)
# the README's road trip: four segments, four prompts, an anchor in segment 2
CHAIN_PROMPTS = ("a road trip", "through the desert", "into the hills", "arriving at dusk")
CHAIN_COND_FRAMES = 9
LONG_TILE, LONG_OVERLAP = 8, 2


def pixels_of(frames: np.ndarray, device) -> torch.Tensor:
    """Host frames (F, H, W, 3) in [0, 1] -> pixels (1, 3, F, H, W) in [-1, 1]
    on the card."""
    return torch.from_numpy(frames).to(device).permute(3, 0, 1, 2)[None] * 2 - 1


@contextlib.contextmanager
def resident(pipe: LTXPipeline, names, device, **memory):
    """The named components placed on the card once and kept there, as a
    server deploys them (no per-phase staging, the text encoder kept), with
    `memory`'s other knobs; after, each points back at its host tensors."""
    t0 = time.perf_counter()
    host = {}
    for name in names:
        module = getattr(pipe, name)
        host[name] = {n: p.data for n, p in module.named_parameters()}
        module.to(device)
    torch.cuda.synchronize(device)
    nbytes = sum(p.numel() * p.element_size() for name in names
                 for p in getattr(pipe, name).parameters())
    log(f"[resident] {', '.join(names)} placed on the card: {nbytes / 2**30:.2f} GiB in "
        f"{time.perf_counter() - t0:.2f} s")
    saved = pipe.memory
    pipe.memory = dataclasses.replace(saved, phase_staging=False, offload_text_encoder=False,
                                      **memory)
    try:
        yield
    finally:
        pipe.memory = saved
        for name, params in host.items():
            module = getattr(pipe, name)
            # None: the block took the component from the pipeline
            for n, p in (() if module is None else module.named_parameters()):
                p.data = params[n]
        torch.cuda.empty_cache()


def log_run(tag: str, result, peak_gib: float) -> None:
    """A run's seconds by phase, its steady denoise step and its peak."""
    tm = result.timings
    log(f"[{tag}] phases (s): staging {tm.staging:.3f}, gemma {tm.gemma:.3f}, connector "
        f"{tm.connector:.3f}, encode {tm.image_encode:.3f}, denoise "
        f"{sum(tm.denoise_steps):.3f} ({len(tm.denoise_steps)} steps, steady step "
        f"{steady_steps(result)}), vae_decode {tm.vae_decode:.3f}, audio decode "
        f"{tm.audio_decode:.3f}, total {tm.total:.3f}; peak {peak_gib:.2f} GiB")


def long_run(tag: str, fn, expected: dict, config: GenerationConfig, frames: int, device):
    """fn() with the counts read around it and the device's peak memory;
    checks the launches and the frames (finite, in [0, 1], `frames` of
    them). Returns (result, launches)."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    result, launches = run_counted(fn)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    log_run(tag, result, peak_gib)
    check_launches(tag, launches, expected)
    check_frames(tag, result.frames, dataclasses.replace(config, num_frames=frames))
    return result, launches


def phase_long_video(pipe: LTXPipeline, device) -> dict:
    """The long-video modes at full width and depth in bf16 at 121f@768x512
    (6144 tokens, 8 distilled steps), the components resident on the card
    (`resident`), the decode tiled as the two-stage phase's: the README's
    four-segment chain (four prompts in one text pass,
    an anchor at pixel frame 16 of segment 2 from a seeded pixel array,
    tail renormalisation 0.5, 9 frames carried: 121 + 3 x 112 frames); its
    segment 0 against generate_video on the same draws and the chain's own
    text rows (precomputed_embeddings; a text pass's rows depend on its
    batch on the card), bit for bit; the extension of the chain's last 9
    frames; keyframes at pixel frames 0 and 112 (the chain's first and last
    frames); video-to-video at strength 0.6 on the chain's first 121 frames
    (121 frames encoded at full size). Each with its launches, phases and
    peak. Returns the launches by path."""
    config = LONG_VIDEO
    shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height, config.width,
                                         channels=pipe.tcfg.in_channels)
    steps = len(pipe._sigmas(config, shape)) - 1
    gen = torch.Generator(device=device).manual_seed(11)
    anchor = torch.rand(1, 3, 1, config.height, config.width, generator=gen,
                        device=device) * 2 - 1
    noise = [generate_noise(shape, gen) for _ in range(len(CHAIN_PROMPTS))]
    segments = len(CHAIN_PROMPTS)
    chain_frames = config.num_frames + (segments - 1) * (config.num_frames - CHAIN_COND_FRAMES)
    log(f"[long] {config.num_frames}f@{config.width}x{config.height}: {shape.token_count} "
        f"tokens, {steps} steps; chain of {segments} segments -> {chain_frames} frames; "
        f"decode tiles of {LONG_TILE} latent frames, overlap {LONG_OVERLAP}")
    launches = {}
    with resident(pipe, ("gemma", "text_encoder", "transformer", "vae_decoder", "vae_encoder"),
                  device, vae_tile_size=LONG_TILE, vae_tile_overlap=LONG_OVERLAP):
        chain, launches["long chain 4x121f@768x512"] = long_run(
            "long chain", lambda: pipe.generate_video_chain(
                CHAIN_PROMPTS[0], config, segments, noise, cond_frames=CHAIN_COND_FRAMES,
                prompts=CHAIN_PROMPTS, anchors={2: [(16, anchor)]}, tail_renorm=0.5),
            expected_launches(pipe, segments * steps, 1), config, chain_frames, device)
        rows = pipe.encode_prompts(CHAIN_PROMPTS)  # the chain's one text pass again
        solo, launches["long chain segment 0 alone"] = long_run(
            "long segment 0", lambda: pipe.generate_video(
                CHAIN_PROMPTS[0], config, noise[0], precomputed_embeddings=rows[0]),
            expected_launches(pipe, steps, 0), config, config.num_frames, device)
        same = np.array_equal(chain.frames[:config.num_frames], solo.frames)
        log(f"[long] the chain's first {config.num_frames} frames against generate_video on "
            f"segment 0's draws and text rows: bit for bit {same}")
        if not same:
            diff = np.abs(chain.frames[:config.num_frames] - solo.frames).max()
            raise AssertionError(f"long chain: segment 0 differs from generate_video by {diff}")
        del solo, rows

        tail = pixels_of(chain.frames[-CHAIN_COND_FRAMES:], device)
        _, launches["long extension 121f"] = long_run(
            "long extension", lambda: pipe.generate_video_extension(
                PROMPT, config, generate_noise(shape, gen), video_frames=tail,
                cond_frames=CHAIN_COND_FRAMES),
            expected_launches(pipe, steps, 1), config, config.num_frames, device)
        del tail
        first, last = pixels_of(chain.frames[:1], device), pixels_of(chain.frames[-1:], device)
        _, launches["long keyframes 0 and 112"] = long_run(
            "long keyframes", lambda: pipe.generate_video_keyframes(
                PROMPT, config, [(0, first), (112, last)], generate_noise(shape, gen)),
            expected_launches(pipe, steps, 1), config, config.num_frames, device)
        clip = pixels_of(chain.frames[:config.num_frames], device)
        del chain
        k = min(max(int(round(0.4 * steps)), 0), steps - 1)
        _, launches["long v2v 121f strength 0.6"] = long_run(
            "long v2v", lambda: pipe.generate_video_from_video(
                PROMPT, config, generate_noise(shape, gen), video_frames=clip, strength=0.6),
            expected_launches(pipe, steps - k, 1), config, config.num_frames, device)
    return launches


# ---------------------------------------------------------------------------
# Prompt enhancement (phase 3e)
# ---------------------------------------------------------------------------

# the cycle model's generated tokens, and the drafts of the enhancement's
# speculation (GenerationConfig.enhancement_spec_k's default)
CYCLE_NEW_TOKENS = 64
SPEC_K = 8
# the share of the drafts a verify forward commits on the cycle model, at
# least (the tiny test's: more than 3 tokens a forward of 5 at spec_k 4)
CYCLE_ACCEPTANCE = 0.9
I2V_NEW_TOKENS = 32


def timed_generate(fn):
    """(fn()'s result, its seconds, synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_cycle_gemma(tok: Tokenizer, device) -> None:
    """The cycle Gemma at Gemma-3-12B's shapes, bf16, built on the card:
    greedy speculation (8 drafts) token for token the sequential run, its
    commit rate, two prompts batched row for row their solo runs, an int8
    cache the same tokens; every launch count 0 (Gemma's attention is
    grouped-query, plain)."""
    from ltx_tpu_torch.weights.synthetic import default_cycle, make_cycle_gemma

    cfg = gemma3.Gemma3Config()
    t0 = time.perf_counter()
    model = make_cycle_gemma(cfg, torch.Generator(device=device).manual_seed(0),
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    cycle = list(default_cycle(cfg))
    log(f"[cycle] cycle Gemma at Gemma-3-12B's shapes (bf16, built on the card): "
        f"{time.perf_counter() - t0:.2f} s, cycle {cycle[0]}..{cycle[-1]}")
    prompts = [np.asarray(tok.encode(p).ids + cycle + cycle[:4]) for p in BATCH_PROMPTS]
    kw = dict(max_new_tokens=CYCLE_NEW_TOKENS, temperature=0.0, stop_tokens=(),
              return_stats=True)
    runs = {}
    for name, extra in (("sequential", {}), ("spec", dict(spec_k=SPEC_K)),
                        ("int8 cache, spec", dict(spec_k=SPEC_K, kv_quant="int8"))):
        ((toks, stats), seconds), launches = run_counted(lambda: timed_generate(
            lambda: gemma3.generate_tokens(model, prompts[0], **kw, **extra)))
        runs[name] = toks
        check_launches(f"cycle {name}", launches, NO_LAUNCHES)
        log(f"[cycle] {name}: {len(toks)} tokens in {stats['forwards']} decode forwards "
            f"({len(toks) / stats['forwards']:.2f} a forward), {seconds:.3f} s, "
            f"{seconds / (stats['forwards'] + 1) * 1e3:.2f} ms a forward (prefill among them), "
            f"{len(toks) / seconds:.1f} tokens/s")
        if name == "spec":
            share = len(toks) / stats["forwards"] / (SPEC_K + 1)
            log(f"[cycle] speculation commits {share:.3f} of a full bundle (must exceed "
                f"{CYCLE_ACCEPTANCE})")
            if not share > CYCLE_ACCEPTANCE:
                raise AssertionError(f"cycle Gemma: speculation commits {share}")
    solo = gemma3.generate_tokens(model, prompts[1], **kw, spec_k=SPEC_K)[0]
    (batched, seconds) = timed_generate(lambda: gemma3.generate_tokens_batched(
        model, prompts, max_new_tokens=CYCLE_NEW_TOKENS, temperature=0.0, stop_tokens=(),
        spec_k=SPEC_K))
    same = {"spec == sequential": runs["spec"] == runs["sequential"],
            "int8 cache == sequential": runs["int8 cache, spec"] == runs["sequential"],
            "batched == solo": batched == [runs["spec"], solo]}
    walks = all(b == cycle[(cycle.index(a) + 1) % len(cycle)]
                for a, b in zip(runs["sequential"], runs["sequential"][1:]))
    log(f"[cycle] two prompts batched with speculation: {seconds:.3f} s; {json.dumps(same)}; "
        f"the sequential run walks the cycle: {walks}")
    if not (all(same.values()) and walks):
        raise AssertionError(f"cycle Gemma: {same}, walks {walks}")
    del model
    gc.collect()
    torch.cuda.empty_cache()


class _Records(logging.Handler):
    """The records of a logger, kept."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@contextlib.contextmanager
def port_log():
    """The port's log records at INFO and up, for the duration."""
    logger = logging.getLogger("ltx_tpu_torch")
    handler, level = _Records(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield handler.records
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


DECODE_PROFILED_BUNDLE = SPEC_K + 1


def profile_decode(gemma, tok: Tokenizer) -> dict:
    """A few speculative verify forwards (SPEC_K + 1 tokens) of `gemma` over
    the enhancement prompt's cache, as profile_step profiles a denoise step:
    host ms, device ms by group, idle share."""
    ids = tok.encode(enhance.build_chat_prompt(enhance.T2V_SYSTEM_PROMPT, PROMPT)).ids
    t_pad = -(-len(ids) // 128) * 128
    dec = gemma3.KVDecoder(gemma, [t_pad - len(ids)], t_pad + 512 + SPEC_K + 1)
    padded = np.zeros((1, t_pad), np.int64)
    padded[0, t_pad - len(ids):] = ids
    toks = np.asarray([ids[-DECODE_PROFILED_BUNDLE:]])

    def forward():
        with torch.inference_mode():
            dec.forward(toks, t_pad)

    with torch.inference_mode():
        dec.prefill(dec.embed(torch.from_numpy(padded).to(gemma.norm.weight.device)))
    return profile_steps(forward)


def phase_enhancement(pipe: LTXPipeline, tok: Tokenizer, noise, steps: int, device) -> int:
    """generate_video with enhance_prompt=True on the phase-3 pipeline (its
    bf16 Gemma-3-12B on random weights, the default 512 tokens and 8
    drafts, temperature 0.7): the enhanced text, not the fallback; the north
    star's launch counts; the phase's seconds, tokens, forwards and peak
    memory; a few decode forwards profiled; enhance_prompts(strict=True);
    then the I2V image path (`phase_i2v_siglip`, whose flash launches it
    returns)."""
    config = dataclasses.replace(NORTH_STAR, enhance_prompt=True)
    expected = {**NO_LAUNCHES, "flash_attention": steps * pipe.tcfg.num_layers * 2
                + pipe.tecfg.connector_layers,
                **norm_launches(pipe.tcfg, pipe.tecfg, steps, 1)}
    pipe.tokenizer = tok
    try:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        with port_log() as records:
            result, launches = run_counted(lambda: pipe.generate_video(PROMPT, config, noise))
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
        texts = [r.getMessage() for r in records]
        enhanced = [t for t in texts if t.startswith("Enhanced prompt: ")]
        failed = [t for t in texts if "enhancement failed" in t or "not loaded" in t]
        tm = result.timings
        log(f"[enhance] generate_video, enhance_prompt=True, {config.num_frames}f@"
            f"{config.width}x{config.height}: enhancement {tm.enhancement:.3f} s, "
            f"{tm.enhancement_tokens} tokens in {tm.enhancement_forwards} decode forwards "
            f"({tm.enhancement_tokens / max(tm.enhancement_forwards, 1):.2f} a forward), "
            f"{tm.enhancement_tokens / tm.enhancement:.1f} tokens/s, "
            f"{tm.enhancement / (tm.enhancement_forwards + 1) * 1e3:.2f} ms a forward "
            f"(prefill among them); phases (s): staging {tm.staging:.3f}, gemma "
            f"{tm.gemma:.3f}, connector {tm.connector:.3f}, denoise "
            f"{sum(tm.denoise_steps):.3f}, vae_decode {tm.vae_decode:.3f}, total "
            f"{tm.total:.3f}; peak device memory {peak_gib:.2f} GiB")
        log(f"[enhance] enhanced prompt ({len(enhanced[0]) if enhanced else 0} characters): "
            f"{enhanced[0][len('Enhanced prompt: '):][:160]!r}" if enhanced else
            "[enhance] no enhanced prompt logged")
        check_launches("enhance", launches, expected)
        check_frames("enhance", result.frames, config)
        if failed or len(enhanced) != 1 or enhanced[0] == f"Enhanced prompt: {PROMPT}" \
                or tm.enhancement_tokens == 0:
            raise AssertionError(f"enhancement fell back: {failed or enhanced}")

        gemma = pipe._on_device("gemma", GenerationTimings())
        res = profile_decode(gemma, tok)
        groups = ", ".join(f"{k} {v:.2f}" for k, v in res["device_ms"].items() if v)
        log(f"[enhance] decode forward of {DECODE_PROFILED_BUNDLE} tokens (profiled): host "
            f"{res['host_ms']:.2f} ms, device {res['device_busy_ms']:.2f} ms ({groups}), idle "
            f"share {res['idle_share']:.3f}; unprofiled wall {res['wall_ms']:.2f} ms")
        out, seconds = timed_generate(lambda: enhance.enhance_prompts(
            gemma, tok, list(BATCH_PROMPTS), max_tokens=I2V_NEW_TOKENS, strict=True))
        log(f"[enhance] enhance_prompts(strict=True), {len(out)} prompts, "
            f"{I2V_NEW_TOKENS} tokens: {seconds:.3f} s, lengths {[len(t) for t in out]}")
        if len(out) != len(BATCH_PROMPTS) or not all(out):
            raise AssertionError(f"enhance_prompts: {out}")
        return phase_i2v_siglip(gemma, tok, device)
    finally:
        pipe.tokenizer = None
        pipe._release("gemma")


SIGLIP_LAYERS = 27


def phase_i2v_siglip(gemma, tok: Tokenizer, device) -> int:
    """I2V enhancement's image path at full size: SigLIP-So400m (random,
    seeded, bf16) on a seeded 896x896 pixel array through vision_forward
    (the flash kernel at head dim 72, one launch a layer) held against the
    same tower on the plain attention; its 256 soft tokens spliced into the
    I2V prompt and decoded greedily. Returns the tower's flash launches."""
    from ltx_tpu_torch.models.siglip import (
        SigLIPConfig,
        project_to_soft_tokens,
        vision_forward,
    )

    cfg = SigLIPConfig()
    model, pixels = checks.siglip_inputs(cfg, device)
    with torch.inference_mode():
        res, launches = run_counted(lambda: checks.check_siglip(model, pixels))
        ms = cuda_ms(lambda: vision_forward(model, pixels), warmup=1, iters=3)
        soft = project_to_soft_tokens(model, res["features"])
    log(f"[siglip] SigLIP-So400m {cfg.num_layers} layers at {cfg.image_size}x{cfg.image_size} "
        f"({cfg.num_patches} patches, {cfg.num_heads} heads of "
        f"{cfg.hidden_size // cfg.num_heads}): features vs the plain attention "
        f"{res['rel_err']:.3e} of max (tol {checks.SIGLIP_REL_TOL:.0e}); tower {ms:.2f} ms; "
        f"soft tokens {tuple(soft.shape)}; launches {json.dumps(launches)}")
    check_launches("siglip", launches, {**NO_LAUNCHES, "flash_attention": SIGLIP_LAYERS})
    ids, embeds = enhance._splice_image_embeds(gemma, tok, enhance.I2V_SYSTEM_PROMPT, PROMPT,
                                               soft)
    (toks, stats), seconds = timed_generate(lambda: gemma3.generate_tokens(
        gemma, [ids], max_new_tokens=I2V_NEW_TOKENS, temperature=0.0, spec_k=SPEC_K,
        input_embeds=embeds, return_stats=True, stop_tokens=enhance._stop_ids(tok)))
    text = enhance.clean_enhanced_prompt(tok.decode(toks))
    log(f"[siglip] I2V prompt of {len(ids)} positions ({soft.shape[1]} soft tokens): "
        f"{len(toks)} tokens in {stats['forwards']} forwards, {seconds:.3f} s; the first "
        f"ids {toks[:8]}, text {len(text)} characters (special ids decode to nothing)")
    del model
    return launches["flash_attention"]


# ---------------------------------------------------------------------------
# The surfaces: server, CLI, resume (phase 3g)
# ---------------------------------------------------------------------------

SURFACE_SEEDS = (7, 8, 7)
SURFACE_ENHANCE_TOKENS = 32
SURFACE_STOP_AFTER = 4  # the resumed run's interrupted steps
# the first enhance request waits this long for the second to join its batch
SURFACE_BATCH_WINDOW_S = 0.5


class _Stop(Exception):
    """Raised from on_progress to interrupt a run."""


def surface_body(seed: int) -> dict:
    """A /v1/generate body at the north star: what the CLI's defaults set."""
    return {"prompt": PROMPT, "width": NORTH_STAR.width, "height": NORTH_STAR.height,
            "num_frames": NORTH_STAR.num_frames, "num_steps": NORTH_STAR.num_steps,
            "seed": seed}


def served_job(base: str, body: dict):
    """POST /v1/generate, polled to its end, with the launch counts read
    around it: (job record, launches, seconds from submit to done)."""
    reset_counts()
    t0 = time.perf_counter()
    code, out = checks.http_json(f"{base}/v1/generate", body)
    if code != 202:
        raise AssertionError(f"POST /v1/generate: {code} {out}")
    job = checks.wait_job(base, out["job_id"])
    seconds = time.perf_counter() - t0
    launches = read_counts()
    if job["state"] != "done":
        raise AssertionError(f"served job {job['state']}: {job.get('error')}")
    return job, launches, seconds


def trace_kernel_counts(path: str) -> dict:
    """Kernel launches by B1's and B6's kernel names in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"flash_fwd_kernel": sum("flash_fwd_kernel" in n for n in names),
            "rms_norm_kernel": sum("rms_norm_kernel" in n for n in names),
            "kernels": len(names)}


def phase_surfaces(pipe: LTXPipeline, tok: Tokenizer, device) -> dict:
    """The port's surfaces at the north star on the phase-3 pipeline (bf16,
    full width and depth, with its Gemma and the smoke tokenizer), its
    components resident as a server keeps them: build_app on a
    SeededPipeline with the north star's warmup, served on 127.0.0.1 from a
    thread; /healthz; two concurrent /v1/enhance requests of 32 tokens
    coalesced into one batch; three T2V jobs at seeds 7, 8, 7 (1 and 3 the
    same pixels bit for bit, 2 not; /metrics counts three done t2v jobs);
    one more job under profile_trace, whose Chrome trace names B1's and B6's
    kernels as often as the counts say; the CLI's `generate` at seed 7 on
    this pipeline (its config job 1's, its pixels job 1's, bit for bit);
    a DenoiseCheckpoint run stopped after 4 steps and resumed: the
    uninterrupted frames bit for bit, the DiT launched for 4 steps. Each
    request's launches checked. Returns the launches by path."""
    from ltx_tpu_torch.io import cli
    from ltx_tpu_torch.io.video import frames_to_uint8
    from ltx_tpu_torch.pipeline import loader
    from ltx_tpu_torch.pipeline.seeded import SeededPipeline
    from ltx_tpu_torch.serve.app import build_app, request_to_config
    from ltx_tpu_torch.serve.server import serve_forever_threaded
    from ltx_tpu_torch.utils.diagnostics import DenoiseCheckpoint, profile_trace

    steps = len(pipe._sigmas(NORTH_STAR, pipe._shape(NORTH_STAR))) - 1
    expected = expected_launches(pipe, steps, 1)
    launches = {}
    seeded = SeededPipeline(pipe)
    pipe.tokenizer = tok
    out_dir = build.BUILD_DIR.parent / "chip_smoke_surfaces"
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        with resident(pipe, ("gemma", "text_encoder", "transformer", "vae_decoder"), device), \
                checks.recorded_mp4(mp4_writer()) as written:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            app = build_app(seeded, output_dir=str(out_dir / "serve"), port=0,
                            batch_window_s=SURFACE_BATCH_WINDOW_S, warmup_shapes=[(NORTH_STAR.width, NORTH_STAR.height,
                                            NORTH_STAR.num_frames)])
            log(f"[surfaces] build_app with the north star's warmup (one seeded step and "
                f"its decode): warmup {app.warmup_seconds:.3f} s")
            serve_forever_threaded(app.server)
            base = "http://%s:%d" % app.server.server_address[:2]
            try:
                code, health = checks.http_json(f"{base}/healthz")
                if (code, health) != (200, {"status": "ok"}):
                    raise AssertionError(f"/healthz: {code} {health}")
                replies = {}

                def enhance_one(prompt):
                    replies[prompt] = checks.http_json(
                        f"{base}/v1/enhance",
                        {"prompts": [prompt], "max_tokens": SURFACE_ENHANCE_TOKENS})

                t0 = time.perf_counter()
                threads = [threading.Thread(target=enhance_one, args=(p,))
                           for p in BATCH_PROMPTS]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                enhance_s = time.perf_counter() - t0
                stats = checks.http_json(f"{base}/v1/stats")[1]["enhance"]
                log(f"[surfaces] two concurrent /v1/enhance requests of "
                    f"{SURFACE_ENHANCE_TOKENS} tokens: {enhance_s:.3f} s, batch sizes "
                    f"{stats['recent_batch_sizes']}, lengths "
                    f"{[len(r[1]['prompts'][0]) for r in replies.values()]}")
                if any(code != 200 or not out["prompts"][0] for code, out in replies.values()):
                    raise AssertionError(f"/v1/enhance: {replies}")
                if stats["recent_batch_sizes"] != [len(BATCH_PROMPTS)]:
                    raise AssertionError(f"the enhance requests did not coalesce: {stats}")

                jobs = []
                for i, seed in enumerate(SURFACE_SEEDS):
                    job, got, seconds = served_job(base, surface_body(seed))
                    check_launches(f"surfaces job {i + 1}", got, expected)
                    jobs.append((job, seconds))
                    rec = job["result"]
                    run_s = job["finished_at"] - job["started_at"]
                    log(f"[surfaces] job {i + 1} (seed {seed}): {seconds:.3f} s from submit "
                        f"to done ({run_s:.3f} s running), {rec['frames']} frames "
                        f"{rec['width']}x{rec['height']}")
                launches["served north star"] = got
                pixels = [written[job["result"]["output"]] for job, _ in jobs]
                log(f"[surfaces] job latency: first {jobs[0][1]:.3f} s (after the warmup), "
                    f"steady {jobs[1][1]:.3f} / {jobs[2][1]:.3f} s")
                if not np.array_equal(pixels[0], pixels[2]):
                    raise AssertionError("jobs 1 and 3 (seed 7) gave other pixels")
                if np.array_equal(pixels[0], pixels[1]):
                    raise AssertionError("jobs 1 and 2 (seeds 7 and 8) gave the same pixels")
                code, text = http_text(f"{base}/metrics")
                done = 'ltx_job_seconds_count{kind="t2v",state="done"} 3'
                if code != 200 or done not in text:
                    raise AssertionError(f"/metrics lacks {done!r}")
                log(f"[surfaces] jobs 1 and 3 bit for bit, job 2 not; /metrics: {done}")

                with profile_trace(str(out_dir / "trace")) as prof:
                    _, got, seconds = served_job(base, surface_body(9))
                counts = trace_kernel_counts(prof.trace_path)
                log(f"[surfaces] a profiled job: {seconds:.3f} s; its Chrome trace "
                    f"({Path(prof.trace_path).stat().st_size / 2**20:.1f} MiB) "
                    f"{json.dumps(counts)}")
                check_launches("surfaces profiled job", got, expected)
                if (counts["flash_fwd_kernel"], counts["rms_norm_kernel"]) != \
                        (got["flash_attention"], got["rms_norm"]):
                    raise AssertionError(f"the trace's kernels {counts} against the counts "
                                         f"{got}")
            finally:
                app.close()

            argv = ["generate", PROMPT, "-w", str(NORTH_STAR.width), "-H",
                    str(NORTH_STAR.height), "-f", str(NORTH_STAR.num_frames), "--seed", "7",
                    "-o", str(out_dir / "cli.mp4"), "--profile"]
            cli_config = cli._generation_config(cli.build_parser().parse_args(argv))
            job_config = request_to_config(surface_body(7))
            if cli_config != job_config:
                raise AssertionError(f"the CLI's config {cli_config} is not job 1's "
                                     f"{job_config}")
            real_load = loader.load_pipeline
            loader.load_pipeline = lambda **kw: pipe
            try:
                t0 = time.perf_counter()
                (rc, got) = run_counted(lambda: cli.main(argv))
                cli_s = time.perf_counter() - t0
            finally:
                loader.load_pipeline = real_load
            check_launches("surfaces CLI", got, expected)
            launches["CLI north star"] = got
            same = np.array_equal(written[str(out_dir / "cli.mp4")], pixels[0])
            log(f"[surfaces] CLI generate --seed 7 --profile: rc {rc}, {cli_s:.3f} s; config "
                f"field for field job 1's; pixels job 1's bit for bit {same}")
            if rc != 0 or not same:
                raise AssertionError(f"the CLI run: rc {rc}, pixels job 1's {same}")

            config = request_to_config(surface_body(7))
            whole = seeded.generate_video(PROMPT, config)
            if not np.array_equal(frames_to_uint8(whole.frames), pixels[0]):
                raise AssertionError("the direct call's pixels differ from job 1's")
            ckpt = DenoiseCheckpoint(str(out_dir / "denoise.ckpt"), every_n_steps=2)

            def stop(i, n, sigma):
                if i == SURFACE_STOP_AFTER - 1:
                    raise _Stop

            try:
                seeded.generate_video(PROMPT, config, on_progress=stop, checkpoint=ckpt)
                raise AssertionError("the interrupted run ran to its end")
            except _Stop:
                pass
            resumed, got = run_counted(
                lambda: seeded.generate_video(PROMPT, config, checkpoint=ckpt))
            check_launches("surfaces resumed", got,
                           expected_launches(pipe, steps - SURFACE_STOP_AFTER, 1))
            launches["resumed north star"] = got
            same = np.array_equal(resumed.frames, whole.frames)
            log(f"[surfaces] resumed after step {SURFACE_STOP_AFTER} of {steps}: "
                f"{len(resumed.timings.denoise_steps)} steps run, "
                f"{resumed.timings.total:.3f} s (uninterrupted {whole.timings.total:.3f} s); "
                f"frames the uninterrupted run's bit for bit {same}")
            if not same:
                raise AssertionError("the resumed run differs from the uninterrupted one")
            peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
            log(f"[surfaces] peak device memory {peak_gib:.2f} GiB")
    finally:
        pipe.tokenizer = None
        shutil.rmtree(out_dir, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Training data (phase 3h): prepare-data on clips written here
# ---------------------------------------------------------------------------

PREPARE_CAPTIONS = ("A red fox runs across a snowy field",
                    "Waves roll onto a pebble beach under grey clouds",
                    "A cyclist climbs a winding mountain road",
                    "Lanterns sway over a night market street")
PREPARE_ROWS_PER_SHARD = 2


def write_clip(path: Path, seed: int, config: GenerationConfig = NORTH_STAR) -> None:
    """A clip of config.num_frames frames at config's size: smooth colour
    gradients drifting with a seeded phase and speed (an easy picture for
    the mp4v encoder), written with OpenCV at config.fps."""
    import cv2

    rng = np.random.default_rng(seed)
    phase, speed = rng.uniform(0, 1, 3), rng.uniform(0.5, 2.0)
    y = np.linspace(0, 1, config.height)[:, None, None]
    x = np.linspace(0, 1, config.width)[None, :, None]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), config.fps,
                             (config.width, config.height))
    try:
        for t in np.linspace(0, 1, config.num_frames):
            rgb = 0.5 + 0.45 * np.sin(2 * np.pi * (speed * t + x + 0.7 * y + phase))
            writer.write(cv2.cvtColor((rgb * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def phase_prepare_data(pipe: LTXPipeline, tok: Tokenizer, device):
    """`prepare-data` through io/cli.py at the north star's 25f@768x512 on the
    phase-3 pipeline (bf16, full width and depth, the smoke tokenizer), its
    Gemma, connector and VAE resident, load_pipeline swapped for it: four
    clips written here, from a JSONL manifest and again from .mp4 + .txt
    sidecars, two rows a shard. Asserts two shards of grid TRAIN_GRID a run,
    finite rows, the two runs bit for bit each other, each clip's tokens bit
    for bit encode_clip of that clip alone, the launches of one text pass
    (four captions in one batch) and none of the DiT. Returns (the launches
    of the manifest run, the directory of its shards, which phase 6 trains
    on)."""
    from ltx_tpu_torch.io import cli
    from ltx_tpu_torch.pipeline import loader
    from ltx_tpu_torch.train import prepare

    config = NORTH_STAR
    work = build.BUILD_DIR.parent / "chip_smoke_prepare"
    shutil.rmtree(work, ignore_errors=True)
    clips = work / "clips"
    clips.mkdir(parents=True)
    items = []
    for i, caption in enumerate(PREPARE_CAPTIONS):
        path = clips / f"clip{i}.mp4"
        write_clip(path, seed=30 + i)
        path.with_suffix(".txt").write_text(caption + "\n")
        items.append((str(path), caption))
    manifest = work / "manifest.jsonl"
    manifest.write_text("".join(json.dumps({"video": f"clips/clip{i}.mp4", "caption": c}) + "\n"
                                for i, c in enumerate(PREPARE_CAPTIONS)))
    size = ["-w", str(config.width), "-H", str(config.height), "-f", str(config.num_frames),
            "--rows-per-shard", str(PREPARE_ROWS_PER_SHARD)]
    expected = expected_launches(pipe, 0, 1)
    runs = {}
    pipe.tokenizer = tok
    try:
        with resident(pipe, ("gemma", "text_encoder", "vae_encoder", "vae_decoder"), device):
            real_load = loader.load_pipeline
            loader.load_pipeline = lambda **kw: pipe
            try:
                for name, source in (("manifest", manifest), ("sidecars", clips)):
                    out = work / f"shards_{name}"
                    torch.cuda.synchronize(device)
                    t0 = time.perf_counter()
                    rc, launches = run_counted(lambda: cli.main(
                        ["prepare-data", str(source), "--out", str(out), *size]))
                    seconds = time.perf_counter() - t0
                    log(f"[prepare] prepare-data from the {name} ({len(items)} clips of "
                        f"{config.num_frames}f@{config.width}x{config.height}): rc {rc}, "
                        f"{seconds:.3f} s")
                    if rc != 0:
                        raise AssertionError(f"prepare-data from the {name}: rc {rc}")
                    check_launches(f"prepare {name}", launches, expected)
                    runs[name] = (sorted(out.glob("*.npz")), launches)
            finally:
                loader.load_pipeline = real_load
            shards, launches = runs["manifest"]
            rows = []
            for path in shards:
                with np.load(path) as z:
                    shard = {k: z[k] for k in z.files}
                log(f"[prepare] {path.name}: tokens {shard['tokens'].shape} "
                    f"{shard['tokens'].dtype}, context {shard['context'].shape}, mask "
                    f"{shard['mask'].shape} ({shard['mask'].sum(axis=1).tolist()} real "
                    f"tokens), grid {tuple(shard['grid'])}")
                if tuple(shard["grid"]) != TRAIN_GRID or len(shard["tokens"]) != \
                        PREPARE_ROWS_PER_SHARD or not (np.isfinite(shard["tokens"]).all()
                                                       and np.isfinite(shard["context"]).all()):
                    raise AssertionError(f"prepare-data: {path.name} grid {shard['grid']}, "
                                         f"{len(shard['tokens'])} rows, or non-finite")
                rows += list(shard["tokens"])
            if [p.name for p in shards] != ["shard00000.npz", "shard00001.npz"]:
                raise AssertionError(f"prepare-data wrote {[p.name for p in shards]}")
            for a, b in zip(shards, runs["sidecars"][0]):
                with np.load(a) as za, np.load(b) as zb:
                    if a.name != b.name or not all(np.array_equal(za[k], zb[k])
                                                   for k in za.files):
                        raise AssertionError(f"prepare-data: {a.name} from the manifest "
                                             f"differs from {b.name} from the sidecars")
            clip_s = []
            for (path, _), row in zip(items, rows):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                tokens, grid = prepare.encode_clip(pipe, path, config.width, config.height,
                                                   config.num_frames)
                clip_s.append(time.perf_counter() - t0)
                if grid != TRAIN_GRID or not np.array_equal(tokens, row):
                    raise AssertionError(f"prepare-data: {path}'s tokens are not encode_clip's "
                                         "of that clip alone")
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            pipe.encode_prompts(list(PREPARE_CAPTIONS), batch=4)
            torch.cuda.synchronize(device)
            text_s = time.perf_counter() - t0
        log(f"[prepare] two shards a run, grid {TRAIN_GRID}, finite; the manifest's and the "
            f"sidecars' shards bit for bit; each clip's tokens bit for bit encode_clip alone; "
            f"seconds a clip (decode, resize, VAE encode): "
            + ", ".join(f"{t:.3f}" for t in clip_s)
            + f"; the text pass of {len(items)} captions in one batch: {text_s:.3f} s")
    finally:
        pipe.tokenizer = None
    return launches, work / "shards_manifest"


def http_text(url: str):
    """(status, body text) of a GET."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read().decode()


# the greedy tokens each loaded quantized Gemma decodes, sequential and with
# drafts
FILES_DECODE_TOKENS = 32


def gemma_decode(tag: str, pipe: LTXPipeline, counter: str) -> int:
    """A greedy FILES_DECODE_TOKENS-token generate_tokens of the loaded Gemma, sequential and
    with 8 drafts: 48 x 7 launches of `counter` (int4_matmul, or the int8
    product of W8A8) each forward, the prefill's and every decode
    forward's (one row, or SPEC_K + 1). Returns the decode forwards'
    launches of both runs."""
    gemma = pipe._on_device("gemma", GenerationTimings())
    ids = pipe.tokenizer.encode(PROMPT).ids
    per_forward = pipe.gcfg.hidden_layers * 7
    runs, decode_launches = {}, 0
    for spec_k in (0, SPEC_K):
        ((toks, stats), seconds), launches = run_counted(lambda: timed_generate(
            lambda: gemma3.generate_tokens(gemma, ids, max_new_tokens=FILES_DECODE_TOKENS,
                                           temperature=0.0, stop_tokens=(), spec_k=spec_k,
                                           return_stats=True)))
        runs[spec_k] = toks
        rows = 1 if spec_k == 0 else spec_k + 1
        log(f"[files] Gemma {tag} decode, {rows} row(s) a forward: {len(toks)} tokens in "
            f"{stats['forwards']} forwards, {seconds:.3f} s, "
            f"{seconds / (stats['forwards'] + 1) * 1e3:.2f} ms a forward (prefill among them)")
        check_launches(f"files gemma {tag} decode", launches,
                       {**NO_LAUNCHES, counter: per_forward * (stats["forwards"] + 1)})
        decode_launches += per_forward * stats["forwards"]
    agree = next((i for i, (a, b) in enumerate(zip(runs[0], runs[SPEC_K])) if a != b),
                 len(runs[0]))
    log(f"[files] Gemma {tag}: speculative and sequential greedy agree on the first {agree} "
        f"of {len(runs[0])} tokens (random weights: a near-tie may part them)")
    pipe._release("gemma")
    return decode_launches


def structure_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of the module tree sharing every parameter and buffer, so
    that swapping a submodule of the copy leaves the original as it is."""
    memo = {id(t): t for t in list(model.parameters()) + list(model.buffers())}
    return copy.deepcopy(model, memo)


def steady_steps(result) -> str:
    """The denoise steps after the first (the first pays first calls)."""
    steps = result.timings.denoise_steps[1:]
    return f"{min(steps):.4f}-{max(steps):.4f} s" if steps else "n/a"


def phase_w8a8_main_path(pipe: LTXPipeline, noise, steps: int, device):
    """The same seeded bf16 DiT requantized per channel to W8A8 on the card
    (quantize_transformer(w8a8=True), layer by layer) into a copy that
    shares the norms and tables, then the same generate_video: every block
    linear through the library's int8 product. The bf16 DiT is put back
    after. Returns the run (result, peak GiB)."""
    bf16 = pipe.transformer
    t0 = time.perf_counter()
    pipe.transformer = quantize_transformer(structure_copy(bf16), bits=8, device=device,
                                            w8a8=True)
    quantized = sum(isinstance(m, W8A8Linear) for m in pipe.transformer.modules())
    nbytes = sum(p.numel() * p.element_size() for p in pipe.transformer.parameters())
    log(f"[w8a8] DiT requantized on the card, kept on the host: {quantized} linears, "
        f"{time.perf_counter() - t0:.2f} s; DiT now {nbytes / 1e9:.2f} GB")
    expected = {**expected_launches(pipe, steps, 1), INT8: steps * pipe.tcfg.num_layers * 10}
    try:
        _, run = north_star_run("w8a8", pipe, noise, expected, device)
    finally:
        pipe.transformer = bf16
    log(f"[w8a8] steady denoise step {steady_steps(run[0])}, peak {run[1]:.2f} GiB")
    return run


def frames_beside_bf16(tag: str, frames, bf16_frames) -> tuple:
    """(mean abs difference, correlation) of a quantized run's frames with
    the bf16 run's, printed."""
    diff = np.abs(frames - bf16_frames)
    corr = float(np.corrcoef(frames.ravel(), bf16_frames.ravel())[0, 1])
    log(f"[{tag}] frames - bf16: max abs {diff.max():.4f}, mean abs {diff.mean():.5f}, "
        f"correlation {corr:.6f}")
    return float(diff.mean()), corr


def phase_int4_main_path(pipe: LTXPipeline, noise, steps: int, bf16_run, device,
                         w8a8_run) -> dict:
    """The same seeded DiT quantized to int4 (group 64) in place, layer by
    layer on the card, then the same generate_video: every block linear
    (attn1 and attn2 q/k/v/out, ff in/out) through int4_matmul. Prints the
    phases beside the bf16 and W8A8 runs'; the W8A8 frames must be no
    further from the bf16 frames than the int4 frames are (mean abs
    difference and correlation): a W8A8 weight is within half a step of
    1/127 of its channel's largest, an int4 one within half a step of 1/15
    of its group's range. Returns the launches."""
    t0 = time.perf_counter()
    quantize_transformer(pipe.transformer, bits=4, group_size=64, device=device)
    quantized = sum(isinstance(m, QuantizedLinear) for m in pipe.transformer.modules())
    nbytes = sum(p.numel() * p.element_size() for p in pipe.transformer.parameters())
    log(f"[int4] DiT quantized on the card, kept on the host: {quantized} linears, "
        f"{time.perf_counter() - t0:.2f} s; DiT now {nbytes / 1e9:.2f} GB")
    expected = {**expected_launches(pipe, steps, 1),
                "int4_matmul": steps * pipe.tcfg.num_layers * 10}
    launches, int4_run = north_star_run("int4", pipe, noise, expected, device)
    for name, (result, peak) in (("bf16", bf16_run), ("w8a8", w8a8_run), ("int4", int4_run)):
        tm, frames = result.timings, result.frames
        log(f"[int4] beside bf16 and w8a8: {name} staging {tm.staging:.3f} s, denoise "
            f"{sum(tm.denoise_steps):.3f} s (steady step {steady_steps(result)}), total "
            f"{tm.total:.3f} s, peak {peak:.2f} GiB, frames mean {frames.mean():.4f} std "
            f"{frames.std():.4f}")
    bf16_frames = bf16_run[0].frames
    int4_mean, int4_corr = frames_beside_bf16("int4", int4_run[0].frames, bf16_frames)
    w8a8_mean, w8a8_corr = frames_beside_bf16("w8a8", w8a8_run[0].frames, bf16_frames)
    if not (w8a8_mean <= int4_mean and w8a8_corr >= int4_corr):
        raise AssertionError(f"w8a8 frames further from bf16 ({w8a8_mean}, {w8a8_corr}) than "
                             f"int4's ({int4_mean}, {int4_corr})")
    return launches


# ---------------------------------------------------------------------------
# Joint audio (phase 5c): the dual audio-video DiT at full width and depth
# ---------------------------------------------------------------------------

# the flagship: two-stage joint audio at 241f@1024x640 (stage 1 at 512x320,
# 4960 tokens; stage 2 19840; 251 audio tokens), I2V through the image hooks
AV_FLAGSHIP = GenerationConfig(width=1024, height=640, num_frames=241, num_steps=8, seed=0,
                               image_cond_noise_scale=0.15, two_stage=True)
AV_FLAGSHIP_TILE, AV_FLAGSHIP_OVERLAP = 8, 2


def audio_pipeline(pipe: LTXPipeline, device) -> LTXPipeline:
    """The joint-audio pipeline at full width and depth beside the phase-3
    one: its Gemma, VAE and upscaler shared, the video DiT dropped from both
    first, then the dual DiT, a text encoder with both connectors, the audio
    VAE and the vocoder drawn from seeded generators on the card; the dual
    DiT stays there (the joint-audio phases run resident), the others are
    kept on the host for phase staging."""
    from ltx_tpu_torch.config import AudioVAEConfig, VocoderConfig
    from ltx_tpu_torch.models.audio_vae import AudioVAE, Vocoder
    from ltx_tpu_torch.models.common import init_random_
    from ltx_tpu_torch.models.dit_av import LTXAVTransformer
    from ltx_tpu_torch.models.text_encoder import TextEncoder

    pipe.transformer = None
    pipe._host_store.pop("transformer", None)
    gc.collect()
    torch.cuda.empty_cache()
    before = host_rss_gib()
    release_host_memory()
    log(f"[av] video DiT dropped: host RSS {before:.2f} GiB, {host_rss_gib():.2f} after "
        "returning freed memory to the system")
    t0 = time.perf_counter()
    home = "cpu" if pipe.memory.phase_staging else device

    def build(i, make, where=home):
        gen = torch.Generator(device=device).manual_seed(16 + i)
        return init_random_(make(), gen).to(where)

    tcfg = TransformerConfig()
    av = build(6, lambda: LTXAVTransformer(tcfg, device, torch.bfloat16), device)
    text_encoder = build(3, lambda: TextEncoder(pipe.tecfg, device, torch.bfloat16,
                                                include_audio=True))
    out = LTXPipeline(
        transformer=None, vae_decoder=pipe.vae_decoder, gemma=pipe.gemma,
        text_encoder=text_encoder, tokenizer=pipe.tokenizer, memory=pipe.memory,
        device=device, vae_encoder=pipe.vae_encoder, upscaler=pipe.upscaler,
        av_transformer=av, audio_vae=build(7, lambda: AudioVAE(AudioVAEConfig(), device)),
        vocoder=build(8, lambda: Vocoder(VocoderConfig(), device)))
    log(f"[av] random full-size dual DiT ({sum(p.numel() for p in av.parameters()) / 1e9:.3f}"
        f" G parameters, {module_sizes(av)[1] / 2**30:.2f} GiB, kept on the card), text "
        f"encoder with the audio connector, audio VAE, vocoder (seeded, on the card, kept on "
        f"the {home}): "
        f"{time.perf_counter() - t0:.2f} s; host RSS {host_rss_gib():.2f} GiB")
    return out


def release_host_memory() -> None:
    """Hand the host memory the allocator holds free back to the system
    (glibc's malloc_trim), so that the dual DiT's host copy takes the place
    of the dropped video DiT's."""
    import ctypes

    ctypes.CDLL("libc.so.6").malloc_trim(0)


def av_expected(pipe: LTXPipeline, dit_calls: int, text_passes: int = 1) -> tuple:
    """(launch counts, flash launches by head dim) of a joint-audio path on
    the card, from the code: the dual blocks' six attentions and twenty
    norms, both connectors a text pass."""
    by_dim = checks.av_flash_counts(pipe.tcfg, pipe.tecfg, dit_calls, text_passes)
    launches, chain = checks.rms_inference_counts(pipe.tcfg, pipe.tecfg, dit_calls,
                                                  text_passes, av=True)
    return ({**NO_LAUNCHES, "flash_attention": sum(by_dim.values()), "rms_norm": launches,
             CHAIN: chain}, by_dim)


def check_waveform(tag: str, audio, config: GenerationConfig, vocoder_cfg) -> None:
    """Finite, in [-1, 1], not constant, (2, samples) with the vocoder's
    samples for the clip's audio latent frames (4T - 3 mel frames)."""
    from ltx_tpu_torch.models.dit_av import audio_frame_count

    frames = audio_frame_count(config.num_frames / config.fps)
    samples = (4 * frames - 3) * int(np.prod(vocoder_cfg.upsample_factors))
    log(f"[{tag}] waveform {audio.shape} {audio.dtype} ({frames} audio latent frames, "
        f"{audio.shape[-1] / vocoder_cfg.sample_rate:.3f} s at {vocoder_cfg.sample_rate} Hz): "
        f"mean {audio.mean():.5f}, std {audio.std():.5f}, min {audio.min():.5f}, max "
        f"{audio.max():.5f}")
    if audio.shape != (2, samples):
        raise AssertionError(f"{tag}: waveform {audio.shape}, expected (2, {samples})")
    if not (np.isfinite(audio).all() and np.abs(audio).max() <= 1.0 and audio.std() > 0.0):
        raise AssertionError(f"{tag}: waveform not finite in [-1, 1], or constant")


def av_run(tag: str, fn, expected: tuple, device):
    """fn() (a joint-audio generation) with the counts read around it and
    the device's peak memory; checks the launches, and the flash launches by
    head dim. Returns (result, launches, peak GiB)."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    result, launches = run_counted(fn)
    by_dim = dict(fa.flash_attention.launches_by_head_dim)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"[{tag}] flash launches by head dim {json.dumps(by_dim)} (expected "
        f"{json.dumps(expected[1])})")
    check_launches(tag, launches, expected[0])
    if by_dim != expected[1]:
        raise AssertionError(f"{tag}: flash launches by head dim {by_dim}")
    return result, launches, peak_gib


def phase_av_north_star(pipe: LTXPipeline, device) -> dict:
    """generate_video_with_audio at the north star (T2V, 25f@768x512, 8
    distilled steps: 1536 video and 26 audio tokens) on the bf16 dual DiT:
    the launch counts (8 x 48 x 6 flash, 1536 of them at head dim 64),
    the frames and the waveform, the phases and the peak memory. Returns
    the launches."""
    config = NORTH_STAR
    shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height, config.width,
                                         channels=pipe.tcfg.in_channels)
    gen = torch.Generator(device=device).manual_seed(0)
    noise = generate_noise(shape, gen)
    audio_noise = torch.randn(pipe.audio_noise_shape(config), generator=gen, device=device)
    steps = len(pipe._sigmas(config, shape)) - 1
    expected = av_expected(pipe, steps)
    log(f"[av] {config.num_frames}f@{config.width}x{config.height} with audio: "
        f"{shape.token_count} video and {pipe.audio_frames(config)} audio tokens, {steps} "
        f"steps; expected launches {json.dumps(expected[0])}")
    result, launches, peak = av_run("av", lambda: pipe.generate_video_with_audio(
        PROMPT, config, noise, audio_noise), expected, device)
    tm = result.timings
    log(f"[av] phases (s): staging {tm.staging:.3f}, gemma {tm.gemma:.3f}, connectors "
        f"{tm.connector:.3f}, denoise {sum(tm.denoise_steps):.3f} (steady step "
        f"{steady_steps(result)}), vae_decode {tm.vae_decode:.3f}, audio decode "
        f"{tm.audio_decode:.3f}, total {tm.total:.3f}; peak {peak:.2f} GiB")
    log("[av] denoise steps (s): " + ", ".join(f"{s:.4f}" for s in tm.denoise_steps))
    check_frames("av", result.frames, config)
    check_waveform("av", result.audio, config, pipe.vocoder_config)
    profile_av_step(pipe, shape, noise, device)
    return launches


def profile_av_step(pipe: LTXPipeline, shape, noise, device) -> None:
    """One dual denoise step at the north star under torch.profiler
    (`profile_step.profile_steps`: a warm-up, two profiled steps, five
    timed): host and device ms, device ms by kernel group, the idle share;
    a random 1024-token context for both streams with 300 padded keys."""
    from ltx_tpu_torch.pipeline.denoise import make_av_denoise_step

    transformer = pipe._on_device("av_transformer", GenerationTimings())
    gen = torch.Generator(device=device).manual_seed(5)
    context = torch.randn(1, 1024, pipe.tcfg.caption_channels, generator=gen,
                          device=device).bfloat16()
    bias = torch.zeros(1, 1, 1, 1024, device=device)
    bias[..., :300] = -10000.0
    af = pipe.audio_frames(NORTH_STAR)
    audio = torch.randn(1, af, pipe.tcfg.audio_in_channels, generator=gen, device=device)
    step = make_av_denoise_step(transformer, GuidanceSpec.from_config(NORTH_STAR), shape, af,
                                context, context, bias, fps=NORTH_STAR.fps)
    prof = profile_steps(lambda latent, s, s_next: step(latent, audio, s, s_next), noise)
    pipe._release("av_transformer")
    log(f"[av] one dual denoise step, profiled: host {prof['host_ms']:.1f} ms, device "
        f"{prof['device_busy_ms']:.1f} ms ({json.dumps({k: round(v, 2) for k, v in prof['device_ms'].items()})}), "
        f"idle share {prof['idle_share']:.3f}; unprofiled wall {prof['wall_ms']:.1f} ms")


def phase_av_flagship(pipe: LTXPipeline, device) -> dict:
    """generate_video_with_audio_two_stage at 241f@1024x640 (the README's
    flagship), I2V from a seeded pixel array through encode_image at half
    and full resolution, the conditioned frame re-noised every step: stage
    1's 8 distilled steps at 4960 tokens, the upscaler and AdaIN, stage 2's
    3 plain-Euler steps at 19840 tokens, 251 audio tokens throughout, a
    temporally tiled decode. The launches, frames, waveform, phases and
    peak memory. Returns the launches."""
    config = AV_FLAGSHIP
    c = pipe.tcfg.in_channels
    s1 = VideoLatentShape.from_pixels(1, config.num_frames, config.height // 2,
                                      config.width // 2, channels=c)
    s2 = VideoLatentShape.from_pixels(1, config.num_frames, config.height, config.width,
                                      channels=c)
    n1 = len(schedule.get_sigmas(config.num_steps, distilled=True,
                                 token_count=s1.token_count)) - 1
    n2 = len(schedule.STAGE_2_SIGMAS) - 1
    expected = av_expected(pipe, n1 + n2)
    gen = torch.Generator(device=device).manual_seed(9)
    image = torch.rand(1, 3, 1, config.height, config.width, generator=gen,
                       device=device) * 2 - 1
    half_image = F.interpolate(image[:, :, 0], scale_factor=0.5, mode="bilinear")[:, :, None]
    af = pipe.audio_frames(config)
    log(f"[av flagship] {config.num_frames}f@{config.width}x{config.height} two-stage I2V "
        f"with audio: stage 1 {s1.token_count} tokens x {n1} steps, stage 2 "
        f"{s2.token_count} tokens x {n2} steps, {af} audio tokens; expected launches "
        f"{json.dumps(expected[0])}")
    memory = pipe.memory
    pipe.memory = dataclasses.replace(memory, vae_tile_size=AV_FLAGSHIP_TILE,
                                      vae_tile_overlap=AV_FLAGSHIP_OVERLAP)
    try:
        enc = GenerationTimings()
        half = pipe.encode_image(half_image, enc)
        full = pipe.encode_image(image, enc)
        draws = dict(
            stage1_noise=generate_noise(s1, gen),
            stage1_audio_noise=torch.randn(pipe.audio_noise_shape(config), generator=gen,
                                           device=device),
            stage2_noise=generate_noise(s2, gen),
            stage2_audio_noise=torch.randn(1, af, pipe.tcfg.audio_in_channels,
                                           generator=gen, device=device),
            stage1_cond_noise=[torch.randn(half.shape, generator=gen, device=device)
                               for _ in range(n1)],
            stage2_cond_noise=[torch.randn(full.shape, generator=gen, device=device)
                               for _ in range(n2)])
        result, launches, peak = av_run(
            "av flagship", lambda: pipe.generate_video_with_audio_two_stage(
                PROMPT, config, image_latent=half, full_res_image_latent=full, **draws),
            expected, device)
    finally:
        pipe.memory = memory
    tm = result.timings
    log(f"[av flagship] image latents {tuple(half.shape)} and {tuple(full.shape)}: encoder "
        f"staging {enc.staging:.3f} s, image encode {enc.image_encode:.3f} s")
    log(f"[av flagship] phases (s): staging {tm.staging:.3f}, gemma {tm.gemma:.3f}, "
        f"connectors {tm.connector:.3f}, stage 1 {sum(tm.denoise_steps[:n1]):.3f}, upscale "
        f"{tm.upscale:.3f}, stage 2 {sum(tm.denoise_steps[n1:]):.3f}, vae_decode "
        f"{tm.vae_decode:.3f}, audio decode {tm.audio_decode:.3f}, total {tm.total:.3f}; "
        f"peak {peak:.2f} GiB")
    log("[av flagship] denoise steps (s): " + ", ".join(f"{s:.4f}" for s in tm.denoise_steps))
    if len(tm.denoise_steps) != n1 + n2:
        raise AssertionError(f"av flagship: {len(tm.denoise_steps)} denoise steps")
    check_frames("av flagship", result.frames, config)
    check_waveform("av flagship", result.audio, config, pipe.vocoder_config)
    return launches


# the joint-audio components placed on the card for phases 5c and 5d; the
# dual DiT is there from its draw (`audio_pipeline`), and nothing may hold
# its bf16 weights once 5d has quantized it
AV_RESIDENT = ("gemma", "text_encoder", "vae_decoder", "vae_encoder", "upscaler",
               "audio_vae", "vocoder")


def phase_av_long_video(pipe: LTXPipeline, device) -> dict:
    """The long-video modes on the dual DiT at the north star's 25f@768x512:
    a 3-segment generate_video_chain_with_audio carrying the audio tail
    (audio_cond), keyframes at pixel frames 0 and 24 with audio (seeded
    pixel arrays), and generate_video_with_audio extending the chain's last
    9 frames, the components resident on the card (`resident`). The
    launches, phases, peak, frames, and the waveform's length and stitch
    (segments of S samples crossfaded over round(S * 9 / 25): 3 S - 2 k in
    all). Returns the launches by path."""
    from ltx_tpu_torch.models.dit_av import audio_frame_count

    config = NORTH_STAR
    shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height, config.width,
                                         channels=pipe.tcfg.in_channels)
    steps = len(pipe._sigmas(config, shape)) - 1
    gen = torch.Generator(device=device).manual_seed(12)
    segments, cond = 3, CHAIN_COND_FRAMES
    af = pipe.audio_frames(config)
    samples = (4 * audio_frame_count(config.num_frames / config.fps) - 3) \
        * int(np.prod(pipe.vocoder_config.upsample_factors))
    k = min(int(round(samples * cond / config.num_frames)), samples)
    launches = {}

    def audio_noise():
        return torch.randn(pipe.audio_noise_shape(config), generator=gen, device=device)

    log(f"[av long] {config.num_frames}f@{config.width}x{config.height} with audio: chain of "
        f"{segments} segments carrying {max(1, round(af * cond / config.num_frames))} of "
        f"{af} audio latent frames, keyframes at 0 and 24, extension of 9 frames")
    with resident(pipe, AV_RESIDENT, device):
        chain, launches["AV chain 3x25f audio_cond"], peak = av_run(
            "av chain", lambda: pipe.generate_video_chain_with_audio(
                PROMPT, config, segments, [generate_noise(shape, gen) for _ in range(segments)],
                [audio_noise() for _ in range(segments)], cond_frames=cond, audio_cond=True),
            av_expected(pipe, segments * steps), device)
        log_run("av chain", chain, peak)
        frames = config.num_frames + (segments - 1) * (config.num_frames - cond)
        check_frames("av chain", chain.frames, dataclasses.replace(config, num_frames=frames))
        stitched = segments * samples - (segments - 1) * k
        log(f"[av chain] waveform {chain.audio.shape}: {segments} segments of {samples} samples "
            f"crossfaded over {k}: {stitched} expected; mean {chain.audio.mean():.5f}, std "
            f"{chain.audio.std():.5f}, min {chain.audio.min():.5f}, max {chain.audio.max():.5f}")
        if chain.audio.shape != (2, stitched) or not (
                np.isfinite(chain.audio).all() and np.abs(chain.audio).max() <= 1.0
                and chain.audio.std() > 0.0):
            raise AssertionError(f"av chain: waveform {chain.audio.shape}, expected (2, "
                                 f"{stitched}) finite in [-1, 1]")

        px = [torch.rand(1, 3, 1, config.height, config.width, generator=gen,
                         device=device) * 2 - 1 for _ in range(2)]
        for tag, name, fn in (
                ("av keyframes", "AV keyframes 0 and 24", lambda: pipe.generate_video_keyframes(
                    PROMPT, config, [(0, px[0]), (24, px[1])], generate_noise(shape, gen),
                    audio_noise(), audio=True)),
                ("av extension", "AV extension 25f", lambda: pipe.generate_video_with_audio(
                    PROMPT, config, generate_noise(shape, gen), audio_noise(),
                    video_frames=pixels_of(chain.frames[-cond:], device), cond_frames=cond))):
            result, launches[name], peak = av_run(tag, fn, av_expected(pipe, steps), device)
            log_run(tag, result, peak)
            check_frames(tag, result.frames, config)
            check_waveform(tag, result.audio, config, pipe.vocoder_config)
    return launches


# ---------------------------------------------------------------------------
# The AV QLoRA step (phase 5d): 5c's dual DiT, int4 and frozen, rank-16 LoRA
# ---------------------------------------------------------------------------

AV_TRAIN_STEPS, AV_TRAIN_RANK = 4, 16


def profile_one(fn):
    """fn() once under torch.profiler (after the steps that warmed it),
    recording the device's activity only (a train step runs some 10^5
    PyTorch ops). Returns (fn's result, {host ms, device ms by kernel group
    (profile_step's groups), the device's idle share})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ltx_tpu_torch.profile_step import GROUPS, group_of

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    device_ms = {name: 0.0 for name, _ in GROUPS}
    device_ms["other"] = 0.0
    # the recorded events as they are: key_averages() would first build a
    # Python object for each of them, which takes half a minute here
    for event in prof.profiler.kineto_results.events():
        if event.device_type() == DeviceType.CUDA:
            device_ms[group_of(event.name())] += event.duration_ns() / 1e6
    busy = sum(device_ms.values())
    if busy <= 0.0:
        raise AssertionError("the profiler recorded no device time")
    return out, {"host_ms": host_ms, "device_ms": device_ms, "device_busy_ms": busy,
                 "idle_share": 1.0 - busy / host_ms}


def phase_av_train(pipe: LTXPipeline, device) -> dict:
    """The joint audio-video QLoRA step at full width and depth on phase
    5c's dual DiT (taken from the pipeline, which keeps none; resident on
    the card from 5c): quantized to int4 on the card and frozen, rank-16
    LoRA on its block linears; AV_TRAIN_STEPS steps of make_av_train_step (per-block remat,
    the flash kernels: sdpa_impl "pallas") at 25f@768x512 (1536 video
    tokens) and the north star's 26 audio tokens, 1024-token text contexts
    left-padded by TRAIN_PADS (video, audio), the draws from a generator in
    the reference's order. Asserts each step's launches
    (checks.av_train_step_launches), finite losses with both streams' terms
    above 0, the frozen parameters bit for bit, every lora_b moved from 0;
    prints the seconds a step, the peak memory and the last step profiled.
    Returns the launches summed over the steps."""
    from ltx_tpu_torch.models.dit_av import prepare_av_ropes
    from ltx_tpu_torch.ops.attention import prepare_additive_mask
    from ltx_tpu_torch.train.flow_match import sample_sigmas
    from ltx_tpu_torch.train.lora import add_lora
    from ltx_tpu_torch.train.step import TrainConfig, init_train_state, make_av_train_step

    t_phase = time.perf_counter()
    model, pipe.av_transformer = pipe.av_transformer, None
    t0 = time.perf_counter()
    model.to(device)  # nothing to copy where the phase runs it resident
    torch.cuda.synchronize(device)
    placed = time.perf_counter() - t0
    t0 = time.perf_counter()
    quantize_transformer(model, bits=4)
    torch.cuda.synchronize(device)
    quantized = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(21)
    add_lora(model, gen, rank=AV_TRAIN_RANK)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = model.cfg
    int4 = sum(isinstance(m, QuantizedLinear) for m in model.blocks.modules())
    log(f"[av train] dual DiT on the card ({placed:.2f} s to place), quantized to int4 there in "
        f"{quantized:.2f} s ({int4} block linears), rank-{AV_TRAIN_RANK} LoRA; "
        f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB on the card")

    f, h, w = TRAIN_GRID
    frames = pipe.audio_frames(NORTH_STAR)
    video = torch.randn(1, f * h * w, cfg.in_channels, generator=gen, device=device)
    audio = torch.randn(1, frames, cfg.audio_in_channels, generator=gen, device=device)
    contexts = [torch.randn(1, TRAIN_TEXT, cfg.caption_channels, generator=gen, device=device)
                for _ in TRAIN_PADS]
    biases = []
    for pad in TRAIN_PADS:
        mask = torch.ones(1, TRAIN_TEXT, dtype=torch.int64, device=device)
        mask[:, :pad] = 0
        biases.append(prepare_additive_mask(mask))
    ropes = prepare_av_ropes(cfg, f, h, w, frames, fps=NORTH_STAR.fps, device=device)
    tc = TrainConfig(lora_only=True, sdpa_impl="pallas")
    trainable, frozen, opt_state = init_train_state(model, tc)
    base = {n: p.detach().clone() for n, p in frozen.items()}
    step = make_av_train_step(model, tc)
    expected = {**NO_LAUNCHES, **checks.av_train_step_launches(model)}
    log(f"[av train] {cfg.num_layers} dual blocks, {f * h * w} video and {frames} audio "
        f"tokens, {TRAIN_TEXT} text tokens (pads {TRAIN_PADS}), {len(trainable)} LoRA "
        f"leaves; expected launches per step {json.dumps(expected)}")

    def draws():
        return (sample_sigmas(gen, 1), sample_sigmas(gen, 1),
                torch.randn(video.shape, generator=gen, device=device),
                torch.randn(audio.shape, generator=gen, device=device))

    def run(d):
        return step(trainable, opt_state, video, audio, *contexts, ropes, *d, *biases)

    totals = dict.fromkeys(expected, 0)
    seconds = []
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    for i in range(AV_TRAIN_STEPS):
        d = draws()
        # the last step under the profiler, its launches counted as the others'
        profiled = i == AV_TRAIN_STEPS - 1
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out, launches = run_counted(lambda: profile_one(lambda: run(d)) if profiled
                                    else (run(d), None))
        torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        (trainable, opt_state, aux), prof = out
        metrics = {k: float(v) for k, v in aux.items()}
        log(f"[av train] step {i}: " + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items())
            + f", {seconds[-1]:.3f} s (synchronised{', profiled' if profiled else ''})")
        check_launches(f"av train step {i}", launches, expected)
        if not (all(np.isfinite(v) for v in metrics.values())
                and metrics["loss_video"] > 0 and metrics["loss_audio"] > 0):
            raise AssertionError(f"av train step {i}: metrics {metrics}")
        totals = {k: totals[k] + launches[k] for k in totals}
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    still = [n for n, p in trainable.items() if n.endswith("lora_b") and not p.abs().max() > 0]
    moved = [n for n, p in frozen.items() if not torch.equal(p, base[n])]
    log(f"[av train] seconds a step: {', '.join(f'{t:.3f}' for t in seconds[:-1])} (the "
        f"profiled step {seconds[-1]:.3f} with the profiler's summary); peak {peak:.2f} GiB; "
        f"lora_b still 0: {len(still)} of {sum(n.endswith('lora_b') for n in trainable)}; "
        f"frozen parameters moved: {len(moved)} of {len(frozen)}")
    if still or moved:
        raise AssertionError(f"av train: lora_b still 0 {still[:4]}, base moved {moved[:4]}")
    del base
    steady = sorted(seconds[1:-1])[len(seconds[1:-1]) // 2] * 1e3
    log(f"[av train] the last step, profiled (the device's activity only): host "
        f"{prof['host_ms']:.1f} ms, device {prof['device_busy_ms']:.1f} ms "
        f"({json.dumps({k: round(v, 2) for k, v in prof['device_ms'].items()})}), idle share "
        f"{prof['idle_share']:.3f}; against the unprofiled steps' median {steady:.1f} ms: "
        f"{1.0 - prof['device_busy_ms'] / steady:.3f} (the video QLoRA step's: device 787 ms, "
        f"idle 0.71-0.73)")
    log(f"[av train] launches over the {AV_TRAIN_STEPS} steps: {json.dumps(totals)}; phase "
        f"{time.perf_counter() - t_phase:.2f} s")
    return totals


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
                                      "dequant_int4": layers * 8,
                                      **norm_launches(pipe.tcfg, pipe.tecfg, 1, 0)})
    if shape.token_count < qz.BIG_M_DEQUANT_THRESHOLD or \
            not (torch.isfinite(out).all() and torch.isfinite(velocity).all()):
        raise AssertionError("bigm: not a big-M shape, or non-finite output")
    return launches


# ---------------------------------------------------------------------------
# Files to frames: a models directory written here, loaded by load_pipeline
# ---------------------------------------------------------------------------

# the one cut of the checkpoint written below: the video DiT keeps 8 of its
# 48 blocks (about 4.6 GB of bf16 instead of 26 GB, for disk and time on a
# machine whose free disk is unknown); every other component is full size
FILES_DIT_BLOCKS = 8
FILES_LORA_RANK = 384
FILES_GEMMA_SHARD_LAYERS = 12
# the DiT linears a distilled-style LoRA adapts, as the checkpoint spells them
FILES_LORA_LINEARS = ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0",
                      "attn2.to_q", "attn2.to_k", "attn2.to_v", "attn2.to_out.0",
                      "ff.net.0.proj", "ff.net.2")
GEMMA_CONFIG = {"model_type": "gemma3", "quantization": {"group_size": 64, "bits": 4},
                "text_config": {"hidden_size": 3840, "num_hidden_layers": 48,
                                "intermediate_size": 15360, "num_attention_heads": 16,
                                "head_dim": 256, "num_key_value_heads": 8,
                                "vocab_size": 262208, "rms_norm_eps": 1e-6,
                                "rope_theta": 1_000_000.0, "rope_local_base_freq": 10_000.0,
                                "query_pre_attn_scalar": 256, "sliding_window": 1024,
                                "sliding_window_pattern": 6}}
# the f32 tensors of the files (the dtypes the loaders keep): everything else
# of the DiT, connector, VAE and LoRA is bf16, the upscaler f32
_F32_KEYS = ("scale_shift_table", "time_embedder", "per_channel_statistics",
             "timestep_scale_multiplier", "weight_scale", "input_scale", ".alpha")


def _smoke_tensor(key: str, shape, gen, device, dtype=None) -> torch.Tensor:
    """A seeded tensor for checkpoint `key`, drawn on the card, on the host:
    linear and conv weights normal * fan_in**-0.5, norm weights 1, biases
    and tables small, the VAE's latent statistics (0, 1)."""
    if dtype is None:
        dtype = torch.float32 if any(k in key for k in _F32_KEYS) else torch.bfloat16
    if key.endswith("mean-of-means"):
        t = torch.zeros(shape, device=device)
    elif key.endswith(("std-of-means", "norm_q.weight", "norm_k.weight")):
        t = torch.ones(shape, device=device)
    elif key.endswith("timestep_scale_multiplier"):
        t = torch.full(shape, 1000.0, device=device)
    elif key.endswith(".weight") and len(shape) >= 2:
        t = torch.randn(shape, generator=gen, device=device) * (
            float(np.prod(shape[1:])) ** -0.5)
    else:
        t = torch.randn(shape, generator=gen, device=device) * 0.02
    return t.to(dtype).cpu()


def _materialize(spec: dict, prefix: str, gen, device, dtype=None) -> dict:
    return {prefix + k: _smoke_tensor(k, shape, gen, device, dtype)
            for k, shape in spec.items()}


def _mlx_gemma(spec: dict, layers, gen, device) -> dict:
    """The MLX 4-bit tensors of `spec` whose layer is in `layers` (None: the
    tensors outside the layers): packed codes as uint32 words, bf16 scales
    around 0.0027 and biases -7.5 * scale (weights within +-0.02), bf16 norms."""
    out = {}
    for key, shape in spec.items():
        m = re.search(r"\.layers\.(\d+)\.", key)
        if (m is None) != (layers is None) or (m is not None and int(m.group(1)) not in layers):
            continue
        if key.endswith(".scales") or key.endswith(".biases"):
            continue
        if f"{key[:-len('.weight')]}.scales" in spec:
            base = key[:-len(".weight")]
            out[key] = torch.randint(-2**31, 2**31, shape, generator=gen, device=device,
                                     dtype=torch.int32).cpu().view(torch.uint32)
            scale = 0.02 / 7.5 * (1.0 + 0.25 * torch.rand(spec[f"{base}.scales"],
                                                          generator=gen, device=device))
            out[f"{base}.scales"] = scale.to(torch.bfloat16).cpu()
            out[f"{base}.biases"] = (-7.5 * scale).to(torch.bfloat16).cpu()
        else:
            out[key] = (torch.randn(shape, generator=gen, device=device) * 0.05).to(
                torch.bfloat16).cpu()
    return out


def smoke_tokenizer(vocab_size: int = 262208) -> dict:
    """A Gemma-style tokenizer.json, written without the tokenizers package:
    BPE with byte fallback, spaces as "▁", the prompt's words as merges,
    special tokens, unused tokens up to Gemma-3's vocabulary (so that every
    id a random Gemma samples decodes), a BOS template and Gemma's decoder."""
    specials = ["<pad>", "<eos>", "<bos>", "<unk>", "<start_of_turn>", "<end_of_turn>"]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for ch in "▁" + "".join(chr(c) for c in range(33, 127)):
        vocab.setdefault(ch, len(vocab))
    merges = []
    for word in set((PROMPT + " " + " ".join(BATCH_PROMPTS)).split()):
        pieces = list("▁" + word)
        while len(pieces) > 1:
            merges.append(f"{pieces[0]} {pieces[1]}")
            pieces[:2] = [pieces[0] + pieces[1]]
            vocab.setdefault(pieces[0], len(vocab))
    while len(vocab) < vocab_size:
        vocab[f"<unused{len(vocab)}>"] = len(vocab)
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": vocab[t], "content": t, "single_word": False,
                              "lstrip": False, "rstrip": False, "normalized": False,
                              "special": True} for t in specials],
            "normalizer": {"type": "Replace", "pattern": {"String": " "}, "content": "▁"},
            "pre_tokenizer": None,
            "post_processor": {"type": "TemplateProcessing",
                               "single": [{"SpecialToken": {"id": "<bos>", "type_id": 0}},
                                          {"Sequence": {"id": "A", "type_id": 0}}],
                               "pair": [{"Sequence": {"id": "A", "type_id": 0}}],
                               "special_tokens": {"<bos>": {"id": "<bos>", "ids": [2],
                                                            "tokens": ["<bos>"]}}},
            "decoder": {"type": "Sequence", "decoders": [
                {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
                {"type": "ByteFallback"}, {"type": "Fuse"},
                {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
            "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}


def weight_fixtures():
    """tests/weight_fixtures.py, the checkpoints' key sets and shapes as the
    reference's sources define them (transcribed independently of the
    loaders), loaded by its path: another installed package may be named
    `tests`."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "weight_fixtures.py"
    spec = importlib.util.spec_from_file_location("weight_fixtures", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_models_dir(base, device) -> dict:
    """The layout `weights.download.download_all_components` resolves, with
    seeded full-width checkpoints (the DiT cut to FILES_DIT_BLOCKS blocks),
    written by the port's safetensors writer. Returns {name: path}."""
    from ltx_tpu_torch.config import LTXModel
    from ltx_tpu_torch.weights import download as dl
    from ltx_tpu_torch.weights import safetensors_io

    wf = weight_fixtures()
    gen = torch.Generator(device=device).manual_seed(2026)
    files = {}

    def save(name, tensors, path):
        path.parent.mkdir(parents=True, exist_ok=True)
        safetensors_io.save(tensors, path)
        files[name] = path

    # the dual DiT's keys: the video DiT's and the audio stream's, as the
    # checkpoint holds them
    dit_spec = wf.av_transformer_spec(num_layers=FILES_DIT_BLOCKS)
    unified = _materialize(dit_spec, "model.diffusion_model.", gen, device)
    for suffix in ("weight_scale", "input_scale"):  # fp8 checkpoints' scalars: dropped
        unified[f"model.diffusion_model.transformer_blocks.0.attn1.to_q.{suffix}"] = \
            torch.ones((), dtype=torch.float32)
    unified.update(_materialize(wf.connector_spec(fmt=2, include_audio=True),
                                "model.diffusion_model.", gen, device))
    unified.update(_materialize(wf.vae_decoder_spec(layout="unified"), "vae.", gen, device))
    save("unified", unified, base / f"ltx-{LTXModel.DISTILLED.value}" /
         LTXModel.DISTILLED.unified_weights_filename)
    del unified
    save("vae", _materialize(wf.vae_encoder_spec(), "", gen, device),
         base / "ltx-vae" / Path(dl.VAE_FILE).name)
    (base / "ltx-vae" / Path(dl.VAE_CONFIG).name).write_text(
        json.dumps({"timestep_conditioning": False}))
    save("connector", {"placeholder": torch.zeros(1)},
         base / "ltx-connector" / Path(dl.CONNECTOR_FILE).name)
    save("upscaler", _materialize(wf.upscaler_spec(), "", gen, device, torch.float32),
         base / "ltx-upscaler" / Path(dl.UPSCALER_FILE).name)
    save("audio_vae", _materialize(wf.audio_vae_spec(), "", gen, device, torch.float32),
         base / "ltx-audio-vae" / Path(dl.AUDIO_VAE_FILE).name)
    save("vocoder", _materialize(wf.vocoder_spec(), "", gen, device, torch.float32),
         base / "ltx-vocoder" / Path(dl.VOCODER_FILE).name)
    lora = {}
    for i in range(FILES_DIT_BLOCKS):
        for linear in FILES_LORA_LINEARS:
            out_dim, in_dim = dit_spec[f"transformer_blocks.{i}.{linear}.weight"]
            key = f"diffusion_model.transformer_blocks.{i}.{linear}"
            lora[f"{key}.lora_down.weight"] = (torch.randn(
                FILES_LORA_RANK, in_dim, generator=gen, device=device) * in_dim**-0.5).to(
                torch.bfloat16).cpu()
            lora[f"{key}.lora_up.weight"] = (torch.randn(
                out_dim, FILES_LORA_RANK, generator=gen, device=device)
                * (0.1 / FILES_LORA_RANK**0.5)).to(torch.bfloat16).cpu()
            lora[f"{key}.alpha"] = torch.tensor(float(FILES_LORA_RANK))
    save("lora", lora, base / "ltx-lora" / Path(dl.DISTILLED_LORA_FILE).name)
    del lora
    gdir = base / "vlm-gemma"
    spec = wf.gemma_spec(mlx_4bit=True, vlm_prefix=True)
    layers = GEMMA_CONFIG["text_config"]["num_hidden_layers"]
    shards = [None] + [range(s, min(s + FILES_GEMMA_SHARD_LAYERS, layers))
                       for s in range(0, layers, FILES_GEMMA_SHARD_LAYERS)]
    for n, shard in enumerate(shards):
        save(f"gemma{n}", _mlx_gemma(spec, shard, gen, device),
             gdir / f"model-{n + 1:05d}-of-{len(shards):05d}.safetensors")
    (gdir / "config.json").write_text(json.dumps(GEMMA_CONFIG))
    (gdir / "tokenizer.json").write_text(json.dumps(smoke_tokenizer()))
    return files


_DROPPED = (".weight_scale", ".input_scale", "timestep_scale_multiplier")


def file_sizes(paths, mlx: bool = False, prefixes=None, keep=None) -> tuple:
    """(values, bytes) the loaders keep from files: the keys the reference
    drops left out (lm_head, fp8 scales, the VAE's timestep multiplier, the
    upscaler's blur kernel), and those `keep` refuses; an MLX 4-bit weight
    counts its 8 codes a word and 2 bytes a value (bf16 once dequantized),
    its scales and biases nothing."""
    from ltx_tpu_torch.weights import safetensors_io

    values = nbytes = 0
    for path in paths:
        header, _ = safetensors_io.read_header(path)
        for key, info in header.items():
            if key == "__metadata__" or key.endswith(_DROPPED) or "lm_head" in key or \
                    key.startswith("blur_down") or (
                    prefixes is not None and not key.startswith(prefixes)) or (
                    keep is not None and not keep(key)):
                continue
            n = int(np.prod(info["shape"], dtype=np.int64))
            if mlx and key.endswith((".scales", ".biases")):
                continue
            if mlx and info["dtype"] == "U32":
                n *= 8
            values += n
            nbytes += 2 * n if mlx else info["data_offsets"][1] - info["data_offsets"][0]
    return values, nbytes


def module_sizes(module) -> tuple:
    return (sum(p.numel() for p in module.parameters()),
            sum(p.numel() * p.element_size() for p in module.parameters()))


def host_rss_gib() -> float:
    """This process's resident set now (VmRSS), in GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("no VmRSS in /proc/self/status")


@contextlib.contextmanager
def host_rss_peak(every: float = 0.02):
    """The largest resident set this process reaches while the block runs,
    sampled every `every` s on a thread: yields a dict whose "peak" (GiB)
    is set when the block ends (the kernel's own high-water mark is not
    readable or resettable on every machine)."""
    import threading

    out = {"peak": host_rss_gib()}
    stop = threading.Event()

    def sample():
        while not stop.wait(every):
            out["peak"] = max(out["peak"], host_rss_gib())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join(timeout=10)
        out["peak"] = max(out["peak"], host_rss_gib())


@contextlib.contextmanager
def counted_quantize_weight():
    """Count the calls of quantize_weight made through the modules that call
    it (QuantizedLinear.from_linear, LoRA fusion) while the block runs."""
    from ltx_tpu_torch.lora import fuse as lora_fuse
    from ltx_tpu_torch.models import common

    calls = [0]
    original = qz.quantize_weight

    def counting(*args, **kwargs):
        calls[0] += 1
        return original(*args, **kwargs)

    common.quantize_weight = lora_fuse.quantize_weight = counting
    try:
        yield calls
    finally:
        common.quantize_weight = lora_fuse.quantize_weight = original


@contextlib.contextmanager
def counted_requant():
    """Count the calls of requant_int8_channel (W8A8Linear.from_linear,
    Gemma's key map) while the block runs."""
    from ltx_tpu_torch.weights import keymaps

    calls = [0]
    original = qz.requant_int8_channel

    def counting(*args, **kwargs):
        calls[0] += 1
        return original(*args, **kwargs)

    qz.requant_int8_channel = keymaps.requant_int8_channel = counting
    try:
        yield calls
    finally:
        qz.requant_int8_channel = keymaps.requant_int8_channel = original


def _load(tag: str, base, device, staging: bool = True, **kw):
    """load_pipeline from `base` with the DiT cut to FILES_DIT_BLOCKS, with
    phase staging or without (the default MemoryConfig); prints the load's
    parts, the host's memory and where Gemma's leaves are."""
    from ltx_tpu_torch.config import MemoryConfig
    from ltx_tpu_torch.pipeline.loader import LoadTimings, load_pipeline

    timings = LoadTimings()
    torch.cuda.reset_peak_memory_stats(device)
    before = host_rss_gib()
    with host_rss_peak() as rss:
        pipe = load_pipeline(models_dir=str(base), device=device,
                             memory=MemoryConfig(phase_staging=True) if staging
                             else MemoryConfig(),
                             transformer_config=dataclasses.replace(
                                 TransformerConfig(), num_layers=FILES_DIT_BLOCKS),
                             timings=timings, **kw)
    places = {p.device.type for p in pipe.gemma.parameters()}
    log(f"[files] {tag}: Gemma's leaves on {sorted(places)}, {module_sizes(pipe.gemma)[1] / 1e9:.3f}"
        f" GB ({'phase staging' if staging else 'no phase staging'})")
    if places != {"cpu" if staging else "cuda"}:
        raise AssertionError(f"{tag}: Gemma's leaves on {places}")
    log(f"[files] {tag}: load (s) read {timings.read:.3f}, key map {timings.key_map:.3f}, "
        f"build {timings.build:.3f}, gemma {timings.gemma:.3f}"
        f" (cache {'hit' if timings.gemma_cache_hit else 'miss'}), fuse "
        f"{timings.fuse:.3f}, quantize {timings.quantize:.3f}, caches {timings.cache:.3f} "
        f"(DiT {'hit' if timings.cache_hit else 'miss'}), total {timings.total:.3f}; host RSS "
        f"{before:.2f} GiB before the load, peak {rss['peak']:.2f} during it (sampled), "
        f"{host_rss_gib():.2f} after, "
        f"process peak (getrusage) {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}; "
        f"device peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    return pipe, timings


def gemma_states(tag: str, pipe: LTXPipeline, expected: dict) -> torch.Tensor:
    """Gemma's 49 hidden states of PROMPT on the card (to the host), the
    launch counts read around the pass and checked against `expected`
    (Gemma's own norms are plain PyTorch: no rms_norm launch)."""
    ids, mask = pipe.tokenize(PROMPT)
    gemma = pipe._on_device("gemma", GenerationTimings())
    with torch.inference_mode():
        states, launches = run_counted(lambda: gemma.forward_hidden_states(ids, mask))
        states = states.cpu()
    pipe._release("gemma")
    check_launches(f"files gemma {tag}", launches, expected)
    return states


# the reference's own check of a quantized Gemma against bf16
# (tests/test_gemma_quant.py): the final states' correlation
GEMMA_STATES_CORR = 0.99


def states_beside_bf16(tag: str, states, bf16_states) -> None:
    """A quantized Gemma's hidden states against the bf16 load's: the
    largest error of each state relative to its largest value, and the
    final state's correlation, which must exceed GEMMA_STATES_CORR."""
    a, b = states.float(), bf16_states.float()
    rel = [((x - y).abs().max() / y.abs().max()).item() for x, y in zip(a, b)]
    corr = float(np.corrcoef(a[-1].numpy().ravel(), b[-1].numpy().ravel())[0, 1])
    log(f"[files] Gemma {tag} - bf16, {len(rel)} hidden states: largest relative error "
        f"{max(rel):.4e} (state {int(np.argmax(rel))}), final state {rel[-1]:.4e}, its "
        f"correlation {corr:.6f} (must exceed {GEMMA_STATES_CORR})")
    if not (np.isfinite(rel).all() and corr > GEMMA_STATES_CORR):
        raise AssertionError(f"Gemma {tag}: states off bf16 by {max(rel)}, correlation {corr}")


def same_dit(pipe: LTXPipeline, first: dict, timings, calls, tag: str, what: str) -> None:
    """A second load must hit both caches, prepare nothing again and give
    the first load's DiT bit for bit."""
    same = all(torch.equal(p.detach().cpu(), first[n])
               for n, p in pipe.transformer.named_parameters()) and \
        len(first) == len(list(pipe.transformer.parameters()))
    log(f"[files] second {tag} load: DiT cache {'hit' if timings.cache_hit else 'miss'}, "
        f"Gemma cache {'hit' if timings.gemma_cache_hit else 'miss'}, {calls[0]} {what}, "
        f"DiT bit for bit the first's: {same}")
    if not (timings.cache_hit and timings.gemma_cache_hit) or calls[0] or not same:
        raise AssertionError(f"{tag}: the quantized caches did not serve the second load")


_DIT_PREFIX = "model.diffusion_model."
_CONNECTOR_KEYS = ("video_embeddings_connector.", "audio_embeddings_connector.",
                   "text_embedding_projection.")


def _dual_dit_keys(key: str) -> bool:
    """The unified file's keys of the dual DiT (every transformer key)."""
    return key.startswith(_DIT_PREFIX) and not key[len(_DIT_PREFIX):].startswith(
        _CONNECTOR_KEYS)


def _video_dit_keys(key: str) -> bool:
    """The dual DiT's keys the video DiT keeps: the audio stream's and the
    dual block's learnable norms are the video key map's to drop."""
    from ltx_tpu_torch.weights.keymaps import map_transformer_key

    return _dual_dit_keys(key) and map_transformer_key(key[len(_DIT_PREFIX):]) is not None


def phase_files_audio(base, files, noise, device) -> dict:
    """load_pipeline(include_audio=True) in bf16 from the models directory
    (the dual DiT assembled from the unified file, the audio connector, the
    audio VAE's and the vocoder's files): its parts' seconds and the host's
    resident memory, the loaded sizes against the files', and one
    generate_video_with_audio at the north star with its launches, frames
    and waveform. Returns the launches."""
    pipe, _ = _load("bf16 with audio", base, device, include_audio=True, gemma_quant="bf16")
    for name, module, keep, paths in (
            ("dual DiT", pipe.av_transformer, _dual_dit_keys, [files["unified"]]),
            ("connectors", pipe.text_encoder,
             lambda k: k[len(_DIT_PREFIX):].startswith(_CONNECTOR_KEYS), [files["unified"]]),
            ("audio VAE", pipe.audio_vae, lambda k: not k.startswith("encoder."),
             [files["audio_vae"]]),
            ("vocoder", pipe.vocoder, None, [files["vocoder"]])):
        want, got = file_sizes(paths, keep=keep), module_sizes(module)
        log(f"[files] {name}: {got[0]} values, {got[1]} bytes loaded; the files' "
            f"{want[0]} / {want[1]}")
        if got != want:
            raise AssertionError(f"{name}: loaded {got}, files {want}")
    config = NORTH_STAR
    steps = len(pipe._sigmas(config, VideoLatentShape(*noise.shape))) - 1
    audio_noise = torch.randn(pipe.audio_noise_shape(config), device=device,
                              generator=torch.Generator(device=device).manual_seed(1))
    expected = av_expected(pipe, steps)
    result, launches, peak = av_run("files av", lambda: pipe.generate_video_with_audio(
        PROMPT, config, noise, audio_noise), expected, device)
    tm = result.timings
    log(f"[files av] phases (s): staging {tm.staging:.3f}, gemma {tm.gemma:.3f}, connectors "
        f"{tm.connector:.3f}, denoise {sum(tm.denoise_steps):.3f}, vae_decode "
        f"{tm.vae_decode:.3f}, audio decode {tm.audio_decode:.3f}, total {tm.total:.3f}; "
        f"peak {peak:.2f} GiB")
    check_frames("files av", result.frames, config)
    check_waveform("files av", result.audio, config, pipe.vocoder_config)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_files_to_frames(device, data) -> int:
    """Write a models directory, load it with load_pipeline (bf16; int4
    with the LoRA fused and Gemma in "int4", the quantized caches missed
    then hit; the defaults, W8A8 Gemma, with a W8A8 DiT and no phase
    staging, missed then hit), run the north star from each but the second
    loads, check the MLX dequantization bit for bit, the loaded sizes
    against the files', the LoRA fusion on the card against the CPU's and
    against the adapter as a side path, each quantized Gemma's hidden
    states against the bf16 one's and its greedy decode (`gemma_decode`),
    and train one step from the unified file with train.cli --weights
    --quant w8a8 on the shards in `data` (phase 3h's); between the bf16 and
    the int4 loads, the joint-audio load
    and clip (`phase_files_audio`). Returns the int4_matmul launches of the
    int4 Gemma's text pass and of its decode forwards, and the joint-audio
    clip's launches."""
    from ltx_tpu_torch.lora.fuse import fuse_lora, parse_lora
    from ltx_tpu_torch.weights import download as dl
    from ltx_tpu_torch.weights import safetensors_io

    t_phase = time.perf_counter()
    base = build.BUILD_DIR.parent / "chip_smoke_models"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    free = shutil.disk_usage(base).free
    t0 = time.perf_counter()
    files = write_models_dir(base, device)
    seconds = time.perf_counter() - t0
    written = sum(p.stat().st_size for p in files.values())
    log(f"[files] models directory written: {written / 1e9:.3f} GB in {seconds:.2f} s "
        f"({written / 1e9 / seconds:.3f} GB/s; {free / 1e9:.1f} GB free before); "
        + ", ".join(f"{k} {p.stat().st_size / 1e9:.3f}" for k, p in files.items()))

    # --- bf16 from the files (the upscaler too), the north star
    pipe, _ = _load("bf16", base, device, include_upscaler=True, gemma_quant="bf16")
    shape = VideoLatentShape.from_pixels(1, NORTH_STAR.num_frames, NORTH_STAR.height,
                                         NORTH_STAR.width, channels=pipe.tcfg.in_channels)
    noise = generate_noise(shape, torch.Generator(device=device).manual_seed(0))
    steps = len(pipe._sigmas(NORTH_STAR, shape)) - 1
    log(f"[files] prompt tokens: {len(pipe.tokenizer.encode(PROMPT).ids)}")
    flash = steps * FILES_DIT_BLOCKS * 2 + pipe.tecfg.connector_layers
    norms = norm_launches(pipe.tcfg, pipe.tecfg, steps, 1)
    north_star_run("files bf16", pipe, noise,
                   {**NO_LAUNCHES, "flash_attention": flash, **norms}, device)
    gemma_files = sorted((base / "vlm-gemma").glob("*.safetensors"))
    key = "language_model.model.layers.0.self_attn.q_proj"
    first = next(p for p in gemma_files if f"{key}.weight" in safetensors_io.read_header(p)[0])
    raw = safetensors_io.load(first)
    res = checks.check_mlx_dequant(raw[f"{key}.weight"], raw[f"{key}.scales"],
                                   raw[f"{key}.biases"], pipe.gemma.layers[0].q_proj.weight)
    del raw
    log(f"[files] MLX dequant of layers.0.q_proj against numpy from the file's arrays: "
        f"{res['differing']} of {res['values']} values differ")
    unified, vae_file = files["unified"], files["vae"]
    for name, module, (paths, mlx, prefixes) in (
            ("DiT", pipe.transformer, ([unified], False, _video_dit_keys)),
            ("connector", pipe.text_encoder, ([unified], False, (
                "model.diffusion_model.video_embeddings_connector",
                "model.diffusion_model.text_embedding_projection"))),
            ("VAE decoder", pipe.vae_decoder, ([unified], False, ("vae.",))),
            ("VAE encoder", pipe.vae_encoder, ([vae_file], False, None)),
            ("Gemma", pipe.gemma, (gemma_files, True, ("language_model.",))),
            ("upscaler", pipe.upscaler, ([files["upscaler"]], False, None))):
        want = (file_sizes(paths, mlx, keep=prefixes) if callable(prefixes)
                else file_sizes(paths, mlx, prefixes))
        got = module_sizes(module)
        log(f"[files] {name}: {got[0]} values, {got[1]} bytes loaded; the files' "
            f"{want[0]} / {want[1]}")
        if got != want:
            raise AssertionError(f"{name}: loaded {got}, files {want}")

    # --- the rank-384 LoRA at full width: the card's fusion against the
    # CPU's, and the fused DiT against the adapter as a side path
    layers = parse_lora(dl.load_safetensors(files["lora"]))
    t0 = time.perf_counter()
    side = checks.lora_side_path_check(pipe.transformer, layers, 1.0, device=device)
    torch.cuda.synchronize(device)
    log(f"[files] LoRA rank {FILES_LORA_RANK} ({len(layers)} linears) fused on the card "
        f"and run beside its side path: {time.perf_counter() - t0:.2f} s; velocity max abs "
        f"err {side['rel_err']:.3e} of its max (tol {checks.LORA_SIDE_PATH_TOL:.0e})")
    if not side["finite"] or side["rel_err"] > checks.LORA_SIDE_PATH_TOL:
        raise AssertionError(f"LoRA side path: {side['rel_err']}, finite {side['finite']}")
    ends = (0, FILES_DIT_BLOCKS - 1)
    picked = [la for la in layers if any(
        la.original_key.startswith(f"transformer_blocks.{b}.") for b in ends)]
    t0 = time.perf_counter()
    cpu = fuse_lora(pipe.transformer, picked, 1.0, device="cpu")
    cpu_s = time.perf_counter() - t0
    paths = {f"blocks.{b}.{p}" for b in ends for p in (
        "attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out", "attn2.to_q", "attn2.to_k",
        "attn2.to_v", "attn2.to_out", "ff.project_in", "ff.project_out")}
    leaves = checks.check_fused_leaves(side["fused"], cpu, picked, 1.0, paths)
    log(f"[files] fused weights of blocks {ends}, card vs CPU ({cpu_s:.2f} s on the host): "
        f"{leaves['values']} values, {leaves['differing']:.3e} of them differ, worst "
        f"{leaves['share']:.3f} of the bound")
    bf16_states = gemma_states("bf16", pipe, NO_LAUNCHES)
    del side, cpu, pipe
    gc.collect()
    torch.cuda.empty_cache()
    audio_launches = phase_files_audio(base, files, noise, device)

    # --- int4 with the LoRA fused, Gemma in "int4": the caches miss, then hit
    q = QuantizationConfig(mode="int4")
    lora_path = str(files["lora"])
    pipe, timings = _load("int4 + LoRA, Gemma int4", base, device, quantization=q,
                          lora_path=lora_path, gemma_quant="int4")
    if timings.cache_hit or timings.gemma_cache_hit:
        raise AssertionError("int4: a quantized cache hit on the first load")
    gemma_linears = pipe.gcfg.hidden_layers * 7
    states = gemma_states("int4", pipe, {**NO_LAUNCHES, "int4_matmul": gemma_linears})
    states_beside_bf16("int4", states, bf16_states)
    decode_launches = gemma_decode("int4", pipe, "int4_matmul")
    expected = {**NO_LAUNCHES, "flash_attention": flash, **norms,
                "int4_matmul": steps * FILES_DIT_BLOCKS * 10 + gemma_linears}
    north_star_run("files int4", pipe, noise, expected, device)
    first_dit = {n: p.detach().cpu().clone() for n, p in pipe.transformer.named_parameters()}
    del pipe, states
    gc.collect()
    with counted_quantize_weight() as calls:
        pipe, timings = _load("int4 + LoRA, Gemma int4, again", base, device, quantization=q,
                              lora_path=lora_path, gemma_quant="int4")
    same_dit(pipe, first_dit, timings, calls, "int4", "quantize_weight calls")
    del pipe, first_dit
    gc.collect()
    torch.cuda.empty_cache()

    # --- the reference's defaults (W8A8 Gemma) with a W8A8 DiT, no phase
    # staging: Gemma prepared and kept on the card; the caches miss, then hit
    q = QuantizationConfig(mode="w8a8")
    pipe, timings = _load("W8A8 DiT, Gemma w8a8 (the defaults)", base, device, staging=False,
                          quantization=q)
    if timings.cache_hit or timings.gemma_cache_hit:
        raise AssertionError("w8a8: a quantized cache hit on the first load")
    states = gemma_states("w8a8", pipe, {**NO_LAUNCHES, INT8: gemma_linears})
    states_beside_bf16("w8a8", states, bf16_states)
    gemma_decode("w8a8", pipe, INT8)
    expected = {**NO_LAUNCHES, "flash_attention": flash, **norms,
                INT8: steps * FILES_DIT_BLOCKS * 10 + gemma_linears}
    north_star_run("files w8a8", pipe, noise, expected, device)
    first_dit = {n: p.detach().cpu().clone() for n, p in pipe.transformer.named_parameters()}
    del pipe, states, bf16_states
    gc.collect()
    torch.cuda.empty_cache()
    with counted_requant() as calls:
        pipe, timings = _load("W8A8 DiT, Gemma w8a8, again", base, device, staging=False,
                              quantization=q)
    same_dit(pipe, first_dit, timings, calls, "w8a8", "requantizations")
    del pipe, first_dit
    gc.collect()
    torch.cuda.empty_cache()

    # --- train.cli --weights on the unified file: W8A8 (the reference's
    # default), rank 16, one step
    work = base / "train"
    work.mkdir(parents=True)
    cfg = dataclasses.replace(TransformerConfig(), num_layers=FILES_DIT_BLOCKS)
    train_leg("files train", [
        "--data", str(data), "--out", str(work / "adapter.safetensors"),
        "--weights", str(unified), "--quant", "w8a8", "--rank", "16", "--sdpa", "pallas",
        "--steps", "1", "--log-every", "1", "--device", str(device)],
        train_step_launches(cfg, "w8a8"))
    shutil.rmtree(base, ignore_errors=True)
    log(f"[files] phase: {time.perf_counter() - t_phase:.2f} s")
    return gemma_linears, decode_launches, audio_launches


TRAIN_GRID = (4, 16, 24)   # 25f@768x512: 1536 latent tokens
TRAIN_TEXT = 1024
TRAIN_PADS = (300, 500)    # left padding of the AV step's text contexts (video, audio)
TRAIN_STEPS, TRAIN_RESUMED_STEPS, TRAIN_CKPT_EVERY, TRAIN_RANK = 4, 5, 2, 16


def train_step_launches(cfg: TransformerConfig, quant: str = "int4") -> dict:
    """Launches in one QLoRA train step, from the code: per-block remat runs
    each block forward twice (the step's forward, then its recompute in the
    backward), each with two statistics launches (self- and
    cross-attention) and its 10 quantized block linears: int4 through
    int4_matmul (1536 latent and 1024 text rows, both under 8192), W8A8
    through the library's int8 product; the backward runs each attention's
    dq and dkv kernels once, and the int4 straight-through backward
    dequantizes once per linear whose input needs a gradient: not block 0's
    attn1 q/k/v (their input is the frozen patchify projection's) nor any
    attn2 to_k/to_v (the frozen caption projection's); the W8A8 one
    multiplies by the int8 weight in bf16 (no launch of ours). The norms go
    as the route gives them in a LoRA step (checks.rms_train_counts): the
    kernel for block 0's first adaln in both forwards, the chain for the
    rest."""
    layers = cfg.num_layers
    quantized = ({"int4_matmul": 2 * 10 * layers, "dequant_int4": 10 * layers - 3 - 2 * layers}
                 if quant == "int4" else {INT8: 2 * 10 * layers})
    return {**NO_LAUNCHES, "flash_attention_stats": 2 * 2 * layers,
            "flash_attention_bwd_dq": 2 * layers, "flash_attention_bwd_dkv": 2 * layers,
            **quantized, **checks.rms_train_counts(cfg, forwards=2)}


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


def phase_train(device, data) -> dict:
    """The training path at full width and depth through train.cli on the
    shards in `data` (phase 3h's): 4 steps with a checkpoint every 2, then
    a resume leg to step 5. Asserts the launches of every step, finite
    losses, lora_b moved from 0 by the first steps, the resume starting at
    step 4 and an adapter of 480 x 3 tensors that reads back. Returns the
    summed launches of the first leg."""
    cfg = TransformerConfig()
    work = build.BUILD_DIR.parent / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ckpt, out = work / "train.npz", work / "adapter.safetensors"
    argv = ["--data", str(data), "--out", str(out), "--random-init", "full",
            "--quant", "int4", "--rank", str(TRAIN_RANK), "--sdpa", "pallas",
            "--steps", str(TRAIN_STEPS), "--ckpt-every", str(TRAIN_CKPT_EVERY),
            "--log-every", "1", "--ckpt", str(ckpt), "--device", str(device)]
    expected = train_step_launches(cfg)
    log(f"[train] {cfg.num_layers} blocks, int4 base, rank {TRAIN_RANK} LoRA, on "
        f"{', '.join(p.name for p in sorted(Path(data).glob('*.npz')))} (grid {TRAIN_GRID}, "
        f"{TRAIN_TEXT} text tokens); expected launches per step "
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
    t_mark = [time.perf_counter()]

    def mark(what: str) -> None:
        now = time.perf_counter()
        log(f"[time] {what}: {now - t_mark[0]:.2f} s")
        t_mark[0] = now

    phase_environment()
    mark("phase 1 (environment, kernel build)")
    flash = phase_flash_kernel(device)
    mark("phase 2 (B1 against its plain version)")
    stats, dq, dkv = phase_flash_training_kernels(device)
    mark("phase 2 (B2, B3a, B3b against their plain versions)")
    matmul, dequant = phase_int4_kernels(device)
    mark("phase 2 (B4, B5 against their plain versions)")
    rms = phase_rms_kernel(device)
    phase_w8a8_products(device)
    mark("phase 2 (B6 and the W8A8 products against their plain versions)")
    phase_tiny_agreement(device)
    mark("phase 2 (tiny pipelines)")
    pipe, noise, steps, (launches, bf16_run) = phase_main_path(device)
    rms["launches_by_path"] = {"north star": launches["rms_norm"]}
    rms["launches"] = launches["rms_norm"]
    mark("phase 3 (main path)")
    phase_two_stage(pipe, device)
    mark("phase 3b (two-stage)")
    t_phase = time.perf_counter()
    tok = Tokenizer.from_str(json.dumps(smoke_tokenizer()))
    phase_cycle_gemma(tok, device)
    siglip = phase_enhancement(pipe, tok, noise, steps, device)
    log(f"[enhance] phase 3e: {time.perf_counter() - t_phase:.2f} s")
    mark("phase 3e (enhancement)")
    # the phase-3 components placed on the card once for the phases that run
    # them resident, as a server keeps them (each phase's own `resident`
    # then places nothing); phase 3 measures the staging
    with resident(pipe, ("gemma", "text_encoder", "transformer", "vae_decoder",
                         "vae_encoder"), device):
        phase_batched(pipe, device)
        phase_norm_choice(pipe, device)
        mark("phase 3c (batched, norm choice)")
        t_phase = time.perf_counter()
        long_paths = phase_long_video(pipe, device)
        log(f"[long] phase 3f: {time.perf_counter() - t_phase:.2f} s")
        t_phase = time.perf_counter()
        surfaces = phase_surfaces(pipe, tok, device)
        log(f"[surfaces] phase 3g: {time.perf_counter() - t_phase:.2f} s")
        t_phase = time.perf_counter()
        prepared, shards = phase_prepare_data(pipe, tok, device)
        log(f"[prepare] phase 3h: {time.perf_counter() - t_phase:.2f} s")
    mark("phases 3f, 3g, 3h (long video, surfaces, prepare-data; resident)")
    # B1's paths: the north star (its DiT and connector), the long-video
    # modes, the surfaces, prepare-data's text pass and the SigLIP tower
    paths = {**long_paths, **surfaces, "prepare-data": prepared}
    flash["launches_by_path"] = {"north star": launches["flash_attention"],
                                 **{k: v["flash_attention"] for k, v in paths.items()},
                                 "SigLIP tower (I2V enhancement)": siglip}
    rms["launches_by_path"].update({k: v["rms_norm"] for k, v in paths.items()})
    flash["launches"] = sum(flash["launches_by_path"].values())
    w8a8_run = phase_w8a8_main_path(pipe, noise, steps, device)
    north_star = phase_int4_main_path(pipe, noise, steps, bf16_run, device,
                                      w8a8_run)["int4_matmul"]
    mark("phases 3d, 4 (W8A8, int4)")
    dequant["launches"] = phase_big_m(pipe, device)["dequant_int4"]
    mark("phase 5 (big M)")
    t_phase = time.perf_counter()
    av_pipe = audio_pipeline(pipe, device)
    del pipe, noise, bf16_run, w8a8_run
    # the joint-audio components resident on the card for 5c and 5d, as a
    # server keeps them (phase 3 measures staging); the AV QLoRA step takes
    # the dual DiT from the pipeline
    with resident(av_pipe, AV_RESIDENT, device):
        av_north = phase_av_north_star(av_pipe, device)
        av_flagship = phase_av_flagship(av_pipe, device)
        av_long = phase_av_long_video(av_pipe, device)
        log(f"[av] phase 5c: {time.perf_counter() - t_phase:.2f} s")
        mark("phase 5c (joint audio)")
        av_train = phase_av_train(av_pipe, device)
    mark("phase 5d (AV QLoRA step)")
    del av_pipe
    gc.collect()
    torch.cuda.empty_cache()
    gemma_pass, gemma_decode_launches, files_av = phase_files_to_frames(device, shards)
    mark("phase 5b (files to frames)")
    av_paths = {"AV north star": av_north, "AV flagship 241f@1024x640": av_flagship,
                **av_long, "AV clip from files (8 blocks)": files_av}
    for entry in (flash, rms):
        entry["launches_by_path"].update({k: v[entry["name"]] for k, v in av_paths.items()})
        entry["launches"] = sum(entry["launches_by_path"].values())
    # B4's paths: the int4 north star, the int4 Gemma's text pass and its
    # decode (FILES_DECODE_TOKENS greedy tokens, sequential and with 8 drafts)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(device, shards)
    shutil.rmtree(shards.parent, ignore_errors=True)
    mark("phase 6 (training)")
    # B2-B5's paths: the video QLoRA steps of the trainer and the AV QLoRA
    # steps; B4's the int4 north star and the int4 Gemma's text pass and
    # decode too, B5's the big-M call
    trained = {f"QLoRA train x{TRAIN_STEPS} (video)": train,
               f"AV QLoRA step x{AV_TRAIN_STEPS}": av_train}
    for entry in (stats, dq, dkv):
        entry["launches_by_path"] = {k: v[entry["name"]] for k, v in trained.items()}
    matmul["launches_by_path"] = {"int4 north star": north_star,
                                  "int4 Gemma text pass": gemma_pass,
                                  "int4 Gemma decode forwards": gemma_decode_launches}
    dequant["launches_by_path"] = {"9216-token int4 call": dequant["launches"]}
    for entry in (matmul, dequant):
        entry["launches_by_path"].update({k: v[entry["name"]] for k, v in trained.items()})
    rms["launches_by_path"][f"AV QLoRA step x{AV_TRAIN_STEPS}"] = av_train["rms_norm"]
    for entry in (stats, dq, dkv, matmul, dequant, rms):
        entry["launches"] = sum(entry["launches_by_path"].values())
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
