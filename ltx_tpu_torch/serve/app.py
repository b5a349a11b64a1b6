"""Assemble the serving stack around a loaded pipeline.

Port of ltx_tpu/serve/app.py. `build_app(pipe, ...)` wires:
  - enhance micro-batches -> pipeline.enhance.enhance_prompts on the
    pipeline's Gemma (strict: a failed batch errors its requests instead of
    echoing them);
  - generation jobs -> the entry point of the request's kind through
    `SeededPipeline` (every draw from the request's seed), exporting an MP4
    (+ WAV) to output_dir/<job_id>.mp4;
  - request validation -> GenerationConfig.validate() BEFORE enqueueing (a
    bad resolution is a 400 at submit time, not a failed job minutes later).

One `device_lock` serializes the device between enhance batches and
generation jobs.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ltx_tpu_torch.pipeline.seeded import SeededPipeline
from ltx_tpu_torch.serve.batcher import MicroBatcher
from ltx_tpu_torch.serve.jobs import Job, JobQueue
from ltx_tpu_torch.serve.metrics import ServeMetrics
from ltx_tpu_torch.serve.server import enhance_group_key, make_server

log = logging.getLogger("ltx_tpu_torch")

# GenerationConfig fields a /v1/generate request may set (whitelist — the
# request dict is untrusted input; everything else keeps config defaults)
_GENERATE_FIELDS = (
    "width", "height", "num_frames", "num_steps", "cfg_scale", "seed",
    "negative_prompt", "guidance_rescale", "cross_attention_scale",
    "ge_gamma", "stg_scale", "two_stage", "enhance_prompt", "fps",
    "image_cond_noise_scale",
)


def export_config_from_request(body: dict, fps: float):
    """VideoExportConfig from the optional 'codec'/'export_quality' request
    fields; raises ValueError on an unknown codec (surfaced as a 400 at
    submission, never a failed job)."""
    from ltx_tpu_torch.io.video import VideoExportConfig

    cfg = VideoExportConfig(
        fps=fps,
        codec=str(body.get("codec", "h264")),
        quality=float(body.get("export_quality", 0.8)),
    )
    _ = cfg.ffmpeg_codec  # validate the codec now
    return cfg


def _fenced_path(body: dict, field: str, image_root: Optional[Path]) -> str:
    """Resolve a request-named server-side path, confined to image_root
    when the fence is set (same rule request_to_config applies at submit
    validation — this is the run-time twin for fields GenerationConfig
    does not carry, e.g. v2v 'video_path')."""
    path = Path(str(body[field]))
    if image_root is not None:
        resolved = (image_root / path).resolve() if not path.is_absolute() \
            else path.resolve()
        root = image_root.resolve()
        if not resolved.is_relative_to(root):
            raise ValueError(f"'{field}' must stay under the server's "
                             "--image-root")
        path = resolved
    return str(path)


def _validate_keyframe_list(kfs, nf: int, image_root: Optional[Path],
                            what: str, min_latent: int = 0):
    """Submit-time validation of a keyframe list (kind=keyframes and the
    chain's per-segment anchors share the rules): 8-aligned in-range
    frames, no duplicate latent indices, fenced paths; min_latent rejects
    anchors that overlap a chain segment's carried tail."""
    if not isinstance(kfs, list) or not kfs:
        raise ValueError(
            f"{what} requires a non-empty list of "
            '{"frame": int, "image_path": str}')
    seen = set()
    for kf in kfs:
        if not isinstance(kf, dict) or "frame" not in kf \
                or not kf.get("image_path"):
            raise ValueError(
                'each keyframe must be {"frame": int, "image_path": str}')
        f = int(kf["frame"])
        if f % 8 != 0 or f < 0:
            raise ValueError(
                f"keyframe 'frame' must be a non-negative multiple of "
                f"8, got {f}")
        if nf and f >= nf:
            raise ValueError(
                f"keyframe 'frame' ({f}) must be < 'num_frames' ({nf})")
        if f // 8 < min_latent:
            raise ValueError(
                f"{what}: 'frame' {f} overlaps the carried tail (first "
                f"{min_latent} latent frames)")
        if f // 8 in seen:
            raise ValueError(f"duplicate keyframe at latent index "
                             f"{f // 8}")
        seen.add(f // 8)
        _fenced_path(kf, "image_path", image_root)  # fence at submit


def request_to_config(body: dict, image_root: Optional[Path] = None):
    """Build + validate a GenerationConfig from an untrusted request dict.

    image_root, when set, confines i2v 'image_path' AND v2v 'video_path'
    to files under that directory (a request names an arbitrary
    server-side path — without the fence any readable file on the host
    could be conditioned into the output video). None = trusted local
    use, any path accepted.

    Raises LTXError/ValueError with a user-facing message on bad input.
    """
    from ltx_tpu_torch.config import GenerationConfig

    kwargs = {}
    for k in _GENERATE_FIELDS:
        if k in body:
            kwargs[k] = body[k]
    if "stg_blocks" in body:
        kwargs["stg_blocks"] = tuple(int(b) for b in body["stg_blocks"])
    kind = body.get("kind", "t2v")
    if kind in ("two_stage", "audio_two_stage"):
        kwargs["two_stage"] = True
    if kind == "i2v":
        if not body.get("image_path"):
            raise ValueError("kind 'i2v' requires 'image_path'")
        kwargs["image_path"] = _fenced_path(body, "image_path", image_root)
    if kind == "v2v":
        if not body.get("video_path"):
            raise ValueError("kind 'v2v' requires 'video_path'")
        _fenced_path(body, "video_path", image_root)  # fence at submit
        strength = float(body.get("strength", 0.6))
        if not 0.0 < strength <= 1.0:
            raise ValueError(f"'strength' must be in (0, 1], got {strength}")
    if kind == "extend":
        if not body.get("video_path"):
            raise ValueError("kind 'extend' requires 'video_path'")
        _fenced_path(body, "video_path", image_root)  # fence at submit
        cf = int(body.get("cond_frames", 9))
        nf = int(body.get("num_frames", kwargs.get("num_frames", 0) or 0))
        if cf < 1 or (cf - 1) % 8 != 0:
            raise ValueError(f"'cond_frames' must be 8k+1, got {cf}")
        if nf and cf >= nf:
            raise ValueError(
                f"'cond_frames' ({cf}) must be < 'num_frames' ({nf})")
    if kind == "chain":
        seg = int(body.get("segments", 2))
        if not 2 <= seg <= 16:
            raise ValueError(
                f"'segments' must be in [2, 16], got {seg} (1 segment is "
                "plain t2v; the cap bounds one job's device time)")
        cf = int(body.get("cond_frames", 9))
        nf = int(body.get("num_frames", kwargs.get("num_frames", 0) or 0))
        if cf < 1 or (cf - 1) % 8 != 0:
            raise ValueError(f"'cond_frames' must be 8k+1, got {cf}")
        if nf and cf >= nf:
            raise ValueError(
                f"'cond_frames' ({cf}) must be < 'num_frames' ({nf})")
        prompts = body.get("prompts")
        if prompts is not None:
            if (not isinstance(prompts, list) or len(prompts) != seg
                    or not all(isinstance(p, str) and p for p in prompts)):
                raise ValueError(
                    f"'prompts' must be {seg} non-empty strings (one per "
                    "segment)")
        tr = float(body.get("tail_renorm", 0.0))
        if not 0.0 <= tr <= 1.0:
            raise ValueError(f"'tail_renorm' must be in [0, 1], got {tr}")
        if body.get("audio_cond") and not body.get("audio"):
            raise ValueError("'audio_cond' requires 'audio': true")
        anchors = body.get("anchors")
        if anchors is not None:
            # per-segment keyframe anchors (video and AV chains)
            if not isinstance(anchors, dict) or not anchors:
                raise ValueError(
                    "'anchors' must be a non-empty {segment: [keyframe, "
                    "...]} object")
            k_lat = (cf - 1) // 8 + 1
            for k_seg, kfs in anchors.items():
                try:
                    si = int(k_seg)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"anchor segment {k_seg!r} is not an integer")
                if not 0 <= si < seg:
                    raise ValueError(
                        f"anchor segment {si} outside [0, {seg})")
                _validate_keyframe_list(
                    kfs, nf, image_root, what=f"anchor segment {si}",
                    min_latent=(k_lat if si > 0 else 0))
    if kind == "keyframes":
        nf = int(body.get("num_frames", kwargs.get("num_frames", 0) or 0))
        _validate_keyframe_list(body.get("keyframes"), nf, image_root,
                                what="kind 'keyframes'")
    cfg = GenerationConfig(**kwargs)
    cfg.validate()
    return cfg


def _seeded(pipe) -> SeededPipeline:
    return pipe if isinstance(pipe, SeededPipeline) else SeededPipeline(pipe)


def warmup_pipeline(pipe, shapes, num_steps: int = 8) -> float:
    """Pay the first-use costs of the given shapes before the server takes
    jobs (serve --warmup): the kernels' build, cuBLAS and cuDNN set-up, the
    allocator's growth. Eager PyTorch compiles no programs, so for each
    shape this runs one seeded generation of ONE denoise step at that shape
    and its decode, and discards it.

    Each entry is (width, height, num_frames) for T2V, or (width, height,
    num_frames, "two_stage"): one step at half size, the 2x upscaler, one
    step at full size and the decode. The default guidance (no CFG or STG,
    the common request); other guidance rows take their first-use costs on
    first use. Returns the seconds."""
    import torch

    from ltx_tpu_torch.config import GenerationConfig
    from ltx_tpu_torch.models.upscaler import upsample_latents

    seeded = _seeded(pipe)
    base = seeded.pipe
    t0 = time.time()
    for spec in shapes:
        w, h, f = spec[:3]
        kind = spec[3] if len(spec) > 3 else "t2v"
        cfg = GenerationConfig(width=int(w), height=int(h), num_frames=int(f),
                               num_steps=num_steps, seed=0,
                               two_stage=(kind == "two_stage"))
        cfg.validate()
        one = dataclasses.replace(cfg, two_stage=False)
        if kind == "two_stage":
            if base.upscaler is None:
                raise ValueError(
                    "two_stage warmup requires the upscaler (serve --upscaler)")
            half, _ = base.stage_shapes(cfg)
            s1 = dataclasses.replace(one, width=cfg.width // 2, height=cfg.height // 2)
            seeded.generate_video("warmup", _one_step(base, s1))
            upscaler = base._on_device("upscaler")
            with torch.inference_mode():
                latent = torch.zeros(half.shape, device=base.device)
                upsample_latents(upscaler, latent,
                                 base.vae_decoder.mean_of_means.to(base.device),
                                 base.vae_decoder.std_of_means.to(base.device))
            base._release("upscaler")
        seeded.generate_video("warmup", _one_step(base, one))
    seconds = time.time() - t0
    log.info("serve warmup: %d shape(s) ready in %.1f s", len(shapes), seconds)
    return seconds


def _one_step(pipe, config):
    """`config` cut to its schedule's first denoise step."""
    first = float(pipe._sigmas(config, pipe._shape(config))[0])
    return dataclasses.replace(config, sigmas_override=(first,))


@dataclass
class ServeApp:
    jobs: JobQueue
    batcher: Optional[MicroBatcher]
    server: object  # ThreadingHTTPServer
    device_lock: threading.Lock
    metrics: Optional[ServeMetrics] = None
    warmup_seconds: float = 0.0

    def close(self):
        # shutdown() blocks until a RUNNING serve_forever loop exits and
        # deadlocks if the loop never started (socketserver docstring) —
        # skip it for a built-but-never-served app.
        if getattr(self.server, "ltx_serving", False):
            self.server.shutdown()
        self.server.server_close()
        if self.batcher is not None:
            self.batcher.close()
        self.jobs.close()


def build_app(
    pipe,
    output_dir: str = "serve_outputs",
    host: str = "127.0.0.1",
    port: int = 8571,
    max_batch: int = 4,
    spec_k: int = 8,
    batch_window_s: float = 0.05,
    enhance_timeout_s: float = 600.0,
    info: Optional[dict] = None,
    image_root: Optional[str] = None,
    kv_quant: str = "bf16",
    gen_batch: int = 1,
    warmup_shapes=None,
) -> ServeApp:
    """Wire a pipeline (an LTXPipeline or a SeededPipeline) into JobQueue +
    MicroBatcher + HTTP server.

    The server is constructed but NOT started; call
    serve_forever_threaded(app.server) or app.server.serve_forever().

    gen_batch > 1 coalesces queued SAME-CONFIG text-to-video jobs into one
    batched denoise (SeededPipeline.generate_videos); per-job seeds, outputs
    and failure isolation are kept. Device memory grows with the batch.
    """
    seeded = _seeded(pipe)
    base = seeded.pipe
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    root = Path(image_root) if image_root is not None else None
    device_lock = threading.Lock()
    metrics = ServeMetrics()

    batcher = None
    if base.gemma is not None and base.tokenizer is not None:
        def run_enhance_batch(payloads):
            from ltx_tpu_torch.pipeline.enhance import enhance_prompts

            p0 = payloads[0]  # group_key guarantees shared params
            gemma = base._on_device("gemma")
            try:
                return enhance_prompts(
                    gemma, base.tokenizer, [p["prompt"] for p in payloads],
                    is_i2v=bool(p0["i2v"]), max_tokens=int(p0["max_tokens"]),
                    temperature=float(p0["temperature"]), seed=int(p0["seed"]),
                    spec_k=spec_k, strict=True, kv_quant=kv_quant, mesh=base.mesh)
            finally:
                base._release("gemma")

        batcher = MicroBatcher(
            run_enhance_batch, max_batch=max_batch,
            batch_window_s=batch_window_s, group_key=enhance_group_key,
            device_lock=device_lock, name="enhance",
            on_batch=metrics.on_batch)

    def run_job(job: Job) -> dict:
        cfg = request_to_config(job.request, image_root=root)
        prompt = job.request["prompt"]
        kind = job.kind
        audio_gain = float(job.request.get("audio_gain", 1.0))
        if kind == "v2v":
            result = seeded.generate_video_from_video(
                prompt, cfg,
                video_path=_fenced_path(job.request, "video_path", root),
                strength=float(job.request.get("strength", 0.6)))
        elif kind == "extend":
            vp = _fenced_path(job.request, "video_path", root)
            cf = int(job.request.get("cond_frames", 9))
            if job.request.get("audio"):
                # extend WITH a soundtrack (needs the audio components — a
                # missing one fails THIS job, not the queue)
                result = seeded.generate_video_with_audio(
                    prompt, cfg, audio_gain=audio_gain,
                    video_path=vp, cond_frames=cf)
            else:
                result = seeded.generate_video_extension(
                    prompt, cfg, video_path=vp, cond_frames=cf)
        elif kind == "keyframes":
            result = seeded.generate_video_keyframes(
                prompt, cfg,
                [(int(kf["frame"]),
                  _fenced_path(kf, "image_path", root))
                 for kf in job.request["keyframes"]],
                audio=bool(job.request.get("audio")),
                audio_gain=audio_gain)
        elif kind == "chain":
            anchors = None
            if job.request.get("anchors"):
                anchors = {
                    int(si): [(int(kf["frame"]),
                               _fenced_path(kf, "image_path", root))
                              for kf in kfs]
                    for si, kfs in job.request["anchors"].items()}
            if job.request.get("audio"):
                result = seeded.generate_video_chain_with_audio(
                    prompt, cfg,
                    segments=int(job.request.get("segments", 2)),
                    cond_frames=int(job.request.get("cond_frames", 9)),
                    prompts=job.request.get("prompts"),
                    audio_gain=audio_gain,
                    audio_cond=bool(job.request.get("audio_cond")),
                    anchors=anchors)
            else:
                result = seeded.generate_video_chain(
                    prompt, cfg,
                    segments=int(job.request.get("segments", 2)),
                    cond_frames=int(job.request.get("cond_frames", 9)),
                    prompts=job.request.get("prompts"),
                    anchors=anchors,
                    tail_renorm=float(job.request.get("tail_renorm", 0.0)))
        elif kind == "audio_two_stage":
            result = seeded.generate_video_with_audio_two_stage(
                prompt, cfg, audio_gain=audio_gain)
        elif kind == "audio":
            result = seeded.generate_video_with_audio(
                prompt, cfg, audio_gain=audio_gain)
        elif kind == "two_stage":
            result = seeded.generate_video_two_stage(prompt, cfg)
        else:  # t2v / i2v (I2V through cfg.image_path inside the pipeline)
            result = seeded.generate_video(prompt, cfg)
        return _export_one(job, result, cfg)

    def _export_one(job: Job, result, cfg) -> dict:
        from ltx_tpu_torch.io.video import export_video, export_wav

        path = str(out / f"{job.job_id}.mp4")
        export_video(result.frames, path, fps=cfg.fps, audio=result.audio,
                     config=export_config_from_request(job.request, cfg.fps))
        rec = {"output": path, "seed": result.seed,
               "frames": int(result.frames.shape[0]),
               "width": int(result.frames.shape[2]),
               "height": int(result.frames.shape[1])}
        if result.audio is not None:
            export_wav(result.audio, path + ".wav")
            rec["audio"] = path + ".wav"
        return rec

    def generate_batch_key(job: Job):
        """Coalescing key for plain T2V jobs, or None (run solo) for any
        other kind / I2V / enhanced request. A cheap projection of the RAW
        request dict — batch_key runs under the JobQueue lock for every
        scanned job, so no config construction/validation here (requests
        were already validated at submit time by validate_fn); two
        requests batch only when every generation field matches verbatim
        (seed excepted — it is per-job)."""
        if job.kind != "t2v":
            return None
        body = job.request
        if body.get("image_path") or body.get("enhance_prompt"):
            # enhanced prompts run through the single-job path: batched
            # enhancement belongs to the MicroBatcher
            return None
        return tuple(
            (k, repr(body.get(k)))
            for k in (*_GENERATE_FIELDS, "stg_blocks", "codec",
                      "export_quality")
            if k != "seed")

    def run_generate_batch(batch) -> list:
        cfgs = [request_to_config(j.request, image_root=root) for j in batch]
        seeds = []
        for i, c in enumerate(cfgs):
            seeds.append(c.seed if c.seed is not None
                         else int(time.time()) + i)
        results = seeded.generate_videos(
            [j.request["prompt"] for j in batch], cfgs[0], seeds=seeds)
        return [_export_one(j, r, c)
                for j, r, c in zip(batch, results, cfgs)]

    jobs = JobQueue(run_job, device_lock=device_lock,
                    on_job=metrics.on_job,
                    run_batch=run_generate_batch if gen_batch > 1 else None,
                    batch_key=generate_batch_key if gen_batch > 1 else None,
                    max_batch=gen_batch)

    def validate_fn(body) -> Optional[str]:
        try:
            cfg = request_to_config(body, image_root=root)
            export_config_from_request(body, cfg.fps)
        except Exception as e:  # noqa: BLE001 — message back to the client
            return str(e)
        return None

    warmup_seconds = 0.0
    if warmup_shapes:
        # the first-use costs paid BEFORE the server accepts jobs: the first
        # job's latency then matches the steady state
        warmup_seconds = warmup_pipeline(seeded, warmup_shapes)

    server = make_server(
        jobs, batcher=batcher,
        info_fn=lambda: info or {"model": "ltx_tpu_torch",
                                 "enhance": batcher is not None},
        validate_fn=validate_fn, host=host, port=port,
        enhance_timeout_s=enhance_timeout_s, metrics=metrics)
    return ServeApp(jobs=jobs, batcher=batcher, server=server,
                    device_lock=device_lock, metrics=metrics,
                    warmup_seconds=warmup_seconds)
