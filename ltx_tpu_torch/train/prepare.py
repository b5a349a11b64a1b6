"""Training-data preparation: video clips and captions to latent shards.

Port of ltx_tpu/train/prepare.py. Each clip is decoded and resized
(`io.video.load_video`), VAE-encoded on the device and normalized with the
decoder's channel statistics in f32 (`LTXPipeline.encode_video`: the
latent space the denoiser trains in), then patchified to (T, C) token
rows; the captions run through Gemma and the connector in groups
(`LTXPipeline.encode_prompts`: each component placed on the device once a
group, not once a caption). The rows go into `train.data.write_shard`
files that `LatentShardDataset` streams at step time, so training never
runs the VAE or the text encoder again.

Driven by `ltx-video-torch prepare-data` (io/cli.py) or directly:

    items = [("clip0.mp4", "a red fox running"), ...]
    prepare_dataset(pipe, items, "shards/", width=768, height=512,
                    num_frames=25)
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

log = logging.getLogger("ltx_tpu_torch")


def encode_clip(pipe, video_path, width: int, height: int, num_frames: int,
                release: bool = True) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """One clip -> ((T, C) f32 normalized-latent tokens on the host, (f, h,
    w) grid). release=False keeps a staged encoder on the device for the
    next clip (`prepare_dataset` releases it after its last)."""
    from ltx_tpu_torch.io.video import load_video
    from ltx_tpu_torch.ops.latents import patchify

    pixels = load_video(video_path, width, height, num_frames)
    latent = pipe.encode_video(pixels, release=release)
    _, _, f, h, w = latent.shape
    tokens = patchify(latent)[0].cpu().numpy()  # (T, C) host
    return tokens, (f, h, w)


def prepare_dataset(
    pipe,
    items: Sequence[Tuple[str, str]],
    out_dir,
    width: int,
    height: int,
    num_frames: int,
    rows_per_shard: int = 8,
    skip_errors: bool = False,
    text_group: int = 8,
    text_batch: int = 4,
) -> List[str]:
    """Encode (video_path, caption) pairs into latent shards under out_dir.

    Two passes, ordered for device residency: pass 1 VAE-encodes every clip
    (the encoder placed once; each clip's failure isolated under
    skip_errors); pass 2 runs the surviving captions through
    `pipe.encode_prompts` in groups of `text_group`, so that under phase
    staging Gemma is placed on the device once a group instead of once a
    caption (raise text_group for fewer placements, at the host memory of
    each caption's hidden states while the group waits). `text_batch`
    captions go through the tower together.

    Returns the shard paths written. All rows share one latent grid (fixed
    width/height/num_frames) and the text encoder's padded length, so any
    subset batches at step time. skip_errors logs and goes on past a bad
    clip instead of aborting the run; the failed paths are reported at the
    end either way.
    """
    from ltx_tpu_torch.train.data import write_shard

    if (num_frames - 1) % 8 != 0:
        raise ValueError(f"num_frames must be 8n+1, got {num_frames}")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    text_group = max(1, int(text_group))

    grid = None
    failed: List[str] = []
    survivors: List[Tuple[np.ndarray, str]] = []  # (tokens, caption)

    # Pass 1: clips -> latent token rows (the VAE encoder placed once).
    try:
        for video_path, caption in items:
            try:
                tokens, g = encode_clip(pipe, video_path, width, height, num_frames,
                                        release=False)
            except Exception as e:  # noqa: BLE001 (each clip's failure isolated)
                if not skip_errors:
                    raise
                log.warning("prepare-data: skipping %s (%s)", video_path, e)
                failed.append(str(video_path))
                continue
            if grid is None:
                grid = g
            elif g != grid:
                raise ValueError(f"{video_path}: grid {g} != {grid} "
                                 "(all clips must share width/height/frames)")
            survivors.append((tokens.astype(np.float32), caption))
    finally:
        pipe._release("vae_encoder")

    # Pass 2: captions in groups -> context rows; shards flush as filled.
    tok_rows: List[np.ndarray] = []
    ctx_rows: List[np.ndarray] = []
    mask_rows: List[np.ndarray] = []
    shards: List[str] = []

    def flush():
        if not tok_rows:
            return
        path = out / f"shard{len(shards):05d}.npz"
        write_shard(path, np.stack(tok_rows), np.stack(ctx_rows), grid,
                    mask=np.stack(mask_rows))
        shards.append(str(path))
        log.info("prepare-data: wrote %s (%d rows)", path, len(tok_rows))
        tok_rows.clear()
        ctx_rows.clear()
        mask_rows.clear()

    for s in range(0, len(survivors), text_group):
        group = survivors[s:s + text_group]
        encs = pipe.encode_prompts([cap for _tok, cap in group], batch=text_batch)
        for (tokens, _cap), enc in zip(group, encs):
            tok_rows.append(tokens)
            ctx_rows.append(enc["video"].float().cpu().numpy()[0])
            mask_rows.append(enc["mask"].cpu().numpy().astype(np.int64)[0])
            if len(tok_rows) >= rows_per_shard:
                flush()
    flush()
    if failed:
        log.warning("prepare-data: %d clip(s) failed: %s", len(failed),
                    ", ".join(failed[:8]))
    if not shards:
        raise RuntimeError("prepare-data produced no shards")
    return shards


def read_manifest(path) -> List[Tuple[str, str]]:
    """JSONL manifest ({"video": ..., "caption": ...} per line) -> items.
    Relative video paths resolve against the manifest's directory."""
    base = Path(path).resolve().parent
    items = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "video" not in rec or "caption" not in rec:
                raise ValueError(f"{path}:{ln}: need 'video' and 'caption'")
            vp = Path(rec["video"])
            if not vp.is_absolute():
                vp = base / vp
            items.append((str(vp), str(rec["caption"])))
    if not items:
        raise ValueError(f"empty manifest {path}")
    return items


def scan_videos(directory) -> List[Tuple[str, str]]:
    """Directory of clips with sidecar captions: x.mp4 + x.txt."""
    root = Path(directory)
    items = []
    for vp in sorted(root.glob("*.mp4")):
        cap = vp.with_suffix(".txt")
        if not cap.exists():
            raise FileNotFoundError(f"no caption sidecar {cap}")
        items.append((str(vp), cap.read_text().strip()))
    if not items:
        raise ValueError(f"no .mp4 files under {directory}")
    return items


def add_prepare_arguments(ap) -> None:
    """The reference's prepare-data flags, plus --device."""
    ap.add_argument("source",
                    help="JSONL manifest ({'video','caption'} per line) or "
                         "a directory of .mp4 clips with .txt sidecars")
    ap.add_argument("--out", required=True, help="shard output directory")
    ap.add_argument("-w", "--width", type=int, default=768)
    ap.add_argument("-H", "--height", type=int, default=512)
    ap.add_argument("-f", "--frames", type=int, default=25)
    ap.add_argument("--rows-per-shard", type=int, default=8)
    ap.add_argument("--text-group", type=int, default=8,
                    help="captions encoded per placement of the text encoder "
                         "(higher = fewer placements, more host memory for the "
                         "group's hidden states)")
    ap.add_argument("--text-batch", type=int, default=4,
                    help="captions per tower/connector batch")
    ap.add_argument("--skip-errors", action="store_true",
                    help="log-and-continue on undecodable clips")
    ap.add_argument("--gemma-quant", choices=["int4", "w8a8", "bf16"],
                    default="w8a8")
    ap.add_argument("--memory", choices=["disabled", "light", "moderate",
                                         "aggressive"], default="moderate")
    ap.add_argument("--gemma-path", default=None)
    ap.add_argument("--ltx-weights", default=None)
    ap.add_argument("--models-dir", default=None)
    ap.add_argument("--hf-token", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda: the card)")


def run(args) -> int:
    from ltx_tpu_torch.config import LTXModel, MemoryConfig
    from ltx_tpu_torch.pipeline import loader

    src = Path(args.source)
    items = (scan_videos(src) if src.is_dir() else read_manifest(src))
    log.info("prepare-data: %d clips -> %s (%dx%d, %d frames)",
             len(items), args.out, args.width, args.height, args.frames)

    pipe = loader.load_pipeline(
        model=LTXModel.DISTILLED,
        models_dir=args.models_dir,
        hf_token=args.hf_token,
        gemma_path=args.gemma_path,
        unified_weights_path=args.ltx_weights,
        memory=MemoryConfig.preset(args.memory),
        gemma_quant=args.gemma_quant,
        device=args.device,
    )
    shards = prepare_dataset(
        pipe, items, args.out, args.width, args.height, args.frames,
        rows_per_shard=args.rows_per_shard, skip_errors=args.skip_errors,
        text_group=args.text_group, text_batch=args.text_batch)
    print(f"PREPARE DATA OK: {len(items)} clips -> {len(shards)} shards "
          f"in {args.out}", file=sys.stdout)
    return 0
