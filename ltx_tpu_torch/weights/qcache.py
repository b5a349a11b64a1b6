"""Quantized-weight cache: quantize once, map the result afterwards.

Port of ltx_tpu/weights/qcache.py, file for file: one safetensors file next
to the source checkpoint, the tree's nested keys joined with "/", bfloat16
leaves stored as their uint16 payload under a "@bf16" key suffix, and the
header metadata holding the format string, the source's size and mtime and
the quantization signature (`pipeline.loader._quant_signature`, or the
Gemma entries' `gemma_signature`). A tree in the JAX package's layout
(`convert.transformer_tree`, `convert.gemma_tree`) is what is stored,
so a cache written by either package loads in the other. Any mismatch of
the signature means a miss, and the caller quantizes again.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

import torch

from ltx_tpu_torch.errors import WeightLoadingFailedError
from ltx_tpu_torch.weights import safetensors_io

log = logging.getLogger("ltx_tpu_torch")

_FORMAT = "ltx-qcache-v1"


def cache_path(source_path, tag: str) -> Path:
    """<source>.<tag>.qcache.safetensors next to the source file (inside it
    for a directory source)."""
    p = Path(source_path)
    if p.is_dir():
        return p / f"{tag}.qcache.safetensors"
    return p.with_name(p.name + f".{tag}.qcache.safetensors")


def _signature(source_path, quant_sig: dict) -> dict:
    p = Path(source_path)
    if p.is_dir():
        # the caches themselves are not part of the source
        files = sorted(f for f in p.glob("*.safetensors")
                       if not f.name.endswith(".qcache.safetensors"))
        size = sum(f.stat().st_size for f in files)
        mtime = max((f.stat().st_mtime_ns for f in files), default=0)
        ident = {"source_size": str(size), "source_mtime_ns": str(mtime),
                 "source_files": str(len(files))}
    else:
        st = os.stat(source_path)
        ident = {"source_size": str(st.st_size), "source_mtime_ns": str(st.st_mtime_ns)}
    return {"format": _FORMAT, **ident, **{k: str(v) for k, v in quant_sig.items()}}


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not isinstance(k, str) or "/" in k or k.endswith("@bf16"):
                raise ValueError(f"uncacheable tree key: {k!r}")
            yield from _flatten(v, f"{prefix}{k}/")
    elif tree is not None:
        yield prefix[:-1], tree


def save_quantized_tree(tree, source_path, tag: str, quant_sig: dict) -> Optional[Path]:
    """Persist a tree of tensors, on the host or a device (each is copied
    to the host as it is written); returns the path, or None when the tree
    cannot be cached or the directory is not writable."""
    flat = {}
    try:
        for key, t in _flatten(tree):
            if not isinstance(t, torch.Tensor):
                return None
            if t.dtype == torch.bfloat16:
                flat[key + "@bf16"] = t.contiguous().view(torch.uint16)
            else:
                flat[key] = t
    except ValueError as e:
        log.info("quantized cache skipped: %s", e)
        return None
    path = cache_path(source_path, tag)
    try:
        safetensors_io.save(flat, path, metadata=_signature(source_path, quant_sig))
    except OSError as e:
        log.info("quantized cache not written (%s): %s", path, e)
        return None
    log.info("quantized cache written: %s (%d tensors)", path, len(flat))
    return path


def load_quantized_tree(source_path, tag: str, quant_sig: dict):
    """-> the nested tree of CPU tensors (views of the mapped cache), or
    None (no cache, stale, another signature, or unreadable)."""
    path = cache_path(source_path, tag)
    if not path.exists():
        return None
    try:
        if safetensors_io.metadata(path) != _signature(source_path, quant_sig):
            log.info("quantized cache stale (%s); requantizing", path)
            return None
        tree: dict = {}
        for key, t in safetensors_io.load(path).items():
            if key.endswith("@bf16"):
                key, t = key[:-len("@bf16")], t.view(torch.bfloat16)
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    except (OSError, ValueError, WeightLoadingFailedError) as e:
        # a bad cache (a truncated write, another version) must never break
        # loading: quantize again
        log.warning("quantized cache unreadable (%s): %s", path, e)
        return None
    log.info("quantized cache hit: %s", path)
    return tree
