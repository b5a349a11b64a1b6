"""Training data: latent shards on disk -> batches on the device.

Port of ltx_tpu/train/data.py. A shard is one .npz holding

    tokens   (N, T, C) float16/32: patchified clean video latents
    context  (N, S, caption_channels): text-encoder embeddings
    mask     (N, S) int: optional attention mask (1 = real token)
    grid     (3,) int: the (frames, height, width) latent grid of every row

`write_shard` and `LatentShardDataset` are the reference's, pure numpy: a
seeded shuffle over (shard, row) pairs each epoch, `state()`/`restore` for
an exact resume. Each batch also carries `cursor`, the dataset's state just
after it was drawn, so that a checkpoint can record the position of the
last batch the step consumed rather than of the last one prefetched.
`prefetch_to_device` keeps `depth` batches in flight: pinned host copies
sent with non_blocking, so the upload overlaps the running step.
"""

from __future__ import annotations

import collections
import dataclasses
from pathlib import Path
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ltx_tpu_torch.ops.attention import prepare_additive_mask

REQUIRED_KEYS = ("tokens", "context", "grid")


@dataclasses.dataclass(frozen=True)
class Batch:
    tokens: np.ndarray    # (B, T, C)
    context: np.ndarray   # (B, S, caption_channels)
    mask: Optional[np.ndarray]  # (B, S) or None
    grid: Tuple[int, int, int]
    cursor: Optional[dict] = None  # the dataset's state after this batch


def write_shard(path, tokens, context, grid, mask=None) -> None:
    """Write one training shard (the format `LatentShardDataset` reads)."""
    arrs = {"tokens": np.asarray(tokens),
            "context": np.asarray(context),
            "grid": np.asarray(grid, np.int64)}
    if mask is not None:
        arrs["mask"] = np.asarray(mask)
    f, h, w = arrs["grid"]
    if arrs["tokens"].shape[1] != f * h * w:
        raise ValueError(
            f"tokens T={arrs['tokens'].shape[1]} != grid {f}x{h}x{w}")
    with open(path, "wb") as fh:
        np.savez(fh, **arrs)


class LatentShardDataset:
    """Shuffled infinite batch iterator over a directory of .npz shards.

    All shards share one latent grid; rows shuffle ACROSS shards each epoch
    with a seeded generator, so runs are reproducible and `state()` /
    `restore` make a mid-epoch resume exact.
    """

    def __init__(self, directory, batch_size: int, seed: int = 0,
                 dtype=np.float32):
        self.paths: Sequence[Path] = sorted(Path(directory).glob("*.npz"))
        if not self.paths:
            raise FileNotFoundError(f"no .npz shards under {directory}")
        self.batch_size = batch_size
        self.dtype = dtype
        self._index = []           # (shard_idx, row_idx)
        self._grid = None
        self._has_mask = True
        for si, p in enumerate(self.paths):
            with np.load(p) as z:
                for k in REQUIRED_KEYS:
                    if k not in z.files:
                        raise KeyError(f"shard {p} missing {k!r}")
                grid = tuple(int(g) for g in z["grid"])
                if self._grid is None:
                    self._grid = grid
                elif grid != self._grid:
                    raise ValueError(
                        f"shard {p} grid {grid} != {self._grid}: one dataset "
                        "is one latent grid")
                self._has_mask &= "mask" in z.files
                n = z["tokens"].shape[0]
            self._index.extend((si, ri) for ri in range(n))
        if len(self._index) < batch_size:
            raise ValueError(f"{len(self._index)} rows < batch_size {batch_size}")
        self._rng = np.random.default_rng(seed)
        self._order = None
        self._pos = 0
        self._epoch = 0

    @property
    def grid(self) -> Tuple[int, int, int]:
        return self._grid

    @property
    def num_rows(self) -> int:
        return len(self._index)

    def state(self) -> dict:
        """Generator state and position, for an exact resume."""
        return {"rng": self._rng.bit_generator.state,
                "pos": self._pos, "epoch": self._epoch,
                "order": None if self._order is None else self._order.copy()}

    def restore(self, state: dict) -> None:
        self._rng.bit_generator.state = state["rng"]
        self._pos = state["pos"]
        self._epoch = state["epoch"]
        self._order = state["order"]

    def _reshuffle(self):
        self._order = self._rng.permutation(len(self._index))
        self._pos = 0
        self._epoch += 1

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        if self._order is None or self._pos + self.batch_size > len(self._order):
            self._reshuffle()  # drop the ragged tail (a static batch shape)
        picks = [self._index[i] for i in
                 self._order[self._pos:self._pos + self.batch_size]]
        self._pos += self.batch_size

        toks, ctxs, masks = [], [], []
        by_shard = {}
        for si, ri in picks:
            by_shard.setdefault(si, []).append(ri)
        for si, rows in by_shard.items():
            with np.load(self.paths[si]) as z:
                t, c = z["tokens"], z["context"]
                m = z["mask"] if self._has_mask else None
                for ri in rows:
                    toks.append(t[ri])
                    ctxs.append(c[ri])
                    if m is not None:
                        masks.append(m[ri])
        return Batch(
            tokens=np.stack(toks).astype(self.dtype),
            context=np.stack(ctxs).astype(self.dtype),
            mask=np.stack(masks) if masks else None,
            grid=self._grid,
            cursor=self.state(),
        )


class DeviceBatch(NamedTuple):
    tokens: torch.Tensor
    context: torch.Tensor
    bias: Optional[torch.Tensor]  # (B, 1, 1, S) additive f32, or None
    cursor: Optional[dict]


def prefetch_to_device(batches: Iterator[Batch], depth: int = 2, device="cuda"):
    """Yield DeviceBatch(tokens, context, bias, cursor) with `depth` uploads
    in flight. On a CUDA device the host arrays are pinned and copied with
    non_blocking, so a transfer overlaps the running step; the mask becomes
    the additive bias by `prepare_additive_mask`."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def up(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    def put(b: Batch) -> DeviceBatch:
        bias = None if b.mask is None else prepare_additive_mask(up(b.mask))
        return DeviceBatch(up(b.tokens), up(b.context), bias, b.cursor)

    queue = collections.deque()
    for b in batches:
        queue.append(put(b))
        if len(queue) > depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
