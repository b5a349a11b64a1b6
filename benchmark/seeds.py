"""Seeds derived from the run's --seed: one independent stream per purpose."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, *path) -> int:
    """A 63-bit seed for the stream named by `path` (strings and integers)
    under `seed`, any whole number of up to 64 bits."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF]
    for part in path:
        words.append(zlib.crc32(part.encode()) if isinstance(part, str) else int(part) + 1)
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *path) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *path))
