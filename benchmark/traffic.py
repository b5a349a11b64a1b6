"""The traffic generator: one clip's inputs from the seed and its index.

A traffic mix is a JSON file of parameters under traffic/: the clip's
frames, height, width, fps, denoise steps and guidance scale, and the prompt
mix (`prompt_words`: the inclusive range of a prompt's word count, drawn
uniformly; `words`: the word list, a file beside it). Clip i of a run with
seed s has its own prompt, video latent noise and (for audio) audio latent
noise, the same for every side of a comparison; index -1 is the warm-up's.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from benchmark.seeds import derive, rng

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


class Traffic:
    def __init__(self, name: str, params: dict = None):
        self.name = name
        self.params = params if params is not None else json.loads(
            (TRAFFIC_DIR / f"{name}.json").read_text())
        words = self.params["words"]
        self.words = (words if isinstance(words, list)
                      else (TRAFFIC_DIR / words).read_text().split())

    def __getitem__(self, key):
        return self.params[key]

    def prompt(self, seed: int, index: int) -> str:
        r = rng(seed, "prompt", index)
        lo, hi = self.params["prompt_words"]
        n = int(r.integers(lo, hi + 1))
        return " ".join(self.words[i] for i in r.integers(0, len(self.words), n))

    def clip(self, seed: int, index: int, shapes: dict, device) -> dict:
        """{"index", "prompt", and each draw of `shapes` ({name: shape}),
        float32 standard normal on `device`}."""
        out = {"index": index, "prompt": self.prompt(seed, index)}
        for name, shape in shapes.items():
            gen = torch.Generator(device=device).manual_seed(derive(seed, name, index))
            out[name] = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return out
