"""The pipelines, one pair of files each: a configuration's `"pipeline"`
value names its program side `paths/<pipeline>.py` and its reference side
`reference/paths/<pipeline>.py`, which the harness loads by that name.
Adding a pipeline is adding the two files.

The program side defines `meta_modules(config)`, `build_pipeline(config,
modules, weights, device)`, `generation_config(traffic)`, `run_clip(pipe,
gen_config, clip, on_progress=None) -> (frames, audio | None, timings)` and
`clip_work(config, traffic)`; it imports the port only inside functions.
The reference side defines `clip_shapes(config, traffic)` (the draws of one
clip), `build(config, weights, precision)` and `generate(modules, config,
traffic, clip) -> {"frames", "audio"}`; it imports nothing of the port.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

PROGRAM_DIR = Path(__file__).resolve().parent
REFERENCE_DIR = PROGRAM_DIR.parent / "reference" / "paths"


class UnknownPipeline(LookupError):
    """A configuration's pipeline without its pair of files."""


def _load(config: dict, side: str):
    pipeline = config["pipeline"]
    files = {"program": PROGRAM_DIR / f"{pipeline}.py",
             "reference": REFERENCE_DIR / f"{pipeline}.py"}
    if not all(f.is_file() for f in files.values()):
        raise UnknownPipeline(f"unknown pipeline {pipeline!r}: looked for {files['program']} "
                              f"and {files['reference']}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{side}_path_{pipeline}",
                                                  files[side])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def program_side(config: dict):
    """The program side of `config`'s pipeline, from its own file."""
    return _load(config, "program")


def reference_side(config: dict):
    """The reference side of `config`'s pipeline, from its own file."""
    return _load(config, "reference")
