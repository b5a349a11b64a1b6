"""The metrics, one reader a file: `<name>.py` under this folder defines
`read(run) -> float | None` for the metric `name` of BENCHMARK.json. A
reader that finds nothing to read returns None, and the metric is left out
of the result line. `run` is a `benchmark.harness.RunRecord`."""

from __future__ import annotations

import importlib.util
from pathlib import Path

METRICS_DIR = Path(__file__).resolve().parent


def reader(name: str):
    """The `read` function of metric `name`, from its own file."""
    path = METRICS_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
