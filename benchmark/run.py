"""Run one cell of the benchmark once, on the machine this starts on.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`) names
its configuration (`configs/<name>.json`), whose `pipeline` names its pair
of files (`paths/<pipeline>.py`, `reference/paths/<pipeline>.py`), and its
traffic (`traffic/<name>.json`); its limits are in `checks/<workload>.json`. The
last line of standard output is the result: correct, attempted, failed,
the metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), the device, with --trace 1 the breakdown, and the checks, each
number compared beside its limit, which are also the last lines of standard
error. Without CUDA, with fewer cards than the cell asks for, without the
port in this checkout, or with a module of JAX or of the JAX package loaded
when the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ltx_tpu"})


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(bench: dict, workload: str):
    """(cell, configuration entry, configuration, metrics of the cell for the
    end-to-end list and for the per-layer list)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [(m["name"], m["unit"]) for m in bench["end_to_end"] if applies(m)]
    layer = [(m["name"], m["unit"]) for m in bench["per_layer"] if applies(m)]
    return cell, entry, config, e2e, layer


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX package's,
    compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread ({exc})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell, _, config, e2e, layer = cell_of(manifest(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import ltx_tpu_torch
    except ImportError as exc:
        print(f"the program is not in this checkout: {exc}", file=sys.stderr)
        return 4
    if Path(ltx_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print(f"ltx_tpu_torch comes from {ltx_tpu_torch.__file__}, not this checkout",
              file=sys.stderr)
        return 4
    from benchmark import harness
    from benchmark.traffic import Traffic

    harness.log(f"[setup] {torch.cuda.get_device_name(0)}; {power_limit()}; torch "
                f"{torch.__version__}, CUDA {torch.version.cuda}")
    traffic = Traffic(cell["traffic"])
    record, checks, extras = harness.run_cell(
        config, traffic, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START,
        harness.limits_of(args.workload))
    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or of the JAX package loaded: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": record.peak_bytes}
    line = harness.result_line(record, checks, extras, layer if args.trace else e2e, device,
                               bool(args.trace))
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
