"""Readings for a cell's limits, on the chip, at the cell's own size.

    python3 -m benchmark.calibrate --workload <name> --seeds 11,12,13 [--control-seeds 11,12]

For each seed: the weights drawn from it, the pipeline built, one clip of
the cell's traffic through the timed path (the program's output), the f32
reference of that clip, and on the control seeds the reference computed in
fp8 in the program's place. Prints one JSON line a seed with the numbers
compared (`benchmark.harness.compare`) for the program and for the control
against the f32 reference, with the seconds each part took. The limits in
`checks/<workload>.json` are set from these lines (PERF.md gives them).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import harness, paths, program
from benchmark.run import cell_of, manifest
from benchmark.traffic import Traffic


def reading(config, traffic, seed: int, control: bool, device) -> dict:
    t0 = time.perf_counter()
    path = paths.program_side(config)
    pipe, drawn = harness.build(config, seed, device)
    shapes = paths.reference_side(config).clip_shapes(config, traffic.params)
    clip = traffic.clip(seed, 0, shapes, device)
    t1 = time.perf_counter()
    frames, audio, _ = path.run_clip(pipe, path.generation_config(traffic), clip)
    harness.sync(device)
    t2 = time.perf_counter()
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    ref = harness.reference_output(config, traffic, drawn, clip)
    t3 = time.perf_counter()
    out = {"seed": seed, "program": harness.compare({"frames": frames, "audio": audio}, ref),
           "seconds": {"build": t1 - t0, "program_clip": t2 - t1, "reference": t3 - t2}}
    if control:
        ctl = harness.reference_output(config, traffic, drawn, clip, "fp8")
        out["control"] = harness.compare(ctl, ref)
        out["seconds"]["control"] = time.perf_counter() - t3
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del drawn, ref
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    cell, _, config, _, _ = cell_of(manifest(), args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    program.build_kernels()
    traffic = Traffic(cell["traffic"])
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps({"workload": args.workload,
                          **reading(config, traffic, seed, seed in control, "cuda:0")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
