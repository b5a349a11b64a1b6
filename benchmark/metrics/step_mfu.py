"""The DiT's model FLOPs over the window's steps (benchmark.flops, from the
shapes), over the summed step wall time, as a share of the bf16 peak, in %."""

from benchmark.flops import PEAK_BF16_FLOPS


def read(run):
    steps = [s for c in run.clips for s in c["steps"]]
    if not steps:
        return None
    return 100.0 * run.work["dit_step_flops"] * len(steps) / sum(steps) / PEAK_BF16_FLOPS
