"""The DiT's model FLOPs over the window's clips (benchmark.flops, from the
shapes: `denoise_flops` a clip, over all its steps), over the summed step
wall time, as a share of the bf16 peak, in %."""

from benchmark.flops import PEAK_BF16_FLOPS


def read(run):
    steps = [s for c in run.clips for s in c["steps"]]
    if not steps:
        return None
    return 100.0 * run.work["denoise_flops"] * len(run.clips) / sum(steps) / PEAK_BF16_FLOPS
