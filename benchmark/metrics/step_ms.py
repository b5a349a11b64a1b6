"""Milliseconds a denoise step: every step's seconds in the window, summed,
over the step count."""


def read(run):
    steps = [s for c in run.clips for s in c["steps"]]
    return 1e3 * sum(steps) / len(steps) if steps else None
