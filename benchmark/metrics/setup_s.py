"""Seconds from the start of the process to the window: imports, the
kernels' build (or the built ones found), the weights drawn on the device,
the pipeline built and the warm-up clip."""


def read(run):
    return run.setup_s
