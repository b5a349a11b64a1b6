"""Milliseconds a denoise step of the step function's call: the program's
`denoise.launch` spans (benchmark.spans), the host enqueueing the step and
any wait on the device inside the call (`ops/schedule.euler_step` copies
its sigmas to the device, which waits for the DiT's kernels). Beside
`step_ms`: the part of a step the host spends before its synchronise."""

from benchmark.spans import per_span_ms


def read(run):
    return per_span_ms(run, "denoise.launch")
