"""One minus the union of kernel intervals over the traced window's wall
time, in %."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
