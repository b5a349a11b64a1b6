"""The least time of the model's attention work in the traced window
(benchmark.flops, from the shapes), over the device time of the kernels in
the trace's "attention" group, in %."""


def read(run):
    if run.trace is None or not run.clips:
        return None
    seconds = run.trace["group_seconds"].get("attention", 0.0)
    if seconds <= 0.0:
        return None
    return 100.0 * run.work["attention_seconds"] * len(run.clips) / seconds
