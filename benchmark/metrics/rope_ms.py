"""Milliseconds a clip of the RoPE tables: the program's `denoise.rope`
spans (benchmark.spans), one a denoise loop, each the pinned copy of the
tables' inputs to the device and the launches of the kernel that builds the
tables there (`kernels.rope.rope_tables`), not waiting for it. Part of
`glue_ms`."""

from benchmark.spans import per_clip_ms


def read(run):
    return per_clip_ms(run, "denoise.rope")
