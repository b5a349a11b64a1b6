"""Milliseconds a clip of the RoPE tables' build and their copy to the
device: the program's `denoise.rope` spans (benchmark.spans), one a denoise
loop. Part of `glue_ms`."""

from benchmark.spans import per_clip_ms


def read(run):
    return per_clip_ms(run, "denoise.rope")
