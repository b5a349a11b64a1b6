"""Milliseconds a clip of the decode's host work: the program's
`decode.stitch`, `decode.widen` and `decode.copy` spans (benchmark.spans),
the tiles' blend and copy, the widening to f32 and the untiled frames' copy
to the host; not its waits on the device. Part of `decode_ms`."""

from benchmark.spans import per_clip_ms


def read(run):
    return per_clip_ms(run, "decode.stitch", "decode.widen", "decode.copy")
