"""Seconds a clip: the window's wall time over the clips it completed."""


def read(run):
    return run.wall_s / len(run.clips) if run.clips else None
