"""The 90th percentile, by nearest rank, of every clip's latency in the
window, from the call to frames on the host (the north-star cell's)."""

import math


def read(run):
    lat = sorted(c["latency_s"] for c in run.clips)
    return lat[math.ceil(0.9 * len(lat)) - 1] if lat else None
