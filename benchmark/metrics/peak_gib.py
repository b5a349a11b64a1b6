"""The device's peak allocated memory over the run, in GiB."""


def read(run):
    return run.peak_bytes / 2**30
