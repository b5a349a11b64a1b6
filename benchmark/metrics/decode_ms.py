"""Milliseconds a clip of the decodes: the VAE's, and the audio VAE's and
the vocoder's where the clip has sound."""


def read(run):
    return 1e3 * sum(c["decode"] for c in run.clips) / len(run.clips) if run.clips else None
