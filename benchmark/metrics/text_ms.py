"""Milliseconds a clip of the text phase: Gemma and the connector(s)."""


def read(run):
    return 1e3 * sum(c["text"] for c in run.clips) / len(run.clips) if run.clips else None
