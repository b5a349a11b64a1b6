"""Serving: dynamic micro-batching, a job queue and an HTTP front end.

Port of ltx_tpu/serve/. Why request-level micro-batching, not slot-level
continuous batching: a batched Gemma decode runs its rows in lockstep from
prefill to the last token, so a request joins at a batch boundary; it waits
at most one batch, and every row of a batch shares each weight read of the
latency-bound decode.
"""

from ltx_tpu_torch.serve.batcher import MicroBatcher  # noqa: F401
from ltx_tpu_torch.serve.jobs import JobQueue  # noqa: F401
from ltx_tpu_torch.serve.server import make_server  # noqa: F401
