"""Run a function on every rank of a gloo world of CPU processes.

jax-free (the ranks import only torch and the port): `run_world(fn, n,
workdir, *args)` is `ltx_tpu_torch.parallel.spawn.run_world` with CPU
ranks over gloo and one torch thread a rank. Each rank joins through a file
under `workdir`, so parallel test workers never collide on a port.
"""

from __future__ import annotations

from ltx_tpu_torch.parallel import spawn


def run_world(fn, world: int, workdir, *args, timeout: float = 240.0) -> list:
    """[fn(0, *args), ..., fn(world - 1, *args)] on a gloo world of CPU ranks."""
    return spawn.run_world(fn, world, workdir, *args, backend="gloo", device="cpu", threads=1,
                           timeout=timeout)
