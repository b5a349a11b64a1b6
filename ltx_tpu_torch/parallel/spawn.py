"""Run a function on every rank of a world of spawned processes.

`run_world(fn, n, workdir, *args)` spawns n processes (torch.multiprocessing,
spawn). Each joins a process group through a file under `workdir` (no port
to collide on; `runtime.initialize_distributed` with `backend` and
`device`), calls `fn(rank, *args)` and sends its result back. A rank that
raises fails the call with the rank's traceback: nothing a rank raises is
swallowed. A world that does not finish inside `timeout` seconds fails
too, and whatever is still running is killed. `fn` must be importable by
name (a module-level function), and its arguments and result picklable.

Two ranks that share one card run with backend "gloo" and device "cuda";
CPU ranks with device "cpu", where `threads` sets each rank's torch threads.
"""

from __future__ import annotations

import os
import queue
import traceback
from typing import Optional


def _rank_main(rank: int, world: int, init_file: str, backend: str, device: str,
               threads: Optional[int], fn, args, results) -> None:
    import torch
    import torch.distributed as dist

    if threads is not None:
        torch.set_num_threads(threads)
    try:
        from ltx_tpu_torch.parallel import runtime

        runtime.initialize_distributed(f"file://{init_file}", world, rank, backend=backend,
                                       device=device)
        results.put((rank, "ok", fn(rank, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world: int, workdir, *args, backend: str = "gloo", device: str = "cpu",
              threads: Optional[int] = None, timeout: float = 240.0) -> list:
    """[fn(0, *args), ..., fn(world - 1, *args)], each run in its own
    process of a world of `world` ranks (module docstring). Raises
    RuntimeError with the failing rank's traceback, or on the timeout."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_file = os.path.join(os.path.abspath(str(workdir)), f"init_{os.getpid()}_{id(fn)}")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init_file, backend, device, threads, fn, args, results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, status, value = results.get(timeout=timeout)
            except queue.Empty:
                errors.append(f"world of {world}: no result within {timeout} s")
                break
            if status != "ok":
                errors.append(f"rank {rank}:\n{value}")
                break
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        if os.path.exists(init_file):
            os.unlink(init_file)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out[r] for r in range(world)]
