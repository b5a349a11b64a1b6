"""The multi-process runtime and the (data, model) mesh.

Port of ltx_tpu/parallel/runtime.py and of sharding.py's `make_mesh`. Every
rank is one process (torchrun, or `--coordinator` / `--num-processes` /
`--process-id`) that holds one device:

* `initialize_distributed()` wraps `torch.distributed.init_process_group`:
  idempotent, and a no-op without arguments or a launcher's environment
  (MASTER_ADDR and WORLD_SIZE). The backend is NCCL for CUDA ranks and
  gloo for CPU ones unless `backend=` names one (two ranks that share one
  card must use gloo: NCCL refuses two ranks on one device). The choice is
  printed, never changed behind the caller's back.
* `Mesh` is a (data, model) grid of ranks (("data", "pipe") for pipeline
  parallelism, `make_pp_mesh`). When the process group spans
  more than one rank it is backed by a `torch.distributed.device_mesh.
  DeviceMesh`, whose per-axis process groups the collectives use; a mesh
  whose axes all have size 1 needs no process group and runs no collective.
* `make_hybrid_mesh` keeps the reference's layout rule: each slice (a group
  of ranks joined by the fast link; `slices=` declares contiguous groups)
  contributes data/slices whole rows, so the model axis never crosses a
  slice, with the reference's InvalidConfigurationError cases and messages.
  With one slice it is `make_mesh`'s layout: ranks row-major.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ltx_tpu_torch.errors import InvalidConfigurationError

log = logging.getLogger("ltx_tpu_torch")

_INITIALIZED = False


def _init_method(coordinator_address: Optional[str]) -> str:
    """"host:port" -> tcp://host:port; a URL (tcp://, file://, env://) as
    given; None -> env:// (a launcher's MASTER_ADDR / MASTER_PORT)."""
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: str = "cuda") -> bool:
    """Join the process group; returns True if this call did.

    No-op (False) when called twice or when nothing indicates a
    multi-process run: no argument and no launcher environment. `device`
    is the device type of this process's rank ("cuda", the port's default,
    or "cpu"): the backend is "nccl" for "cuda" and "gloo" for "cpu" unless
    `backend` is given. A CUDA rank takes card LOCAL_RANK (else rank modulo
    the card count). A CUDA rank on a machine with no card raises: nothing
    falls back to the CPU."""
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        return False
    has_env = bool(os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"))
    if coordinator_address is None and num_processes is None and not has_env:
        return False
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", "1"))
    rank = int(process_id if process_id is not None else os.environ.get("RANK", "0"))
    device = torch.device(device).type
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: a CUDA rank, but no CUDA device is "
                               "available (pass device='cpu' for a CPU rank)")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    chosen = backend or ("nccl" if device == "cuda" else "gloo")
    dist.init_process_group(chosen, init_method=_init_method(coordinator_address),
                            world_size=world, rank=rank)
    _INITIALIZED = True
    print(f"[ltx_tpu_torch] distributed: rank {rank}/{world}, {device} rank, backend "
          f"{chosen} ({'explicit' if backend else 'by device'})", file=sys.stderr, flush=True)
    return True


def world() -> tuple:
    """(rank, world size) of this process: (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A grid of ranks with named axes (the reference's jax Mesh).

    `ranks` (an int array, one dimension per axis) lays the ranks out;
    `shape` maps each axis name to its size, as jax's `mesh.shape` does.
    `device_mesh` is the DeviceMesh behind it when the process group has
    more than one rank, else None; `group(axis)` is this rank's process
    group along `axis` (None for an axis of size 1: no collective runs)."""

    def __init__(self, ranks, axis_names: Sequence[str] = ("data", "model")):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise InvalidConfigurationError(
                f"mesh of rank {self.ranks.ndim} with axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.device_mesh = None
        self._groups = {}
        rank, size = world()
        if size > 1:
            if self.ranks.size != size or sorted(self.ranks.flat) != list(range(size)):
                raise InvalidConfigurationError(
                    f"mesh {dict(self.shape)} covers {self.ranks.size} of the {size} ranks: "
                    "every process of the group must be in the mesh")
            from torch.distributed.device_mesh import DeviceMesh

            # the backend's own device type: NCCL's CUDA, gloo's CPU
            self.device_mesh = DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                                          torch.as_tensor(self.ranks),
                                          mesh_dim_names=self.axis_names)
            for name in self.axis_names:
                if self.shape[name] > 1:
                    self._groups[name] = self.device_mesh.get_group(name)
        self.rank = rank if rank in set(self.ranks.flat) else None

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords(self) -> dict:
        """This rank's index along every axis."""
        where = np.argwhere(self.ranks == (self.rank or 0))[0]
        return {name: int(i) for name, i in zip(self.axis_names, where)}

    def index(self, axis: str) -> int:
        """This rank's index along `axis` (0 for an axis of size 1)."""
        return self.coords()[axis] if self.shape[axis] > 1 else 0

    def group(self, axis: str):
        """This rank's process group along `axis`; None when it has size 1."""
        if self.shape[axis] == 1:
            return None
        if axis not in self._groups:
            raise InvalidConfigurationError(
                f"mesh axis {axis!r} has size {self.shape[axis]} but no process group: "
                "call initialize_distributed() in every process before building the mesh")
        return self._groups[axis]

    def axis_ranks(self, axis: str) -> list:
        """The global ranks of this rank's group along `axis`, in axis order."""
        idx = list(self.coords().values())
        a = self.axis_names.index(axis)
        idx[a] = slice(None)
        return [int(r) for r in self.ranks[tuple(idx)]]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, ranks={self.ranks.tolist()})"


def _rank_list(devices) -> list:
    return list(devices) if devices is not None else list(range(world()[1]))


def make_mesh(data: int = 1, model: Optional[int] = None, devices=None) -> Mesh:
    """A (data, model) mesh over the first data * model ranks, row-major.
    Default: every rank on the model axis. `devices`: the ranks to lay out
    (default all ranks of the process group, or [0] outside one)."""
    ranks = _rank_list(devices)
    n = len(ranks)
    if model is None:
        model = n // data
    need = data * model
    if need > n:
        raise InvalidConfigurationError(f"mesh {data}x{model} needs {need} devices, have {n}")
    return Mesh(np.asarray(ranks[:need]).reshape(data, model), ("data", "model"))


def make_pp_mesh(data: int = 1, pipe: Optional[int] = None, devices=None) -> Mesh:
    """A ("data", "pipe") mesh over the first data * pipe ranks, row-major
    (the reference's parallel/pipeline.py::make_pp_mesh). Default: every
    rank on the pipe axis."""
    ranks = _rank_list(devices)
    n = len(ranks)
    if pipe is None:
        pipe = n // data
    if data * pipe > n:
        raise InvalidConfigurationError(f"mesh {data}x{pipe} needs {data * pipe} devices, have {n}")
    return Mesh(np.asarray(ranks[:data * pipe]).reshape(data, pipe), ("data", "pipe"))


def _group_by_slice(ranks: list, slices: Optional[int]) -> list:
    """-> the per-slice rank lists, contiguous within each. Without
    `slices` every rank is one slice (the port knows no slice topology)."""
    if slices is None:
        return [list(ranks)]
    n = len(ranks)
    if n % slices:
        raise InvalidConfigurationError(f"{n} devices do not split into {slices} equal slices")
    per = n // slices
    return [list(ranks[i * per:(i + 1) * per]) for i in range(slices)]


def make_hybrid_mesh(data: int = 1, model: Optional[int] = None,
                     axis_names: Sequence[str] = ("data", "model"),
                     devices=None, slices: Optional[int] = None) -> Mesh:
    """(data, model) mesh with the model axis inside one slice.

    data must be a multiple of the slice count: each slice contributes
    data/slices rows of `model` ranks, rows ordered slice-major, so only the
    data axis's outer stride crosses slices. With one slice this is
    `make_mesh`'s layout. axis_names=("data", "pipe") names the
    pipeline-parallel variant's axes (`--mesh-pp`, `parallel.pipeline`)."""
    groups = _group_by_slice(_rank_list(devices), slices)
    n_slice = len(groups)
    per_slice = len(groups[0])
    if any(len(g) != per_slice for g in groups):
        raise InvalidConfigurationError(
            f"slices contribute unequal device counts: {[len(g) for g in groups]}")
    n = n_slice * per_slice
    if model is None:
        model = n // data
    if data * model > n:
        raise InvalidConfigurationError(
            f"mesh {data}x{model} needs {data * model} devices, "
            f"have {n} across {n_slice} slice(s)")
    if data * model < n:
        if (data * model) % n_slice:
            raise InvalidConfigurationError(
                f"mesh {data}x{model} does not trim evenly over {n_slice} slices")
        per_slice = data * model // n_slice
        groups = [g[:per_slice] for g in groups]
    if data % n_slice:
        raise InvalidConfigurationError(
            f"data axis {data} must be a multiple of the slice count "
            f"{n_slice} (the model axis may not cross DCN)")
    if model > per_slice:
        raise InvalidConfigurationError(
            f"model axis {model} exceeds one slice's {per_slice} devices — "
            "it would cross DCN; shard data or pipe across slices instead")
    rows_per_slice = data // n_slice
    arr = np.empty((data, model), dtype=np.int64)
    for s, g in enumerate(groups):
        arr[s * rows_per_slice:(s + 1) * rows_per_slice] = np.asarray(g).reshape(
            rows_per_slice, model)
    return Mesh(arr, axis_names)

