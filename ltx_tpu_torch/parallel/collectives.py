"""The collectives of tensor and sequence parallelism, counted.

Each function takes a `Mesh` and an axis name and runs over this rank's
process group along that axis; on an axis of size 1 it is the identity and
runs nothing. Every call counts in `counts` (set to 0 with `reset_counts`,
run, read), by operation:

* "all_reduce": a sum over the group (`all_reduce`);
* "all_reduce_max": an elementwise max (`all_reduce_max`: the W8A8
  activation scale of a row-parallel linear);
* "all_gather": the group's tensors concatenated along a dim (`all_gather`);
* "send_recv": one ring hop, a send to the next rank and a receive from the
  previous (`ring_shift`; a pipeline stage's hop is one, by +1, and its
  adjoint in the backward one by -1);
* "broadcast": one rank's tensor copied to every rank of the group
  (`broadcast`: the last pipeline stage's outputs);
* "host_staged": the calls above that went through host memory.

Two ranks that share one card run over gloo, which moves every CUDA tensor
through host memory. It takes CUDA tensors for an all-reduce and copies
them to the host and back itself; it does not take them for an all-gather,
a broadcast or a point-to-point transfer, so those calls copy the tensor to
pinned host memory here, run there and copy back. Every such call counts in
"host_staged" as well: named and counted, never silent.

The autograd functions carry the collectives' adjoints: `reduce_from`
(all-reduce forward, identity backward: a row-parallel output that every
rank then uses alike), `copy_to` (identity forward, all-reduce backward: the
replicated input of column-parallel linears), `reduce_both` (all-reduce
both ways: a statistic every rank uses on its own shard, the flat QK norm's
sum of squares), `gather_from` (all-gather forward, "take my chunk"
backward) and `scatter_to` (take my chunk forward, all-gather backward).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

counts = {"all_reduce": 0, "all_reduce_max": 0, "all_gather": 0, "send_recv": 0,
          "broadcast": 0, "host_staged": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group: the call goes through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce(t: torch.Tensor, mesh, axis: str, op=None) -> torch.Tensor:
    """The sum (or `op`) of `t` over the group, in place; returns `t`."""
    group = mesh.group(axis)
    if group is None:
        return t
    op = dist.ReduceOp.SUM if op is None else op
    counts["all_reduce" if op == dist.ReduceOp.SUM else "all_reduce_max"] += 1
    if _staged(t, group):  # gloo copies it through the host itself
        counts["host_staged"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_max(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise max of `t` over the group, in place; returns `t`."""
    return all_reduce(t, mesh, axis, dist.ReduceOp.MAX)


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The group's tensors (all of t's shape) concatenated along `dim`, in
    axis order."""
    group = mesh.group(axis)
    if group is None:
        return t
    counts["all_gather"] += 1
    n = mesh.shape[axis]
    src = t.contiguous()
    if _staged(src, group):
        counts["host_staged"] += 1
        host = _to_host(src)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(t.device)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def ring_shift(tensors, mesh, axis: str, step: int = 1) -> list:
    """Each tensor sent to the rank `step` places further along the ring and
    replaced by the one that arrives from `step` places back: one hop of
    the ring (the reference's ppermute with perm i -> i + step). One
    "send_recv" count per hop, whatever the number of tensors."""
    group = mesh.group(axis)
    if group is None:
        return list(tensors)
    counts["send_recv"] += 1
    ranks = mesh.axis_ranks(axis)
    me = ranks.index(dist.get_rank())
    n = len(ranks)
    dst, src = ranks[(me + step) % n], ranks[(me - step) % n]
    out, ops, keep = [], [], []
    for t in tensors:
        send = t.contiguous()
        staged = _staged(send, group)
        if staged:
            counts["host_staged"] += 1
            send = _to_host(send)
        recv = torch.empty_like(send)
        keep.append(send)
        ops.append(dist.isend(send, dst, group=group))
        ops.append(dist.irecv(recv, src, group=group))
        out.append((recv, staged, t.device))
    for w in ops:
        w.wait()
    return [r.to(device, non_blocking=False) if staged else r for r, staged, device in out]


def broadcast(t: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """The tensor of the rank at index `src` along `axis`, written into `t`
    on every rank of the group (all of t's shape and dtype); returns `t`.
    The bytes travel, whatever the dtype."""
    group = mesh.group(axis)
    if group is None:
        return t
    counts["broadcast"] += 1
    root = mesh.axis_ranks(axis)[src]
    if _staged(t, group):
        counts["host_staged"] += 1
        host = _to_host(t)
        dist.broadcast(host.reshape(-1).view(torch.uint8), root, group=group)
        t.copy_(host)
        return t
    buf = t if t.is_contiguous() else t.contiguous()
    dist.broadcast(buf.reshape(-1).view(torch.uint8), root, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


def chunk_of(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's equal chunk of `t` along `dim` (a view)."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axis) * size, size)


# ---------------------------------------------------------------------------
# Adjoints
# ---------------------------------------------------------------------------


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axis), None, None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axis), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return chunk_of(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return chunk_of(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def _records(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce_from(x, mesh, axis: str = "model"):
    """Sum over the group; the gradient passes through unchanged."""
    if mesh.shape[axis] == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis) if _records(x) else all_reduce(x, mesh, axis)


def copy_to(x, mesh, axis: str = "model"):
    """x unchanged; its gradient summed over the group."""
    if mesh.shape[axis] == 1 or not _records(x):
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_both(x, mesh, axis: str = "model"):
    """Sum over the group; the gradient summed over the group too."""
    if mesh.shape[axis] == 1:
        return x
    return _ReduceBoth.apply(x, mesh, axis) if _records(x) else all_reduce(x, mesh, axis)


def gather_from(x, mesh, axis: str, dim: int):
    """The group's chunks concatenated along `dim`; the gradient's own chunk
    flows back."""
    if mesh.shape[axis] == 1:
        return x
    return _GatherFrom.apply(x, mesh, axis, dim) if _records(x) \
        else all_gather(x, mesh, axis, dim)


def scatter_to(x, mesh, axis: str, dim: int):
    """This rank's chunk along `dim` of a replicated tensor; the gradient
    gathered back whole."""
    if mesh.shape[axis] == 1:
        return x
    return _ScatterTo.apply(x, mesh, axis, dim) if _records(x) \
        else chunk_of(x, mesh, axis, dim)
