"""GPipe pipeline parallelism over the DiTs' block stacks, on torch.distributed.

Port of ltx_tpu/parallel/pipeline.py. A ("data", "pipe") mesh
(`runtime.make_pp_mesh`): batch rows split over "data" (guidance rows at
inference, sample rows in training) and each of the S "pipe" stages holds
a contiguous L / S of the L blocks. The reference shards its stacked block
axis and scans M + S - 1 ticks inside `shard_map`; here every rank is a
process:

* `shard_pp(module, mesh, n_microbatches)` slices the module's `blocks` in
  place to this stage's blocks (the other stages' are dropped) and marks
  the module with its `PipelinePlan`. Everything outside the blocks
  (patchify, the timestep and caption projections, the cross-modal
  modulation, the output heads) stays whole on every rank:
  `pp_param_specs` is the rule, every leaf under `blocks` is stage-local.
* `LTXTransformer.forward` and `LTXAVTransformer.forward` under a plan
  (the reference's `dit_forward_pp`, `dit_av_forward_pp`): the whole batch
  in, the whole batch out on every rank. Each rank runs the prepare part on
  its data rows (`data_rows`), its blocks through the schedule
  (`run_stage`), the head on the outputs, and gathers the rows over "data"
  (`head_once`).
* `gpipe_schedule`: M microbatches, M + S - 1 ticks; at tick t stage s
  holds microbatch t - s, stage 0 reads the inputs and the others the
  activation that came from stage s - 1 (`collectives.ring_shift` by +1,
  the reference's ppermute i -> i + 1 mod S). Host
  control flow lets a stage skip its blocks on the ticks where it holds no
  microbatch (the reference computes on garbage there and masks it out);
  every rank still joins every tick's hop, so that sends and receives stay
  matched. The hop after the last tick carries nothing that is read and is
  not made: M + S - 2 hops. The last stage's outputs are broadcast to the
  pipe group (`collectives.broadcast`; the reference sums one nonzero
  term over "pipe").
* Training: while autograd records, the schedule is one autograd
  Function. Its forward keeps each microbatch's graph; its backward runs
  the ticks in reverse, each stage taking the cotangent of its outputs from
  the caller (the last stage) or from stage s + 1 (the hop's adjoint, a
  ring shift by -1), and returns the gradients of the inputs, of the
  per-microbatch inputs and of the stage's parameters. Autograd is not left
  to order the hops: each rank's engine picks its own order, and every
  send must meet its receive. Every rank computes the same loss on the
  same broadcast outputs, so the head's gradient is taken on the last stage
  alone (`head_once`); a whole leaf's gradient is then the sum over the
  pipe group of the stages' parts (`reduce_gradients`), the head's counted
  once, and the global norm counts each stage's blocks once
  (`global_norm`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ltx_tpu_torch.errors import InvalidConfigurationError
from ltx_tpu_torch.parallel import collectives as col
from ltx_tpu_torch.parallel.runtime import Mesh

AXIS = "pipe"


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """The stage a module holds (`shard_pp`)."""

    mesh: Mesh
    stage: int                 # this rank's index on "pipe"
    stages: int                # S
    first: int                 # the whole module's index of this stage's first block
    layers: int                # L, the whole module's blocks
    n_microbatches: Optional[int] = None

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1


def pp_param_specs(module: nn.Module) -> dict:
    """{parameter name: "pipe" for a stage-local leaf (every leaf under
    `blocks`), None for one that stays whole on every rank}: the
    reference's PartitionSpecs P("pipe") and P()."""
    return {n: AXIS if n.startswith("blocks.") else None for n, _ in module.named_parameters()}


def shard_pp(module: nn.Module, mesh: Mesh, n_microbatches: Optional[int] = None) -> nn.Module:
    """Keep this stage's contiguous L / S blocks of a whole video DiT or dual
    DiT in place (the reference's `shard_pp_params`) and mark the module with
    its `PipelinePlan` (`module.pp_plan`); its forward then runs the GPipe
    schedule. n_microbatches: the default microbatch count of its forwards
    (None: one a local row). On a pipe axis of one nothing is sliced.
    Returns `module`."""
    if getattr(module, "tp_mesh", None) is not None:
        raise InvalidConfigurationError("shard() and shard_pp() are mutually exclusive")
    if getattr(module, "pp_plan", None) is not None:
        raise InvalidConfigurationError("the module is split into pipeline stages already")
    layers = len(module.blocks)
    stages = mesh.shape[AXIS]
    if layers % stages:
        raise InvalidConfigurationError(f"num_layers={layers} not divisible by pipe={stages}")
    stage = mesh.index(AXIS)
    per = layers // stages
    del module.blocks[(stage + 1) * per:]  # the same ModuleList, renumbered from 0
    del module.blocks[:stage * per]
    module.pp_plan = PipelinePlan(mesh, stage, stages, stage * per, layers, n_microbatches)
    return module


def check_plan(module: nn.Module, pp_mesh) -> None:
    """A `pp_mesh` argument (the reference's) must be the mesh `shard_pp`
    split `module` over; None asks for nothing (the module's plan, if any,
    decides)."""
    if pp_mesh is None:
        return
    plan = getattr(module, "pp_plan", None)
    if plan is None or plan.mesh is not pp_mesh:
        raise InvalidConfigurationError(
            "pp_mesh is not the mesh the model is split over: call "
            "parallel.pipeline.shard_pp(model, pp_mesh) first")


def data_rows(plan: PipelinePlan, batch: int, n_microbatches: Optional[int]):
    """(rows, M): this data rank's slice of the batch and its microbatch
    count, with the reference's errors."""
    n_data = plan.mesh.shape["data"]
    if batch % n_data:
        raise InvalidConfigurationError(f"batch={batch} not divisible by data={n_data}")
    local = batch // n_data
    n_mb = n_microbatches or plan.n_microbatches or local
    if local % n_mb:
        raise InvalidConfigurationError(
            f"local batch={local} not divisible by microbatches={n_mb}")
    lo = plan.mesh.index("data") * local
    return slice(lo, lo + local), n_mb


def rows_of(bias, rows: slice):
    """A (B or 1, ...) key bias's `rows` (a batch-1 bias broadcasts as it
    is)."""
    return bias if bias is None or bias.shape[0] == 1 else bias[rows]


def _split(a, n_mb: int):
    """(b, ...) -> (M, b / M, ...), microbatch-major."""
    return a.reshape(n_mb, a.shape[0] // n_mb, *a.shape[1:])


def _recording(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


class _Schedule:
    """The ticks of one stage, forward (`run`) and in reverse (`backward`)."""

    def __init__(self, stage_fn, mesh: Mesh, n_mb: int, x_grad, aux_grad):
        self.stage_fn, self.mesh, self.n_mb = stage_fn, mesh, n_mb
        self.stages = mesh.shape[AXIS]
        self.stage = mesh.index(AXIS)
        self.ticks = n_mb + self.stages - 1
        self.x_grad, self.aux_grad = tuple(x_grad), tuple(aux_grad)

    def held(self, t: int) -> Optional[int]:
        """The microbatch this stage holds at tick t, or None."""
        m = t - self.stage
        return m if 0 <= m < self.n_mb else None

    def run(self, xs, aux, keep: Optional[dict]):
        """The forward ticks; the last stage's outputs on every rank. With
        `keep` each microbatch's (input leaves, aux leaves, outputs) are
        recorded there with their graphs."""
        last = self.stages - 1
        buf = tuple(torch.zeros_like(x[0]) for x in xs)
        outs = [None] * self.n_mb
        for t in range(self.ticks):
            m = self.held(t)
            y = buf
            if m is not None:
                x_in = tuple(x[m] for x in xs) if self.stage == 0 else buf
                aux_m = tuple(a[m] for a in aux)
                if keep is None:
                    y = tuple(self.stage_fn(x_in, aux_m, m))
                else:
                    with torch.enable_grad():
                        x_in = tuple(x.detach().requires_grad_(self.stage > 0 or g)
                                     for x, g in zip(x_in, self.x_grad))
                        aux_m = tuple(a.detach().requires_grad_(g)
                                      for a, g in zip(aux_m, self.aux_grad))
                        y = tuple(self.stage_fn(x_in, aux_m, m))
                    keep[m] = (x_in, aux_m, y)
                    y = tuple(v.detach() for v in y)
                if self.stage == last:
                    outs[m] = y
            if t < self.ticks - 1:
                buf = tuple(col.ring_shift(y, self.mesh, AXIS, step=1))
        if self.stage == last:
            got = tuple(torch.stack([o[i] for o in outs]) for i in range(len(xs)))
        else:
            got = tuple(torch.empty_like(x) for x in xs)
        for g in got:
            col.broadcast(g, self.mesh, AXIS, last)
        return got

    def backward(self, keep: dict, xs, aux, params, g_outs):
        """The ticks in reverse: (d xs, d aux, d params), None where a
        tensor needs no gradient. The last stage takes its outputs'
        cotangents from `g_outs`, the others from stage s + 1."""
        last = self.stages - 1
        dxs = [torch.zeros_like(x) if g and self.stage == 0 else None
               for x, g in zip(xs, self.x_grad)]
        daux = [torch.zeros_like(a) if g else None for a, g in zip(aux, self.aux_grad)]
        dparams = [None] * len(params)
        send = gbuf = tuple(torch.zeros_like(x[0]) for x in xs)
        for t in reversed(range(self.ticks)):
            if t < self.ticks - 1:
                gbuf = tuple(col.ring_shift(send, self.mesh, AXIS, step=-1))
            m = self.held(t)
            send = gbuf
            if m is None:
                continue
            x_in, aux_m, y = keep.pop(m)
            g = tuple(go[m] for go in g_outs) if self.stage == last else gbuf
            pairs = [(v, gv) for v, gv in zip(y, g) if v.requires_grad]
            wrt = [v for v in x_in + aux_m if v.requires_grad] + list(params)
            grads = list(torch.autograd.grad([v for v, _ in pairs], wrt, [gv for _, gv in pairs],
                                             allow_unused=True))
            dx = [grads.pop(0) if v.requires_grad else None for v in x_in]
            da = [grads.pop(0) if v.requires_grad else None for v in aux_m]
            for i, gp in enumerate(grads):
                if gp is not None:
                    dparams[i] = gp if dparams[i] is None else dparams[i] + gp
            for i, gv in enumerate(da):
                if gv is not None:
                    daux[i][m] = gv
            if self.stage == 0:
                for i, gv in enumerate(dx):
                    if gv is not None and dxs[i] is not None:
                        dxs[i][m] = gv
            else:
                send = tuple(torch.zeros_like(v) if gv is None else gv
                             for v, gv in zip(x_in, dx))
        return dxs, daux, dparams


class _GPipeFn(torch.autograd.Function):
    """The schedule as one autograd node (module docstring)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, n_x: int, n_aux: int, *tensors):
        xs, aux = tensors[:n_x], tensors[n_x:n_x + n_aux]
        ctx.sched, ctx.keep = sched, {}
        ctx.xs, ctx.aux, ctx.params = xs, aux, tensors[n_x + n_aux:]
        return sched.run(xs, aux, ctx.keep)

    @staticmethod
    def backward(ctx, *g_outs):
        dxs, daux, dparams = ctx.sched.backward(ctx.keep, ctx.xs, ctx.aux, ctx.params, g_outs)
        ctx.keep = ctx.xs = ctx.aux = ctx.params = None
        return (None, None, None, *dxs, *daux, *dparams)


def gpipe_schedule(stage_fn, xs, aux, n_mb: int, mesh: Mesh, params=()):
    """The GPipe tick loop over tuples of tensors (module docstring).

    stage_fn(x, aux_m, m) -> y: this stage's blocks on microbatch m; x and y
    tuples of tensors of the same shapes, aux_m the tuple `aux` at m. xs:
    the (M, mb, ...) inputs; aux: (M, ...) per-microbatch inputs; params:
    the tensors stage_fn reads whose gradients are wanted. Returns the last
    stage's (M, mb, ...) outputs on every rank of the pipe group,
    differentiable in xs, aux and params."""
    xs, aux, params = tuple(xs), tuple(aux), tuple(params)
    sched = _Schedule(stage_fn, mesh, n_mb, (x.requires_grad for x in xs),
                      (a.requires_grad for a in aux))
    if _recording(xs + aux + params):
        return _GPipeFn.apply(sched, len(xs), len(aux), *xs, *aux, *params)
    return sched.run(xs, aux, None)


def run_stage(plan: PipelinePlan, blocks, stage_fn, xs, aux, n_mb: int) -> tuple:
    """This stage's `blocks` over the data rows in n_mb microbatches through
    `gpipe_schedule`: xs, the (b, ...) activations that hop between stages;
    aux, the (b, ...) per-row inputs every stage reads; stage_fn(x, aux_m,
    cols) runs the blocks on one microbatch, cols its slice of the data
    rows. Returns the last stage's (b, ...) outputs on every rank of the
    pipe group, differentiable in xs, aux and the blocks' parameters."""
    mb = xs[0].shape[0] // n_mb
    params = tuple(p for block in blocks for p in block.parameters() if p.requires_grad)
    outs = gpipe_schedule(lambda x, aux_m, m: stage_fn(x, aux_m, slice(m * mb, (m + 1) * mb)),
                          tuple(_split(x, n_mb) for x in xs), tuple(_split(a, n_mb) for a in aux),
                          n_mb, plan.mesh, params=params)
    return tuple(o.reshape(o.shape[0] * o.shape[1], *o.shape[2:]) for o in outs)


class _HeadOnce(torch.autograd.Function):
    """Outputs computed outside autograd, tied to the tensors they came from
    with a zero gradient (`head_once`)."""

    @staticmethod
    def forward(ctx, n: int, *tensors):
        ctx.n = n
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors[n:]]
        return tuple(t.detach() for t in tensors[:n])

    @staticmethod
    def backward(ctx, *grads):
        zeros = [torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.like]
        return (None, *[None] * ctx.n, *zeros)


def head_once(plan: PipelinePlan, head, xs: tuple):
    """head(*xs) on every rank, its outputs' rows gathered over "data"; its
    gradient taken on the last stage alone: another stage computes it
    outside autograd and ties it to xs with a zero gradient, so that the
    schedule's backward still runs there (its hops) and the head's part of
    a whole leaf's gradient is counted once."""
    if plan.last or not _recording(xs):
        outs = head(*xs)
    else:
        with torch.no_grad():
            outs = head(*xs)
        outs = _HeadOnce.apply(len(outs), *outs, *xs)
        outs = (outs,) if torch.is_tensor(outs) else outs
    return tuple(col.gather_from(o, plan.mesh, "data", 0) for o in outs)


# ---------------------------------------------------------------------------
# The DiTs under a plan
# ---------------------------------------------------------------------------


def _planned(model: nn.Module) -> None:
    if getattr(model, "pp_plan", None) is None:
        raise InvalidConfigurationError(
            "the model is not split into pipeline stages: call "
            "parallel.pipeline.shard_pp(model, mesh) first")


def dit_forward_pp(model: nn.Module, latent, context, timesteps, rope, context_bias=None,
                   skip_self_attn=None, skip_ff=None, cross_attn_scale=None,
                   n_microbatches: Optional[int] = None, sdpa_impl: str = "auto",
                   remat: bool = False):
    """The reference's dit_forward_pp: `LTXTransformer.forward` of a module
    split by `shard_pp` (module docstring). The STG masks (L, B) and the
    cross-attention scale (a scalar or (L,)) are indexed by the whole
    module's block; remat checkpoints each block inside the stage. Returns
    (B, T, C) on every rank."""
    _planned(model)
    return model(latent, context, timesteps, rope, context_bias, remat=remat,
                 skip_self_attn=skip_self_attn, skip_ff=skip_ff,
                 cross_attn_scale=cross_attn_scale, sdpa_impl=sdpa_impl,
                 pp_microbatches=n_microbatches)


def dit_av_forward_pp(model: nn.Module, video_latent, audio_latent, video_context,
                      audio_context, video_timesteps, audio_timesteps, ropes, video_bias=None,
                      audio_bias=None, n_microbatches: Optional[int] = None,
                      sdpa_impl: str = "auto", remat: bool = False):
    """The reference's dit_av_forward_pp: `LTXAVTransformer.forward` of a
    module split by `shard_pp`, the (video, audio) activation pair hopping
    between stages together. Returns (video (B, Tv, C), audio (B, Ta,
    C_audio)) on every rank."""
    _planned(model)
    return model(video_latent, audio_latent, video_context, audio_context, video_timesteps,
                 audio_timesteps, ropes, video_bias, audio_bias, remat=remat,
                 sdpa_impl=sdpa_impl, pp_microbatches=n_microbatches)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def reduce_gradients(module: nn.Module, grads: dict) -> dict:
    """A pipelined module's gradients ({name: tensor}, this rank's) made the
    reference's, in place: a whole leaf's summed over the pipe group (each
    stage holds its blocks' part of it, the last stage the head's too), then
    every gradient summed over the data group (each data rank holds its
    rows' part of the loss over the whole batch)."""
    mesh = module.pp_plan.mesh
    specs = pp_param_specs(module)
    for n in sorted(grads):
        if specs[n] is None:
            col.all_reduce(grads[n], mesh, AXIS)
    if mesh.shape["data"] > 1:
        for n in sorted(grads):
            col.all_reduce(grads[n], mesh, "data")
    return grads


def global_norm(module: nn.Module):
    """The global norm of a pipelined module's reduced gradients: the
    squares of the stage-local leaves summed over the pipe group, a whole
    leaf's (the same on every stage) counted once."""
    mesh = module.pp_plan.mesh
    specs = pp_param_specs(module)

    def norm(tree: dict) -> torch.Tensor:
        device = next(iter(tree.values())).device
        local = torch.zeros((), device=device)
        whole = torch.zeros((), device=device)
        for n, t in tree.items():
            sq = torch.sum(torch.square(t.float()))
            if specs[n] is None:
                whole = whole + sq
            else:
                local = local + sq
        return torch.sqrt(whole + col.all_reduce(local, mesh, AXIS))

    return norm
