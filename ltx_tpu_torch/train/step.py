"""The flow-matching train steps, of the video DiT (`make_train_step`) and
of the dual audio-video DiT (`make_av_train_step`), full fine-tune or
LoRA-only, and their optimizer.

Port of ltx_tpu/train/step.py. The reference's step is a jitted pure
function over parameter trees; here the model is an nn.Module, the trainable
parameters are a {name: Parameter} dict, and the step updates them IN PLACE
(the reference donates the buffers; torch simply writes them). The
optimizer is a plain torch re-statement of the reference's optax chain, so
that its numbers are optax's (held against optax by the CPU tests), with the
same functional shape: `init(params) -> state`, `update(grads, state,
params) -> (updates, state)`:

  * `clip_by_global_norm(grad_clip)`: scale by max / norm only when
    norm >= max, no epsilon;
  * `adamw`: bias-corrected moments, eps outside the square root, weight
    decay masked to the leaves whose REFERENCE shape has ndim >= 2 (a
    block's leaves gain the stacked layer axis there), scaled by -lr;
  * a linear warmup from 0 at count 0 over `warmup_steps`, then constant;
  * `MultiSteps(accum_steps)`: the running mean of k gradients, zero
    updates in between, the inner optimizer stepped with the mean.

On a model sharded over a (data, model) mesh (`parallel.sharding.
shard_transformer`: dp+tp under the inference rules) the step keeps the
reference's arithmetic: the whole LoRA leaves of sharded linears sum their
partial gradients over the model group, every gradient is averaged over
the data group (each data rank trains on its own rows), the global norm
counts a sharded leaf's squares once per shard and a whole leaf's once, and
the reported loss is the data group's mean. On a model split into pipeline
stages (`parallel.pipeline.shard_pp`) every rank computes the whole batch's
loss; a whole leaf's gradient is summed over the pipe group (the stages'
parts, the head's counted once), every gradient over the data group, and
the global norm counts each stage's blocks once
(`parallel.pipeline.reduce_gradients`, `global_norm`).

State counters are int32 tensors on the host; moments live beside the
parameters. The state mirrors optax's tree, so that a checkpoint holds it
under optax's key paths (`train/checkpoint.py`): adam's count, mu and nu, a
"schedule_count" where the learning rate is a schedule (warmup), and
MultiSteps' counters and accumulated gradients around the inner state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from ltx_tpu_torch.parallel import pipeline as pp
from ltx_tpu_torch.train.flow_match import (
    av_flow_match_loss,
    check_sdpa_impl,
    flow_match_loss,
)
from ltx_tpu_torch.train.lora import lora_param_mask

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters for make_optimizer / make_train_step: the reference's
    fields and defaults, with compute_dtype a torch dtype. sdpa_impl "xla"
    and "pallas" are one function here (the flash kernels on the card, their
    plain versions on the CPU); "ring" is sequence-parallel attention;
    pp_mesh (the mesh `parallel.pipeline.shard_pp` split the model over)
    and pp_microbatches (default the plan's) run the GPipe schedule."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 0
    lora_only: bool = False
    sigma_scheme: str = "logit_normal"
    sdpa_impl: str = "xla"
    remat: bool = True
    remat_segments: int = 0
    compute_dtype: Any = torch.bfloat16
    accum_steps: int = 1
    pp_mesh: Any = None
    pp_microbatches: Optional[int] = None


class GradientTransformation(NamedTuple):
    """optax's (init, update) pair over {name: tensor} dicts."""

    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params], tuple]


def _i32(value: int) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32)


def _f32(value) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (optax.global_norm), f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tree.values()))


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """A parameter's ndim in the reference's tree, where the blocks' leaves
    are stacked over a leading layer axis."""
    return p.ndim + (1 if name.startswith("blocks.") else 0)


def _learning_rate(tc: TrainConfig, count: torch.Tensor) -> torch.Tensor:
    """optax.join_schedules([linear_schedule(0, lr, warmup), constant(lr)])
    at `count` (the updates made so far), f32; the constant without warmup."""
    lr = _f32(tc.learning_rate)
    if tc.warmup_steps <= 0:
        return lr
    steps = _f32(tc.warmup_steps)
    done = torch.clamp(count.float(), 0.0, float(tc.warmup_steps))
    frac = 1 - done / steps
    warm = (0.0 - lr) * frac + lr
    return torch.where(count < tc.warmup_steps, warm, lr)


def _adamw(tc: TrainConfig, norm_fn=global_norm) -> GradientTransformation:
    """clip_by_global_norm then adamw with the warmup schedule; norm_fn
    computes the gradients' global norm."""

    def init(params: Params) -> dict:
        state = {"count": _i32(0),
                 "mu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
                 "nu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}}
        if tc.warmup_steps > 0:
            # optax's scale_by_schedule counts its own updates, in step with adam's
            state["schedule_count"] = _i32(0)
        return state

    def update(grads: Params, state: dict, params: Params):
        g_norm = norm_fn(grads)
        keep = g_norm < tc.grad_clip
        grads = {n: torch.where(keep, g, (g / g_norm) * tc.grad_clip)
                 for n, g in grads.items()}
        count = state["count"] + 1
        device = g_norm.device
        # host scalars, moved once: the bias corrections and -lr(count)
        bc1, bc2, step = (t.to(device) for t in (
            1 - _f32(tc.b1) ** count.float(), 1 - _f32(tc.b2) ** count.float(),
            -_learning_rate(tc, state["count"])))
        mu, nu, updates = {}, {}, {}
        for n, g in grads.items():
            g = g.float()
            mu[n] = (1 - tc.b1) * g + tc.b1 * state["mu"][n]
            nu[n] = (1 - tc.b2) * torch.square(g) + tc.b2 * state["nu"][n]
            u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + tc.eps)
            if tc.weight_decay and reference_ndim(n, params[n]) >= 2:
                u = u + tc.weight_decay * params[n].float()
            updates[n] = u * step
        new = {"count": count, "mu": mu, "nu": nu}
        if "schedule_count" in state:
            new["schedule_count"] = state["schedule_count"] + 1
        return updates, new

    return GradientTransformation(init, update)


def _multi_steps(inner: GradientTransformation, k: int) -> GradientTransformation:
    """optax.MultiSteps(inner, every_k_schedule=k) with the gradient mean."""

    def init(params: Params) -> dict:
        return {"mini_step": _i32(0), "gradient_step": _i32(0),
                "acc_grads": {n: torch.zeros_like(p, dtype=torch.float32)
                              for n, p in params.items()},
                "inner": inner.init(params)}

    def update(grads: Params, state: dict, params: Params):
        n_acc = int(state["mini_step"])
        acc = {n: a + (grads[n].float() - a) / (n_acc + 1)
               for n, a in state["acc_grads"].items()}
        if n_acc < k - 1:
            zeros = {n: torch.zeros_like(a) for n, a in acc.items()}
            return zeros, {**state, "mini_step": _i32(n_acc + 1), "acc_grads": acc}
        updates, inner_state = inner.update(acc, state["inner"], params)
        return updates, {"mini_step": _i32(0),
                         "gradient_step": state["gradient_step"] + 1,
                         "acc_grads": {n: torch.zeros_like(a) for n, a in acc.items()},
                         "inner": inner_state}

    return GradientTransformation(init, update)


def make_optimizer(tc: TrainConfig, norm_fn=global_norm) -> GradientTransformation:
    """The reference's chain; `norm_fn` computes the global norm of the
    gradients (`sharded_global_norm` on a sharded model)."""
    tx = _adamw(tc, norm_fn)
    if tc.accum_steps > 1:
        tx = _multi_steps(tx, tc.accum_steps)
    return tx


def partition_trainable(model: nn.Module, tc: TrainConfig):
    """(trainable, frozen) {name: Parameter} dicts, with requires_grad set
    to match. LoRA-only: the LoRA leaves train, everything else is frozen;
    full fine-tune: every floating parameter trains."""
    mask = lora_param_mask(model)
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        train = mask[name] if tc.lora_only else p.is_floating_point()
        p.requires_grad_(train)
        (trainable if train else frozen)[name] = p
    return trainable, frozen


def combine_params(trainable: Params, frozen: Params) -> Params:
    """Inverse of partition_trainable: one {name: tensor} dict."""
    return {**frozen, **trainable}


def init_train_state(model: nn.Module, tc: TrainConfig,
                     optimizer: Optional[GradientTransformation] = None):
    """-> (trainable, frozen, opt_state)."""
    trainable, frozen = partition_trainable(model, tc)
    tx = optimizer if optimizer is not None else make_optimizer(tc)
    return trainable, frozen, tx.init(trainable)


def _check_parallel(model: nn.Module, tc: TrainConfig) -> None:
    pp.check_plan(model, tc.pp_mesh)
    check_sdpa_impl(tc.sdpa_impl)


def sharded_global_norm(model: nn.Module):
    """The global norm of a model sharded over a mesh: the squares of its
    sharded leaves (`model.tp_dims`) summed over the model group, a whole
    leaf's counted once; a pipelined model's by `parallel.pipeline.
    global_norm`. `global_norm` for a model without a mesh."""
    if getattr(model, "pp_plan", None) is not None:
        return pp.global_norm(model)
    mesh = getattr(model, "tp_mesh", None)
    if mesh is None or not model.tp_dims:
        return global_norm
    from ltx_tpu_torch.parallel import collectives as col

    def norm(tree: Params) -> torch.Tensor:
        device = next(iter(tree.values())).device
        shards = torch.zeros((), device=device)
        whole = torch.zeros((), device=device)
        for n, t in tree.items():
            sq = torch.sum(torch.square(t.float()))
            if n in model.tp_dims:
                shards = shards + sq
            else:
                whole = whole + sq
        return torch.sqrt(whole + col.all_reduce(shards, mesh, "model"))

    return norm


def _reduce_gradients(model: nn.Module, grads: Params) -> Params:
    """On a mesh: partial gradients of whole leaves summed over the model
    group, then every gradient averaged over the data group; a pipelined
    model's by `parallel.pipeline.reduce_gradients`."""
    if getattr(model, "pp_plan", None) is not None:
        return pp.reduce_gradients(model, grads)
    mesh = getattr(model, "tp_mesh", None)
    if mesh is None:
        return grads
    from ltx_tpu_torch.parallel import collectives as col

    for n in sorted(model.tp_partial & set(grads)):
        col.all_reduce(grads[n], mesh, "model")
    d = mesh.shape["data"]
    if d > 1:
        for n in sorted(grads):
            col.all_reduce(grads[n], mesh, "data").div_(d)
    return grads


def _data_mean(model: nn.Module, aux: dict) -> dict:
    """The metrics averaged over the data group (each rank's own rows)."""
    mesh = getattr(model, "tp_mesh", None)
    if mesh is None or mesh.shape["data"] == 1:
        return aux
    from ltx_tpu_torch.parallel import collectives as col

    d = mesh.shape["data"]
    return {k: col.all_reduce(v.float().clone(), mesh, "data") / d for k, v in aux.items()}


def step_gradients(model: nn.Module, trainable: Params, loss) -> Params:
    """The gradients of `loss` in the trainable parameters, zero where one
    is unused, reduced over the model's mesh (`_reduce_gradients`): what
    the step hands its optimizer."""
    names = list(trainable)
    grads = torch.autograd.grad(loss, [trainable[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(trainable[n]) if g is None else g.contiguous()
             for n, g in zip(names, grads)}
    return _reduce_gradients(model, grads)


def _apply_gradients(model: nn.Module, tx: GradientTransformation, trainable: Params,
                     opt_state: dict, loss, aux: dict):
    """The step's gradients (`step_gradients`), the optimizer's update
    written into the parameters in place, and the detached metrics with the
    gradients' global norm."""
    names = list(trainable)
    grads = step_gradients(model, trainable, loss)
    updates, opt_state = tx.update(grads, opt_state, trainable)
    with torch.no_grad():
        for n in names:
            trainable[n].add_(updates[n].to(trainable[n].dtype))
    aux = _data_mean(model, {k: v.detach() for k, v in aux.items()})
    aux["grad_norm"] = sharded_global_norm(model)(grads)
    return trainable, opt_state, aux


def make_train_step(model: nn.Module, tc: TrainConfig,
                    optimizer: Optional[GradientTransformation] = None):
    """Build the step:

        step(trainable, opt_state, tokens, context, rope, sigma, noise,
             context_bias=None) -> (trainable, opt_state, metrics)

    tokens (B, T, C) are clean patchified latents; sigma (B,) and noise
    (B, T, C) the step's draws (the reference draws them from its key).
    The trainable parameters are updated in place and returned; metrics
    hold the loss, the mean sigma and the gradients' global norm, as
    device tensors."""
    _check_parallel(model, tc)
    tx = optimizer if optimizer is not None else make_optimizer(tc, sharded_global_norm(model))

    def step(trainable: Params, opt_state: dict, tokens, context, rope, sigma, noise,
             context_bias=None):
        loss, aux = flow_match_loss(
            model, tokens, context, rope, sigma, noise, context_bias=context_bias,
            sdpa_impl=tc.sdpa_impl, remat=tc.remat, remat_segments=tc.remat_segments,
            compute_dtype=tc.compute_dtype, pp_mesh=tc.pp_mesh,
            pp_microbatches=tc.pp_microbatches)
        return _apply_gradients(model, tx, trainable, opt_state, loss, aux)

    return step


def make_av_train_step(model: nn.Module, tc: TrainConfig,
                       optimizer: Optional[GradientTransformation] = None,
                       audio_loss_weight: float = 1.0):
    """The joint audio-video variant of `make_train_step`, on an
    LTXAVTransformer:

        step(trainable, opt_state, video_tokens, audio_tokens,
             video_context, audio_context, ropes, sigma_v, sigma_a,
             noise_v, noise_a, video_bias=None, audio_bias=None)
          -> (trainable, opt_state, metrics)

    The loss is `av_flow_match_loss` (each stream its own noise level);
    the draws are arguments, taken in the reference's order (video sigma,
    audio sigma, video noise, audio noise). Metrics hold "loss",
    "loss_video", "loss_audio" and "grad_norm"."""
    _check_parallel(model, tc)
    tx = optimizer if optimizer is not None else make_optimizer(tc, sharded_global_norm(model))

    def step(trainable: Params, opt_state: dict, video_tokens, audio_tokens, video_context,
             audio_context, ropes, sigma_v, sigma_a, noise_v, noise_a, video_bias=None,
             audio_bias=None):
        loss, aux = av_flow_match_loss(
            model, video_tokens, audio_tokens, video_context, audio_context, ropes,
            sigma_v, sigma_a, noise_v, noise_a, video_bias=video_bias,
            audio_bias=audio_bias, audio_loss_weight=audio_loss_weight,
            sdpa_impl=tc.sdpa_impl, remat=tc.remat, remat_segments=tc.remat_segments,
            compute_dtype=tc.compute_dtype, pp_mesh=tc.pp_mesh,
            pp_microbatches=tc.pp_microbatches)
        return _apply_gradients(model, tx, trainable, opt_state, loss, aux)

    return step


def ema_init(trainable: Params) -> Params:
    """An f32 copy of the trainable leaves: the EMA state."""
    return {n: p.detach().float().clone() for n, p in trainable.items()}


def make_ema_update(decay: float = 0.999):
    """ema <- decay * ema + (1 - decay) * params; call after each update."""

    @torch.no_grad()
    def update(ema: Params, trainable: Params) -> Params:
        return {n: e * decay + trainable[n].float() * (1.0 - decay) for n, e in ema.items()}

    return update
