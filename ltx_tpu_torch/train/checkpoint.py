"""Training checkpoints: the trainable leaves, the optimizer state, the step.

Port of ltx_tpu/train/checkpoint.py. One .npz, written atomically (a
pid-unique temporary file, then os.replace). Every array is stored under the
reference's key path (`jax.tree_util.keystr` behind the prefix "t" or "o"),
with its stacked shape, so that a checkpoint written by either package
resumes in the other, optimizer moments and all:

    "t['blocks']['attn1']['to_q']['lora_a']"   (L, in, r), the L blocks stacked

(a Linear's "weight" is the reference's "w", transposed to (in, out); a
1-D "bias" is its "b"). The optimizer state sits where optax's tree puts it
(`optimizer_keys`): the reference's chain of clip_by_global_norm and adamw,
inside MultiSteps when gradients accumulate. Restore follows a template (the
live state) and raises KeyError on a missing key and ValueError on a shape
that differs.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_BLOCK = re.compile(r"^blocks\.(\d+)\.(.+)$")


def reference_key(name: str, ndim: int) -> Tuple[str, Optional[int], bool]:
    """A DiT parameter name -> (the reference's key path, its block index
    or None, whether the layout transposes)."""
    layer = None
    match = _BLOCK.match(name)
    if match:
        layer, name = int(match.group(1)), "blocks." + match.group(2)
    parts = name.split(".")
    transpose = False
    if parts[-1] == "weight":
        parts[-1], transpose = "w", ndim == 2
    elif parts[-1] == "bias" and ndim == 1:
        parts[-1] = "b"
    return "".join(f"['{p}']" for p in parts), layer, transpose


def _host(t: torch.Tensor, transpose: bool) -> np.ndarray:
    t = t.detach()
    if transpose:
        t = t.t()
    return t.float().cpu().numpy() if t.dtype == torch.bfloat16 else t.cpu().numpy()


def flatten_params(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, np.ndarray]:
    """{name: tensor} -> {prefix + reference key: array}, the blocks' leaves
    stacked in block order."""
    out, stacks = {}, {}
    for name, t in params.items():
        key, layer, transpose = reference_key(name, t.ndim)
        if layer is None:
            out[prefix + key] = _host(t, transpose)
        else:
            stacks.setdefault(prefix + key, {})[layer] = _host(t, transpose)
    for key, layers in stacks.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"{key}: blocks {sorted(layers)} are not 0..L-1")
        out[key] = np.stack([layers[i] for i in range(len(layers))])
    return out


@torch.no_grad()
def restore_params(params: Dict[str, torch.Tensor], store: Dict[str, np.ndarray],
                   prefix: str) -> Dict[str, torch.Tensor]:
    """Copy the stored values into the template tensors, in place."""
    for name, t in params.items():
        key, layer, transpose = reference_key(name, t.ndim)
        if prefix + key not in store:
            raise KeyError(f"checkpoint missing {prefix + key!r}: the template does not "
                           "match the saved run (same TrainConfig, rank, targets?)")
        val = store[prefix + key]
        if layer is not None:
            if val.ndim == 0 or layer >= val.shape[0]:
                raise ValueError(f"checkpoint {prefix + key!r} shape {val.shape} has no "
                                 f"block {layer}")
            val = val[layer]
        want = tuple(t.shape[::-1]) if transpose else tuple(t.shape)
        if tuple(val.shape) != want:
            raise ValueError(f"checkpoint {prefix + key!r} shape {val.shape} != template "
                             f"{want}")
        host = torch.from_numpy(np.array(val))  # a copy, 0-d kept 0-d
        t.copy_(host.t() if transpose else host)
    return params


def _adamw_keys(state: dict, prefix: str) -> Dict[str, str]:
    """The reference keys of the adamw chain's state (`train/step.py::_adamw`)
    behind `prefix`: optax's chain(clip_by_global_norm, adamw) has no leaves
    at [0] (clip) and [1][1] (the masked decay); adam is at [1][0], and a
    learning-rate schedule counts at [1][2]."""
    keys = {"count": f"{prefix}[1][0].count", "mu": f"{prefix}[1][0].mu",
            "nu": f"{prefix}[1][0].nu"}
    if "schedule_count" in state:
        keys["schedule_count"] = f"{prefix}[1][2].count"
    return keys


def optimizer_keys(opt_state: dict) -> Dict[tuple, str]:
    """{field path in the port's optimizer state: the reference's key path}
    for `train/step.py::make_optimizer`'s state; a path to a {name: tensor}
    dict maps to the key prefix of its leaves. MultiSteps (accum_steps > 1)
    keeps its counters and mean gradient beside the inner chain's state."""
    if "inner" not in opt_state:
        return {(field,): key for field, key in _adamw_keys(opt_state, "o").items()}
    keys = {("mini_step",): "o.mini_step", ("gradient_step",): "o.gradient_step",
            ("acc_grads",): "o.acc_grads"}
    keys.update({("inner", field): key for field, key in
                 _adamw_keys(opt_state["inner"], "o.inner_opt_state").items()})
    return keys


def _field(state: dict, path: tuple):
    for name in path:
        state = state[name]
    return state


def _flatten_state(opt_state: dict) -> Dict[str, np.ndarray]:
    out = {}
    for path, key in optimizer_keys(opt_state).items():
        value = _field(opt_state, path)
        if isinstance(value, dict):
            out.update(flatten_params(value, key))
        else:
            out[key] = value.detach().cpu().numpy()
    return out


def _restore_state(opt_state: dict, store) -> dict:
    for path, key in optimizer_keys(opt_state).items():
        value = _field(opt_state, path)
        if isinstance(value, dict):
            restore_params(value, store, key)
            continue
        if key not in store:
            raise KeyError(f"checkpoint missing {key!r}: the template does not match the "
                           "saved run (same TrainConfig: accum_steps, warmup?)")
        if tuple(store[key].shape) != tuple(value.shape):
            raise ValueError(f"checkpoint {key!r} shape {store[key].shape} != "
                             f"template {tuple(value.shape)}")
        _field(opt_state, path[:-1])[path[-1]] = torch.as_tensor(
            store[key], dtype=value.dtype).to(value.device)
    return opt_state


def save_train_checkpoint(path, trainable: Dict[str, torch.Tensor], opt_state: dict,
                          step: int) -> int:
    """Write trainable + opt_state + step to `path` (.npz), atomically.
    Returns the number of stored arrays."""
    store = {"__step__": np.asarray(step, np.int64)}
    store.update(flatten_params(trainable, "t"))
    store.update(_flatten_state(opt_state))
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **store)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return len(store)


def load_train_checkpoint(path, trainable: Dict[str, torch.Tensor],
                          opt_state: Optional[dict] = None):
    """-> (trainable, opt_state, step): the stored values copied into the
    templates (trainable in place), from a checkpoint of this package or of
    the reference. With opt_state None only the trainable leaves and the
    step load."""
    with np.load(path) as z:
        store = {k: z[k] for k in z.files}
    step = int(store.pop("__step__"))
    restore_params(trainable, store, "t")
    if opt_state is not None:
        opt_state = _restore_state(opt_state, store)
    return trainable, opt_state, step
