"""Weights drawn from the seed on the device, in a few large calls.

The inventory (component, parameter name, shape, dtype) comes from the
modules as built on the "meta" device. Each dtype's parameters share one
flat buffer, filled with standard normal draws from one seeded generator in
chunks of `CHUNK` elements; each parameter is then a view of its buffer,
scaled in place by its configuration's init rule: the first rule whose
`match` (a regular expression) matches "component.name" gives `mean` and
`std`, the std times fan_in**-0.5 when `fan_in` lists the dimensions whose
product is the fan-in ("rest": every dimension after the first). Both the
program and the reference receive these same tensors.
"""

from __future__ import annotations

import math
import re

import torch

from benchmark.seeds import derive

CHUNK = 1 << 30  # elements drawn per call
ALIGN = 128  # every parameter starts on a multiple of this many elements


def inventory(modules: dict) -> list:
    """[(component, name, shape, dtype)] of every parameter of `modules`."""
    return [(comp, name, tuple(p.shape), p.dtype)
            for comp, module in modules.items() for name, p in module.named_parameters()]


def rule_for(rules: list, key: str, shape: tuple):
    """(mean, std) of the parameter `key` of `shape` under `rules`."""
    for rule in rules:
        if re.search(rule["match"], key):
            std = rule["std"]
            dims = rule.get("fan_in")
            if dims == "rest":
                dims = range(1, len(shape))
            if dims:
                std *= math.prod(shape[d] for d in dims) ** -0.5
            return rule["mean"], std
    raise ValueError(f"no init rule matches {key} {shape}")


@torch.no_grad()
def draw(items: list, rules: list, seed: int, device) -> dict:
    """{component: {name: tensor}} for the inventory `items`."""
    out = {comp: {} for comp, *_ in items}
    by_dtype = {}
    for item in items:
        by_dtype.setdefault(item[3], []).append(item)
    for dtype, group in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        offsets, total = [], 0
        for _, _, shape, _ in group:
            offsets.append(total)
            total += -(-math.prod(shape) // ALIGN) * ALIGN
        flat = torch.empty(total, dtype=dtype, device=device)
        gen = torch.Generator(device=device).manual_seed(derive(seed, "weights", str(dtype)))
        for start in range(0, total, CHUNK):
            flat[start:start + CHUNK].normal_(generator=gen)
        for (comp, name, shape, _), off in zip(group, offsets):
            view = flat[off:off + math.prod(shape)].view(shape)
            mean, std = rule_for(rules, f"{comp}.{name}", shape)
            view.mul_(std)
            if mean:
                view.add_(mean)
            out[comp][name] = view
    return out


def assign(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    """Make `state`'s tensors the parameters of `module` (built on "meta"):
    every parameter once, each of its shape and dtype."""
    params = dict(module.named_parameters())
    if set(params) != set(state):
        raise ValueError(f"weights do not fit {type(module).__name__}: missing "
                         f"{sorted(set(params) - set(state))[:6]}, unknown "
                         f"{sorted(set(state) - set(params))[:6]}")
    for name, p in params.items():
        t = state[name]
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: {t.dtype}{tuple(t.shape)} != {p.dtype}{tuple(p.shape)}")
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf,
                torch.nn.Parameter(t, requires_grad=p.requires_grad))
    return module
