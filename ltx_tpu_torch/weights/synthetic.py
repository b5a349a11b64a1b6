"""A structured synthetic Gemma: the cycle model, for measurable speculation.

Port of ltx_tpu/weights/synthetic.py. Random weights make prompt-lookup
speculation accept nothing (a random stream does not repeat its n-grams),
and real weights are not in the repository. The cycle model is a Gemma of
the real architecture whose greedy and sampled output walks a fixed cycle
of token ids, so the stream repeats itself and the drafts verify:

  * embedding rows: coordinate 0 pinned to `kappa`, the rest standard
    normal, each row scaled to RMS 1; the head is tied as always;
  * every layer zero but layer 0's MLP, a linear map through GELU's
    pass-through: gate row 0 = gamma makes every gate gamma * kappa (large,
    positive), so gelu(gate) * up ~ gamma * kappa * (h @ up); up and down
    carry S = sum_j w_succ(j) u_j^T (the successor map over the cycle's
    rows) plus an entry term that pulls any off-cycle state to cycle[0]
    along the pinned coordinate;
  * layer 0's post-feedforward norm weight margin * sqrt(d) - 1 amplifies
    the successor direction over the residual, so the successor leads the
    logits by a margin; `branch` mixes a second successor (real coin flips,
    partial acceptance), `logit_scale` scales every logit (the final norm).

The port draws its embedding from a torch.Generator on the generator's
device (the full-size table is built on the card), so its values are not
the reference's; the tests convert the reference's parameters for parity
and hold this build to the reference's behavioural checks.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ltx_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model


def default_cycle(cfg: Gemma3Config, period: int = 17) -> Tuple[int, ...]:
    """Cycle token ids: clear of the special ids (0..3) and of each other."""
    lo = 100 if cfg.vocab_size > 100 + period else 4
    return tuple(range(lo, lo + period))


@torch.no_grad()
def make_cycle_gemma_state(cfg: Gemma3Config, gen: torch.Generator, cycle: Sequence[int] = (),
                           margin: float = 24.0, entry_bias: float = 0.5, kappa: float = 4.0,
                           gamma: float = 3.0, branch: float = 0.0, logit_scale: float = 1.0,
                           dtype=torch.float32) -> dict:
    """The cycle model's Gemma3Model state dict (torch layout, `dtype`),
    computed in f32 on the generator's device. margin: the successor's
    amplification in residual-RMS units (the residual is the embedding row
    scaled by sqrt(hidden)); entry_bias: the pull toward cycle[0] from an
    off-cycle state; branch: the weight of a second successor (two steps
    on); logit_scale: the final norm's gain on every logit."""
    d, inter, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nl, hd = cfg.hidden_layers, cfg.head_dim
    cycle = tuple(cycle) or default_cycle(cfg)
    if inter < d:
        raise ValueError("intermediate_size must be >= hidden_size")
    device = gen.device
    f32 = dict(dtype=torch.float32, device=device)

    emb = torch.randn(v, d, generator=gen, **f32)
    emb[:, 0] = kappa
    emb /= torch.sqrt(torch.mean(emb * emb, dim=1, keepdim=True))

    cyc = torch.tensor(cycle, dtype=torch.long, device=device)
    succ = torch.roll(cyc, -1)
    # the match directions leave out the pinned coordinate, which every
    # state shares
    u = emb[cyc].clone()
    u[:, 0] = 0.0
    u /= torch.linalg.norm(u, dim=1, keepdim=True)
    w = emb[succ] / torch.linalg.norm(emb[succ], dim=1, keepdim=True)
    if branch > 0.0:
        w2 = emb[torch.roll(cyc, -2)]
        w = w + branch * (w2 / torch.linalg.norm(w2, dim=1, keepdim=True))
    s_map = u.t() @ w  # (d, d): unit cycle row u_i -> successor w_i
    s_map[0] += (entry_bias * math.sqrt(d) / kappa) * w[0]

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    state = {"embed_tokens.weight": emb.to(dtype),
             "norm.weight": torch.full((d,), logit_scale - 1.0, dtype=dtype, device=device)}
    for i in range(nl):
        p = f"layers.{i}."
        state.update({p + "q_proj.weight": zeros(cfg.attention_heads * hd, d),
                      p + "k_proj.weight": zeros(cfg.kv_heads * hd, d),
                      p + "v_proj.weight": zeros(cfg.kv_heads * hd, d),
                      p + "o_proj.weight": zeros(d, cfg.attention_heads * hd),
                      p + "q_norm.weight": zeros(hd), p + "k_norm.weight": zeros(hd)})
        for name in ("input_layernorm", "post_attention_layernorm",
                     "pre_feedforward_layernorm", "post_feedforward_layernorm"):
            state[p + name + ".weight"] = zeros(d)
        for name, shape in (("gate_proj", (inter, d)), ("up_proj", (inter, d)),
                            ("down_proj", (d, inter))):
            state[p + name + ".weight"] = zeros(*shape)
    # layer 0's MLP (torch's (out, in) weights): every gate gamma * h[0]; up
    # carries S into the first d channels; down reads them back over
    # gamma * kappa
    state["layers.0.gate_proj.weight"][:, 0] = gamma
    state["layers.0.up_proj.weight"][:d] = s_map.t().to(dtype)
    state["layers.0.down_proj.weight"][:, :d] = (torch.eye(d, **f32) / (gamma * kappa)).to(dtype)
    state["layers.0.post_feedforward_layernorm.weight"].fill_(margin * math.sqrt(d) - 1.0)
    return state


def make_cycle_gemma(cfg: Gemma3Config, gen: torch.Generator, **kw) -> Gemma3Model:
    """The cycle model (`make_cycle_gemma_state`'s keywords) as a
    Gemma3Model on the generator's device."""
    return Gemma3Model.from_state_dict(cfg, make_cycle_gemma_state(cfg, gen, **kw))
