"""Sequence-parallel ring attention, forward and backward.

Port of ltx_tpu/parallel/ring_attention.py. The token axis of a
self-attention shards over a mesh axis of n ranks; K and V (with their key
bias) travel around the ring, one hop a step, and each rank merges the
partial attention of its query shard against every visiting block with the
flash-style running statistics (m, l, acc) in f32, exactly as the
reference's `_ring_forward`:

    m' = max(m, m_i), l' = l e^(m - m') + l_i e^(m_i - m'),
    acc' = acc e^(m - m') + (out_i l_i) e^(m_i - m'),  out = acc / l.

A step's partial attention is the statistics forward, B2
(`kernels.flash_attention.flash_attention_stats`: the kernel on the card,
its plain version on the CPU), which returns the normalised output and its
(m, l); out_i * l_i un-normalises it.

The backward rings the flash backward, B3a and B3b: every (query shard,
key block) pair is visited once as the blocks make a second loop, with the
GLOBAL lse = m + log(l) of the forward and delta = rowsum(dO * O), so each
visit's probabilities are the true ones and the partial dQ, dK, dV sum to
the exact gradients. dQ accumulates at home; the dK / dV accumulators travel
with their block and are home after n hops. The key bias gets no gradient.

`sequence_parallel_sdpa` takes and returns whole (replicated) tensors, as
the reference's shard_map wrapper does: each rank takes its token chunk
(its gradient gathered back whole) and the output chunks are gathered (the
gradient's own chunk flows back, not a sum over the ring).
"""

from __future__ import annotations

from typing import Optional

import torch

from ltx_tpu_torch.kernels import flash_attention as fa
from ltx_tpu_torch.parallel import collectives as col


def _partial_attn(q, k_blk, v_blk, bias_blk, scale: float):
    """One ring step's partial attention -> (m, l, out * l) in f32."""
    out, m, l = fa.flash_attention_stats(q, k_blk, v_blk, bias_blk, scale)
    return m, l, out.float() * l[..., None]


def _ring_forward(q, k, v, bias, mesh, axis: str, scale: float):
    """-> (out in q's dtype, m, l): the merged output and its statistics."""
    n = mesh.shape[axis]
    b, h, tq, d = q.shape
    m = torch.full((b, h, tq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    blk = [k, v] + ([bias] if bias is not None else [])
    for i in range(n):
        m_cur, l_cur, pv = _partial_attn(q, blk[0], blk[1], blk[2] if bias is not None
                                         else None, scale)
        m_new = torch.maximum(m, m_cur)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_cur - m_new)
        l = l * alpha + l_cur * beta
        acc = acc * alpha[..., None] + pv * beta[..., None]
        m = m_new
        if i + 1 < n:  # the reference's last rotation only brings the blocks home
            blk = col.ring_shift(blk, mesh, axis)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / safe_l[..., None]).to(q.dtype), m, l


def _visit_backward(q, k_blk, v_blk, bias_blk, o, lse, delta, do, scale: float):
    """(dQ_i, dK_i, dV_i) of one (query shard, key block) visit at the
    global lse and delta: the dq and dkv kernels on the card, the plain
    backward on the CPU (which forms the same delta from o and do)."""
    if q.device.type == "cpu":
        return fa.flash_attention_backward_reference(q, k_blk, v_blk, bias_blk, o, lse, do,
                                                     scale)
    dq = fa.flash_attention_bwd_dq(q, k_blk, v_blk, bias_blk, do, lse, delta, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k_blk, v_blk, bias_blk, do, lse, delta, scale)
    return dq, dk, dv


class _RingAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mesh, axis, scale):
        out, m, l = _ring_forward(q, k, v, bias, mesh, axis, scale)
        ctx.save_for_backward(q, k, v, bias, out, fa.softmax_lse(m, l).contiguous())
        ctx.mesh, ctx.axis, ctx.scale = mesh, axis, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        mesh, axis, scale = ctx.mesh, ctx.axis, ctx.scale
        n = mesh.shape[axis]
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        blk = [k.contiguous(), v.contiguous()] + ([bias] if bias is not None else [])
        for _ in range(n):
            dq_i, dk_i, dv_i = _visit_backward(q, blk[0], blk[1],
                                               blk[2] if bias is not None else None,
                                               o, lse, delta, do, scale)
            dq += dq_i.float()
            dk_acc += dk_i.float()
            dv_acc += dv_i.float()
            # after n hops every block and its accumulators are home
            moved = col.ring_shift(blk + [dk_acc, dv_acc], mesh, axis)
            blk, dk_acc, dv_acc = moved[:len(blk)], moved[-2], moved[-1]
        return (dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype), None, None, None,
                None)


def ring_attention(q, k, v, mesh, axis: str = "model", bias=None,
                   scale: Optional[float] = None):
    """Full (non-causal) attention of sequence-sharded q, k, v.

    q: (B, H, Tq_local, D); k, v: (B, H, Tk_local, D): this rank's shards;
    bias: None or this rank's (B, Tk_local) additive key bias (it rotates
    with k and v). Returns (B, H, Tq_local, D) in q's dtype, differentiable
    in q, k and v (the ring of the flash backward, module docstring)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is not None:
        bias = bias.float().contiguous()
    return _RingAttentionFn.apply(q, k, v, bias, mesh, axis, float(scale))


def sequence_parallel_sdpa(q, k, v, mesh, bias=None, scale: Optional[float] = None,
                           seq_axis: str = "model"):
    """Ring attention of whole (B, H, T, D) q, k, v that every rank of the
    mesh's `seq_axis` holds alike: each rank takes its T / n token chunk,
    runs the ring and gathers the output chunks. bias: None or a (B, T)
    additive key bias. T must divide the ring (`ops.attention.sdpa` pads
    sequences that do not). Differentiable end to end."""
    def chunk(t, dim):
        return col.scatter_to(t, mesh, seq_axis, dim)

    key_bias = None if bias is None else col.chunk_of(bias.float(), mesh, seq_axis, 1)
    out = ring_attention(chunk(q, 2), chunk(k, 2), chunk(v, 2), mesh, seq_axis,
                         bias=key_bias, scale=scale)
    return col.gather_from(out, mesh, seq_axis, 2)
