"""The yardstick: the chip's peaks, the least time of a piece of work, and
the operations and bytes of one clip counted from the model's shapes.

Peaks: one NVIDIA H100 SXM, dense bf16 tensor cores and HBM3, at the full
700 W. A least time is the larger of operations over the peak rate and
bytes over the memory rate, each input read once and each output written
once. A clip's work is counted per guidance row from the configuration and
the traffic's shapes: the DiT's block linears (2 M N K each) and attentions
(4 Tq Tk D per head), and every attention and RMSNorm of the DiT and the
connectors as the pipeline calls them. Norms and elementwise work count in
no FLOP total.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16 = 2  # bytes
F32 = 4


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def linear_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def attention_flops(heads: int, tq: int, tk: int, d: int, batch: int = 1) -> float:
    """QK^T and PV: 4 Tq Tk D a head."""
    return 4.0 * batch * heads * tq * tk * d


def attention_bytes(heads: int, tq: int, tk: int, d: int, bias: bool, batch: int = 1) -> float:
    """q, k, v read and the output written once in bf16, an f32 key bias read."""
    return BF16 * batch * heads * d * (2 * tq + 2 * tk) + (F32 * batch * tk if bias else 0)


def _video_block(t: dict, tv: int, s: int):
    """(flops, attentions, norms) of one video DiT block on tv tokens and s
    text tokens; an attention is (heads, tq, tk, d, bias), a norm (rows, d,
    weighted)."""
    d, h, hd, ff = t["inner_dim"], t["num_heads"], t["head_dim"], t["ffn_dim"]
    flops = (4 * linear_flops(tv, d, d)                    # self q, k, v, out
             + 2 * linear_flops(tv, d, d)                  # cross q, out
             + 2 * linear_flops(s, t["cross_attention_dim"], d)  # cross k, v
             + linear_flops(tv, d, ff) + linear_flops(tv, ff, d)
             + attention_flops(h, tv, tv, hd) + attention_flops(h, tv, s, hd))
    attns = [(h, tv, tv, hd, False), (h, tv, s, hd, True)]
    norms = [(tv, d, False)] * 2 + [(tv, d, True)] * 3 + [(s, d, True)]
    return flops, attns, norms


def _av_block(t: dict, tv: int, ta: int, s: int):
    """(flops, attentions, norms) of one dual block: the video stream's
    phases with weighted norms, the audio stream's, A2V and V2A."""
    flops, attns, _ = _video_block(t, tv, s)
    dv, da = t["inner_dim"], t["audio_inner_dim"]
    ha, hda = t["audio_num_heads"], t["audio_head_dim"]
    flops += (4 * linear_flops(ta, da, da)                 # audio self
              + 2 * linear_flops(ta, da, da) + 2 * linear_flops(s, da, da)  # audio text
              + linear_flops(ta, da, 4 * da) + linear_flops(ta, 4 * da, da)
              + linear_flops(tv, dv, da) + 2 * linear_flops(ta, da, da)
              + linear_flops(tv, da, dv)                   # A2V q, k, v, out
              + linear_flops(ta, da, da) + 2 * linear_flops(tv, dv, da)
              + linear_flops(ta, da, da)                   # V2A q, k, v, out
              + attention_flops(ha, ta, ta, hda) + attention_flops(ha, ta, s, hda)
              + attention_flops(ha, tv, ta, hda) + attention_flops(ha, ta, tv, hda))
    attns = attns + [(ha, ta, ta, hda, False), (ha, ta, s, hda, True),
                     (ha, tv, ta, hda, False), (ha, ta, tv, hda, False)]
    norms = ([(tv, dv, True)] * 3 + [(s, dv, True)]                 # norm1, attn1 q k, attn2 k
             + [(tv, dv, True)] * 2                                 # norm2, attn2 q
             + [(tv, dv, True)] * 2                                 # a2v norm, norm3
             + [(ta, da, True)] * 3 + [(s, da, True)]               # audio norm1, attn1 q k, attn2 k
             + [(ta, da, True)] * 2                                 # audio norm2, attn2 q
             + [(ta, da, True)] * 2                                 # v2a norm, audio norm3
             + [(tv, da, True), (ta, da, True)]                     # A2V q, k
             + [(ta, da, True), (tv, da, True)])                    # V2A q, k
    return flops, attns, norms


def _connector(te: dict, s: int):
    """(attentions, norms) of one connector's pass over s text rows."""
    d = te["connector_heads"] * te["connector_head_dim"]
    layers = te["connector_layers"]
    attns = [(te["connector_heads"], s, s, te["connector_head_dim"], False)] * layers
    norms = [(s, d, False), (s, d, True), (s, d, True), (s, d, False)] * layers + [(s, d, False)]
    return attns, norms


def work(dit_step_flops: float, steps: int, attentions: list, norms: list,
         rope_tables: int) -> dict:
    """A clip's counted work from its pieces: `dit_step_flops`, `steps`,
    `denoise_flops` (the DiT's FLOPs over all the clip's steps), the number
    of `attentions` and `norms` (every flash-attention and RMSNorm call of
    the clip, as the pipeline makes them), `attention_seconds` (the least
    times of the attentions summed) and `rope_tables`, the RoPE tables its
    denoise loops build."""
    return {
        "dit_step_flops": dit_step_flops,
        "steps": steps,
        "denoise_flops": dit_step_flops * steps,
        "attentions": len(attentions),
        "norms": len(norms),
        "attention_seconds": sum(least_seconds(attention_flops(h, q, k, d),
                                               attention_bytes(h, q, k, d, b))
                                 for h, q, k, d, b in attentions),
        "rope_tables": rope_tables,
    }


def clip_work(config: dict, traffic) -> dict:
    """One clip's counted work (`work`), as the pipeline of `config` counts
    it in its own file (benchmark.paths)."""
    from benchmark import paths

    return paths.program_side(config).clip_work(config, traffic)
