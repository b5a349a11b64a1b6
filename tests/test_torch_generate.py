"""Port parity: Gemma's KV-cached generation (ltx_tpu_torch.models.gemma3:
the cache, the sampler, generate_tokens, prompt-lookup speculation, the
batched loop, the int8 cache) and the cycle model
(ltx_tpu_torch.weights.synthetic) against ltx_tpu, on the tiny Gemma.

The port takes its random draws as tensors: the tests hand it the
reference's own Gumbel and uniform numbers, drawn along the reference's
key chain (`JaxDraws`), so sampled decoding is held token for token, not
only greedy. Tolerances: f32 attention outputs and caches 1e-5 relative to
the reference's largest value; `topp_filtered`'s candidate ids equal and
its probabilities within 1e-6; tokens and forward counts equal; the int8
cache within the reference's own 5e-2 of the bf16 cache. C6: a Gemma with
as many key/value heads as query heads (full masks on the plain path).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.kernels.quantization import requant_int8_channel_np
from ltx_tpu.models import gemma3 as jg
from ltx_tpu.weights import synthetic as jsyn
from ltx_tpu_torch import convert
from ltx_tpu_torch.errors import InvalidConfigurationError
from ltx_tpu_torch.models import gemma3 as pg
from ltx_tpu_torch.weights import synthetic as psyn
from torch_parity import assert_rel
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CFG = jg.Gemma3Config().tiny()
PROMPT = np.asarray([5, 9, 11, 5, 9, 11, 5, 9], np.int32)
PROMPTS = [PROMPT, np.asarray([3, 7, 2], np.int32),
           np.asarray([12, 1, 4, 6, 2, 8, 10, 13, 3, 5], np.int32)]
GREEDY = dict(temperature=0.0, stop_tokens=(), bucket=8)
CYCLE = jsyn.default_cycle(CFG, period=11)
CYCLE_PROMPT = np.asarray((5, 7, 9) + CYCLE + CYCLE[:4], np.int32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


class JaxDraws:
    """The reference's draws for `key`, in the order the port's loops take
    them. Solo (`generate_tokens`): a sampled token splits the key and uses
    the sub-key's Gumbel noise; a verify bundle splits it into spec_k + 2
    (the next key, the bonus token's, one per draft: its uniform and its
    residual's Gumbel noise from a split). Batched: each of those keys is
    split once more into one key per row."""

    def __init__(self, key, batched: bool = False):
        self.key, self.batched = key, batched

    def _rows(self, key, rows):
        return list(jax.random.split(key, rows)) if self.batched else [key]

    def token(self, rows, top_k):
        self.key, sub = jax.random.split(self.key)
        return torch.stack([_t(jax.random.gumbel(k, (top_k,))) for k in self._rows(sub, rows)])

    def bundle(self, rows, spec_k, top_k):
        keys = jax.random.split(self.key, spec_k + 2)
        self.key = keys[0]
        u, g = [], []
        for kk in keys[2:]:
            pairs = [jax.random.split(k) for k in self._rows(kk, rows)]
            u.append(torch.stack([_t(jax.random.uniform(ku)) for ku, _ in pairs]))
            g.append(torch.stack([_t(jax.random.gumbel(kc, (top_k,))) for _, kc in pairs]))
        bonus = torch.stack([_t(jax.random.gumbel(k, (top_k,)))
                             for k in self._rows(keys[1], rows)])
        return torch.stack(u), torch.stack(g), bonus


def _init(key, cfg=CFG):
    return jax.jit(jg.init_params, static_argnums=(1, 2))(key, cfg, jnp.float32)


def _cycle_params(dtype=jnp.float32):
    """The reference's tiny cycle model (jitted build)."""
    build = jax.jit(jsyn.make_cycle_gemma_params, static_argnums=0,
                    static_argnames=("cycle", "dtype"))
    return build(CFG, jax.random.key(0), cycle=CYCLE, dtype=dtype)


@pytest.fixture(scope="module")
def tiny():
    params = _init(jax.random.key(0))
    return params, convert.gemma(params, CFG)


# ---------------------------------------------------------------------------
# The cache and the cached attention
# ---------------------------------------------------------------------------


def test_quantize_kv_and_cache_init_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row keeps scale 1
    q, s = jg._quantize_kv(jnp.asarray(x))
    pq, ps = pg.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(s))
    # values on the int8 grid survive exactly
    exact = np.asarray([[1.0, -127.0, 64.0, 0.0]], np.float32) / 127.0
    eq, es = pg.quantize_kv(torch.from_numpy(exact))
    np.testing.assert_array_equal(eq.float().numpy() * es.numpy()[..., None], exact)
    for kv_quant in ("bf16", "int8"):
        want = jg._kv_cache_init(kv_quant, (1, 2, 6, 16), jnp.float32)
        got = pg.kv_cache_init(kv_quant, (1, 2, 6, 16), torch.float32, "cpu")
        if kv_quant == "int8":
            assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
            np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
        else:
            assert got.shape == want.shape and not got.any()


@pytest.mark.parametrize("kv_quant", ["bf16", "int8"])
@pytest.mark.parametrize("per_row", [False, True])
def test_cached_attention_matches_reference(tiny, kv_quant, per_row):
    """One layer's attention writing into a cache at a scalar offset or at
    per-row offsets (batched speculation), against `_attention`."""
    params, model = tiny
    p = jax.tree.map(lambda a: a[0], params["layers"])
    b, t, slots = 2, 3, 12
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, t, CFG.hidden_size)).astype(np.float32)
    cos, sin = jg.rope_tables(slots, CFG.head_dim, CFG.rope_theta)
    cos, sin = cos[:t], sin[:t]
    bias = np.zeros((b, 1, t, slots), np.float32)
    bias[..., 7:] = -1e9
    index = np.asarray([0, 4], np.int32) if per_row else 2
    shape = (b, CFG.kv_heads, slots, CFG.head_dim)
    ref_cache = tuple(jg._kv_cache_init(kv_quant, shape, jnp.float32) for _ in range(2))
    want, (ck, cv) = jg._attention(p, jnp.asarray(x), jnp.asarray(bias), jnp.asarray(cos),
                                   jnp.asarray(sin), CFG, ref_cache,
                                   jnp.asarray(index) if per_row else index)
    cache = tuple(pg.kv_cache_init(kv_quant, shape, torch.float32, "cpu") for _ in range(2))
    got = model.layers[0].attention(torch.from_numpy(x), torch.from_numpy(bias),
                                    torch.from_numpy(cos), torch.from_numpy(sin), cache,
                                    torch.from_numpy(index).long() if per_row else index)
    assert_rel(got, want, 1e-5, f"cached attention {kv_quant} per_row={per_row}")
    for mine, ref in zip(cache, (ck, cv)):
        if kv_quant == "int8":
            # codes may differ by one step where a value sits on a rounding
            # boundary; the dequantized cache holds the reference's values
            deq = mine["q"].float() * mine["s"][..., None]
            ref_deq = np.asarray(ref["q"], np.float32) * np.asarray(ref["s"])[..., None]
            assert_rel(deq, ref_deq, 1e-2, "int8 cache")
        else:
            assert_rel(mine, ref, 1e-5, "bf16 cache")


def test_int8_cache_attention_close_to_bf16_cache(tiny):
    """The reference's own bound on the int8 cache: the attention output
    within 5e-2 of the float cache's."""
    _, model = tiny
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 6, CFG.hidden_size)).astype(np.float32))
    cos, sin = (torch.from_numpy(a[:6]) for a in jg.rope_tables(16, CFG.head_dim,
                                                                 CFG.rope_theta))
    bias = torch.zeros(1, 1, 6, 16)
    bias[..., 6:] = -1e9
    shape = (1, CFG.kv_heads, 16, CFG.head_dim)
    outs = []
    for kv_quant in ("bf16", "int8"):
        cache = tuple(pg.kv_cache_init(kv_quant, shape, torch.float32, "cpu")
                      for _ in range(2))
        outs.append(model.layers[0].attention(x, bias, cos, sin, cache, 0))
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------


def _logit_rows():
    rng = np.random.default_rng(3)
    lg = (rng.standard_normal((6, 256)) * 2.0).astype(np.float32)
    lg[1, [7, 40, 41, 200]] = 9.0  # a tie at the top: the lower id first
    lg[2, :] = 0.5  # all tied
    lg[3, 10:80] = 3.0  # a tie across the top_k boundary
    return lg


@pytest.mark.parametrize("temperature,top_p,top_k", [(0.7, 0.95, 64), (1.3, 0.9, 16)])
def test_topp_filtered_ids_and_probs(temperature, top_p, top_k):
    lg = _logit_rows()
    for row in lg:
        kidx, filt = jg._topp_filtered(jnp.asarray(row), temperature, top_p, top_k)
        pidx, pfilt = pg.topp_filtered(torch.from_numpy(row), temperature, top_p, top_k)
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(kidx))
        np.testing.assert_allclose(pfilt.numpy(), np.asarray(filt), rtol=0, atol=1e-6)


def test_greedy_takes_the_first_maximum():
    lg = _logit_rows()
    want = [int(jax.lax.top_k(jnp.asarray(r), 1)[1][0]) for r in lg]
    assert pg.greedy(torch.from_numpy(lg)).tolist() == want


def test_penalize_matches_the_reference_rule():
    """Tokens of the ring (its empty slots hold `vocab`): positive logits
    divided by the penalty, others multiplied (IEEE division)."""
    lg = _logit_rows()[:2]
    ring = np.asarray([[7, 40, 256, 3, 256], [255, 0, 256, 256, 9]], np.int64)
    got = pg.penalize(torch.from_numpy(lg), torch.from_numpy(ring), 1.1, 256).numpy()
    want = lg.copy()
    for r in range(2):
        hit = np.zeros(257, bool)
        hit[ring[r]] = True
        h = hit[:256]
        want[r, h] = np.where(lg[r, h] > 0, lg[r, h] / np.float32(1.1),
                              lg[r, h] * np.float32(1.1))
    np.testing.assert_array_equal(got, want)
    lg_t = torch.from_numpy(lg)
    assert pg.penalize(lg_t, torch.from_numpy(ring), 1.0, 256) is lg_t  # penalty 1: as is


def test_topp_sample_and_spec_accept_with_the_reference_draws():
    """The same Gumbel and uniform numbers give the same tokens and
    acceptances as the reference's key-driven functions."""
    lg = _logit_rows()
    T, P, K = 0.9, 0.9, 16
    keys = jax.random.split(jax.random.key(7), 40)
    for i, key in enumerate(keys):
        row = lg[i % len(lg)]
        want = int(jg.topp_sample(jnp.asarray(row), key, T, P, K))
        g = _t(jax.random.gumbel(key, (K,)))
        assert int(pg.topp_sample(torch.from_numpy(row), g, T, P, K)) == want
        draft = int(np.argsort(row)[-1 - i % 3])
        tok, acc = jg.spec_accept(jnp.asarray(row), jnp.asarray(draft), key, T, P, K)
        ku, kc = jax.random.split(key)
        ptok, pacc = pg.spec_accept(torch.from_numpy(row), torch.tensor(draft),
                                    _t(jax.random.uniform(ku)), _t(jax.random.gumbel(kc, (K,))),
                                    T, P, K)
        assert (int(ptok), bool(pacc)) == (int(tok), bool(acc))
    # greedy: accept iff the draft is the argmax, else emit the argmax
    for row in lg:
        for draft in (int(np.argmax(row)), 0):
            tok, acc = jg.spec_accept(jnp.asarray(row), jnp.asarray(draft), keys[0], 0.0, P, K)
            ptok, pacc = pg.spec_accept(torch.from_numpy(row), torch.tensor(draft), None,
                                        None, 0.0, P, K)
            assert (int(ptok), bool(pacc)) == (int(tok), bool(acc))


def test_spec_accept_preserves_the_distribution():
    """The committed token is distributed as topp_sample's (total
    variation within Monte-Carlo noise) for drafts of high, low and zero
    probability, and a zero-probability draft is never emitted (the
    reference's test, on the port's own draws)."""
    rng = np.random.default_rng(0)
    lg = torch.from_numpy((rng.standard_normal(64) * 2.0).astype(np.float32))
    n, T, P, K = 4000, 0.9, 0.9, 16
    draws = pg.SamplingDraws(7, "cpu")
    ref = pg.topp_sample(lg.expand(n, 64), draws.token(n, K), T, P, K)
    ref_freq = np.bincount(ref.numpy(), minlength=64) / n
    for draft in (int(lg.argmax()), int(lg.argsort()[-3]), 0):
        u, g, _ = draws.bundle(n, 1, K)
        tok, _ = pg.spec_accept(lg.expand(n, 64), torch.full((n,), draft), u[0], g[0], T, P, K)
        tv = 0.5 * np.abs(np.bincount(tok.numpy(), minlength=64) / n - ref_freq).sum()
        assert tv < 0.05, (draft, tv)
    zlg = lg.clone()
    zlg[0] = -1e9
    u, g, _ = draws.bundle(500, 1, K)
    tok, _ = pg.spec_accept(zlg.expand(500, 64), torch.zeros(500, dtype=torch.long), u[0], g[0],
                            T, P, K)
    assert not (tok == 0).any()


def test_ngram_draft_matches_reference():
    buf = np.asarray([7, 1, 2, 3, 4, 9, 1, 2, 3, 8, 2, 3] + [-1] * 8, np.int64)
    rep = np.asarray([0] * 10 + [-1] * 6, np.int64)
    cases = [(buf, 12, 0, 2, 3), (buf, 9, 0, 2, 6), (buf, 12, 5, 2, 3), (rep, 10, 0, 3, 4),
             (np.asarray([1, 2, 3, 4, 5, 6, -1, -1]), 6, 0, 2, 3), (buf, 18, 0, 2, 4)]
    rng = np.random.default_rng(4)
    for ngram, k in ((2, 3), (3, 4)):
        for _ in range(6):
            b = rng.integers(0, 4, 24)
            cursor = int(rng.integers(4, 24))
            b[cursor:] = -1
            cases.append((b, cursor, int(rng.integers(0, 3)), ngram, k))
    draft = jax.jit(jg._ngram_draft, static_argnums=(3, 4))
    for b, cursor, pad, ngram, k in cases:
        want = np.asarray(draft(jnp.asarray(b, jnp.int32), jnp.asarray(cursor),
                                jnp.asarray(pad), ngram, k))
        np.testing.assert_array_equal(pg.ngram_draft(b, cursor, pad, ngram, k), want,
                                      err_msg=str((list(b), cursor, pad, ngram, k)))
    assert list(pg.ngram_draft(buf, 12, 0, 2, 3)) == [8, 2, 3]


# ---------------------------------------------------------------------------
# generate_tokens and generate_tokens_batched against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [(0, 3), (2, 2), (4, 3), (8, 3)])
def test_greedy_generate_matches_reference(tiny, spec):
    """Sequential and speculative greedy: the reference's tokens and
    forward counts, and speculation equal to the sequential sequence."""
    params, model = tiny
    k, ng = spec
    want, wstats = jg.generate_tokens(params, PROMPT, CFG, jax.random.key(1),
                                      max_new_tokens=40, spec_k=k, spec_ngram=ng,
                                      return_stats=True, **GREEDY)
    got, stats = pg.generate_tokens(model, PROMPT, max_new_tokens=40, spec_k=k,
                                    spec_ngram=ng, return_stats=True, **GREEDY)
    assert got == want and stats == wstats
    if k:
        assert got == pg.generate_tokens(model, PROMPT, max_new_tokens=40, **GREEDY)


@pytest.mark.parametrize("spec_k", [0, 6])
def test_sampled_generate_matches_reference_token_for_token(tiny, spec_k):
    """Temperature 0.7, top-p 0.95, repetition penalty 1.1 with the
    reference's draws fed in."""
    params, model = tiny
    kw = dict(max_new_tokens=24, temperature=0.7, stop_tokens=(), bucket=8, spec_k=spec_k)
    want = jg.generate_tokens(params, PROMPT, CFG, jax.random.key(3), **kw)
    got = pg.generate_tokens(model, PROMPT, draws=JaxDraws(jax.random.key(3)), **kw)
    assert got == want and len(got) == 24


def test_full_accept_bonus_cap_and_stops(tiny):
    """Zero weights: uniform logits, greedy emits token 0 and the drafts
    fully accept (the bonus token, the cap mid-bundle); a stop on the first
    token emits nothing; a stop mid-generation ends spec and sequential
    alike."""
    params, model = tiny
    zero = convert.gemma(jax.tree.map(jnp.zeros_like, params), CFG)
    for n in (33, 16):
        assert pg.generate_tokens(zero, PROMPT, max_new_tokens=n, spec_k=8, **GREEDY) == [0] * n
    for sk in (0, 8):
        assert pg.generate_tokens(zero, PROMPT, max_new_tokens=16, temperature=0.0,
                                  stop_tokens=(0,), bucket=8, spec_k=sk) == []
    seq = pg.generate_tokens(model, PROMPT, max_new_tokens=40, **GREEDY)
    stop = seq[7]
    for sk in (0, 5):
        assert pg.generate_tokens(model, PROMPT, max_new_tokens=40, temperature=0.0,
                                  stop_tokens=(stop,), bucket=8, spec_k=sk) \
            == seq[:seq.index(stop)]


def test_short_prompt_runs_sequential(tiny):
    _, model = tiny
    short = np.asarray([5, 9], np.int32)
    got, stats = pg.generate_tokens(model, short, max_new_tokens=8, spec_k=6, spec_ngram=3,
                                    return_stats=True, **GREEDY)
    assert len(got) == 8 and stats["forwards"] == 8


@pytest.mark.parametrize("spec_k", [0, 2, 4, 8])
def test_batched_greedy_matches_reference_and_solo(tiny, spec_k):
    """Rows of different lengths (own pads, positions and, under
    speculation, own cache offsets): the reference's batched tokens, and
    each row its solo greedy sequence."""
    params, model = tiny
    want = jg.generate_tokens_batched(params, PROMPTS, CFG, jax.random.key(1),
                                      max_new_tokens=24, spec_k=spec_k, **GREEDY)
    got = pg.generate_tokens_batched(model, PROMPTS, max_new_tokens=24, spec_k=spec_k,
                                     **GREEDY)
    assert got == want
    for row, p in zip(got, PROMPTS):
        assert row == pg.generate_tokens(model, p, max_new_tokens=24, **GREEDY)


@pytest.mark.parametrize("spec_k", [0, 4])
def test_batched_sampled_matches_reference(tiny, spec_k):
    params, model = tiny
    prompts = [PROMPT, PROMPT[:4]]
    kw = dict(max_new_tokens=10, temperature=0.7, stop_tokens=(), bucket=8, spec_k=spec_k)
    want = jg.generate_tokens_batched(params, prompts, CFG, jax.random.key(3), **kw)
    got = pg.generate_tokens_batched(model, prompts,
                                     draws=JaxDraws(jax.random.key(3), batched=True), **kw)
    assert got == want and [len(r) for r in got] == [10, 10]


@pytest.mark.parametrize("spec_k", [0, 4])
def test_batched_per_row_stop(tiny, spec_k):
    """A stopped row freezes while the other runs on; all rows stopping
    ends the loop."""
    params, model = tiny
    seq = pg.generate_tokens(model, PROMPT, max_new_tokens=16, **GREEDY)
    stop = seq[5]
    other = np.asarray([3, 7, 2, 9], np.int32)
    kw = dict(max_new_tokens=16, temperature=0.0, stop_tokens=(stop,), bucket=8,
              spec_k=spec_k)
    got = pg.generate_tokens_batched(model, [PROMPT, other], **kw)
    assert got[0] == seq[:seq.index(stop)]
    assert got[1] == pg.generate_tokens(model, other, **kw)
    zero = convert.gemma(jax.tree.map(jnp.zeros_like, params), CFG)
    assert pg.generate_tokens_batched(zero, [PROMPT, other], max_new_tokens=16,
                                      temperature=0.0, stop_tokens=(0,), bucket=8) == [[], []]


@pytest.mark.parametrize("spec_k", [0, 4])
def test_int8_cache_generation_matches_reference(tiny, spec_k):
    params, model = tiny
    ids = np.arange(5, 20)[None].astype(np.int32)
    kw = dict(max_new_tokens=8, temperature=0.0, stop_tokens=(), bucket=16, spec_k=spec_k,
              kv_quant="int8")
    assert pg.generate_tokens(model, ids, **kw) \
        == jg.generate_tokens(params, ids, CFG, jax.random.key(3), **kw)
    prompts = [list(range(5, 12)), list(range(30, 34))]
    assert pg.generate_tokens_batched(model, prompts, **kw) \
        == jg.generate_tokens_batched(params, prompts, CFG, jax.random.key(4), **kw)


def _w8a8_tree():
    params = _init(jax.random.key(1))
    layers = dict(params["layers"])
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"):
        stacked = np.asarray(params["layers"][name]["w"], np.float32)
        per = [requant_int8_channel_np(stacked[i]) for i in range(CFG.hidden_layers)]
        layers[name] = jax.tree.map(lambda *xs: jnp.stack(xs), *per)
    return {**params, "layers": layers}


def _int8_table(params):
    w = np.asarray(params["embed_tokens"]["w"], np.float32)
    sr = np.abs(w).max(axis=1) / 127.0
    sr = np.where(sr == 0, 1.0, sr).astype(np.float32)
    w8r = np.clip(np.rint(w / sr[:, None]), -127, 127).astype(np.int8)
    return {**params, "embed_tokens": {"w8r": jnp.asarray(w8r), "sr": jnp.asarray(sr)}}


@pytest.mark.parametrize("which", ["w8a8", "int8_table"])
def test_quantized_gemma_generation_matches_reference(which):
    """W8A8 projection leaves (speculation through the int8 products) and
    the int8 token table with an int8 cache, solo and batched. The int8
    table implies bf16 activations, so that case runs the bf16 cycle model,
    whose margin no bf16 rounding of either framework can tip."""
    if which == "w8a8":
        tree, prompt = _w8a8_tree(), PROMPT
    else:
        tree, prompt = _int8_table(_cycle_params(jnp.bfloat16)), CYCLE_PROMPT
    model = convert.gemma(tree, CFG)
    kw = dict(max_new_tokens=12, **GREEDY)
    want = jg.generate_tokens(tree, prompt, CFG, jax.random.key(5), **kw)
    assert pg.generate_tokens(model, prompt, **kw) == want
    assert pg.generate_tokens(model, prompt, spec_k=4, **kw) == want
    prompts = [prompt, np.asarray([3, 7, 2], np.int32)]
    bkw = dict(kw, kv_quant="int8", spec_k=3)
    assert pg.generate_tokens_batched(model, prompts, **bkw) \
        == jg.generate_tokens_batched(tree, prompts, CFG, jax.random.key(5), **bkw)


def test_argument_checks(tiny):
    _, model = tiny
    with pytest.raises(InvalidConfigurationError, match="one prompt"):
        pg.generate_tokens(model, np.stack([PROMPT, PROMPT]), max_new_tokens=2)
    with pytest.raises(InvalidConfigurationError, match="non-empty"):
        pg.generate_tokens_batched(model, [PROMPT, []], max_new_tokens=2)
    for fn, arg in ((pg.generate_tokens, PROMPT), (pg.generate_tokens_batched, [PROMPT])):
        # a mesh the model is not sharded over (TP decodes:
        # tests/test_torch_parallel.py)
        with pytest.raises(InvalidConfigurationError, match="shard the model"):
            fn(model, arg, max_new_tokens=2, mesh=object())


# ---------------------------------------------------------------------------
# The cycle model
# ---------------------------------------------------------------------------

REAL = dict(temperature=0.7, top_p=0.95, repetition_penalty=1.1, stop_tokens=())


def test_cycle_model_converted_matches_reference():
    """The reference's cycle parameters in the port: its greedy and sampled
    tokens (the reference's draws), its speculative commit count; the
    default cycle equals the reference's."""
    assert psyn.default_cycle(CFG) == jsyn.default_cycle(CFG)
    assert psyn.default_cycle(jg.Gemma3Config()) == jsyn.default_cycle(jg.Gemma3Config())
    params = _cycle_params()
    model = convert.gemma(params, CFG)
    kw = dict(max_new_tokens=48, spec_k=4, return_stats=True, **REAL)
    want = jg.generate_tokens(params, CYCLE_PROMPT, CFG, jax.random.key(3), **kw)
    assert pg.generate_tokens(model, CYCLE_PROMPT, draws=JaxDraws(jax.random.key(3)),
                              **kw) == want
    assert pg.generate_tokens(model, CYCLE_PROMPT, max_new_tokens=24, temperature=0.0,
                              stop_tokens=()) \
        == jg.generate_tokens(params, CYCLE_PROMPT, CFG, jax.random.key(1), max_new_tokens=24,
                              temperature=0.0, stop_tokens=())


@pytest.fixture(scope="module")
def cycle_model():
    return psyn.make_cycle_gemma(CFG, torch.Generator().manual_seed(0), cycle=CYCLE)


def test_port_cycle_model_walks_its_cycle(cycle_model):
    """The port's own build, held to the reference's behavioural checks:
    greedy walks the cycle, sampled follows it (>= 0.85 of steps), greedy
    speculation equals sequential."""
    toks = pg.generate_tokens(cycle_model, CYCLE_PROMPT, max_new_tokens=32, temperature=0.0,
                              stop_tokens=())
    start = CYCLE.index(toks[0])
    assert toks == [CYCLE[(start + i) % len(CYCLE)] for i in range(len(toks))]
    assert pg.generate_tokens(cycle_model, CYCLE_PROMPT, max_new_tokens=32, temperature=0.0,
                              stop_tokens=(), spec_k=6) == toks
    sampled = pg.generate_tokens(cycle_model, CYCLE_PROMPT, max_new_tokens=24, seed=2, **REAL)
    follows = sum(1 for a, b in zip(sampled, sampled[1:])
                  if a in CYCLE and b == CYCLE[(CYCLE.index(a) + 1) % len(CYCLE)])
    assert follows >= 0.85 * (len(sampled) - 1), sampled


def _rate(model, seed=3):
    toks, stats = pg.generate_tokens(model, CYCLE_PROMPT, max_new_tokens=48, spec_k=4,
                                     return_stats=True, seed=seed, **REAL)
    assert len(toks) == 48
    return len(toks) / max(stats["forwards"], 1)


def test_port_cycle_model_acceptance(cycle_model):
    """Speculation accepts on the cycle (more than 3 tokens a forward of at
    most 5); `branch` gives partial acceptance, below the deterministic
    cycle's and above sequential."""
    det = _rate(cycle_model)
    assert det > 3.0, det
    branchy = _rate(psyn.make_cycle_gemma(CFG, torch.Generator().manual_seed(0), cycle=CYCLE,
                                          branch=1.0))
    assert det > branchy > 1.0 and 1.2 < branchy < 4.5, (det, branchy)


def test_batched_input_embeds_rows_match_solo(cycle_model):
    """A VLM row (soft tokens spliced between two text spans) batched with a
    text row: each row its solo greedy output."""
    ids_a = [int(x) for x in CYCLE_PROMPT]
    emb = cycle_model.embed_tokens.weight
    scale = float(np.sqrt(CFG.hidden_size))
    soft = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 4, CFG.hidden_size)).astype(np.float32))
    e = torch.cat([emb[ids_a[:4]][None] * scale, soft, emb[ids_a[4:]][None] * scale], dim=1)
    ids_b = [0] * e.shape[1]
    kw = dict(max_new_tokens=10, temperature=0.0, stop_tokens=())
    solo_text = pg.generate_tokens(cycle_model, ids_a, **kw)
    solo_vlm = pg.generate_tokens(cycle_model, [ids_b], input_embeds=e, **kw)
    assert pg.generate_tokens_batched(cycle_model, [ids_a, ids_b], input_embeds=[None, e],
                                      **kw) == [solo_text, solo_vlm]


# ---------------------------------------------------------------------------
# C6: as many key/value heads as query heads
# ---------------------------------------------------------------------------


def test_equal_heads_gemma_matches_reference():
    """A Gemma with kv_heads == attention_heads: its full (B, 1, T, T)
    masks go to the plain attention (they raised before), hidden states
    within 1e-5 of the reference's and greedy generation (sequential,
    speculative, batched) token for token."""
    cfg = dataclasses.replace(CFG, kv_heads=CFG.attention_heads)
    params = _init(jax.random.key(2), cfg)
    model = convert.gemma(params, cfg)
    rng = np.random.default_rng(5)
    ids = rng.integers(2, cfg.vocab_size, (1, 12)).astype(np.int32)
    mask = np.ones((1, 12), np.int32)
    mask[0, :3] = 0
    want = jg.forward_hidden_states_jit(params, jnp.asarray(ids), jnp.asarray(mask), cfg)
    got = model.forward_hidden_states(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert_rel(got, want, 1e-5, "equal-heads Gemma hidden states")
    for spec_k in (0, 4):
        assert pg.generate_tokens(model, PROMPT, max_new_tokens=16, spec_k=spec_k, **GREEDY) \
            == jg.generate_tokens(params, PROMPT, cfg, jax.random.key(1), max_new_tokens=16,
                                  spec_k=spec_k, **GREEDY)
    assert pg.generate_tokens_batched(model, PROMPTS[:2], max_new_tokens=12, **GREEDY) \
        == jg.generate_tokens_batched(params, PROMPTS[:2], cfg, jax.random.key(1),
                                      max_new_tokens=12, **GREEDY)
