"""Port parity: joint audio-video LoRA training (ltx_tpu_torch.train's
av_flow_match_loss and make_av_train_step against ltx_tpu.train's) on the
tiny dual DiT of the reference's tests/test_train.py (TransformerConfig
().tiny(), a 2x2x3 latent grid and 5 audio frames), the same numpy-made
inputs and the reference's own jax.random draws (one key split four ways:
video sigma, audio sigma, video noise, audio noise) fed to both sides.

Tolerances (largest error relative to the reference's largest magnitude),
the video step's (tests/test_torch_train.py, PERF.md's parity table):
* av_flow_match_loss, its three terms and its LoRA gradients, float32, the
  port's remat off, per block and segmented against the reference's
  without remat (its remat changes no number and compiles slower): 1e-4
  per leaf. The reference's programs compile without XLA's backend
  optimizations.
* 4 LoRA-only train steps in float32 (Adam's eps 1e-3, for
  test_train_steps_match_reference's reason): the losses, each stream's
  loss and the gradient norms 1e-4; the LoRA leaves 1e-4 per leaf.
* where the adapters land (every attention and feed-forward of every dual
  block, as the reference's add_lora): equal; the base after the steps:
  bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.models import dit_av as jav
from ltx_tpu.ops.attention import prepare_additive_mask as j_mask
from ltx_tpu.train import flow_match as jfm
from ltx_tpu.train import lora as jlora
from ltx_tpu.train import step as jstep
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import TransformerConfig
from ltx_tpu_torch.models import dit_av
from ltx_tpu_torch.models.common import init_random_
from ltx_tpu_torch.ops.attention import prepare_additive_mask
from ltx_tpu_torch.train import checkpoint, lora, step
from ltx_tpu_torch.train.flow_match import av_flow_match_loss
from test_torch_audio import _jcfg, _randomize
from torch_parity import assert_rel
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CFG = TransformerConfig().tiny()
JCFG = _jcfg(CFG)
GRID, AUDIO_FRAMES, S, RANK = (2, 2, 3), 5, 8, 4
# the reference's programs compile without XLA's backend optimizations (a
# fifth less compile; f32 sums in other orders, far inside 1e-4)
FAST = {"xla_backend_optimization_level": 0}
# the dual block's linears that the reference's add_lora adapts
ATTENTIONS = ("attn1", "attn2", "audio_attn1", "audio_attn2", "audio_to_video_attn",
              "video_to_audio_attn")
FEED_FORWARDS = ("ff", "audio_ff")


def _base_tree() -> dict:
    """The tiny dual DiT in f32 as a reference tree of numpy leaves, drawn
    by the port (`init_random_`: the reference's init scales, without its
    jitted init's compile) with the zero tables and biases and the unit
    norms redrawn, so that every parameter matters."""
    model = init_random_(dit_av.LTXAVTransformer(CFG, device="cpu", dtype=torch.float32),
                         torch.Generator().manual_seed(3))
    tree = jax.tree.map(lambda t: t.numpy(), convert.av_transformer_tree(model))
    return _randomize(tree, np.random.default_rng(3))


def _lora_tree() -> dict:
    """`_base_tree` with rank-4 LoRA leaves from the port's add_lora,
    lora_b redrawn nonzero so that lora_a gets a gradient."""
    model = lora.add_lora(convert.av_transformer(_base_tree(), CFG),
                          torch.Generator().manual_seed(4), rank=RANK)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape) * 0.05))
    return jax.tree.map(lambda t: t.numpy(), convert.av_transformer_tree(model))


@pytest.fixture(scope="module")
def lora_tree():
    return _lora_tree()


def _batch():
    """Two rows: video and audio tokens, the two text contexts and a
    left-padded mask per row."""
    rng = np.random.default_rng(1)
    f, h, w = GRID
    mask = np.ones((2, S), np.int32)
    mask[1, :3] = 0
    return dict(
        video=rng.standard_normal((2, f * h * w, CFG.in_channels)).astype(np.float32),
        audio=rng.standard_normal((2, AUDIO_FRAMES, CFG.audio_in_channels)).astype(np.float32),
        vctx=rng.standard_normal((2, S, CFG.caption_channels)).astype(np.float32),
        actx=rng.standard_normal((2, S, CFG.caption_channels)).astype(np.float32),
        mask=mask)


def _draws(key, batch):
    """What the reference's av_flow_match_loss draws from `key`, as CPU
    tensors: sigma_v, sigma_a, noise_v, noise_a."""
    k_sv, k_sa, k_nv, k_na = jax.random.split(key, 4)
    b = batch["video"].shape[0]
    return tuple(torch.from_numpy(np.array(x)) for x in (
        jfm.sample_sigmas(k_sv, b, "logit_normal"), jfm.sample_sigmas(k_sa, b, "logit_normal"),
        jax.random.normal(k_nv, batch["video"].shape, jnp.float32),
        jax.random.normal(k_na, batch["audio"].shape, jnp.float32)))


def _jax_inputs(batch):
    return (jnp.asarray(batch["video"]), jnp.asarray(batch["audio"]),
            jnp.asarray(batch["vctx"]), jnp.asarray(batch["actx"]),
            jav.prepare_av_ropes(JCFG, *GRID, AUDIO_FRAMES))


def _port_inputs(batch):
    return (torch.from_numpy(batch["video"]), torch.from_numpy(batch["audio"]),
            torch.from_numpy(batch["vctx"]), torch.from_numpy(batch["actx"]),
            dit_av.prepare_av_ropes(CFG, *GRID, AUDIO_FRAMES))


def _stacked(tree: dict) -> dict:
    """{reference key path: array} of a reference tree's leaves."""
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def loss_case(lora_tree):
    """The reference's joint loss, its terms and its LoRA gradients (f32,
    no remat, both key biases; one jitted program), and its draws."""
    tree, batch = lora_tree, _batch()
    key = jax.random.key(11)
    trainable, frozen = jstep.partition_trainable(jax.tree.map(jnp.asarray, tree),
                                                  jstep.TrainConfig(lora_only=True))
    bias = j_mask(jnp.asarray(batch["mask"]))

    def loss_fn(tr):
        return jfm.av_flow_match_loss(
            jstep.combine_params(tr, frozen), *_jax_inputs(batch), key, JCFG, video_bias=bias,
            audio_bias=bias, audio_loss_weight=0.5, sdpa_impl="xla", remat=False,
            compute_dtype=jnp.float32)

    (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
        trainable).compile(compiler_options=FAST)(trainable)
    return tree, batch, _draws(key, batch), {k: float(v) for k, v in aux.items()}, \
        _stacked(grads)


@pytest.mark.parametrize("remat,segments", [(False, 0), (True, 0), (True, 2)],
                         ids=["no_remat", "remat", "segments2"])
def test_av_flow_match_loss_and_lora_grads(loss_case, remat, segments):
    tree, batch, draws, want_aux, want = loss_case
    model = convert.av_transformer(tree, CFG)
    trainable, _ = step.partition_trainable(model, step.TrainConfig(lora_only=True))
    bias = prepare_additive_mask(torch.from_numpy(batch["mask"]))
    loss, aux = av_flow_match_loss(model, *_port_inputs(batch), *draws, video_bias=bias,
                                   audio_bias=bias, audio_loss_weight=0.5, remat=remat,
                                   remat_segments=segments, compute_dtype=torch.float32)
    assert set(aux) == set(want_aux) == {"loss", "loss_video", "loss_audio"}
    for k in want_aux:
        assert_rel(aux[k].reshape(1), np.asarray([want_aux[k]]), 1e-4, f"AV {k}")
    grads = torch.autograd.grad(loss, list(trainable.values()))
    got = checkpoint.flatten_params(dict(zip(trainable, grads)), "")
    assert sorted(got) == sorted(want)
    worst = max(assert_rel(got[k], want[k], 1e-4, f"AV d{k} remat={remat} segments={segments}")
                for k in want)
    assert np.isfinite(worst)


def test_av_segmented_remat_rejects_a_non_divisor(loss_case):
    tree, batch, draws, _, _ = loss_case
    model = convert.av_transformer(tree, CFG)
    with pytest.raises(ValueError, match="must divide"):
        av_flow_match_loss(model, *_port_inputs(batch), *draws, remat_segments=3,
                           compute_dtype=torch.float32)


def test_av_train_steps_match_reference(lora_tree):
    """4 LoRA-only steps of the reference's test_av_lora_train_step in
    float32, fed the reference's draws (keys 100, 101, 100, 101); the port
    with per-block remat, the reference without."""
    tree, batch = lora_tree, _batch()
    jtc = jstep.TrainConfig(learning_rate=1e-3, lora_only=True, remat=False, eps=1e-3,
                            compute_dtype=jnp.float32, sdpa_impl="xla")
    trainable, frozen, opt_state = jstep.init_train_state(jax.tree.map(jnp.asarray, tree), jtc)
    jin = _jax_inputs(batch)
    jstep_fn = jstep.make_av_train_step(JCFG, jtc, donate=False, audio_loss_weight=0.5).lower(
        trainable, frozen, opt_state, *jin, jax.random.key(0)).compile(compiler_options=FAST)

    model = convert.av_transformer(tree, CFG)
    base = {n: p.detach().clone() for n, p in model.named_parameters()
            if not lora.lora_param_mask(model)[n]}
    tc = step.TrainConfig(learning_rate=1e-3, lora_only=True, remat=True, eps=1e-3,
                          compute_dtype=torch.float32)
    t_trainable, _, t_opt = step.init_train_state(model, tc)
    t_step = step.make_av_train_step(model, tc, audio_loss_weight=0.5)
    tin = _port_inputs(batch)
    for i in range(4):
        key = jax.random.key(100 + (i % 2))
        trainable, opt_state, aux = jstep_fn(trainable, frozen, opt_state, *jin, key)
        t_trainable, t_opt, t_aux = t_step(t_trainable, t_opt, *tin, *_draws(key, batch))
        assert set(t_aux) == set(aux)
        for k in ("loss", "loss_video", "loss_audio", "grad_norm"):
            assert_rel(t_aux[k].reshape(1), np.asarray([aux[k]]), 1e-4, f"AV step {i} {k}")
    got, want = checkpoint.flatten_params(t_trainable, ""), _stacked(trainable)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_rel(got[k], want[k], 1e-4, f"AV LoRA {k} after 4 steps")
    for n, p in model.named_parameters():
        if n in base:
            assert torch.equal(p, base[n]), f"base parameter {n} moved"
    assert int(t_opt["count"]) == 4


def test_av_adapters_land_where_the_reference_puts_them():
    """add_lora on the dual DiT adapts q, k, v and out of all six
    attentions and both linears of both feed-forwards in every block, the
    reference's leaves exactly; the partition trains those and freezes the
    rest."""
    tree = _base_tree()
    # the reference's leaves from its add_lora traced, not run
    jtree = jax.eval_shape(lambda t, k: jlora.add_lora(t, k, rank=RANK), tree,
                           jax.random.key(3))
    want = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jtree)
            if "lora_" in jax.tree_util.keystr(p)}
    model = convert.av_transformer(tree, CFG)
    lora.add_lora(model, torch.Generator().manual_seed(3), rank=RANK)
    trainable, frozen = step.partition_trainable(model, step.TrainConfig(lora_only=True))
    assert set(checkpoint.flatten_params(trainable, "")) == want
    adapted = {name.rsplit(".", 1)[0] for name in trainable}
    for i in range(CFG.num_layers):
        for attn in ATTENTIONS:
            for proj in ("to_q", "to_k", "to_v", "to_out"):
                assert f"blocks.{i}.{attn}.{proj}" in adapted, (i, attn, proj)
        for ff in FEED_FORWARDS:
            for proj in ("project_in", "project_out"):
                assert f"blocks.{i}.{ff}.{proj}" in adapted, (i, ff, proj)
    assert len(adapted) == CFG.num_layers * (4 * len(ATTENTIONS) + 2 * len(FEED_FORWARDS))
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())
    assert set(trainable) | set(frozen) == {n for n, _ in model.named_parameters()}


def test_av_bf16_steps_stay_finite_and_the_loss_falls():
    """The port alone in bf16 (the card's compute type), per-block remat:
    6 steps over two alternating draws; the loss of the last step on the
    first draw's set is below that of step 0."""
    model = init_random_(dit_av.LTXAVTransformer(CFG, device="cpu", dtype=torch.bfloat16),
                         torch.Generator().manual_seed(3))
    lora.add_lora(model, torch.Generator().manual_seed(5), rank=RANK)
    tc = step.TrainConfig(learning_rate=1e-3, lora_only=True, remat=True)
    trainable, _, opt = step.init_train_state(model, tc)
    t_step = step.make_av_train_step(model, tc)
    batch = _batch()
    draws = [_draws(jax.random.key(200 + k), batch) for k in range(2)]
    losses = []
    for i in range(6):
        trainable, opt, aux = t_step(trainable, opt, *_port_inputs(batch), *draws[i % 2])
        assert all(torch.isfinite(v).all() for v in aux.values())
        assert float(aux["loss_video"]) > 0 and float(aux["loss_audio"]) > 0
        losses.append(float(aux["loss"]))
    print(f"[parity] AV bf16 losses {losses}")
    assert losses[4] < losses[0]
    assert any(float(p.detach().abs().max()) > 0 for n, p in trainable.items()
               if n.endswith("lora_b"))
