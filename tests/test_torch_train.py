"""Port parity: LoRA training (ltx_tpu_torch.train against ltx_tpu.train) on
the tiny DiT, the same numpy-made inputs and the reference's own jax.random
draws of sigma and noise fed to both sides.

Tolerances (largest error relative to the reference's largest magnitude):
* flow_match_loss and its LoRA gradients, remat off, per block and
  segmented (the port's three against the reference's, without remat):
  float32 1e-4 per leaf (the same math; sums in other orders); bf16 5e-2
  over all leaves (the two frameworks round bf16 at different places, as in
  the DiT's forward parity).
* 6 train steps (LoRA-only, warmup, gradient accumulation 2, EMA) in
  float32: the trainable leaves and the EMA 1e-4 per leaf, the losses and
  gradient norms 1e-4.
* 3 QLoRA steps over a W8A8 base, float32, on the reference's activation
  codes (the port's own equal to them but at rounding ties): the losses and
  gradient norms 1e-4, the LoRA leaves 2**-7 (one int8 step of an
  activation row; see the test).
* the optimizer against optax: 1e-6 per leaf (float32, the same formulas).
* datasets, checkpoint resume, the JAX checkpoint's trainable part, the
  exported adapter: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ltx_tpu.core import config as jconfig
from ltx_tpu.lora import fuse as jfuse
from ltx_tpu.ops import rope as jrope
from ltx_tpu.ops.attention import prepare_additive_mask as j_mask
from ltx_tpu.train import checkpoint as jckpt
from ltx_tpu.train import data as jdata
from ltx_tpu.train import export as jexport
from ltx_tpu.train import flow_match as jfm
from ltx_tpu.train import lora as jlora
from ltx_tpu.train import step as jstep
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import TransformerConfig
from ltx_tpu_torch.train import checkpoint, cli, data, export, lora, step
from ltx_tpu_torch.train.flow_match import flow_match_loss, sample_sigmas
from test_torch_dit import _params
from torch_parity import as_np, assert_rel
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CFG = TransformerConfig().tiny()
JCFG = convert.port_config(CFG, jconfig.TransformerConfig)
GRID = (2, 2, 3)
RANK = 4


def _lora_tree(dtype):
    """The reference's tiny DiT (its zero tables, biases and unit norms
    redrawn) with rank-4 LoRA leaves from add_lora, lora_b redrawn nonzero
    so that lora_a gets a gradient; numpy leaves."""
    tree = jax.tree.map(jnp.asarray, _params(dtype))
    tree = jlora.add_lora(tree, jax.random.key(4), rank=RANK)
    rng = np.random.default_rng(9)

    def bump(t):
        return {k: bump(v) if isinstance(v, dict) else (
            (rng.standard_normal(np.shape(v)) * 0.05).astype(np.float32)
            if k == "lora_b" else np.asarray(v)) for k, v in t.items()}

    return bump(tree)


def _batch():
    rng = np.random.default_rng(1)
    f, h, w = GRID
    tokens = rng.standard_normal((2, f * h * w, CFG.in_channels)).astype(np.float32)
    context = rng.standard_normal((2, 16, CFG.caption_channels)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[0, :5] = 0
    mask[1, :11] = 0
    cos, sin = jrope.video_rope(f, h, w, CFG.inner_dim, CFG.num_heads)
    return tokens, context, mask, (np.asarray(cos), np.asarray(sin))


def _draws(key, shape):
    """What the reference's flow_match_loss draws from `key`."""
    k_sigma, k_noise = jax.random.split(key)
    return (np.asarray(jfm.sample_sigmas(k_sigma, shape[0], "logit_normal")),
            np.asarray(jax.random.normal(k_noise, shape, jnp.float32)))


def _torch_batch(batch, dtype=torch.float32):
    tokens, context, mask, (cos, sin) = batch
    return (torch.from_numpy(tokens), torch.from_numpy(context),
            (torch.from_numpy(cos), torch.from_numpy(sin)),
            prepare_bias(mask))


def prepare_bias(mask):
    from ltx_tpu_torch.ops.attention import prepare_additive_mask
    return prepare_additive_mask(torch.from_numpy(mask))


def _stacked(tree: dict) -> dict:
    """{reference key path: array} of a reference tree's leaves."""
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module", params=["f32", "bf16"])
def loss_case(request):
    """The reference's loss and LoRA gradients for one dtype (no remat: the
    reference's remat changes no number, and compiles slower), and the
    port's model converted from the same tree."""
    dtype = jnp.float32 if request.param == "f32" else jnp.bfloat16
    tree = _lora_tree(dtype)
    batch = _batch()
    tokens, context, mask, rope = batch
    key = jax.random.key(11)
    sigma, noise = _draws(key, tokens.shape)
    params = jax.tree.map(jnp.asarray, tree)
    tc = jstep.TrainConfig(lora_only=True, compute_dtype=dtype)
    trainable, frozen = jstep.partition_trainable(params, tc)

    def loss_fn(tr):
        return jfm.flow_match_loss(
            jstep.combine_params(tr, frozen), jnp.asarray(tokens), jnp.asarray(context),
            tuple(map(jnp.asarray, rope)), key, JCFG, context_bias=j_mask(jnp.asarray(mask)),
            sdpa_impl="xla", remat=False, compute_dtype=dtype)[0]

    loss, grads = jax.value_and_grad(loss_fn)(trainable)
    model = convert.transformer(tree, CFG)
    return request.param, model, batch, (sigma, noise), float(loss), _stacked(grads)


@pytest.mark.parametrize("remat,segments", [(False, 0), (True, 0), (True, 2)],
                         ids=["no_remat", "remat", "segments2"])
def test_flow_match_loss_and_lora_grads(loss_case, remat, segments):
    name, model, batch, (sigma, noise), want_loss, want = loss_case
    tokens, context, rope, bias = _torch_batch(batch)
    trainable, _ = step.partition_trainable(model, step.TrainConfig(lora_only=True))
    dtype = torch.float32 if name == "f32" else torch.bfloat16
    loss, aux = flow_match_loss(model, tokens, context, rope, torch.tensor(sigma),
                                torch.tensor(noise), bias, remat=remat,
                                remat_segments=segments, compute_dtype=dtype)
    grads = torch.autograd.grad(loss, list(trainable.values()))
    got = checkpoint.flatten_params(dict(zip(trainable, grads)), "")
    assert sorted(got) == sorted(want)
    tol = 1e-4 if name == "f32" else 5e-2
    assert_rel(torch.tensor([loss.item()]), np.asarray([want_loss]), tol, f"loss {name}")
    if name == "f32":
        worst = max(assert_rel(got[k], want[k], tol, f"d{k} {name}") for k in want)
    else:
        worst = assert_rel(np.concatenate([got[k].ravel() for k in want]),
                           np.concatenate([want[k].ravel() for k in want]), tol,
                           f"LoRA gradients {name} remat={remat} segments={segments}")
    assert np.isfinite(worst)


def test_segmented_remat_rejects_a_non_divisor():
    model = convert.transformer(_lora_tree(jnp.float32), CFG)
    tokens, context, rope, bias = _torch_batch(_batch())
    with pytest.raises(ValueError, match="must divide"):
        flow_match_loss(model, tokens, context, rope, torch.full((2,), 0.5),
                        torch.zeros_like(tokens), bias, remat_segments=3,
                        compute_dtype=torch.float32)


def test_train_steps_match_reference():
    """6 steps of the LoRA-only train step with a 2-step warmup, gradient
    accumulation over 2 (3 updates, at learning rates 0, lr/2 and lr) and
    an EMA, float32, fed the reference's draws. Adam's eps is 1e-3 here:
    some LoRA gradients of this tiny DiT are 0 in the reference and ~1e-9
    on the port (saturated tanh-GELU), and Adam's g / (|g| + eps) turns a
    rounding-level gradient into up to a whole learning rate when eps is
    1e-8. With eps 1e-3 such elements stay put on both sides; the
    optimizer's own test holds the default eps against optax."""
    tree = _lora_tree(jnp.float32)
    batch = _batch()
    tokens, context, mask, rope = batch
    jtc = jstep.TrainConfig(lora_only=True, warmup_steps=2, accum_steps=2, eps=1e-3,
                            learning_rate=1e-2, compute_dtype=jnp.float32, sdpa_impl="xla")
    params = jax.tree.map(jnp.asarray, tree)
    trainable, frozen, opt_state = jstep.init_train_state(params, jtc)
    jstep_fn = jstep.make_train_step(JCFG, jtc, donate=False)
    ema, ema_upd = jstep.ema_init(trainable), jstep.make_ema_update(0.9)

    model = convert.transformer(tree, CFG)
    tc = step.TrainConfig(lora_only=True, warmup_steps=2, accum_steps=2, eps=1e-3,
                          learning_rate=1e-2, compute_dtype=torch.float32)
    t_trainable, _, t_opt = step.init_train_state(model, tc)
    t_step = step.make_train_step(model, tc)
    t_ema, t_ema_upd = step.ema_init(t_trainable), step.make_ema_update(0.9)
    tt, tc_, trope, tbias = _torch_batch(batch)

    key = jax.random.key(5)
    for i in range(6):
        key, sub = jax.random.split(key)
        trainable, opt_state, aux = jstep_fn(
            trainable, frozen, opt_state, jnp.asarray(tokens), jnp.asarray(context),
            tuple(map(jnp.asarray, rope)), sub, context_bias=j_mask(jnp.asarray(mask)))
        ema = ema_upd(ema, trainable)
        sigma, noise = _draws(sub, tokens.shape)
        t_trainable, t_opt, t_aux = t_step(t_trainable, t_opt, tt, tc_, trope,
                                           torch.tensor(sigma), torch.tensor(noise), tbias)
        t_ema = t_ema_upd(t_ema, t_trainable)
        assert_rel(t_aux["loss"].reshape(1), np.asarray([aux["loss"]]), 1e-4, f"loss {i}")
        assert_rel(t_aux["grad_norm"].reshape(1), np.asarray([aux["grad_norm"]]), 1e-4,
                   f"grad_norm {i}")
    for got, want, what in ((t_trainable, trainable, "params"), (t_ema, ema, "ema")):
        got, want = checkpoint.flatten_params(got, ""), _stacked(want)
        assert sorted(got) == sorted(want)
        for k in want:
            assert_rel(got[k], want[k], 1e-4, f"{what} {k} after 6 steps")
    assert int(t_opt["gradient_step"]) == 3 and int(t_opt["inner"]["count"]) == 3


# an activation whose x / s lies within this many code steps of k + 1/2 sits
# at a rounding tie: f32 sums taken in another order (an ulp, 7.6e-6 of a
# step at |x / s| = 127) may round it either way
TIE = 2.0**-10


def _recording_act_quantization(record: dict):
    """The reference's quantize_act_int8, handing every call's codes to
    `record` (its trace-time call index -> the codes of each execution, in
    order: a scanned block body is traced once and run once a block)."""
    from ltx_tpu.kernels import quantization as jq

    original, count = jq.quantize_act_int8, iter(range(1 << 30))

    def quantize(x):
        x8, sx = original(x)
        i = next(count)
        jax.debug.callback(lambda q, i=i: record.setdefault(i, []).append(np.asarray(q)), x8)
        return x8, sx

    return quantize


def test_qlora_steps_over_a_w8a8_base_match_reference(monkeypatch):
    """The reference's test_qlora_over_w8a8_base, on both sides: every block
    linear W8A8 (the size gate lowered), rank-4 LoRA, 3 float32 steps fed
    the reference's draws through the int8 straight-through backward; the
    losses and gradient norms within 1e-4, the LoRA leaves within 2**-7,
    the int8 base unchanged.

    An activation at a rounding tie (x / s within 2**-10 of a step of k +
    1/2) rounds either way when the two frameworks' f32 sums differ by an
    ulp, and one such flipped code moves the loss by 1.4e-4 to 6.2e-4
    relative (block 0's attention input, 7.6e-6 of a step from its tie:
    4.8e-4 on the loss of step 0). So the test records the reference's
    codes (a debug callback on its quantize_act_int8) and holds the port's
    own codes equal to them, call for call, except at ties, where they may
    differ by one; the port's step then runs on the reference's codes and
    is held to 1e-4 as before. A wrong scale changes the codes away from any
    tie, and a dropped LoRA moves the losses, gradient norms and leaves.
    The leaves' bound is one int8 step of an activation row (1/127), as
    before. Adam's eps is 1e-3, for test_train_steps_match_reference's
    reason."""
    from ltx_tpu.kernels import quantization as jq

    from ltx_tpu_torch.kernels import quantization as qz
    from ltx_tpu_torch.models.common import W8A8Linear

    monkeypatch.setattr(jq, "_MIN_QUANT_SIZE", 1)
    record = {}
    monkeypatch.setattr(jq, "quantize_act_int8", _recording_act_quantization(record))
    tree = jq.quantize_transformer_params(jax.tree.map(jnp.asarray, _params(jnp.float32)), 8,
                                          w8a8=True)
    tree = jax.tree.map(np.asarray, jlora.add_lora(tree, jax.random.key(3), rank=RANK))
    batch = _batch()
    tokens, context, mask, rope = batch
    jtc = jstep.TrainConfig(learning_rate=1e-3, lora_only=True, remat=False, eps=1e-3,
                            compute_dtype=jnp.float32)
    trainable, frozen, opt_state = jstep.init_train_state(jax.tree.map(jnp.asarray, tree), jtc)
    jstep_fn = jstep.make_train_step(JCFG, jtc, donate=False)

    model = convert.transformer(tree, CFG)
    assert sum(isinstance(m, W8A8Linear) for m in model.modules()) == 10 * CFG.num_layers
    base = {n: p.clone() for n, p in model.named_parameters() if n.endswith(".w8")}
    tc = step.TrainConfig(learning_rate=1e-3, lora_only=True, remat=False, eps=1e-3,
                          compute_dtype=torch.float32)
    t_trainable, _, t_opt = step.init_train_state(model, tc)
    t_step = step.make_train_step(model, tc)
    tt, tc_, trope, tbias = _torch_batch(batch)

    own = qz.quantize_act_int8
    seen = {"calls": 0, "ties": 0}

    def on_the_references_codes(x):
        """The port's codes against the reference's call of the same block
        and input (the reference's trace order need not be the port's call
        order; to_k and to_v quantize the same context alike)."""
        x8, sx = own(x)
        r = (x.detach() / sx).float()
        tie = ((r - torch.floor(r)) - 0.5).abs() < TIE
        pending = queue[seen["step_calls"] // 10]
        for j, want in enumerate(pending):
            want = torch.from_numpy(np.array(want))
            if want.shape != x8.shape:
                continue
            diff = x8.int() - want.int()
            if diff.abs().max() <= 1 and not diff[~tie].any():
                pending.pop(j)
                seen["calls"] += 1
                seen["step_calls"] += 1
                seen["ties"] += int((diff != 0).sum())
                return want, sx
        raise AssertionError(f"activation call {seen['step_calls']}: no call of the "
                             "reference's has these codes but at rounding ties")

    monkeypatch.setattr(qz, "quantize_act_int8", on_the_references_codes)
    for i in range(3):
        sub = jax.random.key(100 + i)
        record.clear()
        trainable, opt_state, aux = jstep_fn(
            trainable, frozen, opt_state, jnp.asarray(tokens), jnp.asarray(context),
            tuple(map(jnp.asarray, rope)), sub, context_bias=j_mask(jnp.asarray(mask)))
        jax.block_until_ready(aux["loss"])
        # each block's ten calls, the scanned body's executions in block order
        assert all(len(v) == CFG.num_layers for v in record.values()) and len(record) == 10
        queue = [[record[k][b] for k in sorted(record)] for b in range(CFG.num_layers)]
        seen["step_calls"] = 0
        sigma, noise = _draws(sub, tokens.shape)
        t_trainable, t_opt, t_aux = t_step(t_trainable, t_opt, tt, tc_, trope,
                                           torch.tensor(sigma), torch.tensor(noise), tbias)
        assert not any(queue), "reference activation calls the port did not make"
        assert_rel(t_aux["loss"].reshape(1), np.asarray([aux["loss"]]), 1e-4, f"W8A8 loss {i}")
        assert_rel(t_aux["grad_norm"].reshape(1), np.asarray([aux["grad_norm"]]), 1e-4,
                   f"W8A8 grad_norm {i}")
    print(f"[parity] W8A8 QLoRA: {seen['calls']} activation quantizations, {seen['ties']} "
          "codes on the other side of a rounding tie from the reference's")
    got, want = checkpoint.flatten_params(t_trainable, ""), _stacked(trainable)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_rel(got[k], want[k], 2**-7, f"W8A8 QLoRA {k} after 3 steps")
    assert all(torch.equal(p, base[n]) for n, p in model.named_parameters() if n in base)


@pytest.mark.parametrize("kw", [
    dict(weight_decay=0.05, warmup_steps=3),
    dict(grad_clip=0.5, b2=0.99),
    dict(accum_steps=2, warmup_steps=2, weight_decay=0.01),
], ids=["decay_warmup", "clip", "accum"])
def test_optimizer_matches_optax(kw):
    """make_optimizer against the reference's optax chain over 6 updates,
    weight decay judged on the reference's (stacked) shapes: a block's 1-D
    bias is 2-D there and decays, a top-level 1-D bias does not."""
    rng = np.random.default_rng(3)
    shapes = {"blocks.0.lin.lora_a": (6, 3), "blocks.0.lin.lora_s": (),
              "blocks.0.lin.bias": (5,), "proj.bias": (5,), "proj.weight": (5, 6)}
    params = {n: torch.from_numpy(np.asarray(rng.standard_normal(s), np.float32))
              for n, s in shapes.items()}
    tc = step.TrainConfig(**kw)
    jtc = jstep.TrainConfig(**kw)
    tx, jtx = step.make_optimizer(tc), jstep.make_optimizer(jtc)

    def tree(d):
        t = {}
        for key, arr in checkpoint.flatten_params(d, "").items():
            node = t
            parts = key[2:-2].split("']['")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(arr)
        return t

    state, jstate, jparams = tx.init(params), jtx.init(tree(params)), tree(params)
    jupdate = jax.jit(jtx.update)
    for i in range(6):
        scale = 3.0 if i % 2 else 0.05  # the clip triggers on odd updates
        grads = {n: torch.from_numpy(np.asarray(rng.standard_normal(s) * scale, np.float32))
                 for n, s in shapes.items()}
        updates, state = tx.update(grads, state, params)
        params = {n: p + updates[n] for n, p in params.items()}
        jupdates, jstate = jupdate(tree(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupdates)
        got, want = checkpoint.flatten_params(params, ""), _stacked(jparams)
        for k in want:
            assert_rel(got[k], want[k], 1e-6, f"optimizer {kw} {k} update {i}")


def _write_shards(root, n_shards=2, rows=5, s=16):
    rng = np.random.default_rng(0)
    f, h, w = GRID
    for i in range(n_shards):
        mask = np.ones((rows, s), np.int32)
        mask[:, :i + 3] = 0
        data.write_shard(root / f"shard{i}.npz",
                         rng.standard_normal((rows, f * h * w, 16)).astype(np.float16),
                         rng.standard_normal((rows, s, 48)).astype(np.float32), GRID, mask)


def test_datasets_give_identical_batches_and_resume(tmp_path):
    _write_shards(tmp_path)
    ours, ref = data.LatentShardDataset(tmp_path, 3, seed=4), jdata.LatentShardDataset(
        tmp_path, 3, seed=4)
    assert ours.grid == ref.grid and ours.num_rows == ref.num_rows
    for i in range(7):
        if i == 3:
            saved = ours.state()
        a, b = next(ours), next(ref)
        for field in ("tokens", "context", "mask"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    ours.restore(saved)
    ref2 = jdata.LatentShardDataset(tmp_path, 3, seed=4)
    for _ in range(3):
        next(ref2)
    for _ in range(4):
        np.testing.assert_array_equal(next(ours).tokens, next(ref2).tokens)
    # the device batches: pinned only on a card; the additive bias as the reference's
    it = data.prefetch_to_device(data.LatentShardDataset(tmp_path, 2, seed=1), 2, "cpu")
    batch = next(it)
    want = next(jdata.prefetch_to_device(jdata.LatentShardDataset(tmp_path, 2, seed=1), 2))
    for got, w in zip(batch[:3], want):
        np.testing.assert_array_equal(as_np(got), np.asarray(w, np.float32))
    assert batch.cursor["pos"] == 2


def test_checkpoint_resume_exact_and_reference_checkpoints_load(tmp_path):
    """The port's checkpoint restores bitwise into a template; the trainable
    part of a reference checkpoint loads here, and the port's trainable part
    loads in the reference; a mismatched template raises."""
    tree = _lora_tree(jnp.float32)
    model = convert.transformer(tree, CFG)
    tc = step.TrainConfig(lora_only=True, accum_steps=2)
    trainable, _, opt = step.init_train_state(model, tc)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for d in (opt["acc_grads"], opt["inner"]["mu"], opt["inner"]["nu"]):
            for t in d.values():
                t.copy_(torch.randn(t.shape, generator=gen))
    opt["inner"]["count"] = torch.tensor(7, dtype=torch.int32)
    path = tmp_path / "c.npz"
    checkpoint.save_train_checkpoint(path, trainable, opt, 9)
    saved = {n: t.clone() for n, t in trainable.items()}
    saved_mu = {n: t.clone() for n, t in opt["inner"]["mu"].items()}

    model2 = convert.transformer(_lora_tree(jnp.float32), CFG)
    with torch.no_grad():
        for p in model2.parameters():
            p.zero_()
    tr2, _, opt2 = step.init_train_state(model2, tc)
    tr2, opt2, step_n = checkpoint.load_train_checkpoint(path, tr2, opt2)
    assert step_n == 9 and int(opt2["inner"]["count"]) == 7
    assert all(torch.equal(tr2[n], saved[n]) for n in saved)
    assert all(torch.equal(opt2["inner"]["mu"][n], saved_mu[n]) for n in saved_mu)
    # the reference reads the port's trainable part
    jparams = jax.tree.map(jnp.asarray, tree)
    jtr, _ = jstep.partition_trainable(jparams, jstep.TrainConfig(lora_only=True))
    with np.load(path) as z:
        store = {k: z[k] for k in z.files}
    restored = jckpt._restore(jtr, store, "t")
    for k, v in _stacked(restored).items():
        np.testing.assert_array_equal(v, checkpoint.flatten_params(saved, "")[k])
    # the port reads a reference checkpoint's trainable part (the optimizer
    # state of another TrainConfig, MultiSteps here and not there, is a
    # template that does not match it; tests/test_torch_checkpoint.py resumes
    # a matching one, moments and all)
    jpath = tmp_path / "j.npz"
    jckpt.save_train_checkpoint(jpath, jtr, jstep.make_optimizer(
        jstep.TrainConfig(lora_only=True)).init(jtr), 3)
    tr3, _, s3 = checkpoint.load_train_checkpoint(jpath, tr2)
    assert s3 == 3
    for k, v in _stacked(jtr).items():
        np.testing.assert_array_equal(checkpoint.flatten_params(tr3, "")[k], v)
    with pytest.raises(KeyError):
        checkpoint.load_train_checkpoint(jpath, tr2, opt2)
    small, _, _ = step.init_train_state(lora.add_lora(
        convert.transformer(_params(jnp.float32), CFG), torch.Generator(), rank=2),
        step.TrainConfig(lora_only=True))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_train_checkpoint(path, small)


def test_export_equals_reference_and_fuses(tmp_path):
    tree = _lora_tree(jnp.float32)
    model = convert.transformer(tree, CFG)
    got = export.lora_state_dict(dict(model.named_parameters()))
    want = jexport.lora_state_dict(jax.tree.map(jnp.asarray, tree))
    assert sorted(got) == sorted(want) and len(got) == 3 * 10 * CFG.num_layers
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == np.shape(want[k]), k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    path = tmp_path / "a.safetensors"
    assert export.save_lora(dict(model.named_parameters()), path) == len(want)
    from safetensors.numpy import load_file
    loaded = load_file(str(path))
    assert sorted(loaded) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(loaded[k], got[k])
    np.testing.assert_array_equal(export.read_safetensors(path)[k], got[k])
    base = jax.tree.map(jnp.asarray, jlora.strip_lora(tree))
    jpath = tmp_path / "j.safetensors"
    jexport.save_lora(jax.tree.map(jnp.asarray, tree), jpath)
    fused, jfused = jfuse.fuse_lora_file(base, path), jfuse.fuse_lora_file(base, jpath)
    for (kp, a), b in zip(jax.tree_util.tree_leaves_with_path(fused),
                          jax.tree_util.tree_leaves(jfused)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(kp))


def test_add_strip_merge_and_convert():
    """add_lora's shapes and init, strip_lora, merge_lora against the
    reference's merge, and convert's strictness on LoRA leaves."""
    tree = _lora_tree(jnp.float32)
    model = convert.transformer(tree, CFG)
    mask = lora.lora_param_mask(model)
    assert sum(mask.values()) == 3 * 10 * CFG.num_layers
    merged = lora.merge_lora(convert.transformer(tree, CFG))
    want = convert.transformer(jax.tree.map(np.asarray, jlora.merge_lora(
        jax.tree.map(jnp.asarray, tree))), CFG)
    ref = dict(want.named_parameters())
    for n, p in merged.named_parameters():
        assert_rel(p, ref[n], 1e-6, f"merge_lora {n}")
    assert not any(lora.lora_param_mask(merged).values())

    fresh = lora.add_lora(convert.transformer(_params(jnp.float32), CFG),
                          torch.Generator().manual_seed(0), rank=8, alpha=4.0)
    to_q = fresh.blocks[0].attn1.to_q
    assert to_q.lora_a.shape == (CFG.inner_dim, 8) and to_q.lora_b.shape == (8, CFG.inner_dim)
    assert not to_q.lora_b.any() and float(to_q.lora_s.detach()) == 0.5
    lora.strip_lora(fresh)
    assert not any(lora.lora_param_mask(fresh).values())

    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["attn1"]["to_q"]["lora_b"] = bad["blocks"]["attn1"]["to_q"]["lora_b"][:, :2]
    with pytest.raises(ValueError, match="shape"):
        convert.transformer(bad, CFG)


def test_sample_sigmas_ranges():
    gen = torch.Generator().manual_seed(0)
    for scheme in ("uniform", "logit_normal"):
        s = sample_sigmas(gen, 512, scheme)
        assert s.dtype == torch.float32 and ((s > 0) & (s < 1)).all()
    with pytest.raises(ValueError):
        sample_sigmas(gen, 4, "nope")


def test_train_cli_cpu_and_resume(tmp_path):
    """The trainer on the CPU: 4 steps with checkpoints, then a resume leg
    to 6 steps, exports what an uninterrupted 6-step run exports, bit for
    bit; --quant w8a8 on the tiny base trains it unquantized, as the
    reference; a one-rank --mesh trains what the plain run trains, --sdpa
    ring without a mesh exits, and --weights reads the file it names."""
    shards = tmp_path / "shards"
    shards.mkdir()
    _write_shards(shards, n_shards=1, rows=3)
    common = ["--data", str(shards), "--random-init", "tiny", "--quant", "none",
              "--ckpt-every", "2", "--log-every", "2", "--device", "cpu"]
    assert cli.main(common + ["--out", str(tmp_path / "full.safetensors"), "--steps", "6"]) == 0
    ckpt = str(tmp_path / "c.npz")
    reports = []
    assert cli.main(common + ["--out", str(tmp_path / "a.safetensors"), "--steps", "4",
                              "--ckpt", ckpt]) == 0
    assert cli.main(common + ["--out", str(tmp_path / "b.safetensors"), "--steps", "6",
                              "--ckpt", ckpt, "--resume"], reports.append) == 0
    assert reports[0]["start"] == 4 and [r["step"] for r in reports[1:]] == [5, 6]
    full = export.read_safetensors(tmp_path / "full.safetensors")
    resumed = export.read_safetensors(tmp_path / "b.safetensors")
    assert len(full) == 3 * 10 * CFG.num_layers and sorted(full) == sorted(resumed)
    for k in full:
        np.testing.assert_array_equal(full[k], resumed[k])
    # --quant w8a8 (the default) with a tiny random base quantizes nothing,
    # the reference's rule: the run is the --quant none run
    assert cli.main(common + ["--out", str(tmp_path / "w.safetensors"), "--steps", "6",
                              "--quant", "w8a8"]) == 0
    w8a8 = export.read_safetensors(tmp_path / "w.safetensors")
    assert sorted(w8a8) == sorted(full) and all(np.array_equal(full[k], w8a8[k]) for k in full)
    # a one-rank mesh is the plain run, bit for bit; the ring needs a mesh
    # (multi-rank runs: tests/test_torch_parallel_pipeline.py)
    assert cli.main(common + ["--out", str(tmp_path / "m.safetensors"), "--steps", "6",
                              "--mesh", "1,1"]) == 0
    meshed = export.read_safetensors(tmp_path / "m.safetensors")
    assert sorted(meshed) == sorted(full) and all(np.array_equal(full[k], meshed[k])
                                                  for k in full)
    with pytest.raises(SystemExit, match="needs --mesh"):
        cli.main(common + ["--out", str(tmp_path / "x.safetensors"), "--steps", "1",
                           "--sdpa", "ring"])
    # --weights is ported (tests/test_torch_loader.py trains from a file)
    argv = [a for a in common if a not in ("--random-init", "tiny")]
    with pytest.raises(FileNotFoundError):
        cli.main(argv + ["--out", str(tmp_path / "x.safetensors"), "--steps", "1",
                         "--weights", str(tmp_path / "absent.safetensors")])
