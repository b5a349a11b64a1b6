"""Port parity: a training checkpoint written by either package resumes in
the other, optimizer moments and all (ltx_tpu_torch.train.checkpoint
against ltx_tpu.train.checkpoint), on the tiny LoRA DiT of
test_torch_train.py with the reference's own jax.random draws fed to both.

Tolerance: the step parity of test_torch_train.py, float32, 1e-4 relative
per leaf (the same math; sums in other orders). The stored key paths and
shapes are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.ops.attention import prepare_additive_mask as j_mask
from ltx_tpu.train import checkpoint as jckpt
from ltx_tpu.train import step as jstep
from ltx_tpu_torch import convert
from ltx_tpu_torch.train import checkpoint, step
from test_torch_train import CFG, JCFG, _batch, _draws, _lora_tree, _stacked, _torch_batch
from torch_parity import assert_rel
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

# a warmup (so the schedule's own count is in the state) and an Adam eps
# that keeps rounding-level gradients from moving (test_torch_train.py)
KW = dict(lora_only=True, warmup_steps=2, eps=1e-3, learning_rate=1e-2)
SAVED_AT = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three train steps in each package from the same tree, batch and
    draws, each saving a checkpoint after step 2: the paths, the trainable
    leaves after step 3, and what a resumed leg needs."""
    tmp = tmp_path_factory.mktemp("ckpt")
    tree = _lora_tree(jnp.float32)
    batch = _batch()
    tokens, context, mask, rope = batch
    jtc = jstep.TrainConfig(**KW, compute_dtype=jnp.float32, sdpa_impl="xla")
    jtrain, frozen, jopt = jstep.init_train_state(jax.tree.map(jnp.asarray, tree), jtc)
    jfn = jstep.make_train_step(JCFG, jtc, donate=False)
    key, keys = jax.random.key(5), []
    for _ in range(SAVED_AT + 1):
        key, sub = jax.random.split(key)
        keys.append(sub)

    def jax_step(trainable, opt, i):
        return jfn(trainable, frozen, opt, jnp.asarray(tokens), jnp.asarray(context),
                   tuple(map(jnp.asarray, rope)), keys[i],
                   context_bias=j_mask(jnp.asarray(mask)))[:2]

    tc = step.TrainConfig(**KW, compute_dtype=torch.float32)
    tt, tctx, trope, tbias = _torch_batch(batch)

    def port_step(fn, trainable, opt, i):
        sigma, noise = _draws(keys[i], tokens.shape)
        return fn(trainable, opt, tt, tctx, trope, torch.tensor(sigma), torch.tensor(noise),
                  tbias)[:2]

    jpath, ppath = tmp / "jax.npz", tmp / "port.npz"
    model = convert.transformer(tree, CFG)
    ptrain, _, popt = step.init_train_state(model, tc)
    pfn = step.make_train_step(model, tc)
    for i in range(SAVED_AT + 1):
        if i == SAVED_AT:
            jckpt.save_train_checkpoint(jpath, jtrain, jopt, SAVED_AT)
            checkpoint.save_train_checkpoint(ppath, ptrain, popt, SAVED_AT)
        jtrain, jopt = jax_step(jtrain, jopt, i)
        ptrain, popt = port_step(pfn, ptrain, popt, i)
    return dict(tree=tree, tc=tc, jtc=jtc, jax_step=jax_step, port_step=port_step,
                jpath=jpath, ppath=ppath, jax3=_stacked(jtrain),
                port3=checkpoint.flatten_params(ptrain, ""))


def test_reference_checkpoint_resumes_in_the_port(runs):
    """The reference's checkpoint after step 2 loads into the port's
    templates, moments and counts included, and the port's step 3 from it
    is the reference's step 3; from zero moments it is not."""
    model = convert.transformer(runs["tree"], CFG)
    trainable, _, opt = step.init_train_state(model, runs["tc"])
    fresh = {k: v.clone() for k, v in opt["mu"].items()}
    trainable, opt, start = checkpoint.load_train_checkpoint(runs["jpath"], trainable, opt)
    assert start == SAVED_AT and int(opt["count"]) == int(opt["schedule_count"]) == SAVED_AT
    assert any(not torch.equal(opt["mu"][k], fresh[k]) for k in fresh)
    trainable, opt = runs["port_step"](step.make_train_step(model, runs["tc"]), trainable, opt,
                                       SAVED_AT)
    got = checkpoint.flatten_params(trainable, "")
    assert sorted(got) == sorted(runs["jax3"])
    for k, want in runs["jax3"].items():
        assert_rel(got[k], want, 1e-4, f"port step {SAVED_AT + 1} from the reference's {k}")
    # the same step from the checkpoint's leaves but zero moments misses
    model = convert.transformer(runs["tree"], CFG)
    trainable, _, opt = step.init_train_state(model, runs["tc"])
    checkpoint.load_train_checkpoint(runs["jpath"], trainable)
    trainable, _ = runs["port_step"](step.make_train_step(model, runs["tc"]), trainable, opt,
                                     SAVED_AT)
    got = checkpoint.flatten_params(trainable, "")
    worst = max(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
                for k, w in runs["jax3"].items())
    assert worst > 1e-2, worst


def test_port_checkpoint_resumes_in_the_reference(runs):
    """The port's checkpoint after step 2 restores into the reference's
    templates (its `load_train_checkpoint`, optax's tree), and the
    reference's step 3 from it is the port's step 3."""
    jtrain, _, jopt = jstep.init_train_state(jax.tree.map(jnp.asarray, runs["tree"]),
                                             runs["jtc"])
    jtrain, jopt, start = jckpt.load_train_checkpoint(runs["ppath"], jtrain, jopt)
    assert start == SAVED_AT
    jtrain, _ = runs["jax_step"](jtrain, jopt, SAVED_AT)
    want = _stacked(jtrain)
    assert sorted(want) == sorted(runs["port3"])
    for k, w in want.items():
        assert_rel(runs["port3"][k], w, 1e-4, f"reference step {SAVED_AT + 1} from the port's {k}")


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=3), dict(accum_steps=2),
                                dict(accum_steps=2, warmup_steps=2, weight_decay=0.1)],
                         ids=["adamw", "warmup", "accum", "accum_warmup_decay"])
def test_checkpoints_store_the_same_keys(tmp_path, kw):
    """For each optimizer the reference builds (a schedule or not,
    MultiSteps or not), both packages store the same key paths, shapes and
    dtypes."""
    tree = _lora_tree(jnp.float32)
    kw = dict(kw, lora_only=True)
    trainable, _, opt = step.init_train_state(convert.transformer(tree, CFG),
                                              step.TrainConfig(**kw))
    jtrain, _, jopt = jstep.init_train_state(jax.tree.map(jnp.asarray, tree),
                                             jstep.TrainConfig(**kw))
    for write, args, path in ((checkpoint.save_train_checkpoint, (trainable, opt), "p.npz"),
                              (jckpt.save_train_checkpoint, (jtrain, jopt), "j.npz")):
        write(tmp_path / path, *args, 1)
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert {k: (p[k].shape, p[k].dtype) for k in p.files} == \
            {k: (j[k].shape, j[k].dtype) for k in j.files}
