"""Port parity: the parallel pipeline, trainer and CLIs on a gloo world of 4.

The port's ranks (`torch_parallel_cases.mesh_cases`) run on a (2, 2) mesh,
the reference's 2x4 cases run as 2x2, and on a (1, 4) mesh for the ring:

* `pipe.shard(make_mesh(2, 2))` and a tiny `generate_video` (TP over the
  model axis, the 2 latent frames decoded one a rank) against the
  reference's `shard(make_mesh(2, 2))` run on 4 of the conftest's CPU
  devices, its own sharded decode included (its shard_map jitted), frames within
  2e-2 (one guidance row: the tiny T2V test's bound; test_tp_quant.py's
  end-to-end bound is 3e-2);
* the dp+tp LoRA train step (each data rank its 2 of the 4 rows) against
  the reference's step on the whole batch, loss rtol 1e-4
  (test_train.py::test_train_step_dp_tp_mesh), grad norm too;
* the sequence-parallel ring train step over 4 ranks, and the same with
  the model sharded over heads on that axis (its attentions on local heads,
  no ring), against the reference's plain step, loss rtol 1e-4 and grad
  norm rtol 1e-3 (test_train_step_sp_ring_matches_xla);
* `train --mesh 2,2` end to end with a checkpoint and a resume that re-shards
  it (the resumed step bit for bit the uninterrupted one), and a guided
  `generate --mesh 2,2 -g 3` (its two guidance rows split over the data
  axis, its 2 latent frames decoded one a rank) against the single-process
  CLI run of the same seed, frames within 2e-2 (the same arithmetic but
  the sums' order and the decode's tiles).

Every replicated output is bit for bit the same on all four ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_tpu.core import config as jconfig
from ltx_tpu.models import dit as jdit
from ltx_tpu.models import vae as jvae
from ltx_tpu.ops import rope as jrope
from ltx_tpu.parallel import sharding as jsh
from ltx_tpu.train import flow_match as jfm
from ltx_tpu.train import lora as jlora
from ltx_tpu.train import step as jstep
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import GenerationConfig, TransformerConfig
from ltx_tpu_torch.pipeline import generate
from ltx_tpu_torch.train import data
import torch_parallel_cases as cases
from torch_dist import run_world
from torch_parity import jax_normal, jitted_shard_map, video_keys
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CFG = TransformerConfig().tiny()
JCFG = convert.port_config(CFG, jconfig.TransformerConfig)


def _lora_tree(key):
    """The reference's tiny f32 DiT with rank-4 LoRA leaves, lora_b redrawn
    nonzero so that every LoRA leaf gets a gradient; numpy leaves."""
    tree = jlora.add_lora(jdit.init_params(jax.random.key(key), JCFG, jnp.float32),
                          jax.random.key(key + 1), rank=4)
    rng = np.random.default_rng(key)

    def bump(t):
        return {k: bump(v) if isinstance(v, dict) else (
            (rng.standard_normal(np.shape(v)) * 0.05).astype(np.float32)
            if k == "lora_b" else np.asarray(v)) for k, v in t.items()}

    return bump(tree)


def _reference_step(tree, tokens, ctx, rope, key, **kw):
    tc = jstep.TrainConfig(learning_rate=1e-3, lora_only=True, remat=True,
                           compute_dtype=jnp.float32, **kw)
    t, f, o = jstep.init_train_state(jax.tree.map(jnp.asarray, tree), tc)
    _, _, aux = jstep.make_train_step(JCFG, tc, donate=False)(
        t, f, o, jnp.asarray(tokens), jnp.asarray(ctx), tuple(map(jnp.asarray, rope)), key)
    return float(aux["loss"]), float(aux["grad_norm"])


def _reference_pipeline():
    """The reference's tiny T2V pipeline (its random_tiny configs), weights
    from jitted inits: any weights do, both sides load the same trees."""
    from ltx_tpu.models import gemma3 as jgemma
    from ltx_tpu.models import text_encoder as jte
    from ltx_tpu.pipeline.generate import LTXPipeline as JaxPipeline

    tcfg, vcfg, gcfg, tecfg = generate.tiny_configs()
    jt = convert.port_config(tcfg, jconfig.TransformerConfig)
    jv = convert.port_config(vcfg, jvae.VAEConfig)
    jgc = convert.port_config(gcfg, jgemma.Gemma3Config)
    jtec = convert.port_config(tecfg, jte.TextEncoderConfig)
    ks = jax.random.split(jax.random.key(0), 4)

    def init(fn, key, *static):
        return jax.jit(fn, static_argnums=tuple(range(1, 1 + len(static))))(key, *static)

    return JaxPipeline(
        transformer_params=init(jdit.init_params, ks[0], jt, jnp.bfloat16),
        transformer_config=jt,
        vae_decoder_params=init(jvae.init_decoder_params, ks[1], jv), vae_config=jv,
        gemma_params=init(jgemma.init_params, ks[2], jgc, jnp.bfloat16), gemma_config=jgc,
        text_encoder_params=init(jte.init_params, ks[3], jtec, jnp.bfloat16),
        text_encoder_config=jtec, memory=jconfig.MemoryConfig(offload_text_encoder=False))


def _draws(key, shape):
    k_sigma, k_noise = jax.random.split(key)
    return (np.asarray(jfm.sample_sigmas(k_sigma, shape[0], "logit_normal")),
            np.asarray(jax.random.normal(k_noise, shape, jnp.float32)))


def _write_shards(root):
    rng = np.random.default_rng(0)
    for i in range(2):
        mask = np.ones((6, 16), np.int32)
        mask[:, :i + 3] = 0
        data.write_shard(root / f"shard{i}.npz",
                         rng.standard_normal((6, 12, 16)).astype(np.float16),
                         rng.standard_normal((6, 16, 48)).astype(np.float32), (2, 2, 3), mask)


@pytest.fixture(scope="module")
def plan_and_ref(tmp_path_factory):
    rng = np.random.default_rng(0)
    plan, ref = {}, {}
    root = tmp_path_factory.mktemp("mesh")

    # the tiny pipeline, sharded 2 x 2 on both sides
    jpipe = _reference_pipeline()
    config = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=1)
    shape = (1, CFG.in_channels, 2, 2, 2)
    plan["pipe_noise"] = jax_normal(video_keys(config.seed)[0], shape).numpy()
    plan["pipe_config"] = config
    plan["pipe_trees"] = {name: jax.tree.map(np.asarray, getattr(jpipe, name + "_params"))
                          for name in ("transformer", "vae_decoder", "gemma", "text_encoder")}
    tcfg, vcfg, gcfg, tecfg = generate.tiny_configs()
    plan["pipe_cfgs"] = {"transformer": tcfg, "vae": vcfg, "gemma": gcfg,
                         "text_encoder": tecfg}
    jpipe.shard(jsh.make_mesh(data=2, model=2, devices=jax.devices()[:4]))
    try:
        with jitted_shard_map():
            ref["pipe_frames"] = np.asarray(jpipe.generate_video(
                "a cat", convert.port_config(config, jconfig.GenerationConfig)).frames,
                np.float32)
    finally:
        from ltx_tpu.kernels.quantization import set_tensor_parallel

        set_tensor_parallel(False)

    # dp + tp: 4 rows of a 16-token grid, the reference's step on all 4
    f, h, w = 2, 2, 4
    cos, sin = jrope.video_rope(f, h, w, CFG.inner_dim, CFG.num_heads)
    plan["train_cfg"], plan["train_rope"] = CFG, (np.asarray(cos), np.asarray(sin))
    plan["train_tree"] = _lora_tree(3)
    tokens = rng.standard_normal((4, f * h * w, CFG.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((4, 8, CFG.caption_channels)).astype(np.float32)
    key = jax.random.key(7)
    plan["train_tokens"], plan["train_ctx"] = tokens, ctx
    plan["train_sigma"], plan["train_noise"] = _draws(key, tokens.shape)
    ref["dp_tp"] = _reference_step(plan["train_tree"], tokens, ctx, plan["train_rope"], key)

    # the ring: 2 rows, 16 tokens over 4 ranks; the reference's plain step
    plan["ring_tree"] = _lora_tree(5)
    plan["ring_tokens"], plan["ring_ctx"] = tokens[:2], ctx[:2]
    plan["ring_rope"] = plan["train_rope"]
    key = jax.random.key(8)
    plan["ring_sigma"], plan["ring_noise"] = _draws(key, tokens[:2].shape)
    ref["ring"] = _reference_step(plan["ring_tree"], tokens[:2], ctx[:2], plan["ring_rope"], key,
                                  sdpa_impl="xla")

    # the CLIs
    shards = root / "shards"
    shards.mkdir()
    _write_shards(shards)
    plan["shards"] = str(shards)
    plan["cli_out"] = str(root / "adapter.safetensors")
    plan["cli_ckpt"] = str(root / "ckpt.npz")
    plan["gen_out"] = str(root / "out.mp4")
    return plan, ref


@pytest.fixture(scope="module")
def ranks(plan_and_ref, tmp_path_factory):
    return run_world(cases.mesh_cases, 4, tmp_path_factory.mktemp("gloo"), plan_and_ref[0],
                     timeout=400)


def _same_on_ranks(ranks, key):
    for r in ranks[1:]:
        a, b = ranks[0][key], r[key]
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{key} {k}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)


def test_pipe_shard_generate_matches_reference(plan_and_ref, ranks):
    _, ref = plan_and_ref
    for r in ranks:
        assert r["pipe_tp"] == (CFG.num_heads // 2, 1)
        print(f"[parity] pipe.shard generate_video frames: max abs "
              f"{np.abs(r['pipe_frames'] - ref['pipe_frames']).max():.3e}")
        np.testing.assert_allclose(r["pipe_frames"], ref["pipe_frames"], atol=2e-2)
    _same_on_ranks(ranks, "pipe_frames")


def test_dp_tp_train_step_matches_reference(plan_and_ref, ranks):
    _, ref = plan_and_ref
    for r in ranks:
        print(f"[parity] dp+tp step loss, grad norm: {r['dp_tp']} against {ref['dp_tp']}")
        np.testing.assert_allclose(r["dp_tp"][0], ref["dp_tp"][0], rtol=1e-4)
        np.testing.assert_allclose(r["dp_tp"][1], ref["dp_tp"][1], rtol=1e-3)
    _same_on_ranks(ranks, "dp_tp")
    _same_on_ranks(ranks, "dp_tp_adapter")


def test_ring_train_step_matches_reference(plan_and_ref, ranks):
    _, ref = plan_and_ref
    for r in ranks:
        for key in ("ring", "tp_ring"):
            print(f"[parity] {key} step loss, grad norm: {r[key]} against {ref['ring']}")
            np.testing.assert_allclose(r[key][0], ref["ring"][0], rtol=1e-4, err_msg=key)
            np.testing.assert_allclose(r[key][1], ref["ring"][1], rtol=1e-3, err_msg=key)
        # the replicated model rings its self-attentions; the sharded one does not
        assert r["ring_hops"] > 0 and r["tp_ring_hops"] == 0
    _same_on_ranks(ranks, "ring")
    _same_on_ranks(ranks, "tp_ring")


def test_train_cli_mesh_checkpoint_and_resume(ranks):
    """3 steps on a 2 x 2 mesh with a checkpoint at step 2, then a resume
    from it: the resumed step 3 is the uninterrupted step 3, bit for bit,
    and the adapter rank 0 writes holds every LoRA leaf whole."""
    r0 = ranks[0]
    assert len(r0["cli_losses"]) == 3 and np.isfinite(r0["cli_losses"]).all()
    assert r0["cli_resume_start"] == 2 and r0["cli_resumed"] == r0["cli_losses"][2:]
    assert len(r0["cli_adapter"]) == 3 * 10 * CFG.num_layers
    _same_on_ranks(ranks, "cli_losses")
    _same_on_ranks(ranks, "cli_resumed")


def test_generate_cli_mesh_matches_single_process(plan_and_ref, ranks, monkeypatch):
    from ltx_tpu_torch.config import MemoryConfig
    from ltx_tpu_torch.io import cli as gcli
    from ltx_tpu_torch.io import video
    from ltx_tpu_torch.pipeline.generate import LTXPipeline

    pipe = LTXPipeline.random_tiny(device="cpu", seed=0,
                                   memory=MemoryConfig(offload_text_encoder=False))
    monkeypatch.setattr("ltx_tpu_torch.pipeline.loader.load_pipeline", lambda **kw: pipe)
    frames = {}
    monkeypatch.setattr(video, "export_video",
                        lambda f, path, **kw: frames.setdefault("f", np.asarray(f)))
    assert gcli.main(["generate", "a cat", "-w", "64", "-H", "64", "-f", "9", "-s", "2",
                      "-g", "3", "--seed", "5", "-o", plan_and_ref[0]["gen_out"],
                      "--device", "cpu"]) == 0
    r0 = ranks[0]
    assert r0["gen_rc"] == 0 and r0["gen_sharded"]
    # the two guidance rows, one a data rank
    assert [r["gen_data_rows"] for r in ranks] == [(0, 1), (0, 1), (1, 2), (1, 2)]
    print(f"[parity] generate --mesh 2,2 frames: max abs "
          f"{np.abs(r0['gen_frames'] - frames['f']).max():.3e}")
    np.testing.assert_allclose(r0["gen_frames"], frames["f"], atol=2e-2)
    assert all(r["gen_rc"] == 0 and r["gen_frames"] is None for r in ranks[1:])
