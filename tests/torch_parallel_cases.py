"""The rank side of the port's parallel parity tests (jax-free).

Each function runs on every rank of a gloo world (`torch_dist.run_world`),
takes the inputs the test module made with numpy (the reference's
parameter trees among them) and returns numpy outputs, so that the test
module can hold them against the reference's and against each other rank's.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# World of 2: a (1, 2) mesh
# ---------------------------------------------------------------------------


def _ring(plan, mesh, col):
    from ltx_tpu_torch.ops.attention import sdpa, set_sequence_parallel
    from ltx_tpu_torch.parallel.ring_attention import sequence_parallel_sdpa

    out = {}
    q, k, v = (_t(plan[n]) for n in ("q", "k", "v"))
    out["ring"] = _np(sequence_parallel_sdpa(q, k, v, mesh))
    out["ring_bias"] = _np(sequence_parallel_sdpa(q, k, v, mesh, bias=_t(plan["bias"])))
    set_sequence_parallel(mesh)
    try:
        qp, kp, vp = (_t(plan[n]) for n in ("qp", "kp", "vp"))
        bias4 = _t(plan["biasp"])[:, None, None, :]
        out["ring_pad"] = _np(sdpa(qp, kp, vp, bias=bias4, impl="ring"))
    finally:
        set_sequence_parallel(None)
    for name, bias in (("grads", None), ("grads_bias", _t(plan["bias"]))):
        q, k, v = (_t(plan[n]).requires_grad_(True) for n in ("q", "k", "v"))
        col.reset_counts()
        o = sequence_parallel_sdpa(q, k, v, mesh, bias=bias)
        (o * _t(plan["w"])).sum().backward()
        out[name] = [_np(q.grad), _np(k.grad), _np(v.grad)]
        out[name + "_counts"] = dict(col.counts)
    return out


def _dit(plan, mesh, col, sharding):
    from ltx_tpu_torch import convert

    out = {}
    rope = tuple(_t(a) for a in plan["dit_rope"])
    for name, dtype in (("dit_f32", torch.float32), ("dit_bf16", torch.bfloat16)):
        model = convert.transformer(plan[name + "_tree"], plan["dit_cfg"])
        sharding.shard_transformer(model, mesh)
        col.reset_counts()
        sharding.sharded_rms_norm.calls = 0
        with torch.no_grad():
            vel = model(_t(plan["dit_x"], dtype), _t(plan["dit_ctx"], dtype),
                        _t(plan["dit_t"]), rope)
        out[name] = _np(vel)
        out[name + "_counts"] = (dict(col.counts), sharding.sharded_rms_norm.calls)
    model = convert.transformer(plan["dit_int4_tree"], plan["dit_int4_cfg"])
    args = (_t(plan["dit_int4_x"], torch.bfloat16), _t(plan["dit_int4_ctx"], torch.bfloat16),
            _t(plan["dit_t"][:1]), tuple(_t(a) for a in plan["dit_int4_rope"]))
    with torch.no_grad():
        out["dit_int4_whole"] = _np(model(*args))
        sharding.shard_transformer(model, mesh)
        out["dit_int4"] = _np(model(*args))
    out["dit_int4_shards"] = tuple(model.blocks[0].attn1.to_out.w_q4.shape)
    return out


def _av(plan, mesh, sharding):
    from ltx_tpu_torch import convert

    model = convert.av_transformer(plan["av_tree"], plan["av_cfg"])
    sharding.shard_transformer(model, mesh)
    ropes = tuple(tuple(_t(a) for a in pair) for pair in plan["av_ropes"])
    with torch.no_grad():
        bf = torch.bfloat16
        v, a = model(_t(plan["av_v"], bf), _t(plan["av_a"], bf), _t(plan["av_ctx"], bf),
                     _t(plan["av_ctx"], bf), _t(plan["av_t"]), _t(plan["av_t"]), ropes)
    return {"av": [_np(v), _np(a)]}


def _gemma(plan, mesh, sharding):
    from ltx_tpu_torch import convert
    from ltx_tpu_torch.models import gemma3

    out = {}
    ids = torch.from_numpy(plan["g_ids"]).long()
    mask = torch.from_numpy(plan["g_mask"]).long()
    for name in ("gemma", "gemma_w8a8"):
        model = convert.gemma(plan[name + "_tree"], plan["g_cfg"])
        sharding.shard_gemma(model, mesh)
        with torch.no_grad():
            out[name] = _np(model.forward_hidden_states(ids, mask))
    model = convert.gemma(plan["gemma_tree"], plan["g_cfg"])
    sharding.shard_gemma(model, mesh)
    out["kv_heads_local"] = model.layers[0].n_kv
    with torch.no_grad():
        out["decode"] = gemma3.generate_tokens(
            model, plan["g_prompt"], max_new_tokens=16, temperature=0.0, stop_tokens=(),
            mesh=mesh)
        out["decode_spec"] = gemma3.generate_tokens(
            model, plan["g_prompt"], max_new_tokens=16, temperature=0.0, stop_tokens=(),
            spec_k=4, mesh=mesh)
        out["decode_short"] = gemma3.generate_tokens(
            model, plan["g_prompt"][:5], max_new_tokens=8, temperature=0.0, stop_tokens=(),
            mesh=mesh)
        out["decode_batched"] = gemma3.generate_tokens_batched(
            model, [plan["g_prompt"], plan["g_prompt"][:5]], max_new_tokens=8,
            temperature=0.0, stop_tokens=(), mesh=mesh)
    model = convert.gemma(plan["gemma_w8a8_tree"], plan["g_cfg"])
    sharding.shard_gemma(model, mesh)
    with torch.no_grad():
        out["decode_w8a8"] = gemma3.generate_tokens(
            model, plan["g_prompt"], max_new_tokens=12, temperature=0.0, stop_tokens=(),
            mesh=mesh)
    return out


def _sp_denoise(plan, mesh):
    from ltx_tpu_torch import convert
    from ltx_tpu_torch.ops.attention import set_sequence_parallel
    from ltx_tpu_torch.pipeline import denoise

    out = {}
    g = plan["sp_guidance"]
    set_sequence_parallel(mesh)
    try:
        model = convert.transformer(plan["sp_tree"], plan["dit_cfg"])
        step = denoise.make_denoise_step(model, g, plan["sp_shape"], _t(plan["sp_ctx"]), None,
                                         sdpa_impl="ring")
        lat = _t(plan["sp_latent"])
        with torch.no_grad():
            new, vel = step(lat, 0.9, 0.5, torch.zeros_like(lat))
        out["sp"] = [_np(new), _np(vel)]
        av = convert.av_transformer(plan["av_tree"], plan["av_cfg"])
        step = denoise.make_av_denoise_step(av, g, plan["sp_shape"], plan["sp_audio_frames"],
                                            _t(plan["sp_av_ctx"]), _t(plan["sp_av_ctx"]), None,
                                            sdpa_impl="ring")
        with torch.no_grad():
            v, a = step(_t(plan["sp_latent"]), _t(plan["sp_audio"]), 0.9, 0.5)
        out["sp_av"] = [_np(v), _np(a)]
    finally:
        set_sequence_parallel(None)
    return out


def _vae(plan, mesh):
    from ltx_tpu_torch import convert
    from ltx_tpu_torch.models import vae

    out = {}
    dec = convert.vae_decoder(plan["vae_tree"], plan["vae_cfg"])
    with torch.no_grad():
        for name, latent, ov, transfer in (
                ("vae_ov1", "vae_latent", 1, False), ("vae_ov2", "vae_latent", 2, False),
                ("vae_u8", "vae_latent", 2, True), ("vae_yuv", "vae_latent", 2, "yuv420"),
                ("vae_f12", "vae_latent12", 2, False)):
            lat = _t(plan[latent])
            out[name] = vae.decode_video_sharded(dec, lat, mesh, timestep=None, tile_overlap=ov,
                                                 transfer_uint8=transfer)
            if rank_is_zero(mesh) and not transfer:  # the tiled decode of the padded latent
                f = lat.shape[2]
                stride, ov_ = vae.sharded_tiles(f, 2, ov)
                pad = torch.cat([lat, lat[:, :, -1:].expand(-1, -1, 2 * stride + ov_ - f, -1,
                                                            -1)], dim=2)
                tiled = vae.decode_video(dec, pad, timestep=None, tile_size=stride + ov_,
                                         tile_overlap=ov_, transfer_uint8=transfer)
                out[name + "_tiled"] = tiled[:8 * (f - 1) + 1]
        tdec = convert.vae_decoder(plan["vae_ts_tree"], plan["vae_ts_cfg"])
        lat = _t(plan["vae_latent"])
        stride, ov = vae.sharded_tiles(lat.shape[2], 2, 2)
        noise = [_t(n) for n in plan["vae_noise"]]
        out["vae_noise"] = vae.decode_video_sharded(tdec, lat, mesh, timestep=0.05, noise=noise,
                                                    tile_overlap=2)
        if rank_is_zero(mesh):
            pad = torch.cat([lat, lat[:, :, -1:].expand(-1, -1, 2 * stride + ov - 7, -1, -1)],
                            dim=2)
            out["vae_noise_tiled"] = vae.decode_video(tdec, pad, timestep=0.05, noise=noise,
                                                      tile_size=stride + ov,
                                                      tile_overlap=ov)[:49]
    return out


def rank_is_zero(mesh) -> bool:
    return mesh.index("model") == 0


def core_cases(rank: int, plan: dict) -> dict:
    """The ring, sequence-parallel and sharded-decode cases on a (1, 2) mesh."""
    from ltx_tpu_torch.parallel import collectives as col
    from ltx_tpu_torch.parallel import runtime

    mesh = runtime.make_mesh(1, 2)
    out = {"rank": rank, "mesh": mesh.ranks.tolist()}
    out.update(_ring(plan, mesh, col))
    out.update(_sp_denoise(plan, mesh))
    out.update(_vae(plan, mesh))
    return out


def tp_cases(rank: int, plan: dict) -> dict:
    """The tensor-parallel DiT, dual DiT and Gemma cases on a (1, 2) mesh."""
    from ltx_tpu_torch.parallel import collectives as col
    from ltx_tpu_torch.parallel import runtime, sharding

    mesh = runtime.make_mesh(1, 2)
    out = {"rank": rank}
    out.update(_dit(plan, mesh, col, sharding))
    out.update(_av(plan, mesh, sharding))
    out.update(_gemma(plan, mesh, sharding))
    return out


# ---------------------------------------------------------------------------
# World of 4: (2, 2) and (1, 4) meshes
# ---------------------------------------------------------------------------


def _pipeline(plan, mesh):
    from ltx_tpu_torch import convert
    from ltx_tpu_torch.config import MemoryConfig
    from ltx_tpu_torch.pipeline.generate import LTXPipeline

    trees, cfgs = plan["pipe_trees"], plan["pipe_cfgs"]
    pipe = LTXPipeline(
        transformer=convert.transformer(trees["transformer"], cfgs["transformer"]),
        vae_decoder=convert.vae_decoder(trees["vae_decoder"], cfgs["vae"]),
        gemma=convert.gemma(trees["gemma"], cfgs["gemma"]),
        text_encoder=convert.text_encoder(trees["text_encoder"], cfgs["text_encoder"]),
        memory=MemoryConfig(offload_text_encoder=False), device="cpu")
    pipe.shard(mesh)
    res = pipe.generate_video("a cat", plan["pipe_config"], _t(plan["pipe_noise"]))
    return {"pipe_frames": np.asarray(res.frames, np.float32),
            "pipe_tp": (pipe.transformer.blocks[0].attn1.num_heads,
                        pipe.gemma.layers[0].n_kv)}


def _train(plan, mesh, ring_mesh):
    from ltx_tpu_torch import convert
    from ltx_tpu_torch.ops.attention import set_sequence_parallel
    from ltx_tpu_torch.parallel import collectives as col
    from ltx_tpu_torch.parallel import sharding
    from ltx_tpu_torch.train import step as tstep

    out = {}
    cfg = plan["train_cfg"]
    rope = tuple(_t(a) for a in plan["train_rope"])
    tc = tstep.TrainConfig(learning_rate=1e-3, lora_only=True, remat=True,
                           compute_dtype=torch.float32)
    # dp + tp: this rank's data rows, the params by the inference rules
    model = convert.transformer(plan["train_tree"], cfg)
    sharding.shard_transformer(model, mesh)
    rows = slice(mesh.index("data") * 2, mesh.index("data") * 2 + 2)
    trainable, _, opt = tstep.init_train_state(model, tc)
    fn = tstep.make_train_step(model, tc)
    trainable, opt, aux = fn(trainable, opt, _t(plan["train_tokens"])[rows],
                             _t(plan["train_ctx"])[rows], rope, _t(plan["train_sigma"])[rows],
                             _t(plan["train_noise"])[rows])
    out["dp_tp"] = (float(aux["loss"]), float(aux["grad_norm"]))
    full = sharding.gather_params(trainable, model)
    out["dp_tp_adapter"] = {n: _np(full[n]) for n in sorted(full)[:6]}
    # sequence parallel: the ring over a (1, 4) mesh, every rank the batch
    model = convert.transformer(plan["ring_tree"], cfg)
    set_sequence_parallel(ring_mesh)
    try:
        tcr = tstep.TrainConfig(learning_rate=1e-3, lora_only=True, remat=True,
                                compute_dtype=torch.float32, sdpa_impl="ring")
        trainable, _, opt = tstep.init_train_state(model, tcr)
        fn = tstep.make_train_step(model, tcr)
        col.reset_counts()
        _, _, aux = fn(trainable, opt, _t(plan["ring_tokens"]), _t(plan["ring_ctx"]),
                       tuple(_t(a) for a in plan["ring_rope"]), _t(plan["ring_sigma"]),
                       _t(plan["ring_noise"]))
        out["ring"] = (float(aux["loss"]), float(aux["grad_norm"]))
        out["ring_hops"] = col.counts["send_recv"]
        # the same registration on a model sharded over heads on that axis:
        # its attentions take their local heads, and no ring runs
        model = convert.transformer(plan["ring_tree"], cfg)
        sharding.shard_transformer(model, ring_mesh)
        trainable, _, opt = tstep.init_train_state(model, tcr)
        fn = tstep.make_train_step(model, tcr)
        col.reset_counts()
        _, _, aux = fn(trainable, opt, _t(plan["ring_tokens"]), _t(plan["ring_ctx"]),
                       tuple(_t(a) for a in plan["ring_rope"]), _t(plan["ring_sigma"]),
                       _t(plan["ring_noise"]))
        out["tp_ring"] = (float(aux["loss"]), float(aux["grad_norm"]))
        out["tp_ring_hops"] = col.counts["send_recv"]
    finally:
        set_sequence_parallel(None)
    return out


def _train_cli(plan, rank):
    from ltx_tpu_torch.train import cli, export

    args = ["--data", plan["shards"], "--steps", "3", "--batch", "2", "--rank", "4",
            "--random-init", "tiny", "--compute", "f32", "--quant", "none",
            "--log-every", "1", "--device", "cpu", "--seed", "3"]
    reports = []
    assert cli.main(args + ["--out", plan["cli_out"], "--mesh", "2,2", "--ckpt",
                            plan["cli_ckpt"], "--ckpt-every", "2"], reports.append) == 0
    out = {"cli_losses": [r["loss"] for r in reports if "loss" in r]}
    resumed = []
    assert cli.main(args + ["--out", plan["cli_out"] + ".resumed", "--mesh", "2,2", "--ckpt",
                            plan["cli_ckpt"], "--ckpt-every", "2", "--resume"],
                    resumed.append) == 0
    out["cli_resumed"] = [r["loss"] for r in resumed if "loss" in r]
    out["cli_resume_start"] = resumed[0]["start"]
    if rank == 0:
        out["cli_adapter"] = export.read_safetensors(plan["cli_out"])
    return out


def _generate_cli(plan, rank):
    from ltx_tpu_torch.io import cli as gcli
    from ltx_tpu_torch.parallel import sharding
    from ltx_tpu_torch.pipeline import loader

    pipe_holder = {}

    def fake_load(**kw):
        pipe_holder["pipe"] = _tiny_pipe(plan)
        return pipe_holder["pipe"]

    loader.load_pipeline = fake_load
    frames = {}
    from ltx_tpu_torch.io import video

    video.export_video = lambda f, path, **kw: frames.setdefault("f", np.asarray(f))
    rc = gcli.main(["generate", "a cat", "-w", "64", "-H", "64", "-f", "9", "-s", "2",
                    "-g", "3", "--seed", "5", "-o", plan["gen_out"], "--device", "cpu",
                    "--mesh", "2,2"])
    pipe = pipe_holder["pipe"]
    return {"gen_rc": rc, "gen_frames": frames.get("f"), "gen_sharded": pipe.mesh is not None,
            "gen_data_rows": sharding.data_rows(pipe.transformer, 2)[1:]}


def _tiny_pipe(plan):
    from ltx_tpu_torch.config import MemoryConfig
    from ltx_tpu_torch.pipeline.generate import LTXPipeline

    return LTXPipeline.random_tiny(device="cpu", seed=0,
                                   memory=MemoryConfig(offload_text_encoder=False))


def mesh_cases(rank: int, plan: dict) -> dict:
    """Every world-of-4 case: pipe.shard and the dp+tp train step on a
    (2, 2) mesh, the ring train step on a (1, 4) mesh, both CLIs' --mesh."""
    from ltx_tpu_torch.parallel import runtime

    mesh = runtime.make_mesh(2, 2)
    ring_mesh = runtime.make_mesh(1, 4)
    out = {"rank": rank}
    out.update(_pipeline(plan, mesh))
    out.update(_train(plan, mesh, ring_mesh))
    out.update(_train_cli(plan, rank))
    out.update(_generate_cli(plan, rank))
    return out


# ---------------------------------------------------------------------------
# Pipeline parallelism: a world of 4 on (1, 4) and (2, 2) meshes, a world of
# 2 for the pipeline and the CLI
# ---------------------------------------------------------------------------


def _global_name(plan, name: str) -> str:
    """A stage's parameter name in the whole module (its blocks counted
    from the stage's first)."""
    if not name.startswith("blocks."):
        return name
    _, i, rest = name.split(".", 2)
    return f"blocks.{int(i) + plan.first}.{rest}"


def _stage_leaves(model, tensors: dict) -> dict:
    return {_global_name(model.pp_plan, n): _np(t) for n, t in tensors.items()}


def _pp_forwards(plan, col, pipeline, runtime):
    from ltx_tpu_torch import convert

    out = {}
    args = (_t(plan["pp_x"]), _t(plan["pp_ctx"]), _t(plan["pp_t"]),
            tuple(_t(a) for a in plan["pp_rope"]))
    stg = dict(context_bias=_t(plan["pp_bias"]), skip_self_attn=torch.from_numpy(plan["pp_sa"]),
               skip_ff=torch.from_numpy(plan["pp_ff"]), cross_attn_scale=_t(plan["pp_cas"]))
    for data, pipe, n_mb in plan["pp_cases"]:
        mesh = runtime.make_pp_mesh(data, pipe)
        model = pipeline.shard_pp(convert.transformer(plan["pp_tree"], plan["pp_cfg"]), mesh,
                                  n_mb)
        col.reset_counts()
        with torch.no_grad():
            out[f"fwd_{data}x{pipe}_m{n_mb}"] = _np(pipeline.dit_forward_pp(model, *args, **stg))
        out[f"fwd_{data}x{pipe}_m{n_mb}_counts"] = dict(col.counts)
    model = pipeline.shard_pp(convert.transformer(plan["pp_tree"], plan["pp_cfg"]),
                              runtime.make_pp_mesh(2, 2))
    with torch.no_grad():
        out["fwd_defaults"] = _np(model(*args, context_bias=_t(plan["pp_bias1"])))
    av = pipeline.shard_pp(convert.av_transformer(plan["ppav_tree"], plan["pp_cfg"]),
                           runtime.make_pp_mesh(2, 2), 2)
    ropes = tuple(tuple(_t(a) for a in pair) for pair in plan["ppav_ropes"])
    col.reset_counts()
    with torch.no_grad():
        v, a = pipeline.dit_av_forward_pp(
            av, _t(plan["ppav_v"]), _t(plan["ppav_a"]), _t(plan["ppav_vctx"]),
            _t(plan["ppav_actx"]), _t(plan["ppav_t"]), _t(plan["ppav_t"]) * 0.9, ropes,
            video_bias=_t(plan["ppav_bias"]))
    out["fwd_av"] = [_np(v), _np(a)]
    out["fwd_av_counts"] = dict(col.counts)
    return out


def _pp_gradients(plan, col, pipeline, runtime):
    """The latent's and every leaf's gradient of mean(v^2) through a (1, 4)
    pipeline, two microbatches, each block rematerialised."""
    from ltx_tpu_torch import convert

    mesh = runtime.make_pp_mesh(1, 4)
    model = pipeline.shard_pp(convert.transformer(plan["pp_tree"], plan["pp_cfg"]), mesh, 2)
    model.requires_grad_(True)
    lat = _t(plan["pp_x"]).requires_grad_(True)
    v = model(lat, _t(plan["pp_ctx"]), _t(plan["pp_t"]), tuple(_t(a) for a in plan["pp_rope"]),
              context_bias=_t(plan["pp_bias"]), remat=True)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(v.float().square().mean(), [lat, *params.values()],
                                allow_unused=True)
    leaves = {n: torch.zeros_like(params[n]) if g is None else g.clone()
              for n, g in zip(params, grads[1:])}
    pipeline.reduce_gradients(model, leaves)
    # the latent feeds stage 0 alone: its gradient lives there
    g_lat = torch.zeros_like(lat) if grads[0] is None else grads[0].clone()
    return {"grad_leaves": _stage_leaves(model, leaves),
            "grad_latent": _np(col.all_reduce(g_lat, mesh, "pipe"))}


def _pp_train_steps(plan, pipeline, runtime):
    """One full fine-tune step of the video DiT and of the dual DiT on a
    (1, 4) pipeline, two microbatches."""
    import dataclasses

    from ltx_tpu_torch import convert
    from ltx_tpu_torch.train import step as tstep

    out = {}
    mesh = runtime.make_pp_mesh(1, 4)
    tc = dataclasses.replace(plan["pp_tc"], pp_mesh=mesh, pp_microbatches=2)
    model = pipeline.shard_pp(convert.transformer(plan["pp_tree"], plan["pp_cfg"]), mesh)
    trainable, _, opt = tstep.init_train_state(model, tc)
    trainable, opt, aux = tstep.make_train_step(model, tc)(
        trainable, opt, _t(plan["pp_x"]), _t(plan["pp_ctx"]),
        tuple(_t(a) for a in plan["pp_rope"]), _t(plan["pp_sigma"]), _t(plan["pp_noise"]),
        _t(plan["pp_bias"]))
    out["step"] = (float(aux["loss"]), float(aux["grad_norm"]))
    out["step_leaves"] = _stage_leaves(model, trainable)
    av = pipeline.shard_pp(convert.av_transformer(plan["ppav_tree"], plan["pp_cfg"]), mesh)
    tc = dataclasses.replace(plan["ppav_tc"], pp_mesh=mesh, pp_microbatches=2)
    trainable, _, opt = tstep.init_train_state(av, tc)
    ropes = tuple(tuple(_t(a) for a in pair) for pair in plan["ppav_ropes"])
    b = 2
    trainable, opt, aux = tstep.make_av_train_step(av, tc)(
        trainable, opt, _t(plan["ppav_v"][:b]), _t(plan["ppav_a"][:b]),
        _t(plan["ppav_vctx"][:b]), _t(plan["ppav_actx"][:b]), ropes,
        *(_t(plan[k]) for k in ("ppav_sigma_v", "ppav_sigma_a", "ppav_noise_v",
                                "ppav_noise_a")))
    out["av_step"] = (float(aux["loss"]), float(aux["grad_norm"]))
    out["av_step_leaves"] = _stage_leaves(av, trainable)
    return out


def _pp_denoise(plan, pipeline, runtime):
    """The guided video step (CFG + STG: three rows, three microbatches) and
    the guided dual step (CFG: two rows) of bf16 DiTs, whole and on a (1, 4)
    pipeline."""
    from ltx_tpu_torch import convert
    from ltx_tpu_torch.pipeline import denoise

    out = {}
    mesh = runtime.make_pp_mesh(1, 4)
    model = convert.transformer(plan["dn_tree"], plan["pp_cfg"])
    lat = _t(plan["dn_latent"])
    for tag in ("denoise_whole", "denoise"):
        if tag == "denoise":
            pipeline.shard_pp(model, mesh)
        step = denoise.make_denoise_step(model, plan["dn_guidance"], plan["dn_shape"],
                                         _t(plan["dn_ctx"]), _t(plan["dn_bias"]),
                                         pp_mesh=model.pp_plan and mesh)
        with torch.no_grad():
            out[tag] = [_np(t) for t in step(lat, 0.9, 0.5, torch.zeros_like(lat))]
    av = convert.av_transformer(plan["dnav_tree"], plan["pp_cfg"])
    for tag in ("denoise_av_whole", "denoise_av"):
        if tag == "denoise_av":
            pipeline.shard_pp(av, mesh)
        step = denoise.make_av_denoise_step(av, plan["dnav_guidance"], plan["dn_shape"],
                                            plan["dnav_frames"], _t(plan["dnav_ctx"]),
                                            _t(plan["dnav_ctx"]) * 0.9, None,
                                            pp_mesh=av.pp_plan and mesh)
        with torch.no_grad():
            out[tag] = [_np(t) for t in step(_t(plan["dn_latent"]), _t(plan["dnav_audio"]),
                                             0.9, 0.5)]
    return out


def pp_cases(rank: int, plan: dict) -> dict:
    """Every world-of-4 pipeline-parallel case."""
    from ltx_tpu_torch.parallel import collectives as col
    from ltx_tpu_torch.parallel import pipeline, runtime

    out = {"rank": rank}
    out.update(_pp_forwards(plan, col, pipeline, runtime))
    out.update(_pp_gradients(plan, col, pipeline, runtime))
    out.update(_pp_train_steps(plan, pipeline, runtime))
    out.update(_pp_denoise(plan, pipeline, runtime))
    return out


def _pp_pipeline(plan, memory):
    """The tiny pipeline with audio from the reference's trees, on the CPU."""
    from ltx_tpu_torch import convert
    from ltx_tpu_torch.pipeline.generate import LTXPipeline

    trees, cfgs = plan["pipe_trees"], plan["pipe_cfgs"]
    return LTXPipeline(
        transformer=convert.transformer(trees["transformer"], cfgs["transformer"]),
        vae_decoder=convert.vae_decoder(trees["vae_decoder"], cfgs["vae"]),
        gemma=convert.gemma(trees["gemma"], cfgs["gemma"]),
        text_encoder=convert.text_encoder(trees["text_encoder"], cfgs["text_encoder"]),
        av_transformer=convert.av_transformer(trees["av_transformer"], cfgs["transformer"]),
        audio_vae=convert.audio_vae(trees["audio_vae"], cfgs["audio_vae"]),
        vocoder=convert.vocoder(trees["vocoder"], cfgs["vocoder"]),
        memory=memory, device="cpu")


def _pp_runs(plan, pipe, col, audio: bool = True) -> dict:
    """generate_video (with the collectives it ran) and, with `audio`,
    generate_video_with_audio on `pipe`."""
    col.reset_counts()
    res = pipe.generate_video("pp e2e", plan["t2v_config"], _t(plan["t2v_noise"]))
    out = {"t2v": np.asarray(res.frames), "t2v_counts": dict(col.counts),
           "t2v_steps": len(res.timings.denoise_steps)}
    if audio:
        res = pipe.generate_video_with_audio("pp av", plan["av_config"], _t(plan["av_noise"]),
                                             _t(plan["av_audio_noise"]))
        out["av"] = (np.asarray(res.frames), np.asarray(res.audio))
    return out


def _pp_generate_cli(plan, rank):
    from ltx_tpu_torch.io import cli as gcli
    from ltx_tpu_torch.io import video
    from ltx_tpu_torch.pipeline import loader

    holder = {}

    def fake_load(**kw):
        holder["pipe"] = _tiny_pipe(plan)
        return holder["pipe"]

    loader.load_pipeline = fake_load
    frames = {}
    video.export_video = lambda f, path, **kw: frames.setdefault("f", np.asarray(f))
    rc = gcli.main(plan["cli_argv"] + ["--mesh-pp", "1,2"])
    dit = holder["pipe"].transformer
    return {"gen_rc": rc, "gen_frames": frames.get("f"),
            "gen_stage": (dit.pp_plan.stage, dit.pp_plan.first, len(dit.blocks))}


def pp_pipeline_cases(rank: int, plan: dict) -> dict:
    """LTXPipeline.shard_pp on a (1, 2) mesh: the tiny T2V and audio runs
    whole and split, a staged run and a resident one, and generate
    --mesh-pp 1,2."""
    import dataclasses

    from ltx_tpu_torch.config import MemoryConfig
    from ltx_tpu_torch.parallel import collectives as col
    from ltx_tpu_torch.parallel import runtime

    mesh = runtime.make_pp_mesh(1, 2)
    out = {"rank": rank}
    pipe = _pp_pipeline(plan, MemoryConfig(offload_text_encoder=False))
    out.update({k + "_whole": v for k, v in _pp_runs(plan, pipe, col).items()})
    pipe.shard_pp(mesh)
    out.update(_pp_runs(plan, pipe, col))
    out["stages"] = [(m.pp_plan.first, len(m.blocks)) for m in (pipe.transformer,
                                                                 pipe.av_transformer)]
    moderate = MemoryConfig.preset("moderate")
    staged = _pp_pipeline(plan, moderate).shard_pp(mesh)
    out["staged_blocks_before"] = len(staged.transformer.blocks)
    out["t2v_staged"] = _pp_runs(plan, staged, col, audio=False)["t2v"]
    out["staged_blocks_after"] = len(staged.transformer.blocks)
    resident = _pp_pipeline(plan, dataclasses.replace(moderate, phase_staging=False))
    out["t2v_resident"] = _pp_runs(plan, resident.shard_pp(mesh), col, audio=False)["t2v"]
    out.update(_pp_generate_cli(plan, rank))
    return out
