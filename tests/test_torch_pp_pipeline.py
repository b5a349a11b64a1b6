"""Port parity: `LTXPipeline.shard_pp` and `generate --mesh-pp` on a gloo
world of 2 (the pipeline cases of tests/test_pp.py).

The port's ranks (`torch_parallel_cases.pp_pipeline_cases`) build the tiny
pipeline with audio from the reference's trees and run `generate_video`
and `generate_video_with_audio` whole, then split over make_pp_mesh(1, 2)
(one guidance row: one microbatch, a block a stage): the split runs bit for
bit the whole ones (the same products on the same rows in the same
order), and within 2e-2 of the reference's plain runs (frames; the
waveform 5e-2, test_torch_audio_pipeline.py's bound). A staged ("moderate")
split pipeline, its DiT split when its phase starts, runs bit for bit the
resident one. `generate --mesh-pp 1,2` writes, from rank 0, the frames of
the single-process CLI run of the same seed, bit for bit. Every output the
ranks hold alike is bit for bit the same on both. In-process: `shard` and
`shard_pp` exclude each other in both orders, and `--mesh-pp` with
`--audio` passes a dry run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_tpu.core import config as jconfig
from ltx_tpu.models import audio_vae as jaudio
from ltx_tpu.models import gemma3 as jgemma
from ltx_tpu.models import text_encoder as jte
from ltx_tpu.models import vae as jvae
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import GenerationConfig, MemoryConfig
from ltx_tpu_torch.errors import InvalidConfigurationError
from ltx_tpu_torch.ops.latents import VideoLatentShape
from ltx_tpu_torch.parallel import runtime
from ltx_tpu_torch.pipeline import generate
from ltx_tpu_torch.pipeline.generate import LTXPipeline
import torch_parallel_cases as cases
from torch_dist import run_world
from torch_parity import av_keys, jax_normal, video_keys
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

T2V = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=21)
AV = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2, seed=23)
CLI_ARGV = ["generate", "a cat", "-w", "64", "-H", "64", "-f", "9", "-s", "2", "--seed", "5",
            "--device", "cpu"]


def _trees():
    """Every component's tree (numpy) and config, and the audio draw's
    shape. The DiTs and Gemma are
    drawn by the port's seeded init (convert's trees of them); the VAE, the
    text encoder with its audio connector, the audio VAE and the vocoder by
    the reference's jitted inits. Any weights do: both sides load the same
    trees."""
    tcfg, vcfg, gcfg, tecfg = generate.tiny_configs()
    port = LTXPipeline.random_tiny(device="cpu", seed=0, include_audio=True)
    ks = jax.random.split(jax.random.key(0), 4)
    jac, jvoc = jaudio.AudioVAEConfig().tiny(), jaudio.VocoderConfig().tiny()

    def jit(init, key, *static):  # without XLA's backend optimizations: a tenth of the compile
        return jax.jit(init, static_argnums=tuple(range(1, 1 + len(static)))).lower(
            key, *static).compile(compiler_options={"xla_backend_optimization_level": 0})(key)

    def numpy(tree):
        return jax.tree.map(lambda t: np.asarray(jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if str(t.dtype) == "torch.bfloat16" else jnp.float32)), tree)

    trees = {
        "transformer": numpy(convert.transformer_tree(port.transformer)),
        "av_transformer": numpy(convert.av_transformer_tree(port.av_transformer)),
        "gemma": numpy(convert.gemma_tree(port.gemma)),
        "vae_decoder": jit(jvae.init_decoder_params, ks[0],
                           convert.port_config(vcfg, jvae.VAEConfig)),
        "text_encoder": jit(jte.init_params, ks[1],
                            convert.port_config(tecfg, jte.TextEncoderConfig), jnp.bfloat16,
                            True),
        "audio_vae": jit(jaudio.init_audio_vae_params, ks[2], jac),
        "vocoder": jit(jaudio.init_vocoder_params, ks[3], jvoc)}
    cfgs = {"transformer": tcfg, "vae": vcfg, "gemma": gcfg, "text_encoder": tecfg,
            "audio_vae": jac, "vocoder": jvoc}
    return jax.tree.map(np.asarray, trees), cfgs, port.audio_noise_shape(AV)


def _reference_pipeline(trees, cfgs):
    from ltx_tpu.pipeline.generate import LTXPipeline as JaxPipeline

    jt = convert.port_config(cfgs["transformer"], jconfig.TransformerConfig)
    j = jax.tree.map(jnp.asarray, trees)
    return JaxPipeline(
        transformer_params=j["transformer"], transformer_config=jt,
        vae_decoder_params=j["vae_decoder"],
        vae_config=convert.port_config(cfgs["vae"], jvae.VAEConfig),
        gemma_params=j["gemma"],
        gemma_config=convert.port_config(cfgs["gemma"], jgemma.Gemma3Config),
        text_encoder_params=j["text_encoder"],
        text_encoder_config=convert.port_config(cfgs["text_encoder"], jte.TextEncoderConfig),
        av_transformer_params=j["av_transformer"], audio_vae_params=j["audio_vae"],
        audio_vae_config=cfgs["audio_vae"], vocoder_params=j["vocoder"],
        vocoder_config=cfgs["vocoder"],
        memory=jconfig.MemoryConfig(offload_text_encoder=False))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(ranks' results, the reference's runs, the plan): the gloo world runs
    while the reference generates."""
    from concurrent.futures import ThreadPoolExecutor

    trees, cfgs, audio_shape = _trees()
    shape = VideoLatentShape.from_pixels(1, 9, 64, 64, channels=cfgs["transformer"].in_channels)
    vkey, akey, _, _ = av_keys(AV.seed)
    root = tmp_path_factory.mktemp("pp")
    plan = {"pipe_trees": trees, "pipe_cfgs": cfgs, "t2v_config": T2V, "av_config": AV,
            "t2v_noise": jax_normal(video_keys(T2V.seed)[0], shape.shape).numpy(),
            "av_noise": jax_normal(vkey, shape.shape).numpy(),
            "av_audio_noise": jax_normal(akey, audio_shape).numpy(),
            "cli_argv": CLI_ARGV + ["-o", str(root / "out.mp4")]}
    ref_pipe = _reference_pipeline(trees, cfgs)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_world, cases.pp_pipeline_cases, 2, root, plan)
        ref = {"t2v": np.asarray(ref_pipe.generate_video(
            "pp e2e", convert.port_config(T2V, jconfig.GenerationConfig)).frames, np.float32)}
        res = ref_pipe.generate_video_with_audio(
            "pp av", convert.port_config(AV, jconfig.GenerationConfig))
        ref["av"] = (np.asarray(res.frames, np.float32), np.asarray(res.audio, np.float32))
        return ranks.result(), ref, plan


def _same_on_ranks(ranks, key):
    a, b = ranks
    for x, y in zip(a[key] if isinstance(a[key], tuple) else [a[key]],
                    b[key] if isinstance(b[key], tuple) else [b[key]]):
        np.testing.assert_array_equal(x, y, err_msg=key)


def _near(got, want, tol, what):
    err = float(np.abs(got - want).max())
    print(f"[parity] {what}: max abs {err:.3e} (tol {tol:.0e})")
    assert got.shape == want.shape and np.isfinite(got).all() and err <= tol


def test_shard_pp_generate_video(world):
    ranks, ref, _ = world
    for r in ranks:
        np.testing.assert_array_equal(r["t2v"], r["t2v_whole"])
        _near(r["t2v"], ref["t2v"], 2e-2, "shard_pp generate_video vs the reference's")
        # a block a stage: per DiT call one hop (M + S - 2) and one broadcast
        assert r["stages"][0] == (r["rank"], 1)
        counts, steps = r["t2v_counts"], r["t2v_steps"]
        assert (counts["send_recv"], counts["broadcast"], counts["all_gather"]) == (
            steps, steps, 0)
    _same_on_ranks(ranks, "t2v")


def test_shard_pp_generate_video_with_audio(world):
    ranks, ref, _ = world
    for r in ranks:
        for got, whole in zip(r["av"], r["av_whole"]):
            np.testing.assert_array_equal(got, whole)
        _near(r["av"][0], ref["av"][0], 2e-2, "shard_pp generate_video_with_audio frames")
        _near(r["av"][1], ref["av"][1], 5e-2, "shard_pp generate_video_with_audio waveform")
        assert r["stages"][1] == (r["rank"], 1)
    _same_on_ranks(ranks, "av")


def test_staged_shard_pp_matches_resident(world):
    """Under phase staging the DiT is split when its phase starts."""
    ranks, _, _ = world
    for r in ranks:
        assert (r["staged_blocks_before"], r["staged_blocks_after"]) == (2, 1)
        np.testing.assert_array_equal(r["t2v_staged"], r["t2v_resident"])
    _same_on_ranks(ranks, "t2v_staged")


def test_generate_cli_mesh_pp_matches_single_process(world, monkeypatch):
    from ltx_tpu_torch.io import cli as gcli
    from ltx_tpu_torch.io import video

    ranks, _, plan = world
    pipe = LTXPipeline.random_tiny(device="cpu", seed=0,
                                   memory=MemoryConfig(offload_text_encoder=False))
    monkeypatch.setattr("ltx_tpu_torch.pipeline.loader.load_pipeline", lambda **kw: pipe)
    frames = {}
    monkeypatch.setattr(video, "export_video",
                        lambda f, path, **kw: frames.setdefault("f", np.asarray(f)))
    assert gcli.main(plan["cli_argv"]) == 0
    r0, r1 = ranks
    assert r0["gen_rc"] == r1["gen_rc"] == 0 and r1["gen_frames"] is None
    assert (r0["gen_stage"], r1["gen_stage"]) == ((0, 0, 1), (1, 1, 1))
    np.testing.assert_array_equal(r0["gen_frames"], frames["f"])


def test_shard_and_shard_pp_exclude_each_other():
    for first, second in (("shard", "shard_pp"), ("shard_pp", "shard")):
        pipe = LTXPipeline.random_tiny(device="cpu", seed=0)
        mesh = {"shard": runtime.make_mesh(1, 1), "shard_pp": runtime.make_pp_mesh(1, 1)}
        getattr(pipe, first)(mesh[first])
        with pytest.raises(InvalidConfigurationError, match="mutually exclusive"):
            getattr(pipe, second)(mesh[second])


def test_mesh_pp_cli_accepts_audio():
    from ltx_tpu_torch.io import cli as gcli

    assert gcli.main(["generate", "x", "--audio", "--mesh-pp", "1,2", "--dry-run"]) == 0
