"""Port parity for io/cli.py: each subcommand's parser has the reference's
option strings, defaults, choices and nargs (the port adds `--device`);
`_generation_config` and `_resolve_memory` (at the reference's 15.5 GB
budget) give the reference's configs field for field; every invalid flag
combination of `cmd_generate` exits with the reference's code and message;
each `cmd_generate` branch calls the SeededPipeline method the reference's
branch calls on its pipeline, with the same arguments (recording fakes);
real tiny runs on the CPU write their MP4 (and WAV) with the pixels of a
direct SeededPipeline call; the parallel flags raise NotImplementedError
naming ROADMAP A18, and `prepare-data` reaches
ltx_tpu_torch.train.prepare.run with its parsed arguments. Also the memory
estimate and the enhancement micro-batch bound."""

import argparse
import dataclasses

import numpy as np
import pytest

from ltx_tpu.io import cli as jcli
from ltx_tpu_torch.io import cli as pcli
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REFERENCE_BUDGET_GB = 15.5  # the reference's one-chip budget (ops/latents.py)


def _subparsers(parser):
    (action,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default,
                     tuple(a.choices) if a.choices else None, a.nargs, a.required,
                     type(a).__name__, getattr(a.type, "__name__", a.type))
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parsers_match_reference():
    ref, port = _subparsers(jcli.build_parser()), _subparsers(pcli.build_parser())
    assert list(port) == list(ref)
    for name in ref:
        want, got = _options(ref[name]), _options(port[name])
        extra = {"device"} if name in ("generate", "enhance", "serve", "train",
                                       "prepare-data") else set()
        assert set(got) - set(want) == extra, name
        for dest, option in want.items():
            assert got[dest] == option, (name, dest)
    assert _options(port["generate"])["device"][:2] == (("--device",), "cuda")


ARGV = {
    "defaults": [],
    "dev": ["-m", "dev"],
    "flags": ["-w", "768", "-H", "512", "-f", "121", "--seed", "42", "--stg-scale", "0.5",
              "--stg-blocks", "28,29", "--guidance-rescale", "0.7", "--cross-attn-scale",
              "1.2", "--ge-gamma", "0.3", "--two-stage", "--enhance-prompt", "--image",
              "/tmp/x.png", "--image-cond-noise", "0.2", "--negative-prompt", "blurry",
              "--fps", "30", "--spec-k", "0", "-g", "3.0", "-s", "12"],
    "distilled_lora": ["-m", "distilled", "--distilled-lora"],
    "distilled_lora_override": ["--distilled-lora", "-s", "20", "-g", "2.5"],
    "extension_noise": ["--extend-video", "a.mp4", "--image-cond-noise", "0.3"],
    "keyframe_noise": ["--keyframe", "0:a.png"],
    "no_conditioning_noise": ["--image-cond-noise", "0.3"],
}


@pytest.mark.parametrize("name", ARGV)
def test_generation_config_matches_reference(name):
    argv = ["generate", "a cat", *ARGV[name]]
    want = dataclasses.asdict(jcli._generation_config(jcli.build_parser().parse_args(argv)))
    got = dataclasses.asdict(pcli._generation_config(pcli.build_parser().parse_args(argv)))
    assert {k: got[k] for k in want} == want


MEMORY_ARGV = {
    "flagship_int4_auto": ["-w", "1216", "-H", "704", "-f", "241", "--transformer-quant", "int4"],
    "flagship_light": ["-w", "1216", "-H", "704", "-f", "241", "--transformer-quant", "int4",
                       "--memory", "light"],
    "small": ["-w", "512", "-H", "512", "-f", "25", "--transformer-quant", "int4"],
    "bf16_north_star": ["-w", "768", "-H", "512", "-f", "25"],
    "audio_tiles": ["-w", "768", "-H", "512", "-f", "121", "--audio", "--vae-tile-size", "4",
                    "--vae-tile-overlap", "2", "--decode-transfer", "yuv420"],
    "moderate": ["--memory", "moderate", "--decode-transfer", "yuv420"],
    "disabled": ["--memory", "disabled"],
    "aggressive": ["--memory", "aggressive"],
}


@pytest.mark.parametrize("name", MEMORY_ARGV)
def test_resolve_memory_matches_reference_at_its_budget(name):
    argv = ["generate", "x", *MEMORY_ARGV[name]]
    ja, pa = jcli.build_parser().parse_args(argv), pcli.build_parser().parse_args(argv)
    want = dataclasses.asdict(jcli._resolve_memory(ja, jcli._generation_config(ja)))
    got = dataclasses.asdict(pcli._resolve_memory(pa, pcli._generation_config(pa),
                                                  budget_gb=REFERENCE_BUDGET_GB))
    want.pop("remat_blocks")  # no counterpart in the port
    assert got == want


def test_memory_estimate_matches_reference():
    from ltx_tpu.core.config import MemoryConfig as JMemory
    from ltx_tpu.ops import latents as jl
    from ltx_tpu_torch.config import MemoryConfig
    from ltx_tpu_torch.ops import latents as pl

    for frames, h, w in ((25, 512, 768), (121, 576, 1024), (241, 704, 1216), (9, 64, 64)):
        jshape = jl.VideoLatentShape.from_pixels(1, frames, h, w)
        pshape = pl.VideoLatentShape.from_pixels(1, frames, h, w)
        for rows in (1, 3):
            for bits in (None, 8, 4):
                for tile in (0, 6, 8):
                    for audio in (False, True):
                        assert pl.estimate_memory_gb(pshape, rows, bits, tile, audio) == \
                            jl.estimate_memory_gb(jshape, rows, bits, tile, audio)
                assert pl.recommended_memory_preset(
                    pshape, rows, bits, budget_gb=REFERENCE_BUDGET_GB) == \
                    jl.recommended_memory_preset(jshape, rows, bits)
    # an 80 GB card keeps the flagship's bf16 run untiled
    flagship = pl.VideoLatentShape.from_pixels(1, 241, 704, 1216)
    assert pl.recommended_memory_preset(flagship, 1, None, budget_gb=80.0) == "light"
    for name in ("disabled", "light", "moderate", "aggressive"):
        want = dataclasses.asdict(JMemory.preset(name))
        want.pop("remat_blocks")
        assert dataclasses.asdict(MemoryConfig.preset(name)) == want
    with pytest.raises(ValueError) as want_err:
        JMemory.preset("huge")
    with pytest.raises(ValueError) as got_err:
        MemoryConfig.preset("huge")
    assert str(got_err.value) == str(want_err.value)


def test_enhance_max_batch_is_the_reference_rule():
    """Memory less Gemma's resident weights over one row's cache at 1024
    slots: Gemma-3-12B's bf16 row is ~0.4 GB (the reference's figure)."""
    import torch

    from ltx_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model
    from ltx_tpu_torch.pipeline.enhance import enhance_max_batch, kv_row_bytes, module_bytes

    assert kv_row_bytes(Gemma3Config()) == 48 * 2 * 8 * 256 * 2 * 1024
    assert kv_row_bytes(Gemma3Config(), "int8") == 48 * 2 * 8 * (256 + 4) * 1024
    gemma = Gemma3Model(Gemma3Config().tiny(), device="cpu", dtype=torch.bfloat16)
    row = kv_row_bytes(gemma.cfg)
    weights = module_bytes(gemma)
    assert enhance_max_batch(gemma, (weights + 5.5 * row) / 1e9) == 5
    assert enhance_max_batch(gemma, weights / 1e9) == 1
    assert enhance_max_batch(gemma, (weights + 5.5 * row) / 1e9, kv_quant="int8") == \
        int(5.5 * row // kv_row_bytes(gemma.cfg, "int8"))


# ---------------------------------------------------------------------------
# cmd_generate: invalid flags, dispatch
# ---------------------------------------------------------------------------


class _Recorder:
    """A pipeline stand-in: every generate_* call is recorded and answered
    with three blank frames (and a short waveform for audio)."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        if not name.startswith("generate"):
            raise AttributeError(name)

        def call(prompt, config, *args, **kwargs):
            self.calls.append((name, prompt, dataclasses.asdict(config), args, kwargs))
            audio = np.zeros((2, 100), np.float32) if "audio" in name or \
                kwargs.get("audio") else None
            return type("Result", (), dict(frames=np.zeros((3, 32, 32, 3), np.float32),
                                           audio=audio, seed=config.seed,
                                           timings=None))()
        return call


def _run_reference(argv, monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr("ltx_tpu.pipeline.loader.load_pipeline",
                        lambda **kw: _Recorder(calls))
    rc = jcli.main(["generate", *argv, "-o", str(tmp_path / "r.mp4")])
    return rc, calls


def _run_port(argv, monkeypatch, tmp_path):
    from ltx_tpu_torch.pipeline import seeded

    calls, loads = [], []
    monkeypatch.setattr("ltx_tpu_torch.pipeline.loader.load_pipeline",
                        lambda **kw: loads.append(kw) or object())
    monkeypatch.setattr(seeded, "SeededPipeline", lambda pipe: _Recorder(calls))
    rc = pcli.main(["generate", *argv, "-o", str(tmp_path / "p.mp4"), "--device", "cpu"])
    return rc, calls, loads


INVALID = {
    "width_65": ["x", "-w", "65"],
    "frames_10": ["x", "-f", "10"],
    "cfg_30": ["x", "-g", "30"],
    "two_stage_96": ["x", "--two-stage", "-w", "96"],
    "mesh_and_pp": ["x", "--mesh", "1,2", "--mesh-pp", "1,2"],
    "chain_0": ["x", "--chain", "0"],
    "chain_prompt_alone": ["x", "--chain-prompt", "b"],
    "chain_anchor_alone": ["x", "--chain-anchor", "1:16:a.png"],
    "chain_renorm_alone": ["x", "--chain-tail-renorm", "0.5"],
    "chain_audio_cond_alone": ["x", "--chain-audio-cond"],
    "chain_audio_cond_no_audio": ["x", "--chain", "2", "--chain-audio-cond"],
    "chain_two_stage": ["x", "--chain", "2", "--two-stage"],
    "chain_keyframe": ["x", "--chain", "2", "--keyframe", "0:a.png"],
    "chain_prompt_count": ["x", "--chain", "3", "--chain-prompt", "b"],
    "chain_anchor_format": ["x", "--chain", "2", "--chain-anchor", "1:a.png"],
    "video_audio": ["x", "--video", "a.mp4", "--audio"],
    "video_keyframe": ["x", "--video", "a.mp4", "--keyframe", "0:a.png"],
    "extend_image": ["x", "--extend-video", "a.mp4", "--image", "a.png"],
    "keyframe_two_stage": ["x", "--keyframe", "0:a.png", "--two-stage"],
    "keyframe_format": ["x", "--keyframe", "a.png"],
}


@pytest.mark.parametrize("name", INVALID)
def test_invalid_generate_flags_exit_as_the_reference(name, monkeypatch, tmp_path, capsys):
    rc_ref, ref_calls = _run_reference(INVALID[name], monkeypatch, tmp_path)
    err_ref = capsys.readouterr().err
    rc, calls, _ = _run_port(INVALID[name], monkeypatch, tmp_path)
    err = capsys.readouterr().err
    assert rc == rc_ref == 2
    assert err.strip().splitlines()[-1] == err_ref.strip().splitlines()[-1]
    assert err.startswith("error: ") and not calls and not ref_calls


BRANCHES = {
    "t2v": ["a cat", "--seed", "3"],
    "i2v": ["a cat", "--image", "a.png", "--seed", "3"],
    "two_stage": ["a cat", "--two-stage", "-w", "128", "-H", "128"],
    "audio": ["a cat", "--audio", "--audio-gain", "2.0"],
    "audio_two_stage": ["a cat", "--audio", "--two-stage", "-w", "128", "-H", "128"],
    "v2v": ["a cat", "--video", "in.mp4", "--strength", "0.4"],
    "extend": ["a cat", "--extend-video", "in.mp4", "--cond-frames", "17", "-f", "33"],
    "extend_audio": ["a cat", "--extend-video", "in.mp4", "--audio"],
    "keyframes": ["a cat", "--keyframe", "0:a.png", "--keyframe", "16:b.png"],
    "keyframes_audio": ["a cat", "--keyframe", "0:a.png", "--audio", "--audio-gain", "0.5"],
    "chain": ["a cat", "--chain", "3", "--chain-prompt", "b", "--chain-prompt", "c",
              "--chain-anchor", "1:16:a.png", "--chain-anchor", "1:24:b.png",
              "--chain-tail-renorm", "0.5"],
    "chain_audio": ["a cat", "--chain", "2", "--audio", "--chain-audio-cond",
                    "--chain-anchor", "0:0:a.png"],
}


@pytest.mark.parametrize("name", BRANCHES)
def test_generate_branches_call_the_reference_entry_points(name, monkeypatch, tmp_path):
    rc_ref, want = _run_reference(BRANCHES[name], monkeypatch, tmp_path)
    rc, got, loads = _run_port(BRANCHES[name], monkeypatch, tmp_path)
    assert rc == rc_ref == 0 and len(got) == len(want) == 1
    (gname, gprompt, gcfg, gargs, gkw), (wname, wprompt, wcfg, wargs, wkw) = got[0], want[0]
    assert (gname, gprompt, gargs) == (wname, wprompt, wargs)
    assert {k: gcfg[k] for k in wcfg} == wcfg
    assert set(gkw) == set(wkw) and callable(gkw.pop("on_progress"))
    wkw.pop("on_progress")
    assert gkw == wkw
    (load,) = loads
    assert load["device"] == "cpu" and load["include_audio"] == ("--audio" in BRANCHES[name])
    assert load["include_upscaler"] == ("--two-stage" in BRANCHES[name])
    assert (tmp_path / "p.mp4").stat().st_size > 0
    assert (tmp_path / "p.mp4.wav").exists() == ("--audio" in BRANCHES[name])


@pytest.mark.parametrize("argv, roadmap", [
    (["generate", "x", "--mesh", "1,8"], "A18"),
    (["generate", "x", "--mesh-pp", "1,8"], "A18"),
    (["generate", "x", "--coordinator", "h:1"], "A18"),
    (["generate", "x", "--num-processes", "2"], "A18"),
], ids=["mesh", "mesh_pp", "coordinator", "num_processes"])
def test_unported_surfaces_raise(argv, roadmap):
    with pytest.raises(NotImplementedError, match=roadmap):
        pcli.main(argv)


def test_prepare_data_calls_the_port(monkeypatch):
    """`prepare-data` hands its parsed arguments to
    ltx_tpu_torch.train.prepare.run and returns its code."""
    calls = []
    monkeypatch.setattr("ltx_tpu_torch.train.prepare.run",
                        lambda args: calls.append(vars(args)) or 7)
    assert pcli.main(["prepare-data", "clips/", "--out", "shards", "-f", "9",
                      "--rows-per-shard", "4", "--skip-errors", "--device", "cpu"]) == 7
    (args,) = calls
    assert args["command"] == "prepare-data" and args["source"] == "clips/"
    assert (args["out"], args["frames"], args["rows_per_shard"], args["skip_errors"],
            args["device"], args["width"], args["height"]) == ("shards", 9, 4, True, "cpu",
                                                                768, 512)


# ---------------------------------------------------------------------------
# Real tiny runs on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("audio", [False, True], ids=["t2v", "audio"])
def test_tiny_generate_writes_the_seeded_pixels(audio, monkeypatch, tmp_path, capsys):
    from ltx_tpu_torch.checks import recorded_mp4
    from ltx_tpu_torch.config import GenerationConfig, MemoryConfig
    from ltx_tpu_torch.io.video import frames_to_uint8
    from ltx_tpu_torch.pipeline.generate import LTXPipeline
    from ltx_tpu_torch.pipeline.seeded import SeededPipeline

    pipe = LTXPipeline.random_tiny(device="cpu", seed=0, include_audio=audio,
                                   memory=MemoryConfig(offload_text_encoder=False))
    monkeypatch.setattr("ltx_tpu_torch.pipeline.loader.load_pipeline", lambda **kw: pipe)
    out = tmp_path / "out.mp4"
    argv = ["generate", "a waterfall", "-w", "64", "-H", "64", "-f", "9", "--seed", "5",
            "-o", str(out), "--device", "cpu", "--profile"] + (["--audio"] if audio else [])
    with recorded_mp4() as written:
        assert pcli.main(argv) == 0
    assert out.stat().st_size > 0
    assert "Saved" in capsys.readouterr().out
    assert any(p.name.startswith("trace_") for p in (tmp_path / "out.mp4.trace").iterdir())
    config = GenerationConfig(width=64, height=64, num_frames=9, seed=5)
    seeded = SeededPipeline(pipe)
    want = seeded.generate_video_with_audio("a waterfall", config) if audio else \
        seeded.generate_video("a waterfall", config)
    (pixels,) = written.values()
    np.testing.assert_array_equal(pixels, frames_to_uint8(want.frames))
    if audio:
        assert (tmp_path / "out.mp4.wav").stat().st_size > 44


def test_cmd_serve_wires_the_seeded_pipeline(monkeypatch, tmp_path):
    from ltx_tpu_torch.pipeline.generate import LTXPipeline
    from ltx_tpu_torch.pipeline.seeded import SeededPipeline
    from ltx_tpu_torch.serve import app as app_mod

    calls = {}
    pipe = LTXPipeline.random_tiny(device="cpu", seed=0)
    monkeypatch.setattr("ltx_tpu_torch.pipeline.loader.load_pipeline",
                        lambda **kw: calls.setdefault("load", kw) and pipe)
    real_build = app_mod.build_app

    def fake_build(p, **kw):
        calls["pipe"], calls["kw"] = p, kw
        app = real_build(p, **kw)
        monkeypatch.setattr(app.server, "serve_forever", lambda: None)
        return app

    monkeypatch.setattr(app_mod, "build_app", fake_build)
    args = pcli.build_parser().parse_args(
        ["serve", "--port", "0", "--output-dir", str(tmp_path), "--gemma-quant", "int4",
         "--max-batch", "3", "--device", "cpu", "--warmup", "64x64x9"])
    assert pcli.cmd_serve(args) == 0
    assert calls["load"]["gemma_quant"] == "int4" and calls["load"]["device"] == "cpu"
    assert calls["load"]["memory"].phase_staging  # the "moderate" default
    assert isinstance(calls["pipe"], SeededPipeline) and calls["pipe"].pipe is pipe
    assert calls["kw"]["max_batch"] == 3 and calls["kw"]["warmup_shapes"] == [(64, 64, 9)]
    bad = pcli.build_parser().parse_args(["serve", "--warmup", "64x64"])
    assert pcli.cmd_serve(bad) == 2
