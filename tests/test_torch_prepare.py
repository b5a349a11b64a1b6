"""Port parity for train/prepare.py: clips and captions to latent shards
(ltx_tpu_torch.train.prepare against ltx_tpu.train.prepare) on tiny
pipelines of the same weights, the components prepare-data runs (VAE
encoder and decoder, Gemma, connector; the DiT for the closing train step)
at `torch_parity.reference_and_port()`'s configs, over .mp4 clips the test
writes as the reference's tests/test_prepare.py does. The DiT and Gemma
are drawn by the port, the VAE and the connector by the reference, its
inits compiled without XLA's backend optimizations (a third of the time;
any weights do, both sides get the same).

Tolerances: the shards' names, row counts, grids and masks equal; the
tokens (the VAE encoder in f32, normalized, patchified) 1e-5 relative to
the reference's largest, the VAE encoder's own (PERF.md's parity table);
the text contexts (Gemma and the connector in bf16) 5e-2, the text
encoder's. Shards of either package read by the other's dataset: equal.
Manifests, sidecar scans, argument errors and the parser: the reference's
values, exception types and messages."""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.train import data as jdata
from ltx_tpu.train import prepare as jprep
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import MemoryConfig
from ltx_tpu_torch.io import cli as pcli
from ltx_tpu_torch.models.common import init_random_
from ltx_tpu_torch.models.dit import LTXTransformer
from ltx_tpu_torch.models.gemma3 import Gemma3Model
from ltx_tpu_torch.ops import rope
from ltx_tpu_torch.ops.attention import prepare_additive_mask
from ltx_tpu_torch.pipeline import generate
from ltx_tpu_torch.pipeline.generate import LTXPipeline
from ltx_tpu_torch.train import data, lora, prepare, step
from test_prepare import _synthetic_clip
from test_torch_cli import _options
from torch_parity import assert_rel
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

W = H = 64
FRAMES = 9
CAPTIONS = ("clip number 0 of a moving gradient", "a second clip, slower",
            "three: the last one")


@pytest.fixture(scope="module")
def pipes():
    """(the reference's pipeline, the port's) with the same VAE, Gemma,
    connector and DiT weights; the DiT and Gemma drawn by the port."""
    from ltx_tpu.core import config as jconfig
    from ltx_tpu.models import gemma3 as jgemma
    from ltx_tpu.models import text_encoder as jte
    from ltx_tpu.models import vae as jvae
    from ltx_tpu.pipeline.generate import LTXPipeline as JaxPipeline

    tcfg, vcfg, gcfg, tecfg = generate.tiny_configs()
    jv = convert.port_config(vcfg, jvae.VAEConfig)
    jg = convert.port_config(gcfg, jgemma.Gemma3Config)
    jt = convert.port_config(tecfg, jte.TextEncoderConfig)
    keys = jax.random.split(jax.random.key(0), 3)
    fast = {"xla_backend_optimization_level": 0}

    def init(fn, key, *static):
        return jax.jit(lambda k: fn(k, *static)).lower(key).compile(
            compiler_options=fast)(key)

    def reference_tree(tree):
        """A module tree of torch tensors as the reference's jnp leaves, each
        in its own dtype."""
        return jax.tree.map(lambda t: jnp.asarray(t.float().numpy(), {
            torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[t.dtype]), tree)

    gen = torch.Generator().manual_seed(0)
    dit = init_random_(LTXTransformer(tcfg, device="cpu", dtype=torch.bfloat16), gen)
    gemma = init_random_(Gemma3Model(gcfg, device="cpu", dtype=torch.bfloat16), gen)
    ref = JaxPipeline(
        transformer_params=reference_tree(convert.transformer_tree(dit)),
        transformer_config=convert.port_config(tcfg, jconfig.TransformerConfig),
        vae_decoder_params=init(jvae.init_decoder_params, keys[0], jv), vae_config=jv,
        gemma_params=reference_tree(convert.gemma_tree(gemma)), gemma_config=jg,
        text_encoder_params=init(jte.init_params, keys[1], jt, jnp.bfloat16),
        text_encoder_config=jt,
        vae_encoder_params=init(jvae.init_encoder_params, keys[2], jv),
        memory=jconfig.MemoryConfig(offload_text_encoder=False))
    port = LTXPipeline(
        transformer=dit, vae_decoder=convert.vae_decoder(ref.vae_decoder_params, vcfg),
        gemma=gemma,
        text_encoder=convert.text_encoder(ref.text_encoder_params, tecfg),
        vae_encoder=convert.vae_encoder(ref.vae_encoder_params, vcfg),
        memory=MemoryConfig(offload_text_encoder=False), device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Three 9-frame 64x64 clips with captions: (video path, caption) items."""
    root = tmp_path_factory.mktemp("clips")
    items = []
    for i, caption in enumerate(CAPTIONS):
        path = root / f"c{i}.mp4"
        _synthetic_clip(path, frames=FRAMES, h=H, w=W, seed=i)
        items.append((str(path), caption))
    return items


@pytest.fixture(scope="module")
def shards(pipes, clips, tmp_path_factory):
    """Both packages' prepare_dataset over the same clips, 2 rows a shard."""
    ref, port = pipes
    out = {}
    for name, mod, pipe in (("ref", jprep, ref), ("port", prepare, port)):
        d = tmp_path_factory.mktemp(f"shards_{name}")
        paths = mod.prepare_dataset(pipe, clips, d, width=W, height=H, num_frames=FRAMES,
                                    rows_per_shard=2, text_group=2, text_batch=2)
        out[name] = (d, paths)
    return out


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_prepare_dataset_matches_reference(shards):
    (rdir, rpaths), (pdir, ppaths) = shards["ref"], shards["port"]
    assert [p.rsplit("/", 1)[-1] for p in ppaths] == [p.rsplit("/", 1)[-1] for p in rpaths] \
        == ["shard00000.npz", "shard00001.npz"]
    for rp, pp in zip(rpaths, ppaths):
        want, got = _load(rp), _load(pp)
        assert sorted(got) == sorted(want) == ["context", "grid", "mask", "tokens"]
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        assert np.array_equal(got["grid"], want["grid"])
        assert tuple(got["grid"]) == ((FRAMES - 1) // 8 + 1, H // 32, W // 32)
        assert np.array_equal(got["mask"], want["mask"])
        name = pp.rsplit("/", 1)[-1]
        assert_rel(got["tokens"], want["tokens"], 1e-5, f"prepare tokens {name}")
        assert_rel(got["context"], want["context"], 5e-2, f"prepare contexts {name}")
    assert [len(_load(p)["tokens"]) for p in ppaths] == [2, 1]


def test_shards_cross_read(shards):
    """Each package's LatentShardDataset reads the other's shards: the same
    rows in the same order for one seed as from its own."""
    (rdir, _), (pdir, _) = shards["ref"], shards["port"]
    for own, other, cls in ((rdir, pdir, jdata.LatentShardDataset),
                            (pdir, rdir, data.LatentShardDataset)):
        a, b = cls(own, batch_size=3, seed=0), cls(other, batch_size=3, seed=0)
        assert a.num_rows == b.num_rows == 3 and a.grid == b.grid
        ba, bb = next(iter(a)), next(iter(b))
        assert np.array_equal(ba.mask, bb.mask)
        assert ba.tokens.shape == bb.tokens.shape and ba.context.shape == bb.context.shape
        assert_rel(bb.tokens, ba.tokens, 1e-5, f"{cls.__module__} cross-read tokens")
    port_ds, ref_ds = (data.LatentShardDataset(pdir, batch_size=3, seed=0),
                       jdata.LatentShardDataset(pdir, batch_size=3, seed=0))
    bp, br = next(iter(port_ds)), next(iter(ref_ds))
    assert np.array_equal(bp.tokens, br.tokens) and np.array_equal(bp.context, br.context)
    assert np.array_equal(bp.mask, br.mask)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 (the outcome is compared)
        return (type(e).__name__, str(e))


def test_frame_count_and_skip_errors_as_reference(pipes, clips, tmp_path):
    """num_frames not 8n+1, a file that is no video (with and without
    skip_errors), an empty item list: the reference's outcome each."""
    ref, port = pipes
    good = clips[0][0]
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    cases = {
        "frames10": dict(items=[(good, "x")], num_frames=10),
        "bad_clip": dict(items=[(str(bad), "x"), (good, "y")]),
        "none": dict(items=[]),
    }
    for name, kw in cases.items():
        kw = {"num_frames": FRAMES, **kw}
        got = _outcome(lambda: prepare.prepare_dataset(port, kw["items"], tmp_path / f"p{name}",
                                                       W, H, kw["num_frames"]))
        want = _outcome(lambda: jprep.prepare_dataset(ref, kw["items"], tmp_path / f"r{name}",
                                                      W, H, kw["num_frames"]))
        assert got[0] == want[0] != "ok", (name, got, want)
        if name != "bad_clip":  # the decoder's own message names its library
            assert got[1] == want[1], name
    got = prepare.prepare_dataset(port, [(str(bad), "x"), (good, "y")], tmp_path / "ps",
                                  W, H, FRAMES, skip_errors=True)
    want = jprep.prepare_dataset(ref, [(str(bad), "x"), (good, "y")], tmp_path / "rs",
                                 W, H, FRAMES, skip_errors=True)
    assert [p.rsplit("/", 1)[-1] for p in got] == [p.rsplit("/", 1)[-1] for p in want]
    assert len(_load(got[0])["tokens"]) == len(_load(want[0])["tokens"]) == 1


def test_manifest_and_sidecar_scan_as_reference(tmp_path):
    (tmp_path / "a.mp4").write_bytes(b"x")
    (tmp_path / "a.txt").write_text("caption a\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.mp4").write_bytes(b"x")
    (tmp_path / "empty").mkdir()
    manifests = {
        "relative_and_blank": [json.dumps({"video": "a.mp4", "caption": "c"}), "",
                               json.dumps({"video": "/abs/b.mp4", "caption": 7})],
        "missing_caption": [json.dumps({"video": "a.mp4"})],
        "empty": [],
        "not_json": ["{video"],
    }
    for name, lines in manifests.items():
        path = tmp_path / f"{name}.jsonl"
        path.write_text("\n".join(lines) + "\n")
        got, want = _outcome(lambda: prepare.read_manifest(path)), \
            _outcome(lambda: jprep.read_manifest(path))
        assert got == want, name
    for directory in (tmp_path, tmp_path / "sub", tmp_path / "empty"):
        assert _outcome(lambda: prepare.scan_videos(directory)) == \
            _outcome(lambda: jprep.scan_videos(directory)), directory
    assert prepare.read_manifest(tmp_path / "relative_and_blank.jsonl") == [
        (str(tmp_path / "a.mp4"), "c"), ("/abs/b.mp4", "7")]


def test_add_prepare_arguments_as_reference():
    ref, port = argparse.ArgumentParser(), argparse.ArgumentParser()
    jprep.add_prepare_arguments(ref)
    prepare.add_prepare_arguments(port)
    want, got = _options(ref), _options(port)
    assert set(got) - set(want) == {"device"}
    for dest, option in want.items():
        assert got[dest] == option, dest
    assert got["device"][:2] == (("--device",), "cuda")


def test_cli_prepare_data_then_a_train_step(pipes, clips, tmp_path, monkeypatch, capsys):
    """`prepare-data` from a directory of clips with sidecars, through the
    CLI on the tiny pipeline (load_pipeline swapped for it), then one LoRA
    step of the port's trainer on the shards: a finite loss."""
    _, port = pipes
    src = tmp_path / "src"
    src.mkdir()
    for i, (path, caption) in enumerate(clips):
        (src / f"c{i}.mp4").write_bytes(open(path, "rb").read())
        (src / f"c{i}.txt").write_text(caption + "\n")
    loads = []

    def load_pipeline(**kw):
        loads.append(kw)
        return port

    monkeypatch.setattr("ltx_tpu_torch.pipeline.loader.load_pipeline", load_pipeline)
    out = tmp_path / "shards"
    rc = pcli.main(["prepare-data", str(src), "--out", str(out), "-w", str(W), "-H", str(H),
                    "-f", str(FRAMES), "--rows-per-shard", "4", "--device", "cpu"])
    assert rc == 0 and "PREPARE DATA OK: 3 clips -> 1 shards" in capsys.readouterr().out
    (kw,) = loads
    assert kw["device"] == "cpu" and kw["gemma_quant"] == "w8a8"
    ds = data.LatentShardDataset(out, batch_size=2, seed=0)
    assert ds.num_rows == 3
    batch = next(iter(ds))
    f, h, w = ds.grid
    cfg = port.tcfg
    model = port.transformer
    lora.add_lora(model, torch.Generator().manual_seed(1), rank=2)
    try:
        tc = step.TrainConfig(learning_rate=1e-4, lora_only=True)
        trainable, _, opt = step.init_train_state(model, tc)
        cos, sin = rope.video_rope(f, h, w, cfg.inner_dim, cfg.num_heads)
        _, _, aux = step.make_train_step(model, tc)(
            trainable, opt, torch.from_numpy(batch.tokens), torch.from_numpy(batch.context),
            (torch.from_numpy(np.asarray(cos)), torch.from_numpy(np.asarray(sin))),
            torch.full((2,), 0.5), torch.zeros(batch.tokens.shape),
            prepare_additive_mask(torch.from_numpy(batch.mask)))
        assert np.isfinite(float(aux["loss"]))
    finally:
        lora.strip_lora(model)
        for p in model.parameters():
            p.requires_grad_(False)
