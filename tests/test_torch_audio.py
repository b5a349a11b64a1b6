"""Port parity for the joint audio modules: the dual audio-video DiT
(ltx_tpu_torch.models.dit_av against ltx_tpu.models.dit_av), the audio VAE
decoder and the vocoder (models.audio_vae), the text encoder's audio
connector, the dual denoise step and `export_wav`, on tiny configs with the
same numpy inputs and jax.random draws on both sides.

Tolerances. float32: 5e-5 relative for the DiT (the timestep sinusoid's
ulp, as test_torch_dit), 1e-5 for the convolutions and the connector.
bf16: the port is held to the reference's own bf16 error against an f32 run
of the same weights (x1.5) and to 5e-2 of the reference's bf16 output, as
the video DiT. int4 (every block linear through its kernel route on both
sides, a 256-wide config) and W8A8: 5e-2. The step's own arithmetic
(guidance rows, CFG and video-only rescale, per-token timesteps of both
streams, the video and audio re-noise draws, scheduler or plain Euler, the
conditioned frames carried) is held exactly around the same stand-in for
the DiT in both packages: 1e-5. `export_wav` byte for byte."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_tpu.core import config as jconfig
from ltx_tpu.io import video as jvideo
from ltx_tpu.kernels import quantization as jq
from ltx_tpu.models import audio_vae as jaudio
from ltx_tpu.models import dit_av as jav
from ltx_tpu.models import text_encoder as jte
from ltx_tpu.ops import rope as jrope
from ltx_tpu.ops.attention import prepare_additive_mask as j_mask
from ltx_tpu.ops.latents import VideoLatentShape as JShape
from ltx_tpu.pipeline import denoise as jdenoise
from ltx_tpu_torch import convert
from ltx_tpu_torch.config import (AudioVAEConfig, GenerationConfig, TransformerConfig,
                                  VocoderConfig)
from ltx_tpu_torch.errors import InvalidConfigurationError
from ltx_tpu_torch.io.video import export_wav
from ltx_tpu_torch.models import audio_vae, dit_av
from ltx_tpu_torch.models import dit as tdit
from ltx_tpu_torch.models.common import QuantizedLinear, W8A8Linear
from ltx_tpu_torch.models.text_encoder import TextEncoderConfig
from ltx_tpu_torch.ops import rope
from ltx_tpu_torch.ops.attention import prepare_additive_mask
from ltx_tpu_torch.ops.latents import VideoLatentShape
from ltx_tpu_torch.pipeline import denoise
from torch_parity import as_np, as_torch, assert_rel, reference_int4_kernel_route, rel_err
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CFG = TransformerConfig().tiny()
# every linear of the dual block passes the int4 kernel route's shape rule
QCFG = dataclasses.replace(CFG, head_dim=64, cross_attention_dim=256, audio_head_dim=64)
GRID, AUDIO_FRAMES, S = (3, 2, 2), 5, 8
NORMS = {"q_norm", "k_norm", "norm1", "norm2", "norm3", "audio_norm1", "audio_norm2",
         "audio_norm3", "audio_to_video_norm", "video_to_audio_norm"}


def _jcfg(cfg):
    return convert.port_config(cfg, jconfig.TransformerConfig)


def _randomize(tree, rng, parent=""):
    """numpy copy with the zero tables and biases and the unit norm weights
    redrawn, so that every parameter matters."""
    if isinstance(tree, dict):
        return {k: _randomize(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize(v, rng, parent) for v in tree]
    a = np.asarray(tree)
    if parent in NORMS:
        return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
    if parent == "b" or "scale_shift_table" in parent:
        return rng.uniform(-0.5, 0.5, a.shape).astype(a.dtype)
    return a


def _av_tree(dtype, cfg=CFG, seed=3):
    tree = jax.tree.map(np.asarray, jav.init_params(jax.random.key(seed), _jcfg(cfg), dtype))
    return _randomize(tree, np.random.default_rng(seed))


def _bf16_values(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _av_inputs(cfg, per_token=False):
    """Two rows: tokens, contexts, a left-padded key bias and timesteps
    (per token when asked), bf16-representable."""
    rng = np.random.default_rng(1)
    f, h, w = GRID
    tv = f * h * w
    out = dict(
        video=_bf16_values(rng.standard_normal((2, tv, cfg.in_channels))),
        audio=_bf16_values(rng.standard_normal((2, AUDIO_FRAMES, cfg.audio_in_channels))),
        vctx=_bf16_values(rng.standard_normal((2, S, cfg.caption_channels))),
        actx=_bf16_values(rng.standard_normal((2, S, cfg.caption_channels))))
    mask = np.ones((2, S), np.int32)
    mask[1, :3] = 0
    out["mask"] = mask
    if per_token:
        out["ts_v"] = rng.uniform(0.0, 1.0, (2, tv)).astype(np.float32)
        out["ts_a"] = rng.uniform(0.0, 1.0, (2, AUDIO_FRAMES)).astype(np.float32)
    else:
        out["ts_v"] = out["ts_a"] = np.array([0.7, 0.3], np.float32)
    return out


def _jax_av(tree, dtype, cfg=CFG, per_token=False):
    x = _av_inputs(cfg, per_token)
    ropes = jav.prepare_av_ropes(_jcfg(cfg), *GRID, AUDIO_FRAMES)
    bias = j_mask(jnp.asarray(x["mask"]))
    return jav.dit_av_forward(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x["video"], dtype),
        jnp.asarray(x["audio"], dtype), jnp.asarray(x["vctx"], dtype),
        jnp.asarray(x["actx"], dtype), jnp.asarray(x["ts_v"]), jnp.asarray(x["ts_a"]), ropes,
        _jcfg(cfg), video_bias=bias, audio_bias=bias)


def _port_av(tree, dtype, cfg=CFG, per_token=False, model=None):
    x = _av_inputs(cfg, per_token)
    model = model if model is not None else convert.av_transformer(tree, cfg)
    ropes = dit_av.prepare_av_ropes(cfg, *GRID, AUDIO_FRAMES)
    bias = prepare_additive_mask(torch.from_numpy(x["mask"]))
    with torch.inference_mode():
        v, a = model(as_torch(x["video"], dtype), as_torch(x["audio"], dtype),
                     as_torch(x["vctx"], dtype), as_torch(x["actx"], dtype),
                     torch.from_numpy(x["ts_v"]), torch.from_numpy(x["ts_a"]), ropes,
                     video_bias=bias, audio_bias=bias)
    assert v.dtype == a.dtype == dtype
    assert v.shape == (2, x["video"].shape[1], cfg.out_channels)
    assert a.shape == (2, AUDIO_FRAMES, cfg.audio_out_channels)
    return v, a


def test_audio_rope_tables_are_the_references():
    """create_audio_position_grid and the four tables of prepare_av_ropes,
    the same float64 host arithmetic: equal."""
    for frames in (1, 26, 251):
        np.testing.assert_array_equal(rope.create_audio_position_grid(frames),
                                      jrope.create_audio_position_grid(frames))
    for cfg in (CFG, TransformerConfig()):
        got = dit_av.prepare_av_ropes(cfg, 4, 2, 3, 26)
        want = jav.prepare_av_ropes(_jcfg(cfg), 4, 2, 3, 26)
        for (gc, gs), (wc, ws) in zip(got, want):
            np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
            np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert dit_av.audio_frame_count(25 / 24) == jav.audio_frame_count(25 / 24) == 26
    assert dit_av.audio_frame_count(241 / 24) == 251


@pytest.mark.parametrize("per_token", [False, True], ids=["row_timesteps", "per_token"])
def test_dit_av_forward_f32(per_token):
    tree = _av_tree(jnp.float32)
    got = _port_av(tree, torch.float32, per_token=per_token)
    want = _jax_av(tree, jnp.float32, per_token=per_token)
    for g, w, stream in zip(got, want, ("video", "audio")):
        assert_rel(g, w, 5e-5, f"dit_av_forward float32 {stream}, per_token={per_token}")


def test_av_block_forward_f32():
    """One dual block on its own: the 8 phases with their two rope tables
    a cross-modal attention."""
    tree = _av_tree(jnp.float32)
    x = _av_inputs(CFG, per_token=True)
    rng = np.random.default_rng(2)
    d, da = CFG.inner_dim, CFG.audio_inner_dim
    tv = x["video"].shape[1]
    vx = rng.standard_normal((2, tv, d)).astype(np.float32)
    ax = rng.standard_normal((2, AUDIO_FRAMES, da)).astype(np.float32)
    ctx_v = rng.standard_normal((2, S, d)).astype(np.float32)
    ctx_a = rng.standard_normal((2, S, da)).astype(np.float32)
    ts_v = rng.standard_normal((2, tv, 6, d)).astype(np.float32)
    ts_a = rng.standard_normal((2, AUDIO_FRAMES, 6, da)).astype(np.float32)
    cv = rng.standard_normal((2, tv, 5, d)).astype(np.float32)
    ca = rng.standard_normal((2, AUDIO_FRAMES, 5, da)).astype(np.float32)
    jropes = jav.prepare_av_ropes(_jcfg(CFG), *GRID, AUDIO_FRAMES)
    block0 = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"])
    want = jav.av_block_forward(block0, *map(jnp.asarray, (vx, ax, ctx_v, ctx_a, ts_v, ts_a,
                                                           cv, ca)),
                                jropes, j_mask(jnp.asarray(x["mask"])),
                                j_mask(jnp.asarray(x["mask"])), _jcfg(CFG))
    block = convert.av_transformer(tree, CFG).blocks[0]
    bias = prepare_additive_mask(torch.from_numpy(x["mask"]))
    with torch.inference_mode():
        got = block(*map(torch.from_numpy, (vx, ax, ctx_v, ctx_a, ts_v, ts_a, cv, ca)),
                    dit_av.prepare_av_ropes(CFG, *GRID, AUDIO_FRAMES), bias, bias)
    for g, w, stream in zip(got, want, ("video", "audio")):
        assert_rel(g, w, 1e-5, f"av_block_forward float32 {stream}")


def test_dit_av_forward_bf16():
    """Both packages in bf16 against the reference in f32 on the same bf16
    weights: the port as close to it as the reference itself (x1.5), and
    within 5e-2 of the reference's bf16 output."""
    tree = _av_tree(jnp.bfloat16)
    got = _port_av(tree, torch.bfloat16, per_token=True)
    want = _jax_av(tree, jnp.bfloat16, per_token=True)
    exact = _jax_av(jax.tree.map(lambda a: np.asarray(a, np.float32), tree), jnp.float32,
                    per_token=True)
    for g, w, e, stream in zip(got, want, exact, ("video", "audio")):
        ref_err = rel_err(w, e)
        assert_rel(g, e, 1.5 * ref_err, f"dit_av_forward bf16 {stream} vs f32 reference")
        assert_rel(g, w, 5e-2, f"dit_av_forward bf16 {stream}")


def test_dit_av_forward_int4_route_matched(monkeypatch):
    """The reference's int4 tree (quantize_transformer_params walks the six
    attentions and two feed-forwards of each dual block), every block linear
    through its kernel route on both sides; the port's own quantization
    selects the same linears."""
    calls = reference_int4_kernel_route(monkeypatch)
    tree = _av_tree(jnp.bfloat16, QCFG)
    qtree = jax.tree.map(np.asarray, jq.quantize_transformer_params(tree, 4, 64))
    want = _jax_av(qtree, jnp.bfloat16, QCFG)
    assert len(calls) == 28  # one traced dual block: 6 attentions x 4 + 2 FFNs x 2
    model = convert.av_transformer(qtree, QCFG)
    assert sum(isinstance(m, QuantizedLinear) for m in model.modules()) == 28 * QCFG.num_layers
    got = _port_av(qtree, torch.bfloat16, QCFG, model=model)
    for g, w, stream in zip(got, want, ("video", "audio")):
        assert_rel(g, w, 5e-2, f"dit_av_forward int4 {stream}, route-matched")
    mine = tdit.quantize_transformer(convert.av_transformer(tree, QCFG), 4, 64)
    np.testing.assert_array_equal(
        sorted(n for n, m in mine.named_modules() if isinstance(m, QuantizedLinear)),
        sorted(n for n, m in model.named_modules() if isinstance(m, QuantizedLinear)))
    for (name, a), (_, b) in zip(mine.named_parameters(), model.named_parameters()):
        assert torch.equal(a, b), name


def test_dit_av_forward_w8a8(monkeypatch):
    """W8A8 on the tiny dual DiT (the size gate lowered on both sides): the
    port's quantize_transformer gives the reference's tree bit for bit, and
    its velocities."""
    monkeypatch.setattr(jq, "_MIN_QUANT_SIZE", 1)
    monkeypatch.setattr(tdit, "_MIN_QUANT_SIZE", 1)
    tree = _av_tree(jnp.bfloat16)
    qtree = jax.tree.map(np.asarray, jq.quantize_transformer_params(
        jax.tree.map(jnp.asarray, tree), 8, w8a8=True))
    model = tdit.quantize_transformer(convert.av_transformer(tree, CFG), 8, w8a8=True)
    assert sum(isinstance(m, W8A8Linear) for m in model.modules()) == 28 * CFG.num_layers
    got_tree = convert.av_transformer_tree(model)
    flat_got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
                     got_tree))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else a,
                     qtree)))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(leaf, flat_want[path], err_msg=str(path))
    back = convert.av_transformer_from_tree(got_tree, CFG)
    got = _port_av(None, torch.bfloat16, model=back)
    want = _jax_av(qtree, jnp.bfloat16)
    for g, w, stream in zip(got, want, ("video", "audio")):
        assert_rel(g, w, 5e-2, f"dit_av_forward W8A8 {stream}")


# ---------------------------------------------------------------------------
# Audio VAE, vocoder, the audio connector, export_wav
# ---------------------------------------------------------------------------


def _audio_trees(seed=4):
    acfg, vcfg = AudioVAEConfig().tiny(), VocoderConfig().tiny()
    rng = np.random.default_rng(seed)
    vae = jax.tree.map(np.asarray, jaudio.init_audio_vae_params(
        jax.random.key(seed), convert.port_config(acfg, jaudio.AudioVAEConfig)))
    voc = jax.tree.map(np.asarray, jaudio.init_vocoder_params(
        jax.random.key(seed + 1), convert.port_config(vcfg, jaudio.VocoderConfig)))
    vae = _randomize(vae, rng)
    vae["latents_mean"] = rng.uniform(-0.5, 0.5, vae["latents_mean"].shape).astype(np.float32)
    vae["latents_std"] = rng.uniform(0.5, 1.5, vae["latents_std"].shape).astype(np.float32)
    return acfg, vcfg, vae, _randomize(voc, rng)


def test_audio_vae_and_vocoder_f32():
    acfg, vcfg, vae, voc = _audio_trees()
    jacfg = convert.port_config(acfg, jaudio.AudioVAEConfig)
    jvcfg = convert.port_config(vcfg, jaudio.VocoderConfig)
    lat = np.random.default_rng(5).standard_normal(
        (2, 8, 7, acfg.mel_latent_bins)).astype(np.float32)
    tvae, tvoc = convert.audio_vae(vae, acfg), convert.vocoder(voc, vcfg)
    with torch.inference_mode():
        mel = audio_vae.audio_vae_decode(tvae, torch.from_numpy(lat))
        wave = audio_vae.vocoder_forward(tvoc, mel)
        full = audio_vae.decode_audio(tvae, tvoc, torch.from_numpy(lat[0]))
    want_mel = jax.jit(jaudio.audio_vae_decode, static_argnums=2)(vae, jnp.asarray(lat), jacfg)
    assert mel.shape == (2, 2, 4 * 7 - 3, acfg.mel_bins)
    assert_rel(mel, want_mel, 1e-5, "audio_vae_decode float32")
    assert_rel(wave, jax.jit(jaudio.vocoder_forward, static_argnums=2)(voc, want_mel, jvcfg),
               1e-5, "vocoder_forward float32")
    want = jaudio.decode_audio_jit(vae, voc, jnp.asarray(lat[0]), jacfg, jvcfg)
    assert full.shape == want.shape == (1, 2, 25 * 2 * 2)
    assert 0.05 < float(np.abs(np.asarray(want)).max()) < 1.0  # the tanh does not saturate
    assert_rel(full, want, 1e-5, "decode_audio float32")


def test_text_encoder_audio_connector_f32():
    """The tree with the audio connector: both outputs, and the tree without
    it has no audio output."""
    cfg = TextEncoderConfig().tiny()
    jcfg = convert.port_config(cfg, jte.TextEncoderConfig)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jte.init_params(
        jax.random.key(6), jcfg, jnp.float32, include_audio=True))
    rng = np.random.default_rng(6)
    hidden = rng.standard_normal((cfg.num_gemma_layers, 2, cfg.max_length,
                                  cfg.hidden_dim)).astype(np.float32)
    mask = np.ones((2, cfg.max_length), np.int32)
    mask[0, :5] = 0
    want = jte.encode_from_hidden_states(tree, jnp.asarray(hidden), jnp.asarray(mask), jcfg)
    model = convert.text_encoder(tree, cfg)
    assert model.has_audio
    with torch.inference_mode():
        got = model.encode_from_hidden_states(torch.from_numpy(hidden), torch.from_numpy(mask))
    assert set(got) == set(want) == {"video", "audio", "mask"}
    for k in ("video", "audio"):
        assert_rel(got[k], want[k], 1e-5, f"text encoder {k} float32")
    assert rel_err(got["audio"], got["video"]) > 0.1  # its own weights
    video_only = {k: v for k, v in tree.items() if k != "audio_embeddings_connector"}
    with torch.inference_mode():
        out = convert.text_encoder(video_only, cfg).encode_from_hidden_states(
            torch.from_numpy(hidden), torch.from_numpy(mask))
    assert set(out) == {"video", "mask"} and torch.equal(out["video"], got["video"])


@pytest.mark.parametrize("shape", [(2, 4800), (1000,)], ids=["stereo", "mono"])
def test_export_wav_is_the_references_byte_for_byte(tmp_path, shape):
    rng = np.random.default_rng(7)
    audio = rng.uniform(-1.2, 1.2, shape).astype(np.float32)  # some values clip
    audio.reshape(-1)[:4] = [1.0, -1.0, 0.0, -0.99999]
    got = export_wav(audio, str(tmp_path / "port" / "a.wav"), sample_rate=16000)
    want = jvideo.export_wav(audio, str(tmp_path / "ref.wav"), sample_rate=16000)
    assert open(got, "rb").read() == open(want, "rb").read()


# ---------------------------------------------------------------------------
# The dual denoise step
# ---------------------------------------------------------------------------


def _standin(xp, v, a, vctx, actx, ts_v, ts_a, bias):
    """An elementwise function of everything the step hands the dual DiT,
    the same expression in jnp and torch, so that any mix-up of rows,
    streams or timesteps shows."""
    f32 = jnp.float32 if xp is jnp else torch.float32
    cast = (lambda t: t.astype(f32)) if xp is jnp else (lambda t: t.float())
    row_v = cast(vctx).mean(axis=(1, 2)) if xp is jnp else cast(vctx).mean(dim=(1, 2))
    row_a = cast(actx).mean(axis=(1, 2)) if xp is jnp else cast(actx).mean(dim=(1, 2))
    tv = ts_v if ts_v.ndim == 2 else ts_v[:, None]
    ta = ts_a if ts_a.ndim == 2 else ts_a[:, None]
    ov = cast(v) * (0.5 + tv[:, :, None]) + row_v[:, None, None] - 0.3 * row_a[:, None, None]
    oa = cast(a) * (0.25 + ta[:, :, None]) + row_a[:, None, None] + 0.2 * row_v[:, None, None]
    if bias is not None:
        b = 1e-4 * bias[:, 0, 0].sum(-1)
        ov, oa = ov + b[:, None, None], oa - b[:, None, None]
    if xp is jnp:
        return ov.astype(v.dtype), oa.astype(a.dtype)
    return ov.to(v.dtype), oa.to(a.dtype)


class StandInAV(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.cfg = CFG

    def forward(self, v, a, vctx, actx, ts_v, ts_a, ropes, video_bias=None, audio_bias=None,
                sdpa_impl="auto"):
        assert ropes[0][0].shape[1] == v.shape[1] and ropes[1][0].shape[1] == a.shape[1]
        assert video_bias is audio_bias
        return _standin(torch, v, a, vctx, actx, ts_v, ts_a, video_bias)


def _j_standin(params, v, a, vctx, actx, ts_v, ts_a, ropes, tcfg, video_bias=None,
               audio_bias=None, **_):
    return _standin(jnp, v, a, vctx, actx, ts_v, ts_a, video_bias)


STEP_CASES = {
    "t2v_cfg_rescale": dict(kw=dict(cfg_scale=3.0, guidance_rescale=0.7)),
    "i2v_injected": dict(kw=dict(cfg_scale=2.0), cond="leading", scale=0.2),
    "keyframes": dict(kw=dict(), cond="keyframes", scale=0.15),
    "audio_cond_injected": dict(kw=dict(cfg_scale=2.5), cond="leading", scale=0.2,
                                audio_k=2),
    "plain_euler_i2v": dict(kw=dict(), cond="leading", scale=0.0, euler="plain"),
}


def _av_step_pair(transformer, tree, case):
    rng = np.random.default_rng(8)
    g = denoise.GuidanceSpec.from_config(GenerationConfig(**case["kw"]))
    jg = jdenoise.GuidanceSpec.from_config(convert.port_config(
        GenerationConfig(**case["kw"]), jconfig.GenerationConfig))
    f, h, w = GRID
    shape, jshape = (VideoLatentShape(1, CFG.in_channels, f, h, w),
                     JShape(1, CFG.in_channels, f, h, w))
    pos, neg = (_bf16_values(rng.standard_normal((1, S, CFG.caption_channels)))
                for _ in range(2))
    apos, aneg = (_bf16_values(rng.standard_normal((1, S, CFG.caption_channels)))
                  for _ in range(2))
    mask = np.ones((1, S), np.int32)
    mask[0, :2] = 0
    contexts = []
    for build, cast, spec in ((denoise.build_guidance_context,
                               lambda x: as_torch(x, torch.bfloat16), g),
                              (jdenoise.build_guidance_context,
                               lambda x: jnp.asarray(x, jnp.bfloat16), jg)):
        m = torch.from_numpy(mask) if spec is g else jnp.asarray(mask)
        vctx, bias = build(spec, cast(pos), m, cast(neg), m)
        actx, _ = build(spec, cast(apos), m, cast(aneg), m)
        contexts.append((vctx, actx, bias))
    extra = dict(fps=24.0)
    jextra = dict(fps=24.0)
    key = jax.random.key(11)
    draws = {}
    cond = case.get("cond")
    if cond is not None:
        idx = (0, 2) if cond == "keyframes" else None
        k = 2 if cond == "keyframes" else 1
        cm = np.zeros((1, f * h * w), np.float32)
        for fr in (idx if idx is not None else range(k)):
            cm[:, fr * h * w:(fr + 1) * h * w] = 1.0
        clean = rng.standard_normal((1, CFG.in_channels, k, h, w)).astype(np.float32)
        common = dict(conditioning_mask=cm, image_cond_noise_scale=case["scale"],
                      cond_frames=k, cond_frame_idx=idx)
        extra.update(common, conditioned_latent=torch.from_numpy(clean))
        jextra.update(common, conditioned_latent=jnp.asarray(clean))
        draws["noise"] = torch.from_numpy(np.array(
            jax.random.normal(key, clean.shape, jnp.float32)))
    if case.get("audio_k"):
        ak = case["audio_k"]
        aclean = rng.standard_normal((1, ak, CFG.audio_in_channels)).astype(np.float32)
        extra.update(audio_cond_frames=ak, audio_conditioned_latent=torch.from_numpy(aclean))
        jextra.update(audio_cond_frames=ak, audio_conditioned_latent=jnp.asarray(aclean))
        draws["audio_noise"] = torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, 1), aclean.shape, jnp.float32)))
    euler = case.get("euler", "scheduler")
    step = denoise.make_av_denoise_step(transformer, g, shape, AUDIO_FRAMES, *contexts[0],
                                        video_euler=euler, **extra)
    jstep = jdenoise.make_av_denoise_step(tree, _jcfg(CFG), jg, jshape, AUDIO_FRAMES,
                                          *contexts[1], video_euler=euler, **jextra)
    video = rng.standard_normal(shape.shape).astype(np.float32)
    audio = rng.standard_normal((1, AUDIO_FRAMES, CFG.audio_in_channels)).astype(np.float32)
    return step, jstep, video, audio, draws, key


@pytest.mark.parametrize("name", STEP_CASES)
def test_av_step_arithmetic_is_the_references(monkeypatch, name):
    monkeypatch.setattr(jav, "dit_av_forward", _j_standin)
    case = STEP_CASES[name]
    step, jstep, video, audio, draws, key = _av_step_pair(StandInAV(), {}, case)
    sigma, sigma_next = 0.725, 0.421875
    want_v, want_a = jstep(jnp.asarray(video), jnp.asarray(audio), sigma, sigma_next, key)
    got_v, got_a = step(torch.from_numpy(video), torch.from_numpy(audio), sigma, sigma_next,
                        **draws)
    assert got_v.dtype == got_a.dtype == torch.float32
    assert_rel(got_v, want_v, 1e-5, f"AV step {name} video")
    assert_rel(got_a, want_a, 1e-5, f"AV step {name} audio")
    if case.get("cond"):
        frames = [0, 2] if case["cond"] == "keyframes" else [0]
        np.testing.assert_allclose(as_np(got_v)[:, :, frames],
                                   np.asarray(want_v)[:, :, frames], rtol=1e-6, atol=1e-6)
        if case["scale"] > 0:
            assert not np.allclose(as_np(got_v)[:, :, frames], video[:, :, frames])
    if case.get("audio_k"):
        np.testing.assert_allclose(as_np(got_a)[:, :2], np.asarray(want_a)[:, :2],
                                   rtol=1e-6, atol=1e-6)
        assert not np.allclose(as_np(got_a)[:, :2], audio[:, :2])
    # a missing draw raises; the loop hands one a step
    if case.get("scale"):
        with pytest.raises(ValueError, match="draw"):
            step(torch.from_numpy(video), torch.from_numpy(audio), sigma, sigma_next)
        with pytest.raises(ValueError, match="draws"):
            denoise.run_av_denoise_loop(step, torch.from_numpy(video),
                                        torch.from_numpy(audio), [1.0, 0.5, 0.0])


def test_av_loop_and_the_bf16_dit():
    """run_av_denoise_loop with the real bf16 dual DiT against the
    reference's loop (keys split once a step), guided, I2V with the
    conditioned frame re-noised every step: 5e-2 of each stream."""
    tree = _av_tree(jnp.bfloat16)
    case = dict(kw=dict(cfg_scale=2.0), cond="leading", scale=0.2)
    step, jstep, video, audio, _, _ = _av_step_pair(convert.av_transformer(tree, CFG),
                                                    jax.tree.map(jnp.asarray, tree), case)
    sigmas = np.array([1.0, 0.725, 0.4, 0.0], np.float32)
    key = jax.random.key(12)
    want_v, want_a = jdenoise.run_av_denoise_loop(jstep, jnp.asarray(video),
                                                  jnp.asarray(audio), sigmas, key=key)
    draws, k = [], key
    f, h, w = GRID
    for _ in range(3):
        k, sub = jax.random.split(k)
        draws.append(torch.from_numpy(np.array(jax.random.normal(
            sub, (1, CFG.in_channels, 1, h, w), jnp.float32))))
    seen = []
    with torch.inference_mode():
        got_v, got_a = denoise.run_av_denoise_loop(
            step, torch.from_numpy(video), torch.from_numpy(audio), sigmas, cond_noise=draws,
            on_step=lambda i, n, s: seen.append((i, n, s)))
    assert seen == [(i, 3, float(sigmas[i])) for i in range(3)]
    assert_rel(got_v, want_v, 5e-2, "AV loop bf16 DiT video")
    assert_rel(got_a, want_a, 5e-2, "AV loop bf16 DiT audio")


def test_av_step_refuses_what_the_reference_refuses():
    g = denoise.GuidanceSpec.from_config(GenerationConfig(stg_scale=1.0, stg_blocks=(0,)))
    shape = VideoLatentShape(1, CFG.in_channels, *GRID)
    ctx = torch.zeros(1, S, CFG.caption_channels)
    with pytest.raises(ValueError, match="STG"):
        denoise.make_av_denoise_step(StandInAV(), g, shape, AUDIO_FRAMES, ctx, ctx, None)
    g = denoise.GuidanceSpec.from_config(GenerationConfig())
    with pytest.raises(InvalidConfigurationError, match="pp_mesh"):
        denoise.make_av_denoise_step(StandInAV(), g, shape, AUDIO_FRAMES, ctx, ctx, None,
                                     pp_mesh=object())
    with pytest.raises(ValueError, match="audio_cond_frames"):
        denoise.make_av_denoise_step(StandInAV(), g, shape, AUDIO_FRAMES, ctx, ctx, None,
                                     audio_cond_frames=AUDIO_FRAMES)
    with pytest.raises(ValueError, match="video_euler"):
        denoise.make_av_denoise_step(StandInAV(), g, shape, AUDIO_FRAMES, ctx, ctx, None,
                                     video_euler="heun")
