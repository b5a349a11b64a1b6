"""Port parity: prompt enhancement (ltx_tpu_torch.pipeline.enhance, the
tokenizer's `decode`, the pipeline's wiring) against ltx_tpu.

The tiny Gemma and a Gemma-style byte-fallback tokenizer whose ids all fit
the tiny vocabulary (`tokenizer_spec`): the reference reads it with the
`tokenizers` package, the port with its own reader. Tolerances: strings and
token ids equal; the spliced embeddings bit for bit; the tokenizer's
`decode` equal to the package's on every id list. The pipeline's wiring
is held in tests/test_torch_pipeline.py, which builds the tiny pipelines.
"""

import dataclasses
import json
import logging
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors

from ltx_tpu.models import gemma3 as jg
from ltx_tpu.models import siglip as js
from ltx_tpu.pipeline import enhance as je
from ltx_tpu_torch import convert
from ltx_tpu_torch.errors import InvalidConfigurationError
from ltx_tpu_torch.pipeline import enhance as pe
from ltx_tpu_torch.tokenizer import Tokenizer as PortTokenizer
from test_torch_tokenizer import BOS, _strings, _trained_bpe
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

# the tiny Gemma with room for a tokenizer that spells the system prompts in
# a few hundred tokens (the reference's sizes otherwise)
GCFG = dataclasses.replace(jg.Gemma3Config().tiny(), vocab_size=2048)
GEMMA_DECODER = {"type": "Sequence", "decoders": [
    {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
    {"type": "ByteFallback"}, {"type": "Fuse"},
    {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}


def tokenizer_spec(vocab_size: int = GCFG.vocab_size) -> dict:
    """A Gemma-style tokenizer.json of exactly `vocab_size` ids: special
    tokens, byte fallback for the bytes 0x00-0x7F, spaces as "▁", the
    printable ASCII characters, merges that spell each word of the system
    prompts, unused tokens up to the size, a BOS template and Gemma's
    decoder."""
    specials = ["<pad>", "<eos>", "<bos>", "<unk>", "<start_of_turn>", "<end_of_turn>"]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(128):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for ch in "▁" + "".join(chr(c) for c in range(33, 127)):
        vocab.setdefault(ch, len(vocab))
    merges = []
    words = sorted(set(je.T2V_SYSTEM_PROMPT.split() + je.I2V_SYSTEM_PROMPT.split()))
    for word in (w for w in words if all(ch in vocab for ch in w)):
        pieces = list("▁" + word)
        while len(pieces) > 1 and len(vocab) < vocab_size:
            merged = pieces[0] + pieces[1]
            if merged not in vocab:
                vocab[merged] = len(vocab)
            merges.append(f"{pieces[0]} {pieces[1]}")
            pieces[:2] = [merged]
        if len(vocab) >= vocab_size:
            break
    merges = list(dict.fromkeys(merges))
    while len(vocab) < vocab_size:
        vocab[f"<unused{len(vocab)}>"] = len(vocab)
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": vocab[t], "content": t, "single_word": False,
                              "lstrip": False, "rstrip": False, "normalized": False,
                              "special": True} for t in specials],
            "normalizer": {"type": "Replace", "pattern": {"String": " "}, "content": "▁"},
            "pre_tokenizer": None, "post_processor": BOS, "decoder": GEMMA_DECODER,
            "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}


@pytest.fixture(scope="module")
def toks():
    """The reference's tokenizer (the `tokenizers` package) and the port's,
    on the same file."""
    text = json.dumps(tokenizer_spec())
    ref, port = Tokenizer.from_str(text), PortTokenizer.from_str(text)
    assert ref.get_vocab_size() == GCFG.vocab_size
    chat = je.build_chat_prompt(je.T2V_SYSTEM_PROMPT, "a cat")
    assert port.encode(chat).ids == ref.encode(chat).ids
    return ref, port


@pytest.fixture(scope="module")
def gemma():
    params = jax.jit(jg.init_params, static_argnums=(1, 2))(jax.random.key(0), GCFG,
                                                             jnp.float32)
    return params, convert.gemma(params, GCFG)


# ---------------------------------------------------------------------------
# The template, the cleaning, the tokenizer's decode
# ---------------------------------------------------------------------------


def test_system_prompts_chat_template_and_cleaning():
    assert pe.T2V_SYSTEM_PROMPT == je.T2V_SYSTEM_PROMPT
    assert pe.I2V_SYSTEM_PROMPT == je.I2V_SYSTEM_PROMPT
    chat = pe.build_chat_prompt("SYS", "a cat")
    assert chat == je.build_chat_prompt("SYS", "a cat")
    assert chat.startswith("<start_of_turn>user\nSYS") and chat.endswith("<start_of_turn>model\n")
    for text in ("Output: Style: realistic.<end_of_turn><eos>", "  prompt :  x ```",
                 "<start_of_turn>Output:Prompt: y", "", "```\n\n```", "plain text"):
        assert pe.clean_enhanced_prompt(text) == je.clean_enhanced_prompt(text), text


def _word_level():
    vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2}
    vocab.update({w: i + 4 for i, w in enumerate(["a", "cat", "plays", "piano", "dog"])})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<eos>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="<bos> $A",
                                                       special_tokens=[("<bos>", 2)])
    return tok


def _gemma_style():
    spec = _trained_bpe(True, fuse_unk=True)
    vocab = spec["model"]["vocab"]
    for b in range(256):
        vocab.setdefault(f"<0x{b:02X}>", len(vocab))
    spec["post_processor"] = BOS
    tok = Tokenizer.from_str(json.dumps(spec))
    tok.add_special_tokens(["<start_of_turn>", "<end_of_turn>"])
    tok.add_tokens(["an added word"])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    return tok


def _metaspace():
    spec = _trained_bpe(False, fuse_unk=True)
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                             "prepend_scheme": "first", "split": True}
    tok = Tokenizer.from_str(json.dumps(spec))
    tok.add_special_tokens(["<eos>"])
    return tok


@pytest.mark.parametrize("build", [_word_level, _gemma_style, _metaspace],
                         ids=["word_level", "gemma_style", "metaspace"])
def test_tokenizer_decode_matches_tokenizers(build):
    """The test_torch_tokenizer files: the encodings of its strings and
    random id lists (special and unknown ids among them), with and without
    skipping special tokens."""
    hf = build()
    port = PortTokenizer.from_str(hf.to_str())
    rng = random.Random(0)
    n = hf.get_vocab_size(with_added_tokens=True)
    id_lists = [hf.encode(s).ids for s in _strings()]
    id_lists += [[rng.randrange(n + 3) for _ in range(rng.randint(0, 40))] for _ in range(200)]
    for ids in id_lists:
        for skip in (True, False):
            assert port.decode(ids, skip) == hf.decode(ids, skip_special_tokens=skip), ids


def test_decoder_steps_the_reader_lacks_raise_on_decode():
    spec = _trained_bpe(False)
    spec["decoder"] = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                       "split": True}
    port = PortTokenizer.from_str(json.dumps(spec))
    assert port.encode("a cat").ids  # encoding is unaffected
    with pytest.raises(NotImplementedError, match="decoder Metaspace"):
        port.decode([4, 5])


# ---------------------------------------------------------------------------
# enhance_prompt, enhance_prompts
# ---------------------------------------------------------------------------

VCFG = dataclasses.replace(js.SigLIPConfig().tiny(), text_hidden_size=GCFG.hidden_size)


@pytest.fixture(scope="module")
def vision():
    params = jax.jit(js.init_params, static_argnums=1)(jax.random.key(3), VCFG)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params, convert.siglip(params, VCFG)


@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    from PIL import Image

    arr = np.random.default_rng(1).integers(0, 256, (30, 44, 3), dtype=np.uint8)
    path = tmp_path_factory.mktemp("img") / "cond.png"
    Image.fromarray(arr).save(path)
    return str(path)


def test_splice_image_embeds_matches_reference(gemma, toks, vision, image_file):
    params, model = gemma
    soft = js.embed_image_for_gemma(vision[0], image_file, VCFG)
    ids, want = je._splice_image_embeds(params, GCFG, toks[0], je.I2V_SYSTEM_PROMPT, "a dog",
                                        soft)
    pids, got = pe._splice_image_embeds(model, toks[1], pe.I2V_SYSTEM_PROMPT, "a dog",
                                        torch.from_numpy(np.array(soft)))
    assert pids == ids and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("i2v", [False, True], ids=["t2v", "i2v_image"])
def test_enhance_prompt_greedy_matches_reference(gemma, toks, vision, image_file, i2v):
    """Temperature 0 (speculation on, the default 8 drafts): the reference's
    string; I2V splices the image's soft tokens."""
    params, model = gemma
    kw = dict(is_i2v=i2v, max_tokens=12, temperature=0.0)
    img = dict(image_path=image_file) if i2v else {}
    want = je.enhance_prompt(params, GCFG, toks[0], "a dog on a hill", **kw, **img,
                             vision_params=vision[0] if i2v else None, vision_config=VCFG)
    stats = {}
    got = pe.enhance_prompt(model, toks[1], "a dog on a hill", **kw, **img,
                            vision=vision[1] if i2v else None, stats=stats)
    assert got == want and got != "a dog on a hill"
    assert stats["tokens"] <= 12 and 0 < stats["forwards"] <= 12


def test_enhance_prompt_falls_back_and_warns(gemma, toks, image_file, caplog):
    _, model = gemma
    with caplog.at_level(logging.WARNING, logger="ltx_tpu_torch"):
        assert pe.enhance_prompt(model, None, "a dog") == "a dog"
    assert "prompt enhancement failed" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="ltx_tpu_torch"):
        pe.enhance_prompt(model, toks[1], "a dog", is_i2v=True, image_path=image_file,
                          max_tokens=2, temperature=0.0)
    assert "TEXT-ONLY" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="ltx_tpu_torch"):
        # a mesh the model is not sharded over: refused, and the raw prompt
        assert pe.enhance_prompt(model, toks[1], "a dog", mesh=object()) == "a dog"
    assert "shard the model" in caplog.text


@pytest.mark.parametrize("kw", [dict(), dict(max_batch=1, kv_quant="int8", spec_k=4)],
                         ids=["one_batch", "micro_batches_int8_spec"])
def test_enhance_prompts_matches_reference(gemma, toks, kw):
    params, model = gemma
    prompts = ["a cat", "a dog on a hill"]
    want = je.enhance_prompts(params, GCFG, toks[0], prompts, max_tokens=8, temperature=0.0,
                              **kw)
    got = pe.enhance_prompts(model, toks[1], prompts, max_tokens=8, temperature=0.0,
                             strict=True, **kw)
    assert got == want and all(got)


def test_enhance_prompts_image_rows_and_strict(gemma, toks, vision, image_file):
    """Image rows splice their soft tokens and decode from those embeddings
    (each row its solo enhance_prompt's greedy text; the reference drops the
    embeddings in its batched call, a fault noted in ROADMAP); without the
    tower, strict raises and best effort warns."""
    _, model = gemma
    kw = dict(is_i2v=True, max_tokens=8, temperature=0.0)
    got = pe.enhance_prompts(model, toks[1], ["a cat", "a dog"], spec_k=4,
                             image_paths=[None, image_file], vision=vision[1], strict=True, **kw)
    assert got == [pe.enhance_prompt(model, toks[1], "a cat", spec_k=4, **kw),
                   pe.enhance_prompt(model, toks[1], "a dog", image_path=image_file,
                                     vision=vision[1], spec_k=4, **kw)]
    with pytest.raises(InvalidConfigurationError, match="no vision tower"):
        pe.enhance_prompts(model, toks[1], ["a dog"], image_paths=[image_file], strict=True,
                           **kw)
    assert pe.enhance_prompts(model, None, ["a dog"], **kw) == ["a dog"]
