"""The port's tokenizer.json reader (ltx_tpu_torch.tokenizer) against the
`tokenizers` package: the same ids for a few hundred strings (ASCII,
accented Latin, CJK, emoji, control and odd white space, added tokens
written into the text, an over-long prompt), on

  * the WordLevel tokenizer of tests/test_load_pipeline_e2e.py (Whitespace
    pre-tokenizer, a BOS template);
  * a Gemma-style BPE trained here: byte fallback, `Replace(" ", "▁")`,
    added special tokens, a BOS template;
  * a BPE behind `Prepend("▁")` and a Metaspace pre-tokenizer that prepends
    to the first piece only, with an unknown token fused over runs and no
    byte fallback.

A component the reader does not implement fails when the file is read.
"""

import json
import random

import pytest
from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors, trainers

from ltx_tpu_torch.tokenizer import Tokenizer as PortTokenizer

CORPUS = ["A beaver builds a dam in a mountain stream at golden hour",
          "The quick brown fox jumps over the lazy dog",
          "un café crème, s'il vous plaît", "Größe und Maß", "东京的夜景非常漂亮",
          "emoji 🦫🌄 fun", "a cat plays piano", "naïve coöperation ½ x² Ⓐ"]
BOS = {"type": "TemplateProcessing",
       "single": [{"SpecialToken": {"id": "<bos>", "type_id": 0}},
                  {"Sequence": {"id": "A", "type_id": 0}}],
       "pair": [{"Sequence": {"id": "A", "type_id": 0}}],
       "special_tokens": {"<bos>": {"id": "<bos>", "ids": [2], "tokens": ["<bos>"]}}}


def _strings(extra=()):
    rng = random.Random(0)
    alphabet = (list("abcdefghijklmnopqrstuvwxyz ABCXYZ0123456789,.;!?'\"-_()") +
                list("éèüßøñç东京夜景🦫🌄🎬▁") + ["  ", "\t", "\n", "　", "\xa0",
                                              "\x1c", "‍", "½", "²", "Ⓐ"] + list(extra))
    strings = CORPUS + ["", " ", "  leading", "trailing  ", "a" * 3000,
                        " ".join(CORPUS) * 40]
    strings += ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, 80)))
                for _ in range(300)]
    return strings


def _assert_same_ids(hf: Tokenizer, strings):
    port = PortTokenizer.from_str(hf.to_str())
    for s in strings:
        assert port.encode(s).ids == hf.encode(s).ids, repr(s)


def test_word_level_whitespace_bos():
    vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2}
    vocab.update({w: i + 4 for i, w in enumerate(["a", "cat", "plays", "piano", "dog"])})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<eos>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="<bos> $A",
                                                       special_tokens=[("<bos>", 2)])
    _assert_same_ids(tok, _strings())


def _trained_bpe(byte_fallback: bool, **model_kw):
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=byte_fallback, **model_kw))
    tok.normalizer = normalizers.Replace(" ", "▁")
    tok.train_from_iterator(CORPUS * 10, trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<pad>", "<eos>", "<bos>", "<unk>"]))
    return json.loads(tok.to_str())


def test_gemma_style_bpe_with_byte_fallback_and_special_tokens():
    spec = _trained_bpe(True, fuse_unk=True)
    vocab = spec["model"]["vocab"]
    for b in range(256):  # Gemma's byte tokens are model vocabulary
        vocab.setdefault(f"<0x{b:02X}>", len(vocab))
    spec["post_processor"] = BOS
    tok = Tokenizer.from_str(json.dumps(spec))
    tok.add_special_tokens(["<start_of_turn>", "<end_of_turn>"])
    assert json.loads(tok.to_str())["model"]["byte_fallback"]
    _assert_same_ids(tok, _strings(["<start_of_turn>", "<end_of_turn>", "<eos>", "<0x41>",
                                    "<unk>", "<start_of"]))


def test_prepend_metaspace_bpe_fused_unknowns():
    spec = _trained_bpe(False, fuse_unk=True)
    spec["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Prepend", "prepend": "▁"}, {"type": "Replace", "pattern": {"String": " "},
                                              "content": "▁"}]}
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                             "prepend_scheme": "first", "split": True}
    spec["post_processor"] = BOS
    tok = Tokenizer.from_str(json.dumps(spec))
    tok.add_special_tokens(["<eos>"])
    _assert_same_ids(tok, _strings(["<eos>"]))


@pytest.mark.parametrize("change", [
    {"normalizer": {"type": "NFKC"}},
    {"pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                       "use_regex": True}},
    {"post_processor": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
                        "use_regex": True}},
    {"truncation": {"direction": "Right", "max_length": 8, "strategy": "LongestFirst",
                    "stride": 0}},
])
def test_unsupported_components_fail_when_read(change):
    spec = {**_trained_bpe(True), **change}
    with pytest.raises(NotImplementedError, match="not supported"):
        PortTokenizer.from_str(json.dumps(spec))
