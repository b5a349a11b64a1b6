"""A reader of Hugging Face `tokenizer.json` files: text to ids and back.

What `LTXPipeline.tokenize` and prompt enhancement need from the
`tokenizers` package (`Tokenizer.from_file(path).encode(text).ids` and
`.decode(ids)`), for the components a Gemma tokenizer and the tests'
tokenizers use, with the package's semantics:

  * added tokens are cut out of the text whole before anything else
    (leftmost, longest first), those marked `normalized` after
    normalization;
  * normalizers `Replace` (a string or a regex), `Prepend`, `Sequence`;
  * pre-tokenizers none, `Whitespace` (runs of word characters, runs of
    other non-space characters) and `Metaspace` (spaces to the
    replacement, prepended by its scheme, split before each);
  * models `BPE` (merges by rank, leftmost first among equals;
    `byte_fallback` to `<0xXX>` tokens; `unk_token` with `fuse_unk`;
    `ignore_merges`) and `WordLevel`;
  * post-processor `TemplateProcessing` (the `single` template);
  * decoding: special added tokens and unknown ids are skipped, then the
    decoders `Replace`, `ByteFallback` (runs of `<0xXX>` tokens as UTF-8,
    one U+FFFD per byte when they are not), `Fuse`, `Strip` and
    `Sequence` (Gemma's), or without a decoder the tokens joined by spaces.

Any other component, or an option of these that changes the ids and is
not implemented, raises NotImplementedError when the file is read, never
while encoding; another decoder raises when `decode` is called.
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from pathlib import Path
from typing import List, Optional, Tuple


class Encoding:
    """The ids of one encoded text (`tokenizers.Encoding.ids`)."""

    def __init__(self, ids: List[int]):
        self.ids = ids


def _unsupported(what: str):
    raise NotImplementedError(f"tokenizer.json: {what} is not supported by this reader")


# --------------------------------------------------------------------------
# Normalizers
# --------------------------------------------------------------------------


def _pattern(spec: dict):
    """A `{"String": s}` or `{"Regex": r}` pattern -> a compiled regex."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return re.compile(spec["Regex"])
    return _unsupported(f"pattern {spec}")


def _normalizer(spec: Optional[dict]):
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: pat.sub(lambda _: content, s)
    if kind == "Prepend":
        prefix = spec["prepend"]
        return lambda s: prefix + s if s else s
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]

        def run(s):
            for step in steps:
                s = step(s)
            return s
        return run
    return _unsupported(f"normalizer {kind}")


# --------------------------------------------------------------------------
# Pre-tokenizers: (text, offset of the piece in the original text) -> words
# --------------------------------------------------------------------------

# word characters as Unicode's regular expressions define them (what the
# tokenizers package's `\w` matches): letters, marks, decimal digits,
# connector punctuation, letter numbers, join controls, and the symbols
# that are alphabetic (circled and squared letters)
_ALPHABETIC_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                       (0x1F170, 0x1F189))


def _is_word(ch: str) -> bool:
    cat = unicodedata.category(ch)
    if cat[0] in "LM" or cat in ("Nd", "Nl", "Pc"):
        return True
    cp = ord(ch)
    return cp in (0x200C, 0x200D) or any(lo <= cp <= hi for lo, hi in _ALPHABETIC_SYMBOLS)


# Unicode's White_Space property (`\s`); str.isspace() also takes the
# separators U+001C..U+001F, which are not white space there
_WHITE_SPACE = frozenset("\t\n\v\f\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                         + "".join(map(chr, range(0x2000, 0x200B))))


def _whitespace_split(text: str) -> List[str]:
    r"""`\w+|[^\w\s]+`: runs of word characters, runs of other non-space
    characters."""
    words, cur, cur_kind = [], [], None
    for ch in text:
        kind = "w" if _is_word(ch) else ("s" if ch in _WHITE_SPACE else "p")
        if kind != cur_kind and cur:
            if cur_kind != "s":
                words.append("".join(cur))
            cur = []
        cur.append(ch)
        cur_kind = kind
    if cur and cur_kind != "s":
        words.append("".join(cur))
    return words


def _pre_tokenizer(spec: Optional[dict]):
    if spec is None:
        return lambda text, offset: [text] if text else []
    kind = spec.get("type")
    if kind == "Whitespace":
        return lambda text, offset: _whitespace_split(text)
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if scheme not in ("always", "first", "never"):
            _unsupported(f"Metaspace prepend_scheme {scheme}")
        split = spec.get("split", True)

        def metaspace(text, offset):
            text = text.replace(" ", rep)
            if not text.startswith(rep) and (
                    scheme == "always" or (scheme == "first" and offset == 0)):
                text = rep + text
            if not split:
                return [text] if text else []
            pieces, start = [], 0
            for i in range(1, len(text)):
                if text[i] == rep:
                    pieces.append(text[start:i])
                    start = i
            if text:
                pieces.append(text[start:])
            return pieces
        return metaspace
    return _unsupported(f"pre_tokenizer {kind}")


# --------------------------------------------------------------------------
# Models
# --------------------------------------------------------------------------


class _WordLevel:
    def __init__(self, spec: dict):
        self.vocab = spec["vocab"]
        unk = spec.get("unk_token")
        self.unk = self.vocab[unk] if unk is not None else None

    def tokenize(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        if self.unk is None:
            raise ValueError(f"{word!r} is not in the vocabulary and there is no unk_token")
        return [self.unk]


class _BPE:
    def __init__(self, spec: dict):
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                _unsupported(f"BPE {key}={spec[key]!r}")
        self.vocab = spec["vocab"]
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges = {}  # (left id, right id) -> (rank, merged id)
        for rank, merge in enumerate(spec.get("merges", [])):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            if a not in self.vocab or b not in self.vocab or a + b not in self.vocab:
                raise ValueError(f"merge {a!r} {b!r}: a token is not in the vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])

    def _symbols(self, word: str) -> List[int]:
        """One symbol per character, bytes for a character outside the
        vocabulary (byte fallback), else the unknown token (fused runs)."""
        ids: List[int] = []
        unk: Optional[int] = None
        for ch in word:
            if ch in self.vocab:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(self.vocab[ch])
                continue
            if self.byte_fallback:
                codes = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode()]
                if all(c is not None for c in codes):
                    ids.extend(codes)
                    continue
            if self.unk_token is None:
                raise ValueError(f"{ch!r} is not in the vocabulary and there is no unk_token")
            if unk is not None and not self.fuse_unk:
                ids.append(unk)
            unk = self.vocab[self.unk_token]
        if unk is not None:
            ids.append(unk)
        return ids

    def tokenize(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        sym = self._symbols(word)
        n = len(sym)
        nxt, prv = list(range(1, n + 1)), list(range(-1, n - 1))
        alive = [True] * n
        queue: List[Tuple[int, int, int]] = []
        for i in range(n - 1):
            m = self.merges.get((sym[i], sym[i + 1]))
            if m is not None:
                queue.append((m[0], i, m[1]))
        heapq.heapify(queue)
        while queue:
            rank, i, new = heapq.heappop(queue)
            j = nxt[i]
            if not alive[i] or j >= n:
                continue
            if self.merges.get((sym[i], sym[j]), (None, None))[1] != new:
                continue  # an entry for a pair that has changed since
            sym[i] = new
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prv[nxt[j]] = i
            if prv[i] >= 0:
                m = self.merges.get((sym[prv[i]], new))
                if m is not None:
                    heapq.heappush(queue, (m[0], prv[i], m[1]))
            if nxt[i] < n:
                m = self.merges.get((new, sym[nxt[i]]))
                if m is not None:
                    heapq.heappush(queue, (m[0], i, m[1]))
        return [s for s, a in zip(sym, alive) if a]


def _model(spec: dict):
    kind = spec.get("type")
    if kind == "BPE" or (kind is None and "merges" in spec):
        return _BPE(spec)
    if kind == "WordLevel":
        return _WordLevel(spec)
    return _unsupported(f"model {kind}")


# --------------------------------------------------------------------------
# Decoders: a list of token strings -> a list of strings
# --------------------------------------------------------------------------


def _byte_fallback(tokens: List[str]) -> List[str]:
    """Runs of `<0xXX>` tokens become their UTF-8 text, or one U+FFFD a
    byte when the run is not valid UTF-8."""
    out: List[str] = []
    run = bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("\ufffd" * len(run))
            run.clear()

    for tok in tokens:
        if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
            try:
                run.append(int(tok[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(tok)
    flush()
    return out


def _strip(content: str, start: int, stop: int):
    """Each token without up to `start` leading and `stop` trailing
    `content` characters."""
    def run(tokens: List[str]) -> List[str]:
        out = []
        for tok in tokens:
            lo = 0
            while lo < min(start, len(tok)) and tok[lo] == content:
                lo += 1
            hi = len(tok)
            while len(tok) - hi < stop and hi > lo and tok[hi - 1] == content:
                hi -= 1
            out.append(tok[lo:hi])
        return out
    return run


def _decoder(spec: Optional[dict]):
    """A decoder spec -> a function of the token list, or a function that
    raises NotImplementedError for a decoder this reader lacks."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda tokens: [pat.sub(lambda _: content, t) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return _strip(spec["content"], int(spec.get("start", 0)), int(spec.get("stop", 0)))
    if kind == "Sequence":
        steps = [_decoder(d) for d in spec["decoders"]]

        def run(tokens):
            for step in steps:
                tokens = step(tokens)
            return tokens
        return run

    def unsupported(tokens):
        return _unsupported(f"decoder {kind}")
    return unsupported


# --------------------------------------------------------------------------
# The tokenizer
# --------------------------------------------------------------------------


class Tokenizer:
    """`Tokenizer.from_file(path).encode(text).ids`, `.decode(ids)`."""

    def __init__(self, spec: dict):
        for key in ("truncation", "padding"):
            if spec.get(key):
                _unsupported(key)
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = _model(spec["model"])
        self.raw_added, self.normalized_added = {}, {}
        self.decoder = _decoder(spec.get("decoder"))
        self.id_to_token = {i: t for t, i in self.model.vocab.items()}
        self.special_ids = set()
        for tok in spec.get("added_tokens", []):
            self.id_to_token[tok["id"]] = tok["content"]
            if tok.get("special", False):
                self.special_ids.add(tok["id"])
            for opt in ("single_word", "lstrip", "rstrip"):
                if tok.get(opt):
                    _unsupported(f"added token {tok['content']!r} with {opt}")
            if tok.get("normalized", not tok.get("special", False)):
                self.normalized_added[self.normalize(tok["content"])] = tok["id"]
            else:
                self.raw_added[tok["content"]] = tok["id"]
        self.template = self._template(spec.get("post_processor"))

    @staticmethod
    def _template(spec: Optional[dict]):
        """The single-sequence template as a list of ids and None (the text)."""
        if spec is None:
            return [None]
        if spec.get("type") != "TemplateProcessing":
            _unsupported(f"post_processor {spec.get('type')}")
        out = []
        for piece in spec["single"]:
            if "Sequence" in piece:
                out.append(None)
            elif "SpecialToken" in piece:
                out.extend(spec["special_tokens"][piece["SpecialToken"]["id"]]["ids"])
            else:
                _unsupported(f"template piece {piece}")
        return out

    @classmethod
    def from_file(cls, path) -> "Tokenizer":
        return cls(json.loads(Path(path).read_text(encoding="utf-8")))

    @classmethod
    def from_str(cls, text: str) -> "Tokenizer":
        return cls(json.loads(text))

    @staticmethod
    def _split(text: str, offset: int, tokens: dict):
        """Cut the added tokens of `tokens` out of `text`, leftmost and then
        longest first: [(piece, its offset, None) or (token, offset, id)]."""
        if not tokens:
            return [(text, offset, None)] if text else []
        longest = max(map(len, tokens))
        out, start, i = [], 0, 0
        while i < len(text):
            for n in range(min(longest, len(text) - i), 0, -1):
                if text[i:i + n] in tokens:
                    if i > start:
                        out.append((text[start:i], offset + start, None))
                    out.append((text[i:i + n], offset + i, tokens[text[i:i + n]]))
                    i += n
                    start = i
                    break
            else:
                i += 1
        if start < len(text):
            out.append((text[start:], offset + start, None))
        return out

    def encode(self, text: str) -> Encoding:
        ids: List[int] = []
        for piece, offset, tid in self._split(text, 0, self.raw_added):
            if tid is not None:
                ids.append(tid)
                continue
            for part, off, nid in self._split(self.normalize(piece), offset,
                                             self.normalized_added):
                if nid is not None:
                    ids.append(nid)
                    continue
                for word in self.pre_tokenize(part, off):
                    ids.extend(self.model.tokenize(word))
        out: List[int] = []
        for t in self.template:
            if t is None:
                out.extend(ids)
            else:
                out.append(t)
        return Encoding(out)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        """The text of `ids`: each id's token (an unknown id skipped, a
        special added token too unless skip_special_tokens is False)
        through the decoder, or joined by spaces when there is none."""
        tokens = [self.id_to_token[i] for i in map(int, ids) if i in self.id_to_token
                  and not (skip_special_tokens and i in self.special_ids)]
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))
