"""CLIP BPE tokenizer — OpenAI byte-level BPE, pure Python, stdlib ``re``.

Port of ``dropclip_tpu/teachers/tokenizer.py`` (reference
models/features/clip/simple_tokenizer.py:68-138, clip.py:206-247). The
JAX package splits words with the third-party ``regex`` module's
``\\p{L}`` / ``\\p{N}`` classes and ``\\s``; the card's machine has no
``regex``, so this port spells the same classes out for stdlib ``re``:
letter and number classes are built once from ``unicodedata`` categories
(L*, N*), and whitespace is Unicode's White_Space set, which is what
``regex``'s ``\\s`` matches. Token ids are identical (tested).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import sys
import unicodedata
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

VOCAB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets", "bpe_simple_vocab_16e6.txt.gz")
CONTEXT_LENGTH = 77
SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"

# Unicode White_Space (``regex``'s \s)
_WS = ("\t\n\x0b\x0c\r\x20\x85\xa0\u1680\u2000-\u200a\u2028\u2029"
       "\u202f\u205f\u3000")
_SPACE_RE = re.compile(f"[{_WS}]+")
# characters that dominate latin-1/cp1252-mis-decoded UTF-8 ("mojibake")
_MOJIBAKE_RE = re.compile("[\u00c2\u00c3\u00e2\u0080-\u009f]")


def _category_class(major: str) -> str:
    """A ``re`` character-class body of every code point whose Unicode
    general category starts with ``major`` ("L" letters, "N" numbers)."""
    ranges, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp))[0] == major:
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            ranges.append((start, prev))
            start = None
    if start is not None:
        ranges.append((start, prev))
    esc = lambda cp: re.escape(chr(cp))
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}"
                   for a, b in ranges)


@functools.lru_cache()
def _word_re() -> re.Pattern:
    letters, numbers = _category_class("L"), _category_class("N")
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        f"|[{letters}]+|[{numbers}]|[^{_WS}{letters}{numbers}]+",
        re.IGNORECASE)


def fix_text(text: str) -> str:
    """ftfy-equivalent text repair (reference simple_tokenizer.py:50-54):
    re-decode cp1252/latin-1 mojibake (up to twice, only when it strictly
    reduces the indicator characters), NFC-normalize, drop control /
    surrogate / unassigned characters except whitespace. Identity on
    ASCII."""
    for _ in range(2):
        bad = len(_MOJIBAKE_RE.findall(text))
        if not bad:
            break
        repaired = None
        for codec in ("cp1252", "latin-1"):
            try:
                cand = text.encode(codec).decode("utf-8")
            except (UnicodeEncodeError, UnicodeDecodeError):
                continue
            if len(_MOJIBAKE_RE.findall(cand)) < bad:
                repaired = cand
                break
        if repaired is None:
            break
        text = repaired
    text = unicodedata.normalize("NFC", text)
    return "".join(c for c in text
                   if c.isspace()
                   or unicodedata.category(c) not in ("Cc", "Co", "Cs", "Cn"))


@functools.lru_cache()
def _byte_unicode_table() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    printable = (list(range(ord("!"), ord("~") + 1))
                 + list(range(ord("\xa1"), ord("\xac") + 1))
                 + list(range(ord("\xae"), ord("\xff") + 1)))
    chars = printable[:]
    extra = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            chars.append(256 + extra)
            extra += 1
    return dict(zip(printable, (chr(c) for c in chars)))


class ClipTokenizer:
    """encode(str) -> tuple of ids; decode(ids) -> str."""

    def __init__(self, vocab_path: str = VOCAB_PATH):
        self.byte_encoder = _byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        # header line + the first 49152-256-2+1 merges (OpenAI's slice)
        merge_lines = merge_lines[1: 49152 - 256 - 2 + 1]
        merges: List[Tuple[str, str]] = [tuple(m.split()) for m in merge_lines]

        alphabet = list(self.byte_encoder.values())
        vocab = alphabet + [c + "</w>" for c in alphabet]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT_TOKEN, EOT_TOKEN])
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.rank: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        self.sot = self.encoder[SOT_TOKEN]
        self.eot = self.encoder[EOT_TOKEN]
        self._cache: Dict[str, List[str]] = {
            SOT_TOKEN: [SOT_TOKEN], EOT_TOKEN: [EOT_TOKEN]}

    def _bpe(self, word_str: str) -> List[str]:
        if word_str in self._cache:
            return self._cache[word_str]
        parts = list(word_str[:-1]) + [word_str[-1] + "</w>"]
        while len(parts) > 1:
            pairs = set(zip(parts[:-1], parts[1:]))
            best = min(pairs, key=lambda p: self.rank.get(p, float("inf")))
            if best not in self.rank:
                break
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word_str] = parts
        return parts

    @staticmethod
    def _clean(text: str) -> str:
        text = html.unescape(html.unescape(fix_text(text)))
        return _SPACE_RE.sub(" ", text).strip()

    @functools.lru_cache(maxsize=16384)
    def encode(self, text: str) -> Tuple[int, ...]:
        # immutable: the cache hands the same object to every caller
        ids: List[int] = []
        for word in _word_re().findall(self._clean(text).lower()):
            word_bytes = "".join(self.byte_encoder[b]
                                 for b in word.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(word_bytes))
        return tuple(ids)

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(texts: Union[str, Sequence[str]],
             context_length: int = CONTEXT_LENGTH,
             truncate: bool = False) -> np.ndarray:
    """Texts -> (N, context_length) int32 token matrix: [SOT] ids [EOT],
    zero-padded; overlong raises unless ``truncate``, which cuts and
    re-terminates."""
    if isinstance(texts, str):
        texts = [texts]
    tk = default_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for row, text in enumerate(texts):
        ids = [tk.sot, *tk.encode(text), tk.eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length "
                    f"{context_length}")
            ids = ids[:context_length]
            ids[-1] = tk.eot
        out[row, : len(ids)] = ids
    return out
