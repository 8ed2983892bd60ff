"""CLIP's byte-level BPE tokenizer (copy of kvq_tpu/data/tokenizer.py:
48-224; reference clip/simple_tokenizer.py:62-130 and clip/clip.py:185-221
``tokenize``).

Text is cleaned (``ftfy``'s repair when it is installed, HTML entities
unescaped twice), whitespace-folded and lowercased, split by CLIP's
pattern, mapped byte by byte to printable characters
(:func:`bytes_to_unicode`) and merged by BPE with ``</w>`` word ends; ids
are 256 byte symbols, their 256 ``</w>`` forms, one per merge, then
``<|startoftext|>`` and ``<|endoftext|>``, the order of OpenAI's
vocabulary, so that the ids match OpenAI's checkpoints given the same
merges.  The merges are a constructor argument (a list, or the path of a
merges file such as the reference's ``bpe_simple_vocab_16e6.txt.gz``,
which is not in this repository).  :func:`tokenize` gives the (n,
context_length) int32 matrix ``<sot> ids <eot>``, zero-padded.  Host-side
Python; nothing runs on the card.
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache

import numpy as np

try:  # pragma: no cover - environment dependent
    import regex as _re
except ImportError:  # pragma: no cover
    import re as _re

try:  # pragma: no cover - optional
    import ftfy as _ftfy
except ImportError:  # pragma: no cover
    _ftfy = None

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"

_WORD_PATTERN = (
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    if _re.__name__ == "regex"
    else r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+"
)


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte -> printable-unicode map (reference
    simple_tokenizer.py:12-30)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def basic_clean(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return _re.sub(r"\s+", " ", text).strip()


def _read_merges(path: str | None) -> list[tuple[str, str]]:
    if path is None:
        return []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    # reference slices [1:49152-256-2+1] — header line + special/byte rows
    merges = []
    for line in lines[1 : 49152 - 256 - 2 + 1]:
        parts = line.split()
        if len(parts) == 2:
            merges.append((parts[0], parts[1]))
    return merges


class SimpleTokenizer:
    """Byte-level BPE (reference simple_tokenizer.py:62-130).

    vocab = 256 byte symbols + 256 ``</w>`` variants + one token per merge
    + the two specials; ids follow the same construction order as the
    reference so token ids match OpenAI's CLIP checkpoints when given the
    same merges file.
    """

    def __init__(self, bpe_path: str | None = None,
                 merges: list[tuple[str, str]] | None = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if merges is None:
            merges = _read_merges(bpe_path)
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend([SOT, EOT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT: SOT, EOT: EOT}
        self.pat = _re.compile(_WORD_PATTERN, _re.IGNORECASE)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_token(self) -> int:
        return self.encoder[SOT]

    @property
    def eot_token(self) -> int:
        return self.encoder[EOT]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(
                self.byte_encoder[b] for b in token.encode("utf-8")
            )
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(
            self.decoder[int(t)]
            for t in tokens
            if int(t) not in (self.sot_token, self.eot_token)
        )
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


def tokenize(
    texts: str | list[str],
    tokenizer: SimpleTokenizer,
    context_length: int = 77,
    truncate: bool = False,
) -> np.ndarray:
    """(len(texts), context_length) int32 token matrix (reference
    clip/clip.py:185-221): ``<sot> tokens <eot>`` zero-padded."""
    if isinstance(texts, str):
        texts = [texts]
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [tokenizer.sot_token] + tokenizer.encode(text) + [
            tokenizer.eot_token
        ]
        if len(tokens) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length "
                    f"{context_length}"
                )
            tokens = tokens[:context_length]
            tokens[-1] = tokenizer.eot_token
        result[i, : len(tokens)] = tokens
    return result
