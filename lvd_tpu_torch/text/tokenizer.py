"""CLIP text tokenizers (the port's own copy of lvd_tpu/text/tokenizer.py).

The stage-2 models condition on CLIP text embeddings, and phrase->token
alignment (for cross-attention guidance) needs token-level access. Two
implementations share one small interface:

* :class:`ClipBpeTokenizer` — a from-scratch CLIP byte-pair-encoding tokenizer
  loading the standard ``vocab.json``/``merges.txt`` files of a checkpoint
  (equivalent in behaviour to ``transformers.CLIPTokenizer`` which the
  reference uses via the HF hub).
* :class:`WordHashTokenizer` — a deterministic offline fallback for tests and
  weightless benchmarks: one token per lowercased word, ids from a stable
  hash. Alignment logic works identically on either.

Interface: ``encode(text) -> list[int]`` (bos/eos included, truncated to
``model_max_length``), ``id_to_token(id) -> str``, ``bos/eos`` attrs.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import html
import json
import os
import re
from typing import List


_WORD_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
    if False
    else r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2 style reversible byte <-> unicode mapping."""
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
    return dict(zip(bs, (chr(c) for c in cs)))


class ClipBpeTokenizer:
    """CLIP BPE (lowercased, word tokens suffixed with ``</w>``)."""

    model_max_length = 77

    def __init__(self, vocab: dict, merges: List[tuple]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos_token = "<|startoftext|>"
        self.eos_token = "<|endoftext|>"
        self.bos_token_id = self.encoder[self.bos_token]
        self.eos_token_id = self.encoder[self.eos_token]
        self._bpe_cache: dict[str, str] = {}

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str) -> "ClipBpeTokenizer":
        with open(vocab_json, "r", encoding="utf-8") as f:
            vocab = json.load(f)
        opener = gzip.open if merges_txt.endswith(".gz") else open
        with opener(merges_txt, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = []
        for line in lines:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = tuple(line.split())
            if len(parts) == 2:
                merges.append(parts)
        return cls(vocab, merges)

    @classmethod
    def from_pretrained_dir(cls, path: str) -> "ClipBpeTokenizer":
        """Load from a HF-style tokenizer directory."""
        for sub in ("", "tokenizer"):
            base = os.path.join(path, sub) if sub else path
            vocab = os.path.join(base, "vocab.json")
            merges = os.path.join(base, "merges.txt")
            if os.path.exists(vocab) and os.path.exists(merges):
                return cls.from_files(vocab, merges)
        raise FileNotFoundError(f"No vocab.json/merges.txt under {path}")

    # -- BPE ------------------------------------------------------------------
    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        tokens: List[str] = []
        for match in _WORD_PATTERN.findall(text):
            encoded = "".join(self.byte_encoder[b] for b in match.encode("utf-8"))
            tokens.extend(self._bpe(encoded).split(" "))
        return tokens

    def encode(self, text: str, max_length: int | None = None) -> List[int]:
        ids = [self.encoder.get(t, self.eos_token_id) for t in self.tokenize(text)]
        ids = [self.bos_token_id] + ids + [self.eos_token_id]
        limit = max_length or self.model_max_length
        if len(ids) > limit:
            ids = ids[: limit - 1] + [self.eos_token_id]
        return ids

    def encode_padded(self, text: str, max_length: int | None = None) -> List[int]:
        """bos + tokens + eos, padded with eos to ``max_length`` (CLIP style)."""
        limit = max_length or self.model_max_length
        ids = self.encode(text, max_length=limit)
        return ids + [self.eos_token_id] * (limit - len(ids))

    def id_to_token(self, token_id: int) -> str:
        return self.decoder.get(int(token_id), self.eos_token)


class WordHashTokenizer:
    """Deterministic word-level fallback with a CLIP-like surface.

    Ids are stable across processes (md5-based), tokens carry the ``</w>``
    suffix so phrase/token alignment behaves like real CLIP tokens.
    """

    model_max_length = 77

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.bos_token = "<|startoftext|>"
        self.eos_token = "<|endoftext|>"
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self._id_to_token: dict[int, str] = {
            self.bos_token_id: self.bos_token,
            self.eos_token_id: self.eos_token,
        }

    def _word_id(self, word: str) -> int:
        digest = hashlib.md5(word.encode("utf-8")).digest()
        token_id = int.from_bytes(digest[:4], "little") % (self.vocab_size - 2)
        self._id_to_token[token_id] = word + "</w>"
        return token_id

    def tokenize(self, text: str) -> List[str]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text)
        return [w + "</w>" for w in words]

    def encode(self, text: str, max_length: int | None = None) -> List[int]:
        words = [t[: -len("</w>")] for t in self.tokenize(text)]
        ids = [self.bos_token_id] + [self._word_id(w) for w in words] + [
            self.eos_token_id
        ]
        limit = max_length or self.model_max_length
        if len(ids) > limit:
            ids = ids[: limit - 1] + [self.eos_token_id]
        return ids

    def encode_padded(self, text: str, max_length: int | None = None) -> List[int]:
        limit = max_length or self.model_max_length
        ids = self.encode(text, max_length=limit)
        return ids + [self.eos_token_id] * (limit - len(ids))

    def id_to_token(self, token_id: int) -> str:
        return self._id_to_token.get(int(token_id), self.eos_token)


def load_tokenizer(checkpoint_dir: str | None = None):
    """Best-effort tokenizer: the checkpoint's CLIP BPE when vocab files
    exist, else the bundled offline-learned BPE assets (a copy of lvd_tpu's
    text/assets — the real BPE code path with a corpus-learned merge
    table), else the
    WordHash fallback."""
    if checkpoint_dir:
        try:
            return ClipBpeTokenizer.from_pretrained_dir(checkpoint_dir)
        except FileNotFoundError:
            pass
    assets = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
    try:
        return ClipBpeTokenizer.from_pretrained_dir(assets)
    except FileNotFoundError:
        return WordHashTokenizer()
