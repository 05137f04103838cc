"""Deterministic offline BPE vocabulary generator (a copy of
lvd_tpu/text/make_vocab.py on the port's tokenizer helpers).

The real OpenAI CLIP vocab (49408 BPE entries) cannot be fetched in a
zero-egress environment, and the WordHash fallback never exercises the
production multi-token phrase->token alignment path. This script LEARNS a
CLIP-*structured* BPE (byte alphabet + `</w>` word suffix + greedy merges,
the exact algorithm `text/tokenizer.ClipBpeTokenizer` executes) from the
framework's own text surface — the 500 benchmark prompts, the few-shot
templates, and the negative prompt — and writes `vocab.json`/`merges.txt`
to ``lvd_tpu_torch/text/assets/`` (a copy of lvd_tpu's, which the same
corpus reproduces).

`load_tokenizer(None)` falls back to these assets, so bench and random-
weight runs drive the REAL BPE code path (merges, multi-token phrases,
eos-padding) end to end; only the learned merge table differs from
OpenAI's. Converted real checkpoints ship their own vocab files, which take
precedence (models/convert.py copies them; loader passes the checkpoint
dir).

Deterministic: pure counting with lexicographic tie-breaks — re-running
reproduces the committed assets byte-for-byte.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, List, Tuple

from .tokenizer import _WORD_PATTERN, _basic_clean, _bytes_to_unicode, _whitespace_clean

ASSETS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def corpus_texts() -> List[str]:
    """Every prompt string the framework itself can emit offline."""
    from ..eval.benchmark import get_lvd_full_prompts
    from . import templates

    texts: List[str] = list(get_lvd_full_prompts("lvd"))
    texts.append(templates.NEGATIVE_PROMPT)
    # The few-shot template bodies (object names, background keywords).
    for msgs in templates.TEMPLATES.values():
        for m in msgs:
            texts.append(m["content"] if isinstance(m, dict) else str(m))
    return texts


def _words(texts) -> Dict[Tuple[str, ...], int]:
    byte_encoder = _bytes_to_unicode()
    counts: collections.Counter = collections.Counter()
    for text in texts:
        text = _whitespace_clean(_basic_clean(text)).lower()
        for match in _WORD_PATTERN.findall(text):
            enc = "".join(byte_encoder[b] for b in match.encode("utf-8"))
            counts[tuple(enc[:-1]) + (enc[-1] + "</w>",)] += 1
    return dict(counts)


def learn_bpe(texts, num_merges: int = 6000):
    """Classic greedy BPE: repeatedly merge the most frequent adjacent pair
    (count desc, then lexicographic — fully deterministic)."""
    words = _words(texts)
    merges: List[Tuple[str, str]] = []
    for _ in range(num_merges):
        pairs: collections.Counter = collections.Counter()
        for w, c in words.items():
            for a, b in zip(w[:-1], w[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        best_count = max(pairs.values())
        if best_count < 2:
            break
        best = min(p for p, c in pairs.items() if c == best_count)
        merges.append(best)
        first, second = best
        new_words = {}
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and w[i] == first and w[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + c
        words = new_words
    return merges


def build_vocab(merges) -> Dict[str, int]:
    """CLIP vocab layout: byte alphabet, byte</w> alphabet, merge results
    in merge order, then the two specials."""
    byte_chars = [_bytes_to_unicode()[b] for b in range(256)]
    vocab: Dict[str, int] = {}

    def add(tok):
        if tok not in vocab:
            vocab[tok] = len(vocab)

    for c in byte_chars:
        add(c)
    for c in byte_chars:
        add(c + "</w>")
    for a, b in merges:
        add(a + b)
    add("<|startoftext|>")
    add("<|endoftext|>")
    return vocab


def write_assets(out_dir: str = ASSETS_DIR, num_merges: int = 6000) -> tuple:
    os.makedirs(out_dir, exist_ok=True)
    merges = learn_bpe(corpus_texts(), num_merges=num_merges)
    vocab = build_vocab(merges)
    vocab_path = os.path.join(out_dir, "vocab.json")
    merges_path = os.path.join(out_dir, "merges.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False, indent=0, sort_keys=False)
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.write("\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return vocab_path, merges_path, len(vocab), len(merges)


if __name__ == "__main__":
    vp, mp, nv, nm = write_assets()
    print(f"wrote {vp} ({nv} entries), {mp} ({nm} merges)")
