"""Phrase -> prompt-token alignment for cross-attention guidance (a copy of
lvd_tpu/layout/align.py). Grounding phrases are located in the tokenized
prompt by substring-matching token strings; phrases missing from the prompt
go through a fallback chain (strip digits -> last word -> pluralize).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

from ..utils import words


def get_token_map(tokenizer, prompt: str, padding: str = "do_not_pad") -> List[str]:
    """Token strings of the tokenized prompt (bos/eos included)."""
    if padding == "do_not_pad":
        ids = tokenizer.encode(prompt)
    else:
        ids = tokenizer.encode_padded(prompt)
    return [tokenizer.id_to_token(i) for i in ids]


def refine_phrase(prompt: str, phrase: str, verbose: bool = False):
    """Reduce ``phrase`` until it word-matches inside ``prompt``.

    Returns ``(found, refined_phrase)``. Fallbacks, in order: the phrase
    itself; digits stripped; the last word; the last word pluralized.
    """

    def in_prompt(p: str) -> bool:
        return bool(p) and re.search(r"\b" + re.escape(p) + r"\b", prompt) is not None

    candidate = phrase
    if in_prompt(candidate):
        return True, candidate

    candidate = candidate.strip("0123456789 ")
    if in_prompt(candidate):
        return True, candidate

    candidate = candidate.split(" ")[-1]
    if verbose:
        print(f"Phrase {phrase!r} not in prompt; trying last word {candidate!r}")
    if in_prompt(candidate):
        return True, candidate

    candidate = words.plural(candidate)
    if verbose:
        print(f"Still not in prompt; trying plural {candidate!r}")
    if in_prompt(candidate):
        return True, candidate

    return False, candidate


def get_phrase_indices(
    tokenizer,
    prompt: str,
    phrases: Sequence[str],
    token_map: Optional[List[str]] = None,
    include_eos: bool = False,
    verbose: bool = False,
) -> List[List[int]]:
    """Token indices of each phrase inside the tokenized prompt.

    Matches the refined phrase's token-string sequence as a substring of the
    prompt's token-string sequence and returns the covered index ranges.
    """
    if token_map is None:
        token_map = get_token_map(tokenizer, prompt)
    token_map_str = " ".join(token_map)

    object_positions = []
    for phrase in phrases:
        found, refined = refine_phrase(prompt, phrase, verbose=verbose)
        if not found:
            raise ValueError(
                f"Phrase {phrase!r} not found in prompt {prompt!r}; the prompt "
                "should have been suffixed with the phrase upstream"
            )

        phrase_tokens = get_token_map(tokenizer, refined)[1:-1]  # drop bos/eos
        phrase_str = " ".join(phrase_tokens)

        pos = token_map_str.index(phrase_str)
        # Number of space-separated tokens before the match.
        first_index = len(token_map_str[: max(pos - 1, 0)].split(" ")) if pos else 1
        if pos == 0:
            first_index = 0

        positions = list(range(first_index, first_index + len(phrase_tokens)))
        if include_eos:
            positions.append(token_map.index(tokenizer.eos_token))
        object_positions.append(positions)

        if verbose:
            print(f"{phrase!r} -> tokens {positions} of {token_map_str!r}")

    return object_positions
