"""Pluralisation of a phrase's last word (a copy of ``plural`` from
lvd_tpu/utils/words.py), the last fallback of layout/align.refine_phrase.
"""

from __future__ import annotations

# Nouns whose plural is irregular, limited to words plausible in prompts.
_IRREGULAR_PLURALS = {
    "person": "people",
    "man": "men",
    "woman": "women",
    "child": "children",
    "foot": "feet",
    "tooth": "teeth",
    "goose": "geese",
    "mouse": "mice",
    "sheep": "sheep",
    "deer": "deer",
    "fish": "fish",
    "wolf": "wolves",
    "leaf": "leaves",
    "knife": "knives",
    "life": "lives",
}


def _split_last(phrase: str):
    parts = phrase.rsplit(" ", 1)
    if len(parts) == 1:
        return "", parts[0]
    return parts[0] + " ", parts[1]


def plural(phrase: str) -> str:
    """Pluralize the last word of ``phrase``."""
    head, word = _split_last(phrase)
    lower = word.lower()
    if lower in _IRREGULAR_PLURALS:
        out = _IRREGULAR_PLURALS[lower]
    elif lower.endswith(("s", "x", "z", "ch", "sh")):
        out = word + "es"
    elif lower.endswith("y") and len(lower) > 1 and lower[-2] not in "aeiou":
        out = word[:-1] + "ies"
    elif lower.endswith("o") and lower not in ("photo", "piano", "halo", "video"):
        out = word + "es"
    else:
        out = word + "s"
    return head + out
