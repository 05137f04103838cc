"""Minimal English inflection helpers (a copy of lvd_tpu/utils/words.py: a
self-contained replacement for the `inflect` dependency of the reference's
utils/guidance.py:12-14 and utils/eval/lvd.py, `p = inflect.engine()`).

Only the behaviours exercised by the LVD benchmark and phrase refinement are
implemented: ``number_to_words`` (0..99), ``plural``, ``singular_noun`` and
``a`` (indefinite-article selection). All functions operate on the final word
of a phrase, matching inflect's behaviour for the inputs this framework uses.
"""

from __future__ import annotations

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]

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
_IRREGULAR_SINGULARS = {v: k for k, v in _IRREGULAR_PLURALS.items() if v != k}

# Words starting with a vowel letter but a consonant sound (take "a"), and
# words starting with a consonant letter but a vowel sound (take "an").
_A_EXCEPTIONS = {"one", "once", "unique", "uniform", "university", "user",
                 "unicorn", "unit", "used", "useful", "european"}
_AN_EXCEPTIONS = {"hour", "honest", "honor", "honour", "heir"}


def number_to_words(n: int) -> str:
    """0..99 -> English words ("twenty-one" style)."""
    n = int(n)
    if n < 0 or n > 99:
        raise ValueError(f"number_to_words supports 0..99, got {n}")
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] if ones == 0 else f"{_TENS[tens]}-{_ONES[ones]}"


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


def singular_noun(phrase: str):
    """Inverse of :func:`plural` on the last word. Returns ``False`` when the
    word does not look plural (mirrors ``inflect.engine().singular_noun``)."""
    head, word = _split_last(phrase)
    lower = word.lower()
    if lower in _IRREGULAR_SINGULARS:
        return head + _IRREGULAR_SINGULARS[lower]
    if lower.endswith("ies") and len(lower) > 3:
        return head + word[:-3] + "y"
    if lower.endswith(("ches", "shes", "xes", "zes", "ses")):
        return head + word[:-2]
    if lower.endswith("s") and not lower.endswith("ss"):
        return head + word[:-1]
    return False


def a(phrase: str) -> str:
    """Prefix ``phrase`` with "a" or "an" (inflect's ``p.a``)."""
    first = phrase.split(" ", 1)[0].lower()
    if first in _AN_EXCEPTIONS:
        art = "an"
    elif first in _A_EXCEPTIONS or first.startswith(("uni", "use", "one", "eu")):
        art = "a"
    elif first[:1] in "aeiou":
        art = "an"
    else:
        art = "a"
    return f"{art} {phrase}"
