"""The 500-prompt, 5-task LVD benchmark generator.

A copy of lvd_tpu/eval/benchmark.py; parity target of both: the reference's
utils/eval/lvd.py:16-399. Prompts are paired
with predicate closures carrying ``.type`` (task), ``.texts`` (OWL-ViT
queries) and ``.one_box_per_class``. Prompt strings must match the reference
bit-for-bit — the shipped layout caches are keyed by them.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ..utils import words
from . import predicates

PROMPT_PREFIX = "A realistic lively video of a scene"
PROMPT_TOP_DOWN_PREFIX = "A realistic lively video of a top-down viewed scene"

EVALUATE_CLASSES = [
    ("moving car", "car"),
    ("lively cat", "cat"),
    ("flying bird", "bird"),
    ("moving ball", "ball"),
    ("walking dog", "dog"),
]
EVALUATE_CLASSES_NO_ATTRIBUTE = [plain for _, plain in EVALUATE_CLASSES]

_MODIFIERS = [
    "red", "orange", "yellow", "green", "blue", "purple", "pink", "brown",
    "black", "white", "gray",
]

# Box-center comparators over normalized xyxy boxes.
_LR_LOCATIONS = [
    ("left", "right", lambda b1, b2: (b1[0] + b1[2]) / 2 < (b2[0] + b2[2]) / 2),
    ("right", "left", lambda b1, b2: (b1[0] + b1[2]) / 2 > (b2[0] + b2[2]) / 2),
]
_TB_LOCATIONS = [
    ("top", "bottom", lambda b1, b2: (b1[1] + b1[3]) / 2 < (b2[1] + b2[3]) / 2),
    ("bottom", "top", lambda b1, b2: (b1[1] + b1[3]) / 2 > (b2[1] + b2[3]) / 2),
]

_QUADRANTS = {
    "lower left": lambda b: (b[1] + b[3]) / 2 > 0.5 and (b[0] + b[2]) / 2 < 0.5,
    "lower right": lambda b: (b[1] + b[3]) / 2 > 0.5 and (b[0] + b[2]) / 2 > 0.5,
    "upper left": lambda b: (b[1] + b[3]) / 2 < 0.5 and (b[0] + b[2]) / 2 < 0.5,
    "upper right": lambda b: (b[1] + b[3]) / 2 < 0.5 and (b[0] + b[2]) / 2 > 0.5,
}
_WAYPOINT_TRIPLES = [
    ("lower left", "lower right", "upper right"),
    ("lower left", "upper left", "upper right"),
    ("lower right", "lower left", "upper left"),
    ("lower right", "upper right", "upper left"),
]


def _tag(predicate, type_, texts, one_box_per_class):
    predicate.type = type_
    predicate.texts = texts
    predicate.one_box_per_class = one_box_per_class
    return predicate


def get_prompt_predicates_numeracy(min_num=1, max_num=5, repeat=2):
    out = []
    for number in range(min_num, max_num + 1):
        for object_name, plain in EVALUATE_CLASSES:
            noun = words.plural(object_name) if number > 1 else object_name
            count = words.number_to_words(number) if number < 21 else number
            prompt = f"{PROMPT_PREFIX} with {count} {noun}".strip()
            predicate = _tag(
                partial(predicates.predicate_numeracy, (plain,), number),
                "numeracy",
                [f"a photo of {words.a(plain)}"],
                one_box_per_class=False,
            )
            out += [(prompt, predicate)] * repeat
    return out


def get_prompt_predicates_attribution(num_prompts=100, repeat=1):
    out = []
    for ind in range(num_prompts):
        np.random.seed(ind)
        mod1, mod2 = np.random.choice(_MODIFIERS, 2, replace=False)
        name1, name2 = np.random.choice(
            EVALUATE_CLASSES_NO_ATTRIBUTE, 2, replace=False
        )
        prompt = (
            f"{PROMPT_PREFIX} with {words.a(mod1)} {name1} "
            f"and {words.a(mod2)} {name2}"
        ).strip()
        predicate = _tag(
            partial(
                predicates.predicate_attribution,
                (name1,),
                (name2,),
                mod1,
                mod2,
                1,
                1,
            ),
            "attribution",
            [
                f"a photo of {words.a(mod1)} {name1}",
                f"a photo of {words.a(mod2)} {name2}",
            ],
            one_box_per_class=True,
        )
        out += [(prompt, predicate)] * repeat
    return out


def get_prompt_predicates_visibility(repeat=2):
    out = []
    for object_name, plain in EVALUATE_CLASSES:
        for appears in (True, False):
            half = "second" if appears else "first"
            prompt = (
                f"{PROMPT_PREFIX} in which {words.a(object_name)} appears "
                f"only in the {half} half of the video"
            )
            predicate = _tag(
                partial(predicates.predicate_visibility, (plain,), appears),
                "visibility",
                [f"a photo of {words.a(plain)}"],
                one_box_per_class=True,
            )
            out += [(prompt, predicate)] * repeat
    return out


def get_prompt_predicates_1obj_dynamic_spatial(repeat=1, left_right_only=True):
    locations = list(_LR_LOCATIONS) + ([] if left_right_only else list(_TB_LOCATIONS))
    out = []
    for plain in EVALUATE_CLASSES_NO_ATTRIBUTE:
        for loc1, loc2, verify_fn in locations:
            prompt = (
                f"{PROMPT_PREFIX} with {words.a(plain)} moving "
                f"from the {loc1} to the {loc2}"
            ).strip()
            predicate = _tag(
                partial(
                    predicates.predicate_1obj_dynamic_spatial, (plain,), verify_fn
                ),
                "dynamic_spatial",
                [f"a photo of {words.a(plain)}"],
                one_box_per_class=True,
            )
            out += [(prompt, predicate)] * repeat
    return out


def get_prompt_predicates_2obj_dynamic_spatial(
    num_prompts=10, repeat=1, left_right_only=True
):
    locations = list(_LR_LOCATIONS) + ([] if left_right_only else list(_TB_LOCATIONS))
    out = []
    for ind in range(num_prompts):
        np.random.seed(ind)
        for loc1, loc2, verify_fn in locations:
            name1, name2 = np.random.choice(
                EVALUATE_CLASSES_NO_ATTRIBUTE, 2, replace=False
            )
            prompt = (
                f"{PROMPT_PREFIX} with {words.a(name1)} moving "
                f"from the {loc1} of {words.a(name2)} to its {loc2}"
            ).strip()
            predicate = _tag(
                partial(
                    predicates.predicate_2obj_dynamic_spatial,
                    (name1,),
                    (name2,),
                    verify_fn,
                ),
                "dynamic_spatial",
                [
                    f"a photo of {words.a(name1)}",
                    f"a photo of {words.a(name2)}",
                ],
                one_box_per_class=True,
            )
            out += [(prompt, predicate)] * repeat
    return out


def get_prompt_predicates_sequential(repeat=1):
    out = []
    for plain in EVALUATE_CLASSES_NO_ATTRIBUTE:
        for loc1, loc2, loc3 in _WAYPOINT_TRIPLES:
            prompt = (
                f"{PROMPT_TOP_DOWN_PREFIX} in which {words.a(plain)} initially "
                f"on the {loc1} of the scene. It first moves to the {loc2} of "
                f"the scene and then moves to the {loc3} of the scene."
            )
            predicate = _tag(
                partial(
                    predicates.predicate_sequential,
                    (plain,),
                    _QUADRANTS[loc1],
                    _QUADRANTS[loc2],
                    _QUADRANTS[loc3],
                ),
                "sequential",
                [f"a photo of {words.a(plain)}"],
                one_box_per_class=True,
            )
            out += [(prompt, predicate)] * repeat
    return out


def get_lvd_full_prompt_predicates(prompt_type=None):
    numeracy = get_prompt_predicates_numeracy(max_num=4, repeat=5)
    attribution = get_prompt_predicates_attribution(num_prompts=100)
    visibility = get_prompt_predicates_visibility(repeat=10)
    dynamic = get_prompt_predicates_1obj_dynamic_spatial(
        repeat=5
    ) + get_prompt_predicates_2obj_dynamic_spatial(num_prompts=25)
    sequential = get_prompt_predicates_sequential(repeat=5)

    registry = {
        "lvd": numeracy + attribution + visibility + dynamic + sequential,
        "lvd_static": numeracy + attribution,
        "lvd_numeracy": numeracy,
        "lvd_attribution": attribution,
        "lvd_dynamic": visibility + dynamic + sequential,
        "lvd_dynamic_spatial": dynamic,
        "lvd_visibility": visibility,
        "lvd_sequential": sequential,
    }
    if prompt_type is not None:
        return registry[prompt_type]
    return registry


def get_lvd_full_prompts(prompt_type):
    pp = get_lvd_full_prompt_predicates(prompt_type)
    if prompt_type is not None:
        return [prompt for prompt, _ in pp]
    return {k: [prompt for prompt, _ in v] for k, v in pp.items()}
