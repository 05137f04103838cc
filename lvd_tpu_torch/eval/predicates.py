"""Task predicates: pure functions Condition -> bool.

A copy of lvd_tpu/eval/predicates.py; parity target of both: the reference's
utils/eval/utils.py:49-311. Each benchmark
prompt pairs with one of these closures; the same predicates score stage-1
layouts and stage-2 OWL-ViT detections.
"""

from __future__ import annotations

import numpy as np

from ..layout.boxes import Condition


def get_box(condition: Condition, name_include):
    """First object whose phrase contains one of ``name_include`` as a word
    (word-boundary-ish: "car " prefix or suffix match, so "car" != "carrot")."""
    box_match = [
        any(
            (item + " ") in phrase or phrase.endswith(item)
            for item in name_include
        )
        for phrase in condition.phrases
    ]
    if not any(box_match):
        return None
    return condition.boxes[int(np.min(np.where(box_match)[0]))]


def box_to_valid_frames(object_box) -> np.ndarray:
    """Frames where the box has nonzero extent.

    Note the coordinate convention follows the reference exactly
    (utils/eval/utils.py:135-141): columns 2 and 3 are treated as extents,
    which for xyxy boxes means x1 != 0 and y1 != 0 — an all-zero box marks
    absence in both conventions.
    """
    box = np.asarray(object_box)
    return (box[:, 2] != 0) & (box[:, 3] != 0)


def get_box_counts(condition: Condition):
    if len(condition.boxes) == 0:
        return None
    num_frames = len(condition.boxes[0])
    counts = np.zeros(num_frames, dtype=int)
    for box in condition.boxes:
        if len(box) != num_frames:
            raise ValueError(f"{len(box)} != {num_frames} frames")
        counts += box_to_valid_frames(box).astype(int)
    return counts.tolist()


def predicate_numeracy(query_names, intended_count, condition, verbose=False):
    if len(query_names) != 1:
        raise ValueError("numeracy uses a single query name")
    counts = get_box_counts(condition)
    majority = 0 if counts is None else int(np.bincount(counts).argmax())
    if verbose:
        print(f"box_counts={counts} majority={majority} intended={intended_count}")
    return majority == intended_count


def predicate_attribution(
    query_names1,
    query_names2,
    modifier1,
    modifier2,
    intended_count1,
    intended_count2,
    condition,
    verbose=False,
):
    if intended_count1 != 1 or intended_count2 != 1:
        raise ValueError("attribution assumes one instance per object")

    names1 = [f"{modifier1} {n}" for n in query_names1] if modifier1 else query_names1
    box1 = get_box(condition, names1)
    if box1 is None:
        return False
    if box_to_valid_frames(box1).mean() < 0.5:
        return False

    if query_names2 is None:
        return True

    names2 = [f"{modifier2} {n}" for n in query_names2] if modifier2 else query_names2
    box2 = get_box(condition, names2)
    if box2 is None:
        return False
    if box_to_valid_frames(box2).mean() < 0.5:
        return False

    if verbose:
        print(f"box1={box1} box2={box2}")
    return True


def predicate_visibility(query_names, test_appearance, condition, verbose=False):
    box = get_box(condition, query_names)
    if not box:
        return False

    valid = box_to_valid_frames(box)
    half = len(valid) // 2
    # The two middle frames are excluded: interpolation/sampling can disagree
    # with the LLM about exactly where "half the video" falls.
    first_half = bool(np.any(valid[: half - 1]))
    second_half = bool(np.any(valid[half + 1 :]))

    if verbose:
        print(f"valid={valid} first={first_half} second={second_half}")
    if test_appearance:
        return (not first_half) and second_half
    return first_half and (not second_half)


def predicate_1obj_dynamic_spatial(query_names, verify_fn, condition, verbose=False):
    box = get_box(condition, query_names)
    if not box:
        return False
    valid = box_to_valid_frames(box)
    if not valid[0] or not valid[-1]:
        return False
    return verify_fn(box[0], box[-1])


def predicate_2obj_dynamic_spatial(
    query_names1, query_names2, verify_fn, condition, verbose=False
):
    box1 = get_box(condition, query_names1)
    box2 = get_box(condition, query_names2)
    if not box1 or not box2:
        return False
    valid1, valid2 = box_to_valid_frames(box1), box_to_valid_frames(box2)
    if not (valid1[0] and valid2[0] and valid1[-1] and valid2[-1]):
        return False
    return verify_fn(box1[0], box2[0]) and verify_fn(box2[-1], box1[-1])


def predicate_sequential(
    query_names, verify_fn1, verify_fn2, verify_fn3, condition, verbose=False
):
    box = get_box(condition, query_names)
    if not box:
        return False
    valid = box_to_valid_frames(box)
    middle = len(valid) // 2
    if not (valid[0] and valid[middle] and valid[-1]):
        return False
    return (
        bool(verify_fn1(box[0]))
        and bool(verify_fn2(box[middle]))
        and bool(verify_fn3(box[-1]))
    )
