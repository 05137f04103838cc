"""Layout-level evaluation harness.

A copy of lvd_tpu/eval/harness.py; parity target of both: the reference's
utils/eval/eval.py:135-154 (`evaluate_with_layout`).
"""

from __future__ import annotations

from ..layout.condition import parsed_layout_to_condition


def evaluate_with_layout(
    parsed_layout, predicate, num_parsed_layout_frames, height, width, verbose=False
):
    """Score one parsed layout with its predicate. Returns (task_type, bool).

    The layout is converted without temporal interpolation (the six layout
    frames are scored directly) and with trailing digits stripped from
    phrases so "car 1"/"car 2" both match "car".
    """
    condition = parsed_layout_to_condition(
        parsed_layout,
        tokenizer=None,
        height=height,
        width=width,
        num_parsed_layout_frames=num_parsed_layout_frames,
        num_condition_frames=num_parsed_layout_frames,
        strip_phrases=True,
        verbose=verbose,
    )
    return predicate.type, bool(predicate(condition, verbose=verbose))
