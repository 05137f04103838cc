"""parsed_layout -> Condition transform (a numpy copy of
lvd_tpu/layout/condition.py). Collects per-object boxes across the six
layout frames (handling appearance/disappearance), converts to normalized
xyxy, interpolates to the video frame count, appends the background keyword
to the prompt, suffixes the prompt with phrases that cannot be aligned, and
computes phrase token indices when a tokenizer is given.
"""

from __future__ import annotations

import numpy as np

from . import align
from .boxes import Condition, convert_box, interpolate_box


def parsed_layout_to_condition(
    parsed_layout: dict,
    height: float,
    width: float,
    num_parsed_layout_frames: int = 6,
    num_condition_frames: int = 24,
    interpolate_boxes: bool = True,
    tokenizer=None,
    add_background_to_prompt: bool = True,
    strip_phrases: bool = False,
    verbose: bool = False,
) -> Condition:
    prompt = parsed_layout["Prompt"]

    if add_background_to_prompt and parsed_layout.get("Background keyword"):
        prompt = f"{prompt}, {parsed_layout['Background keyword']} background"

    id_to_phrase: dict = {}
    id_to_box: dict = {}
    box_ids: list = []

    for frame_ind in range(num_parsed_layout_frames):
        for obj in parsed_layout[f"Frame {frame_ind + 1}"]:
            obj_id = obj["id"]
            if obj_id not in id_to_phrase:
                id_to_phrase[obj_id] = obj.get("name", obj.get("keyword"))
                id_to_box[obj_id] = {}
                box_ids.append(obj_id)
            id_to_box[obj_id][frame_ind] = convert_box(
                obj["box"], height=height, width=width
            )

    boxes = [id_to_box[i] for i in box_ids]
    phrases = [id_to_phrase[i] for i in box_ids]

    if interpolate_boxes:
        boxes = [
            interpolate_box(
                box,
                num_parsed_layout_frames,
                num_condition_frames,
                repeat=parsed_layout.get("Repeat", 1),
            )
            for box in boxes
        ]

    object_positions = None
    token_map = None
    if tokenizer is not None:
        for phrase in phrases:
            found, _ = align.refine_phrase(prompt, phrase, verbose=verbose)
            if not found:
                # Make the phrase alignable by suffixing it onto the prompt,
                # separated with "|" (reference utils/parse.py:330-338).
                prompt += "| " + phrase
                if verbose:
                    print(f"Added {phrase!r} to the prompt: {prompt!r}")

        token_map = align.get_token_map(tokenizer, prompt)
        object_positions = align.get_phrase_indices(
            tokenizer, prompt, phrases, token_map=token_map, verbose=verbose
        )

    if strip_phrases:
        phrases = [phrase.strip("1234567890 ") for phrase in phrases]

    if verbose:
        print(f"prompt: {prompt!r}")
        print(f"boxes: {np.round(np.asarray(boxes), 2) if boxes else boxes}")
        print(f"phrases: {phrases} object_positions: {object_positions}")

    return Condition(prompt, boxes, phrases, object_positions, token_map)
