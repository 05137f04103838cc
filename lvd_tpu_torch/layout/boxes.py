"""Box conversion and temporal interpolation for Dynamic Scene Layouts
(a numpy copy of lvd_tpu/layout/boxes.py).

Boxes arrive from the LLM as ``[x, y, w, h]`` in 512x512 pixels and become
normalized ``[x0, y0, x1, y1]`` per video frame, linearly interpolated from
the 6 layout frames to the generation frame count, with absent frames zeroed.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np


class Condition(NamedTuple):
    """Stage-1 -> stage-2 conditioning contract.

    boxes: per-object list of per-frame ``[x0, y0, x1, y1]`` in [0, 1]
    phrases: per-object grounding phrase
    object_positions: per-object list of token indices of the phrase in the
        tokenized prompt (None when built without a tokenizer)
    token_map: token strings of the tokenized prompt (None without tokenizer)
    """

    prompt: str
    boxes: list
    phrases: list
    object_positions: Optional[list]
    token_map: Optional[list]


def convert_box(box: Sequence[float], height: float, width: float):
    """``[x, y, w, h]`` pixels -> normalized ``(x0, y0, x1, y1)``."""
    x0 = box[0] / width
    y0 = box[1] / height
    return (x0, y0, x0 + box[2] / width, y0 + box[3] / height)


def interpolate_box(
    box: Dict[int, Sequence[float]],
    num_input_frames: int = 6,
    num_output_frames: int = 24,
    repeat: int = 1,
) -> List[List[float]]:
    """Interpolate a per-frame box dict onto ``num_output_frames`` frames.

    ``box`` maps layout-frame index -> normalized xyxy box; missing indices
    mean the object is absent there and the output box is all-zero for output
    frames that fall on absent layout frames. With ``repeat > 1`` the layout
    cycles ``repeat`` times across the output frames.
    """
    present = np.sort(np.array(list(box.keys())))
    # Layout frames on a [0, 1] time axis, tiled `repeat` times on [0, repeat).
    xs = np.concatenate(
        [present / (num_input_frames - 1) + cycle for cycle in range(repeat)]
    )
    # Query times; the epsilon keeps the final sample inside the last cycle.
    xs_query = np.linspace(0, repeat - 1e-5, num_output_frames)
    # An output frame is "present" iff the layout frame it lands on is present.
    landed = np.floor((xs_query % 1.0) * num_input_frames)
    mask = np.isin(landed, present)

    out = np.zeros((num_output_frames, 4))
    for coord in range(4):
        ys = np.array([box[k][coord] for k in present] * repeat)
        out[:, coord] = np.interp(xs_query, xs, ys) * mask
    return out.tolist()
