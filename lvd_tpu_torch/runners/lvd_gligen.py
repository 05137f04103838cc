"""LVD-GLIGEN runner: gated self-attention adapters, no backward guidance.

Counterpart of lvd_tpu/runners/lvd_gligen.py; parity target of both: the
reference's generation/lvd_gligen.py. Uses the `longlian/text-to-video-
lvd-{ms,zs}` GLIGEN-finetuned checkpoints; README recommends
`gligen_scheduled_sampling_beta 0.4` (README.md:79-87).
"""

from __future__ import annotations

import os

from ..text.templates import NEGATIVE_PROMPT
from . import base

version = "lvd-gligen"

_BASE_PRESETS = {
    "modelscope256": "lvd-gligen_modelscope256",
    "zeroscope": "lvd-gligen_zeroscope",
}

_state = base.RunnerState()


def init(base_model: str):
    global _state
    _state = base.init_pipeline(_BASE_PRESETS[base_model])
    return _state.H, _state.W


def run(
    parsed_layout,
    seed,
    num_inference_steps=40,
    num_frames=16,
    gligen_scheduled_sampling_beta=1.0,
    repeat_ind=None,
    save_annotated_videos=False,
    save_formats=("gif", "joblib"),
):
    out = base.output_path(seed, repeat_ind)
    if os.path.exists(out + ".gif"):
        print(f"Skipping {out}.gif")
        return

    condition = base.build_condition(_state, parsed_layout, num_frames)
    boxes, phrases = base.gligen_per_frame_inputs(condition, num_frames)

    video = _state.pipe(
        condition.prompt,
        negative_prompt=NEGATIVE_PROMPT,
        num_inference_steps=num_inference_steps,
        height=_state.H,
        width=_state.W,
        num_frames=num_frames,
        seed=seed,
        gligen_boxes=boxes,
        gligen_phrases=phrases,
        gligen_scheduled_sampling_beta=gligen_scheduled_sampling_beta,
    )[0]

    base.save_video(
        out, video, save_formats, save_annotated_videos, condition, seed
    )
