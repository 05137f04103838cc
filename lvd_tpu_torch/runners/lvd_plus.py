"""LVD+ runner: GLIGEN adapters AND cross-attention guidance together.

Counterpart of lvd_tpu/runners/lvd_plus.py; parity target of both: the
reference's generation/lvd_plus.py:75-210.
"""

from __future__ import annotations

import os

from ..text.templates import NEGATIVE_PROMPT
from . import base

version = "lvd-plus"

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
    loss_scale=5.0,
    loss_threshold=200.0,
    max_iter=5,
    max_index_step=10,
    fg_top_p=0.75,
    bg_top_p=0.75,
    fg_weight=1.0,
    bg_weight=4.0,
    attn_sync_weight=0.0,
    boxdiff_loss_scale=0.0,
    boxdiff_normed=True,
    boxdiff_L=1,
    com_loss_scale=0.0,
    use_ratio_based_loss=False,
    upsample_scale=1,
    upsample_mode="bilinear",
    save_formats=("gif", "joblib"),
):
    out = base.output_path(seed, repeat_ind)
    if os.path.exists(out + ".gif"):
        print(f"Skipping {out}.gif")
        return

    condition = base.build_condition(_state, parsed_layout, num_frames)
    boxes, phrases = base.gligen_per_frame_inputs(condition, num_frames)

    g_cfg = base.guidance_config(locals())

    video = _state.pipe(
        condition.prompt,
        negative_prompt=NEGATIVE_PROMPT,
        num_inference_steps=num_inference_steps,
        height=_state.H,
        width=_state.W,
        num_frames=num_frames,
        seed=seed,
        backward_guidance={
            "boxes": condition.boxes,
            "object_positions": condition.object_positions,
            "config": g_cfg,
            "attn_keys": base.OVERALL_GUIDANCE_ATTN_KEYS,
        },
        gligen_boxes=boxes,
        gligen_phrases=phrases,
        gligen_scheduled_sampling_beta=gligen_scheduled_sampling_beta,
    )[0]

    base.save_video(
        out, video, save_formats, save_annotated_videos, condition, seed
    )
