"""Ungrounded Zeroscope baseline (plain T2V with DPM-Solver++), with an
optional Zeroscope-XL vid2vid refinement pass (``init("xl")``).

Counterpart of lvd_tpu/runners/zeroscope_dpm.py; parity target of both: the
reference's generation/zeroscope_dpm.py (including the XL refine at
strength 0.6, :90-109).
"""

from __future__ import annotations

import os

from ..text.templates import NEGATIVE_PROMPT
from . import base

version = "zeroscope"

_state = base.RunnerState()
_xl = False


def init(option: str = ""):
    global _state, _xl
    _xl = option == "xl"
    _state = base.init_pipeline("zeroscope")
    return _state.H, _state.W


def run(
    parsed_layout,
    seed,
    num_inference_steps=40,
    num_frames=24,
    repeat_ind=None,
    save_formats=("gif", "joblib"),
):
    out = base.output_path(seed, repeat_ind)
    if os.path.exists(out + ".gif"):
        print(f"Skipping {out}.gif")
        return

    prompt = parsed_layout["Prompt"]
    if parsed_layout.get("Background keyword"):
        prompt = f"{prompt}, {parsed_layout['Background keyword']} background"

    video = _state.pipe(
        prompt,
        negative_prompt=NEGATIVE_PROMPT,
        num_inference_steps=num_inference_steps,
        height=_state.H,
        width=_state.W,
        num_frames=num_frames,
        seed=seed,
    )[0]

    if _xl:
        from ..cli.upsample import upsample_video_zsxl

        video = upsample_video_zsxl(video, prompt, seed=seed, strength=0.6)

    base.save_video(out, video, save_formats)
