"""Shared runner machinery (counterpart of lvd_tpu/runners/base.py).

Runners keep lvd_tpu's module contract: ``version: str``,
``init(base_model | option) -> (H, W)``, ``run(parsed_layout, seed,
**hparams)``. Each runner writes ``{img_dir}/video_{suffix}.{gif,joblib}``
and skips an output whose GIF exists.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from ..diffusion.guidance import GuidanceConfig
from ..diffusion.guidance import OVERALL_GUIDANCE_ATTN_KEYS  # noqa: F401 (lvd_tpu's name)
from ..layout.condition import parsed_layout_to_condition
from ..models.loader import load_pipeline_models
from ..pipeline import TextToVideoPipeline
from ..utils import vis

# Output directory, settable by the caller (as lvd_tpu's).
img_dir = "imgs"


class RunnerState:
    pipe: Optional[TextToVideoPipeline] = None
    H: int = 0
    W: int = 0
    box_h: int = 512
    box_w: int = 512


def init_pipeline(preset_name: str) -> RunnerState:
    """The preset's pipeline on the card, in bf16."""
    if os.environ.get("LVD_TINY") == "1":
        raise NotImplementedError(
            "LVD_TINY=1: lvd_tpu's tiny weights come from jax.random in its key "
            "order, which this package cannot draw yet (ROADMAP A3)")
    models = load_pipeline_models(preset_name, dtype=torch.bfloat16)
    state = RunnerState()
    state.pipe = TextToVideoPipeline(models, dtype=torch.bfloat16)
    state.H, state.W = models.preset.height, models.preset.width
    state.box_h, state.box_w = models.preset.box_h, models.preset.box_w
    return state


def build_condition(state: RunnerState, parsed_layout, num_frames: int):
    return parsed_layout_to_condition(
        parsed_layout,
        tokenizer=state.pipe.m.tokenizer,
        height=state.box_h,
        width=state.box_w,
        num_condition_frames=num_frames,
        verbose=True,
    )


def guidance_config(run_args: dict) -> GuidanceConfig:
    """The GuidanceConfig of a guided runner's ``run()`` arguments: every one
    whose name is a GuidanceConfig field (the 16 that lvd_tpu's runners pass
    by name); the other fields keep their defaults."""
    names = {f.name for f in dataclasses.fields(GuidanceConfig)}
    return GuidanceConfig(**{k: v for k, v in run_args.items() if k in names})


def gligen_per_frame_inputs(condition, num_frames: int):
    """Per-frame box/phrase lists, dropping absent ([0,0,0,0]) boxes
    (reference generation/lvd_gligen.py:99-115)."""
    boxes, phrases = [], []
    for f in range(num_frames):
        present = [
            (phrase, b[f])
            for phrase, b in zip(condition.phrases, condition.boxes)
            if list(b[f]) != [0.0, 0.0, 0.0, 0.0]
        ]
        phrases.append([p for p, _ in present])
        boxes.append([list(b) for _, b in present])
    return boxes, phrases


def output_path(seed, repeat_ind) -> str:
    suffix = repeat_ind if repeat_ind is not None else f"seed{seed}"
    return f"{img_dir}/video_{suffix}"


def save_video(
    base_path: str,
    video,  # (F, H, W, 3) float [0,1]
    save_formats=("gif", "joblib"),
    annotated=False,
    condition=None,
    seed=None,
):
    frames = (np.clip(np.asarray(video), 0, 1) * 255.0).astype(np.uint8)
    if annotated and condition is not None:
        ann = []
        for i, frame in enumerate(frames):
            boxes_i = [b[i] for b in condition.boxes]
            img = vis.draw_box(Image.fromarray(frame), boxes_i, condition.phrases)
            ann.append(np.asarray(img))
        vis.save_frames(f"{base_path}_seed{seed}_with_box", ann, formats="gif")
    vis.save_frames(base_path, frames, formats=save_formats)
