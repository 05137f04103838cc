"""Host-side preparation of static-shape guidance inputs (a copy of
lvd_tpu/layout/rasterize.py; numpy only).

Boxes are rasterized once per video into dense per-resolution masks, phrase
token indices are padded into a fixed (O, P) matrix, and top-k sizes become
per-(object, frame) integers, so the energy is pure tensor ops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np


def scale_proportion(box, H: int, W: int) -> Tuple[int, int, int, int]:
    """Normalized xyxy -> integer pixel bounds, rounding the box *size*
    (shift-invariant; reference utils/utils.py:82-103)."""
    x_min, y_min = round(box[0] * W), round(box[1] * H)
    box_w = round((box[2] - box[0]) * W)
    box_h = round((box[3] - box[1]) * H)
    x_max, y_max = x_min + box_w, y_min + box_h
    return max(x_min, 0), max(y_min, 0), min(x_max, W), min(y_max, H)


def boxes_to_masks(boxes: Sequence, H: int, W: int) -> np.ndarray:
    """boxes: per-object list of per-frame normalized xyxy -> (O, F, H, W)
    binary masks (all-zero for absent frames)."""
    boxes = np.asarray(boxes, dtype=np.float64)
    n_obj, n_frames = boxes.shape[0], boxes.shape[1]
    masks = np.zeros((n_obj, n_frames, H, W), dtype=np.float32)
    for o in range(n_obj):
        for f in range(n_frames):
            x0, y0, x1, y1 = scale_proportion(boxes[o, f], H=H, W=W)
            masks[o, f, y0:y1, x0:x1] = 1.0
    return masks


@dataclasses.dataclass
class GuidancePack:
    """Static-shape device inputs for the CA energy of one video."""

    # masks[key] : (O, F, Hk, Wk) float32
    masks: Dict[Tuple, np.ndarray]
    # token index matrix (O, P) int32, padded with 0; token_mask (O, P) float32
    token_indices: np.ndarray
    token_mask: np.ndarray
    # per-(key, object, frame) top-k sizes, clamped to >= 1
    k_fg: Dict[Tuple, np.ndarray]  # (O, F) int32
    k_bg: Dict[Tuple, np.ndarray]  # (O, F) int32
    num_objects: int


def _level_of_key(key: Tuple, num_blocks: int = 4) -> int:
    kind, idx = key[0], int(key[1])
    if kind == "down":
        return idx
    if kind == "mid":
        return num_blocks - 1
    if kind == "up":
        return num_blocks - 1 - idx
    raise ValueError(f"Unknown key kind: {key}")


def resolution_of_key(
    key: Tuple, latent_hw: Tuple[int, int], num_blocks: int = 4
) -> Tuple[int, int]:
    """Attention grid (H, W) at an instrumented layer, given latent size.

    Spatial attention at down/up level L runs at latent_hw / 2^L. Up blocks
    process at the resolution *before* their upsample, mirroring down levels.
    """
    level = _level_of_key(key, num_blocks)
    h, w = latent_hw
    return h // (2 ** level), w // (2 ** level)


def make_guidance_pack(
    boxes: Sequence,
    object_positions: Sequence[Sequence[int]],
    guidance_attn_keys: Sequence[Tuple],
    latent_hw: Tuple[int, int],
    fg_top_p: float = 0.75,
    bg_top_p: float = 0.75,
    max_tokens_per_obj: int = None,
    upsample_scale: int = 1,
) -> GuidancePack:
    """Build all static-shape inputs the jitted CA energy needs.

    boxes: (O, F, 4) normalized xyxy (from Condition.boxes)
    object_positions: per-object token-index lists (from Condition)
    upsample_scale: rasterize masks (and compute top-k sizes) at
        ``upsample_scale`` x the attention resolution — pairs with
        GuidanceConfig.upsample_scale, which resizes the per-token maps to
        the same grid (reference utils/guidance.py:226,238-244,297-310).
    """
    n_obj = len(boxes)
    masks, k_fg, k_bg = {}, {}, {}
    for key in guidance_attn_keys:
        hk, wk = resolution_of_key(tuple(key), latent_hw)
        hk, wk = hk * int(upsample_scale), wk * int(upsample_scale)
        m = boxes_to_masks(boxes, hk, wk)  # (O, F, Hk, Wk)
        masks[tuple(key)] = m
        fg_area = m.sum(axis=(2, 3))
        bg_area = (1.0 - m).sum(axis=(2, 3))
        k_fg[tuple(key)] = np.maximum((fg_area * fg_top_p).astype(np.int64), 1).astype(
            np.int32
        )
        k_bg[tuple(key)] = np.maximum((bg_area * bg_top_p).astype(np.int64), 1).astype(
            np.int32
        )

    p_max = max_tokens_per_obj or max((len(p) for p in object_positions), default=1)
    token_indices = np.zeros((n_obj, p_max), dtype=np.int32)
    token_mask = np.zeros((n_obj, p_max), dtype=np.float32)
    for o, positions in enumerate(object_positions):
        take = positions[:p_max]
        token_indices[o, : len(take)] = take
        token_mask[o, : len(take)] = 1.0

    return GuidancePack(
        masks=masks,
        token_indices=token_indices,
        token_mask=token_mask,
        k_fg=k_fg,
        k_bg=k_bg,
        num_objects=n_obj,
    )
