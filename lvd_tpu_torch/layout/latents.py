"""Latent blending, composition and alignment of the image path
(counterpart of lvd_tpu/layout/latents.py).

Per-object latents are drawn with their own seeds, blended into the
background noise inside their boxes, denoised per object, and the per-step
latent histories are composed (largest mask first), optionally re-aligned
to the overall layout's boxes first. Channels-last tensors ((B, H, W, C));
masks are (H, W) float tensors. The noise is lvd_tpu's draw from the same
seed (utils/prng.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import prng
from ..utils.device import resolve_device
from .rasterize import scale_proportion


def proportion_to_mask(box, h: int, w: int) -> torch.Tensor:
    x0, y0, x1, y1 = scale_proportion(box, H=h, W=w)
    mask = torch.zeros((h, w), dtype=torch.float32)
    mask[y0:y1, x0:x1] = 1.0
    return mask


def get_unscaled_latents(key, batch_size: int, in_channels: int, height: int, width: int,
                         dtype=torch.float32, device=None) -> torch.Tensor:
    """Initial N(0, 1) latents at the 8x-downsampled size:
    ``jax.random.normal(key, ...)`` in float32, cast to ``dtype``, on
    ``device`` (the card unless asked)."""
    shape = (batch_size, height // 8, width // 8, in_channels)
    return prng.normal_key(key, shape, resolve_device(device)).to(dtype)


def blend_latents(latents_bg, latents_fg, fg_mask, fg_blending_ratio: float = 0.01):
    """Independent fg noise blended into the bg noise inside the mask, with a
    variance-preserving sqrt mix."""
    m = torch.as_tensor(fg_mask).to(latents_bg.device, torch.float32)[None, :, :, None]
    bg = latents_bg.float()
    mixed = bg * float(np.sqrt(1.0 - fg_blending_ratio)) \
        + latents_fg.float() * float(np.sqrt(fg_blending_ratio))
    return (bg * (1.0 - m) + mixed * m).to(latents_bg.dtype)


def _numpy(mask) -> np.ndarray:
    if isinstance(mask, torch.Tensor):
        return mask.detach().float().cpu().numpy()
    return np.asarray(mask)


def binary_mask_to_box_mask(mask) -> torch.Tensor:
    """The tight bounding-box mask of a binary mask."""
    mask = _numpy(mask) > 0.5
    out = np.zeros(mask.shape, np.float32)
    if mask.any():
        ys, xs = np.where(mask)
        out[ys.min():ys.max() + 1, xs.min():xs.max() + 1] = 1.0
    return torch.from_numpy(out)


def binary_mask_to_center(mask, normalize: bool = True) -> Tuple[float, float]:
    mask = _numpy(mask).astype(np.float32)
    total = mask.sum()
    if total == 0:
        return 0.5, 0.5
    h, w = mask.shape
    ys = (mask.sum(1) * np.arange(h)).sum() / total
    xs = (mask.sum(0) * np.arange(w)).sum() / total
    if normalize:
        return float(xs / w), float(ys / h)
    return float(xs), float(ys)


def shift_tensor(x, x_offset: float, y_offset: float, offset_normalized: bool = True):
    """Shifts the two spatial dims of (..., H, W, C) with zero fill; offsets
    are fractions of (W, H) when ``offset_normalized``."""
    h, w = x.shape[-3], x.shape[-2]
    dx = int(round(x_offset * w)) if offset_normalized else int(round(x_offset))
    dy = int(round(y_offset * h)) if offset_normalized else int(round(y_offset))
    out = torch.zeros_like(x)
    if abs(dx) >= w or abs(dy) >= h:
        return out
    out[..., max(dy, 0):h - max(-dy, 0), max(dx, 0):w - max(-dx, 0), :] = \
        x[..., max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0), :]
    return out


def shift_mask(mask, x_offset: float, y_offset: float):
    return shift_tensor(torch.as_tensor(mask)[..., None], x_offset, y_offset)[..., 0]


def compose_latents(latents_all_list: Sequence, mask_tensor_list: Sequence, latents_bg,
                    compose_box_to_bg: bool = True):
    """Per-object (T+1, B, h, w, C) latent histories composed over a
    background (B, h, w, C), largest mask first: the t = 0 slot is the
    composed initial noise, later steps carry only masked content. Returns
    (composed (T+1, B, h, w, C), foreground_indices (h, w) int32)."""
    if not latents_all_list:
        raise ValueError("Nothing to compose")
    composed = torch.zeros((latents_all_list[0].shape[0], *latents_bg.shape),
                           dtype=latents_bg.dtype, device=latents_bg.device)
    composed[0] = latents_bg
    foreground_indices = torch.zeros(latents_bg.shape[1:3], dtype=torch.int32,
                                     device=latents_bg.device)
    sizes = np.array([float(_numpy(m).sum()) for m in mask_tensor_list])
    order = np.argsort(-sizes)
    on = lambda m: torch.as_tensor(m).to(latents_bg.device)

    if compose_box_to_bg:
        for idx in order:
            m = on(binary_mask_to_box_mask(mask_tensor_list[idx]))[None, :, :, None]
            m = m.to(composed.dtype)
            composed[0] = composed[0] * (1.0 - m) + latents_all_list[idx][0] * m

    for idx in order:
        mask = on(mask_tensor_list[idx])
        foreground_indices = torch.where(mask > 0.5, int(idx) + 1, foreground_indices)
        m = mask[None, None, :, :, None].to(composed.dtype)
        composed = composed * (1.0 - m) + latents_all_list[idx] * m
    return composed, foreground_indices.to(torch.int32)


def expand_overall_bboxes(overall_bboxes):
    """Per-phrase box lists flattened into one list."""
    return [box for boxes in overall_bboxes for box in (
        boxes if isinstance(boxes[0], (list, tuple, np.ndarray)) else [boxes])]


def align_with_bboxes(latents_all_list, mask_tensor_list, bboxes,
                      horizontal_shift_only: bool = False):
    """Shifts each per-object latent history so that its mask's center lands
    on its target box's center."""
    new_latents, new_masks, offsets = [], [], []
    for latents_all, mask, bbox in zip(latents_all_list, mask_tensor_list, bboxes):
        x_src, y_src = binary_mask_to_center(mask, normalize=True)
        x0, y0, x1, y1 = bbox
        x_off = (x0 + x1) / 2 - x_src
        y_off = 0.0 if horizontal_shift_only else (y0 + y1) / 2 - y_src
        new_latents.append(shift_tensor(latents_all, x_off, y_off))
        new_masks.append(shift_mask(mask, x_off, y_off))
        offsets.append((x_off, y_off))
    return new_latents, new_masks, offsets


def compose_latents_with_alignment(latents_all_list, mask_tensor_list, latents_bg,
                                   align_with_overall_bboxes: bool = True,
                                   overall_bboxes: Optional[Sequence] = None,
                                   horizontal_shift_only: bool = False, **kwargs):
    if align_with_overall_bboxes and len(latents_all_list):
        bboxes = expand_overall_bboxes(overall_bboxes)
        latents_all_list, mask_tensor_list, offsets = align_with_bboxes(
            latents_all_list, mask_tensor_list, bboxes, horizontal_shift_only)
    else:
        offsets = [(0.0, 0.0)] * len(latents_all_list)
    composed, fg_indices = compose_latents(latents_all_list, mask_tensor_list, latents_bg,
                                           **kwargs)
    return composed, fg_indices, offsets


def get_input_latents_list(in_channels: int, bg_seed: int, fg_seed_start, fg_blending_ratio,
                           height: int, width: int, so_boxes: Sequence,
                           init_noise_sigma: float = 1.0, dtype=torch.float32,
                           device=None) -> Tuple[List, torch.Tensor]:
    """Per-object blended initial latents and the background latents, all
    scaled by the scheduler's init sigma."""
    latents_bg = get_unscaled_latents(prng.prng_key(bg_seed), 1, in_channels, height, width,
                                      dtype, device)
    out = []
    h, w = height // 8, width // 8
    for idx, box in enumerate(so_boxes):
        fg_seed = fg_seed_start[idx] if isinstance(fg_seed_start, list) else fg_seed_start + idx
        if fg_seed == bg_seed:
            raise ValueError(f"fg seed {fg_seed} must differ from bg seed {bg_seed}")
        latents_fg = get_unscaled_latents(prng.prng_key(fg_seed), 1, in_channels, height,
                                          width, dtype, device)
        ratio = (fg_blending_ratio[idx] if isinstance(fg_blending_ratio, list)
                 else fg_blending_ratio)
        out.append(blend_latents(latents_bg, latents_fg, proportion_to_mask(box, h, w), ratio)
                   * init_noise_sigma)
    return out, latents_bg * init_noise_sigma
