"""Attention-map post-processing for analysis/visualization (a numpy copy
of lvd_tpu/utils/attn_post.py; parity target of both: the reference's
utils/attn.py:10-88, `get_token_attnv2`, `shift_saved_attns`). Operates on aux dicts returned by the UNet
({key: (T, B*F, heads, HW, L)} when stacked over timesteps, or a list of
per-timestep aux dicts).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def get_token_attn(
    saved_attns: Sequence[Dict],
    key: Tuple,
    token_index: int,
    grid_hw: Tuple[int, int],
    average_timesteps: bool = True,
    average_heads: bool = True,
):
    """Average one token's cross-attention maps across timesteps (and heads).

    saved_attns: list of per-timestep aux dicts {key: (BF, heads, HW, L)}.
    Returns (BF, H, W) (heads averaged) or (BF, heads, H, W).
    """
    maps = np.stack([np.asarray(aux[key]) for aux in saved_attns])  # (T, BF, h, HW, L)
    token = maps[..., token_index]  # (T, BF, h, HW)
    if average_timesteps:
        token = token.mean(axis=0)
    if average_heads:
        token = token.mean(axis=-2)
    h, w = grid_hw
    return token.reshape(*token.shape[:-1], h, w)


def shift_attn_map(attn_map: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """Spatially shift a (.., H, W) map, zero-filling vacated cells
    (reference shift_saved_attns_item semantics)."""
    out = np.zeros_like(attn_map)
    h, w = attn_map.shape[-2:]
    if abs(dx) >= w or abs(dy) >= h:
        return out  # shifted fully out of frame
    src_y = slice(max(-dy, 0), h - max(dy, 0))
    src_x = slice(max(-dx, 0), w - max(dx, 0))
    dst_y = slice(max(dy, 0), h - max(-dy, 0))
    dst_x = slice(max(dx, 0), w - max(-dx, 0))
    out[..., dst_y, dst_x] = attn_map[..., src_y, src_x]
    return out


def shift_saved_attns(
    saved_attns: Sequence[Dict],
    key: Tuple,
    grid_hw: Tuple[int, int],
    dx: int = 0,
    dy: int = 0,
) -> List[np.ndarray]:
    """Shift every timestep's saved map for ``key`` by (dx, dy) grid cells."""
    h, w = grid_hw
    out = []
    for aux in saved_attns:
        m = np.asarray(aux[key])  # (BF, heads, HW, L)
        bf, heads, hw_, l = m.shape
        m2 = m.transpose(0, 1, 3, 2).reshape(bf, heads, l, h, w)
        m2 = shift_attn_map(m2, dx, dy)
        out.append(m2.reshape(bf, heads, l, hw_).transpose(0, 1, 3, 2))
    return out
