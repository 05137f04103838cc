"""GLIGEN grounding: the Fourier box embedder, PositionNet and the gated
self-attention fuser (counterpart of lvd_tpu/models/gligen.py:18-83, same
param tree, same rounding points).

The fuser's attention goes through ``ops.attention.attention`` and its FF
through ``ops.basic.feed_forward``, so on the card they take kernel A (the
S visual tokens plus the grounding tokens: a key count that is no multiple
of 64) and kernel C wherever lvd_tpu routes them to its Pallas kernels.
"""

from __future__ import annotations

import torch

from ..ops.attention import attention
from ..ops.basic import feed_forward, layer_norm, linear, silu
from ..utils import prng
from . import init


def fourier_embed(x, num_freqs: int = 8, temperature: float = 100.0):
    """(..., 4) boxes -> (..., num_freqs * 2 * 4) Fourier features, computed
    in fp32 and cast to x's type. Features are ordered frequency first, then
    (sin, cos), then the coordinate."""
    freqs = temperature ** (
        torch.arange(num_freqs, dtype=torch.float32, device=x.device) / num_freqs)
    ang = x[..., None].float() * freqs  # (..., 4, F)
    emb = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)  # (..., 4, F, 2)
    emb = torch.movedim(emb, -3, -1)  # (..., F, 2, 4)
    return emb.reshape(*x.shape[:-1], num_freqs * 2 * 4).to(x.dtype)


def position_net_leaves(key, positive_len: int, out_dim: int, fourier_freqs: int = 8):
    """The PositionNet's tree in lvd_tpu's key order (models/gligen.py:33-50),
    undrawn (models/init.py)."""
    position_dim = fourier_freqs * 2 * 4
    k = prng.split(key, 3)
    return {
        "linears_0": init.linear(k[0], positive_len + position_dim, 512),
        "linears_1": init.linear(k[1], 512, 512),
        "linears_2": init.linear(k[2], 512, out_dim),
        "null_positive_feature": init.zeros(positive_len),
        "null_position_feature": init.zeros(position_dim),
    }


def init_position_net(key, positive_len: int, out_dim: int, fourier_freqs: int = 8,
                      device=None, dtype=torch.float32):
    """lvd_tpu's ``init_position_net(key, ...)`` drawn on ``device`` (the card
    unless asked)."""
    return init.draw(position_net_leaves(key, positive_len, out_dim, fourier_freqs),
                     device, dtype)


def apply_position_net(p, boxes, masks, positive_embeddings, fourier_freqs: int = 8):
    """boxes (N, M, 4), masks (N, M), positive_embeddings (N, M, positive_len)
    -> grounding tokens (N, M, out_dim). Padded slots take the null
    features."""
    masks = masks[..., None].to(boxes.dtype)
    xyxy = fourier_embed(boxes, fourier_freqs)
    xyxy = xyxy * masks + (1.0 - masks) * p["null_position_feature"].to(boxes.dtype)
    pos = positive_embeddings * masks + (1.0 - masks) * p["null_positive_feature"].to(boxes.dtype)
    h = torch.cat([pos, xyxy], dim=-1)
    h = silu(linear(p["linears_0"], h))
    h = silu(linear(p["linears_1"], h))
    return linear(p["linears_2"], h)


def apply_gated_self_attention(p, x, objs, num_heads: int):
    """The fuser: the visual tokens attend over [visual; grounding] tokens and
    are added back through tanh gates (zero at init). x (N, S, C); objs
    (N, M, context_dim); only the first S rows of the attention are kept."""
    n_visual = x.shape[1]
    objs = linear(p["linear"], objs)
    h = torch.cat([x, objs], dim=1)
    attn_out, _ = attention(p["attn"], layer_norm(p["norm1"], h), None, num_heads)
    x = x + torch.tanh(p["alpha_attn"]).to(x.dtype) * attn_out[:, :n_visual]
    return x + torch.tanh(p["alpha_dense"]).to(x.dtype) * feed_forward(
        p["ff"], layer_norm(p["norm2"], x))
