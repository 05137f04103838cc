"""Multi-head attention with an optional attention-probability output
(counterpart of lvd_tpu/ops/attention.py, with the same dispatch).

* ``attention(...)`` without maps: the head-packed path. Long keys always
  take it (materializing (S, S) probabilities is the reference's OOM); short
  keys take it on the card, where it is kernel A, and the small einsum on
  the CPU, as lvd_tpu takes it off the TPU.
* ``attention(..., return_probs=True)`` or a ``probs_transform``: the
  materializing path, returning fp32 (B, heads, S_q, S_k) maps.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import packed_attention
from .basic import linear

_FUSED_MIN_KEY_LEN = 256


def _split_heads(x, num_heads: int):
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def sdpa(q, k, v, scale: Optional[float] = None, return_probs: bool = False,
         probs_transform=None):
    """Scaled dot-product attention over (B, H, S, D) tensors; softmax in
    fp32. ``probs`` returned under ``return_probs`` are pre-transform."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not return_probs and probs_transform is None and k.shape[-2] >= _FUSED_MIN_KEY_LEN:
        b, h, s_q, d = q.shape
        pack = lambda t: t.transpose(1, 2).reshape(b, t.shape[2], h * d)
        out = packed_attention.attention_packed_plain(pack(q), pack(k), pack(v), scale, h)
        return _split_heads(out, h), None
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    used = probs if probs_transform is None else probs_transform(probs)
    out = torch.matmul(used.to(v.dtype).float(), v.float()).to(v.dtype)
    return out, (probs if return_probs else None)


def attention(
    p,
    hidden_states,
    encoder_hidden_states=None,
    num_heads: int = 8,
    return_probs: bool = False,
    probs_transform=None,
):
    """Projected multi-head attention (bias-free q/k/v, output projection
    with bias). hidden_states (B, S_q, C); encoder_hidden_states
    (B, S_k, C_enc) or None. Returns (out, probs | None)."""
    context = hidden_states if encoder_hidden_states is None else encoder_hidden_states
    on_card = hidden_states.is_cuda
    short_key = context.shape[-2] < _FUSED_MIN_KEY_LEN
    fused_path = not return_probs and probs_transform is None and (not short_key or on_card)
    q = linear(p["to_q"], hidden_states)
    k = linear(p["to_k"], context)
    v = linear(p["to_v"], context)
    if fused_path:
        d = q.shape[-1] // num_heads
        out = packed_attention.attention_packed(q, k, v, d ** -0.5, num_heads)
        return linear(p["to_out"], out), None
    out, probs = sdpa(
        _split_heads(q, num_heads),
        _split_heads(k, num_heads),
        _split_heads(v, num_heads),
        return_probs=return_probs,
        probs_transform=probs_transform,
    )
    return linear(p["to_out"], _merge_heads(out)), probs
