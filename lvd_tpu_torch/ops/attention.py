"""Multi-head attention with an optional attention-probability output
(counterpart of lvd_tpu/ops/attention.py, with the same dispatch and the
same two switches, read at import as lvd_tpu reads them).

* ``attention(...)`` without maps: the head-packed path. Long keys always
  take it (materializing (S, S) probabilities is the reference's OOM); short
  keys take it on the card, and the small einsum on the CPU, as lvd_tpu
  takes it off the TPU. On the card it is kernel A where lvd_tpu's
  ``pallas_ok`` holds (``packed_attention.kernel_ok``) and lvd_tpu's chunked
  route on stock ops (``heads_chunked``) elsewhere: head dims % 64 != 0,
  fp16, or a K/V block above 8 MiB.
* ``attention(..., return_probs=True)`` or a ``probs_transform``: the
  materializing path, returning fp32 (B, heads, S_q, S_k) maps.
* ``sdpa()`` on (B, H, S, D) tensors: long keys without maps take
  ``attention_bh``, kernel A with one head (lvd_tpu's row-1 kernel
  ``_pallas_attention``), and kernel E in the backward.

``LVD_DISABLE_FLASH=1`` sends every attention, sdpa() included, to the
materializing einsum path. ``LVD_FUSED_LINEAR=1`` routes the q/k/v and
output projections of the fused path through kernel H
(ops/linear_fused.py) where its predicate holds.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from . import linear_fused, packed_attention
from .basic import linear

# lvd_tpu's kill switch for the fused attention paths (debugging).
_DISABLE_FUSED = os.environ.get("LVD_DISABLE_FLASH") == "1"
# lvd_tpu's opt-in switch for the resident-weights projections.
_FUSED_LINEAR = os.environ.get("LVD_FUSED_LINEAR") == "1"

_FUSED_MIN_KEY_LEN = 256


def _split_heads(x, num_heads: int):
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _chunked_sdpa(q, k, v, scale: float, block_q: int = 512):
    """lvd_tpu's route for (BH, S, D) shapes its kernel predicate rejects
    (``_chunked_sdpa``): exact attention in query blocks, stock ops."""
    out = []
    for i in range(0, q.shape[1], block_q):
        logits = torch.matmul(q[:, i:i + block_q].float(), k.float().transpose(-1, -2))
        probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
        out.append(torch.matmul(probs.float(), v.float()).to(v.dtype))
    return torch.cat(out, dim=1)


def heads_chunked(q, k, v, scale: float, num_heads: int):
    """lvd_tpu's ``_heads_chunked``: ``_chunked_sdpa`` on head-packed
    (B, S, C) tensors, for the shapes its packed kernels' predicate
    rejects."""
    b, s_q, c = q.shape
    d = c // num_heads
    to_bh = lambda t: t.reshape(b, t.shape[1], num_heads, d).transpose(1, 2).reshape(
        b * num_heads, t.shape[1], d)
    out = _chunked_sdpa(to_bh(q), to_bh(k), to_bh(v), scale)
    return out.reshape(b, num_heads, s_q, d).transpose(1, 2).reshape(b, s_q, c)


def attention_bh(q, k, v, scale: float):
    """Attention on (B, H, S, D) tensors (lvd_tpu's ``attention_bh``): the
    contiguous (B*H, S, D) view is kernel A's packed layout with one head,
    so no relayout. On the card, bf16 or fp32 with D % 64 == 0 take kernels
    A and E (lvd_tpu's row-1 predicate); other shapes take lvd_tpu's chunked
    route. On the CPU, the kernels' plain versions."""
    b, h, s_q, d = q.shape
    flat = lambda t: t.reshape(b * h, t.shape[2], d)
    if q.is_cuda and not (d % 64 == 0 and q.dtype in (torch.bfloat16, torch.float32)):
        out = _chunked_sdpa(flat(q), flat(k), flat(v), scale)
    else:
        out = packed_attention.attention_packed(flat(q), flat(k), flat(v), scale, 1)
    return out.reshape(b, h, s_q, d)


def sdpa(q, k, v, scale: Optional[float] = None, return_probs: bool = False,
         probs_transform=None):
    """Scaled dot-product attention over (B, H, S, D) tensors; softmax in
    fp32. ``probs`` returned under ``return_probs`` are pre-transform."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if (not return_probs and probs_transform is None and not _DISABLE_FUSED
            and k.shape[-2] >= _FUSED_MIN_KEY_LEN):
        return attention_bh(q, k, v, scale), None
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
    fused_path = (not return_probs and probs_transform is None and not _DISABLE_FUSED
                  and (not short_key or on_card))
    in_lin = linear
    if (fused_path and _FUSED_LINEAR
            and linear_fused.supported(p["to_q"]["w"], hidden_states)):
        # Only on the fused path, as lvd_tpu: the captured sites keep the
        # stock projections; k/v check their own weight (text keys).
        in_lin = linear_fused.maybe_linear
    q = in_lin(p["to_q"], hidden_states)
    k = in_lin(p["to_k"], context)
    v = in_lin(p["to_v"], context)
    if fused_path:
        d = q.shape[-1] // num_heads
        if on_card and not packed_attention.kernel_ok(q, k, num_heads):
            out = heads_chunked(q, k, v, d ** -0.5, num_heads)
        else:
            out = packed_attention.attention_packed(q, k, v, d ** -0.5, num_heads)
        out_lin = linear
        if _FUSED_LINEAR and linear_fused.supported(p["to_out"]["w"], out):
            out_lin = linear_fused.linear
        return out_lin(p["to_out"], out), None
    out, probs = sdpa(
        _split_heads(q, num_heads),
        _split_heads(k, num_heads),
        _split_heads(v, num_heads),
        return_probs=return_probs,
        probs_transform=probs_transform,
    )
    return linear(p["to_out"], _merge_heads(out)), probs
