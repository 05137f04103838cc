"""Fused temporal double self-attention: kernel B and its plain versions
(counterpart of lvd_tpu/ops/temporal_attention.py).

``temporal_attention_pair(p, y, heads, eps, frames_major)`` runs
LN1 -> attn1 -> +res -> LN2 -> attn2 -> +res over the frame axis of
(B, P, F, C) input, or of the (B, F, P, C) stream with ``frames_major``. On
a CUDA tensor it launches kernel B (csrc/temporal_attention.cu, replacing
``_pallas_pair``); on a CPU tensor it runs ``_pair_ref`` / ``_pair_ref_fm``,
the plain formulation lvd_tpu's kernel is held to. The FF stage stays
outside (ops.geglu_fused).
"""

from __future__ import annotations

import torch

from . import _build

HEAD_DIM = 64
MAX_CHANNELS = 640


def _ref_ln(p, x, eps):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _ref_attn(pa, y, num_heads):
    """Self-attention over axis 2 of (B, P, F, C): bf16-rounded q/k/v,
    fp32 logits and softmax, probabilities and head outputs in y's type."""
    d = y.shape[-1] // num_heads
    q, k, v = (y @ pa[n]["w"].to(y.dtype) for n in ("to_q", "to_k", "to_v"))
    outs = []
    for h in range(num_heads):
        sl = slice(h * d, (h + 1) * d)
        logits = torch.matmul(q[..., sl].float(), k[..., sl].float().transpose(-1, -2))
        probs = torch.softmax(logits * d ** -0.5, dim=-1).to(y.dtype)
        outs.append(torch.matmul(probs.float(), v[..., sl].float()).to(y.dtype))
    o = torch.cat(outs, dim=-1)
    out = torch.matmul(o.float(), pa["to_out"]["w"].to(y.dtype).float())
    return (out + pa["to_out"]["b"].float()).to(y.dtype)


def _pair_ref(p, y, num_heads, eps):
    y = y + _ref_attn(p["attn1"], _ref_ln(p["norm1"], y, eps), num_heads)
    y = y + _ref_attn(p["attn2"], _ref_ln(p["norm2"], y, eps), num_heads)
    return y


def _pair_ref_fm(p, y, num_heads, eps):
    """Frames-major plain version: transposes around ``_pair_ref``."""
    return _pair_ref(p, y.transpose(1, 2), num_heads, eps).transpose(1, 2)


def supported(y, num_heads: int) -> bool:
    """lvd_tpu's routing predicate (temporal_attention.py:501-513): 64-wide
    heads and C <= 640."""
    c = y.shape[-1]
    return c // num_heads == HEAD_DIM and c <= MAX_CHANNELS


def _attn_weights(pa, ln):
    f32 = lambda t: t.float().contiguous()
    bf = lambda t: t.to(torch.bfloat16).contiguous()
    wqkv = torch.cat([pa["to_q"]["w"], pa["to_k"]["w"], pa["to_v"]["w"]], dim=1)
    return [f32(ln["scale"]), f32(ln["bias"]), bf(wqkv), bf(pa["to_out"]["w"]),
            f32(pa["to_out"]["b"])]


def temporal_attention_pair_plain(p, y, num_heads: int, eps: float = 1e-5,
                                  frames_major: bool = False):
    ref = _pair_ref_fm if frames_major else _pair_ref
    return ref(p, y, num_heads, eps)


def temporal_attention_pair(p, y, num_heads: int, eps: float = 1e-5,
                            frames_major: bool = False):
    if y.device.type == "cpu":
        return temporal_attention_pair_plain(p, y, num_heads, eps, frames_major)
    y = _build.kernel_input(y, torch.bfloat16, "temporal_attention_pair y")
    if frames_major:
        b, f, pdim, c = y.shape
        strides = (f * pdim * c, pdim * c, c)
    else:
        b, pdim, f, c = y.shape
        strides = (f * pdim * c, c, f * c)
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"temporal_attention_pair: C={c} is not {num_heads} heads of {HEAD_DIM}")
    weights = _attn_weights(p["attn1"], p["norm1"]) + _attn_weights(p["attn2"], p["norm2"])
    out = torch.empty_like(y)
    err = _build.lib().lvd_temporal_pair(
        y.data_ptr(), out.data_ptr(), *[w.data_ptr() for w in weights],
        b, f, pdim, c, num_heads, *strides, float(eps), _build.stream_of(y))
    _build.check(err, "temporal_attention_pair")
    temporal_attention_pair.launches += 1
    return out


temporal_attention_pair.launches = 0
