"""Core functional ops on channels-last tensors (counterpart of
lvd_tpu/ops/basic.py).

Params are plain dicts of tensors in lvd_tpu's layouts:
  linear: {"w": (in, out), "b": (out,)?}
  conv2d: {"w": (kh, kw, in, out), "b": (out,)?}        (HWIO)
  conv3d: {"w": (kt, kh, kw, in, out), "b": (out,)?}
  norm:   {"scale": (C,), "bias": (C,)}
Convolutions hand cuDNN a channels-last view, so no activation is relaid out.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F


def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def conv2d(p, x, stride: int = 1, padding: int = 1):
    """x: (N, H, W, C) -> (N, H', W', O)."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    b = p["b"].to(x.dtype) if "b" in p else None
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3d(p, x, padding=((1, 1), (0, 0), (0, 0))):
    """x: (N, T, H, W, C); kernel (kt, kh, kw, in, out); symmetric padding."""
    if any(lo != hi for lo, hi in padding):
        raise ValueError(f"conv3d: only symmetric padding, got {padding}")
    w = p["w"].to(x.dtype).permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    b = p["b"].to(x.dtype) if "b" in p else None
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, padding=tuple(lo for lo, _ in padding))
    return y.permute(0, 2, 3, 4, 1).contiguous()


def group_norm_coeffs(p, x, num_groups: int = 32, eps: float = 1e-5, axis_name=None,
                      count_override: Optional[int] = None):
    """Per-channel affine GroupNorm coefficients (a, b), both (N, C) fp32,
    such that ``y = x * a + b``. One-pass fp32 statistics (m2 - mean^2),
    as lvd_tpu computes them. ``axis_name``: a parallel/comm.Group over
    which x is sharded (frames across ranks): the group sums are psummed
    and the per-group count scaled by the group's size; ``count_override``
    is the exact count where the shard carries zero padding."""
    n, c = x.shape[0], x.shape[-1]
    g = num_groups
    xr = x.reshape(n, -1, c)
    per_group = xr.shape[1] * (c // g)
    s1c = xr.sum(dim=1, dtype=torch.float32)
    x32 = xr.float()
    s2c = (x32 * x32).sum(dim=1)
    del x32
    s1 = s1c.view(n, g, c // g).sum(-1)
    s2 = s2c.view(n, g, c // g).sum(-1)
    if axis_name is not None:
        from ..parallel import comm

        s1 = comm.psum(s1, axis_name)
        s2 = comm.psum(s2, axis_name)
        per_group = per_group * comm.axis_size(axis_name)
    if count_override is not None:
        per_group = count_override
    mean_g = s1 / per_group
    var_g = torch.clamp(s2 / per_group - mean_g * mean_g, min=0.0)
    inv_g = torch.rsqrt(var_g + eps)
    inv_c = inv_g.repeat_interleave(c // g, dim=1)
    mean_c = mean_g.repeat_interleave(c // g, dim=1)
    a = inv_c * p["scale"].float()[None, :]
    b = p["bias"].float()[None, :] - mean_c * a
    return a, b


def group_norm(p, x, num_groups: int = 32, eps: float = 1e-5, axis_name=None,
               count_override: Optional[int] = None):
    """GroupNorm over channels-last input of any rank >= 2; statistics per
    (batch, group) over all non-batch axes (and over ``axis_name``'s ranks,
    see group_norm_coeffs), applied in the input dtype."""
    n, c = x.shape[0], x.shape[-1]
    a, b = group_norm_coeffs(p, x, num_groups, eps, axis_name, count_override)
    xr = x.reshape(n, -1, c)
    y = xr * a[:, None, :].to(x.dtype) + b[:, None, :].to(x.dtype)
    return y.reshape(x.shape)


def layer_norm(p: Optional[dict], x, eps: float = 1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    m2 = (x32 * x32).mean(dim=-1, keepdim=True)
    var = torch.clamp(m2 - mean * mean, min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if p is not None:
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def silu(x):
    return F.silu(x)


def geglu(p, x):
    """GEGLU projection: Linear(dim -> 2*inner), gated with GELU in the form
    ops.geglu_fused.GELU_FORM names."""
    from . import geglu_fused

    h, gate = linear(p, x).chunk(2, dim=-1)
    return h * F.gelu(gate, approximate="tanh" if geglu_fused.GELU_FORM == "tanh" else "none")


def feed_forward(p, x):
    """BasicTransformerBlock FF: GEGLU -> Linear. Routed to the fused GEGLU
    on the shapes lvd_tpu routes to its Pallas kernel (resident weights:
    C <= 640 in bf16, C <= 320 in fp32), unless ``LVD_DISABLE_FUSED_FF=1``
    (read per call, as lvd_tpu reads it)."""
    from . import geglu_fused

    if (os.environ.get("LVD_DISABLE_FUSED_FF") != "1"
            and geglu_fused.supported(p["proj"]["w"], p["out"]["w"], x)):
        return geglu_fused.geglu_mlp(p, x)
    return linear(p["out"], geglu(p["proj"], x))


def timestep_embedding(timesteps, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0, max_period: float = 10000.0):
    """Sinusoidal timestep embedding (diffusers ``Timesteps``). timesteps: (N,)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


def time_embedding_mlp(p, t_emb):
    """diffusers ``TimestepEmbedding``: linear -> silu -> linear."""
    return linear(p["linear_2"], silu(linear(p["linear_1"], t_emb)))


def upsample_nearest_2x(x):
    """(N, H, W, C) -> (N, 2H, 2W, C) nearest-neighbour."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)
