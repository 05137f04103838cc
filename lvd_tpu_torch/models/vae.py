"""SD AutoencoderKL decoder, channels-last (counterpart of the decode half of
lvd_tpu/models/vae.py). GroupNorm/SiLU resnets without time embedding and
one single-head self-attention in the mid stage, which stays plain torch as
lvd_tpu leaves it to XLA."""

from __future__ import annotations

import torch

from ..config import VAEConfig
from ..ops.basic import conv2d, group_norm, linear, silu, upsample_nearest_2x


def _resnet(p, x, groups, eps=1e-6):
    h = conv2d(p["conv1"], silu(group_norm(p["norm1"], x, groups, eps)))
    h = conv2d(p["conv2"], silu(group_norm(p["norm2"], h, groups, eps)))
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


def _attn(p, x, groups, eps=1e-6):
    n, h, w, c = x.shape
    y = group_norm(p["norm"], x, groups, eps).reshape(n, h * w, c)
    q, k, v = linear(p["to_q"], y), linear(p["to_k"], y), linear(p["to_v"], y)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * c ** -0.5
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    y = linear(p["to_out"], torch.matmul(probs, v)).reshape(n, h, w, c)
    return x + y


def decode(params, cfg: VAEConfig, latents):
    """latents (N, h, w, latent_channels), already divided by the scaling
    factor -> images (N, 8h, 8w, 3) in [-1, 1]."""
    g = cfg.norm_num_groups
    dec = params["decoder"]
    x = conv2d(params["post_quant_conv"], latents, padding=0)
    x = conv2d(dec["conv_in"], x)
    x = _resnet(dec["mid"]["resnet_1"], x, g)
    x = _attn(dec["mid"]["attn"], x, g)
    x = _resnet(dec["mid"]["resnet_2"], x, g)
    for block in dec["up_blocks"]:
        for rp in block["resnets"]:
            x = _resnet(rp, x, g)
        if "upsample" in block:
            x = conv2d(block["upsample"], upsample_nearest_2x(x))
    return conv2d(dec["conv_out"], silu(group_norm(dec["conv_norm_out"], x, g, 1e-6)))
