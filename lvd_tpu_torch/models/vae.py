"""SD AutoencoderKL, channels-last (counterpart of lvd_tpu/models/vae.py):
the encoder (the vid2vid and img2img paths' ``encode``) and the decoder.
GroupNorm/SiLU resnets without time embedding and one single-head
self-attention in each mid stage, which stays plain torch as lvd_tpu leaves
it to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import VAEConfig
from ..ops.basic import conv2d, group_norm, group_norm_silu, linear, upsample_nearest_2x
from ..utils import prng
from . import init


def _resnet_leaves(key, cin, cout):
    k = prng.split(key, 3)
    p = {"norm1": init.norm(cin), "conv1": init.conv(k[0], 3, 3, cin, cout),
         "norm2": init.norm(cout), "conv2": init.conv(k[1], 3, 3, cout, cout)}
    if cin != cout:
        p["conv_shortcut"] = init.conv(k[2], 1, 1, cin, cout)
    return p


def _attn_leaves(key, c):
    k = prng.split(key, 4)
    return {"norm": init.norm(c), **{name: init.linear(k[i], c, c) for i, name in
                                     enumerate(("to_q", "to_k", "to_v", "to_out"))}}


def _mid_leaves(keys, c):
    return {"resnet_1": _resnet_leaves(next(keys), c, c), "attn": _attn_leaves(next(keys), c),
            "resnet_2": _resnet_leaves(next(keys), c, c)}


def vae_leaves(key, cfg: VAEConfig):
    """lvd_tpu's VAE tree (``init_vae``, models/vae.py:80-142), encoder and
    decoder, with its keys, undrawn: the keys of ``split(key, 128)`` in
    turn, the encoder's first."""
    boc = cfg.block_out_channels
    keys = iter(prng.split(key, 128))
    enc = {"conv_in": init.conv(next(keys), 3, 3, cfg.in_channels, boc[0])}
    blocks, ch = [], boc[0]
    for i, cout in enumerate(boc):
        block = {"resnets": [_resnet_leaves(next(keys), ch if j == 0 else cout, cout)
                             for j in range(cfg.layers_per_block)]}
        if i < len(boc) - 1:
            block["downsample"] = init.conv(next(keys), 3, 3, cout, cout)
        blocks.append(block)
        ch = cout
    enc["down_blocks"] = blocks
    enc["mid"] = _mid_leaves(keys, boc[-1])
    enc["conv_norm_out"] = init.norm(boc[-1])
    enc["conv_out"] = init.conv(next(keys), 3, 3, boc[-1], 2 * cfg.latent_channels)

    dec = {"conv_in": init.conv(next(keys), 3, 3, cfg.latent_channels, boc[-1])}
    dec["mid"] = _mid_leaves(keys, boc[-1])
    blocks, rev = [], list(reversed(boc))
    ch = rev[0]
    for i, cout in enumerate(rev):
        block = {"resnets": [_resnet_leaves(next(keys), ch if j == 0 else cout, cout)
                             for j in range(cfg.layers_per_block + 1)]}
        if i < len(boc) - 1:
            block["upsample"] = init.conv(next(keys), 3, 3, cout, cout)
        blocks.append(block)
        ch = cout
    dec["up_blocks"] = blocks
    dec["conv_norm_out"] = init.norm(boc[0])
    dec["conv_out"] = init.conv(next(keys), 3, 3, boc[0], cfg.out_channels)
    lat2 = 2 * cfg.latent_channels
    return {"encoder": enc, "decoder": dec,
            "quant_conv": init.conv(next(keys), 1, 1, lat2, lat2),
            "post_quant_conv": init.conv(next(keys), 1, 1, cfg.latent_channels,
                                         cfg.latent_channels)}


def init_vae(key, cfg: VAEConfig, device=None, dtype=torch.float32):
    """lvd_tpu's ``init_vae(key, cfg)`` drawn on ``device`` (the card unless
    asked)."""
    return init.draw(vae_leaves(key, cfg), device, dtype)


def _resnet(p, x, groups, eps=1e-6):
    h = conv2d(p["conv1"], group_norm_silu(p["norm1"], x, groups, eps))
    h = conv2d(p["conv2"], group_norm_silu(p["norm2"], h, groups, eps))
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


def encode(params, cfg: VAEConfig, images):
    """images (N, H, W, 3) in [-1, 1] -> (mean, logvar), each (N, H/8, W/8,
    latent_channels), logvar clipped to [-30, 20]. A sample times
    ``cfg.scaling_factor`` is the pipeline's latents."""
    g = cfg.norm_num_groups
    enc = params["encoder"]
    x = conv2d(enc["conv_in"], images)
    for block in enc["down_blocks"]:
        for rp in block["resnets"]:
            x = _resnet(rp, x, g)
        if "downsample" in block:
            # diffusers' encoder downsample: pad (0, 1, 0, 1), then a
            # stride-2 VALID conv.
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
            x = conv2d(block["downsample"], x, stride=2, padding=0)
    x = _resnet(enc["mid"]["resnet_1"], x, g)
    x = _attn(enc["mid"]["attn"], x, g)
    x = _resnet(enc["mid"]["resnet_2"], x, g)
    x = conv2d(enc["conv_out"], group_norm_silu(enc["conv_norm_out"], x, g, 1e-6))
    x = conv2d(params["quant_conv"], x, padding=0)
    mean, logvar = x.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


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
    return conv2d(dec["conv_out"], group_norm_silu(dec["conv_norm_out"], x, g, 1e-6))
