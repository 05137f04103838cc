"""2D conditional UNet, Stable-Diffusion architecture (counterpart of
lvd_tpu/models/unet2d.py, same param tree and key order).

Built from the 3D UNet's blocks (``models/unet3d``) minus the temporal
layers, so every kernel route of the video UNet holds here too: attention
on kernel A where lvd_tpu's ``pallas_ok`` holds, the feed-forward on kernel
C where its weights stay resident, the resnets' GroupNorm -> SiLU -> 3x3
conv on kernel I under ``LVD_ENABLE_FUSED_SC=1`` and the projections on
kernel H under ``LVD_FUSED_LINEAR=1``. Spatial transformers hold
``transformer_depth`` blocks per down block (the SDXL refiner: 4). The SDXL
"text_time" added conditioning (pooled text embedding + Fourier-embedded
time ids) joins the time embedding; ``capture_keys`` use the 3D UNet's
``(dir, block, layer, btb)`` addresses; GLIGEN inputs go through the
PositionNet once and every block with a fuser takes them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.basic import (
    conv2d,
    group_norm_silu,
    time_embedding_mlp,
    timestep_embedding,
    upsample_nearest_2x,
)
from ..utils import prng
from . import init
from . import unet3d as u3
from .gligen import apply_position_net, position_net_leaves


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # SD1.x: 8 heads at every block (head dim varies with width).
    num_heads: Tuple[int, ...] = (8, 8, 8, 8)
    # Which down blocks carry cross-attention (up mirrors the reverse) and
    # how many transformer blocks each attention layer holds.
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 0)
    mid_transformer_depth: int = 1
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_norm_eps: float = 1e-6
    attention_type: str = "default"
    gligen_positive_len: int = 768
    gligen_fourier_freqs: int = 8
    addition_embed_type: str = ""  # "" | "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)


def sdxl_refiner_config() -> UNet2DConfig:
    """stabilityai/stable-diffusion-xl-refiner-1.0's UNet: OpenCLIP-bigG
    hidden states (1280) plus the pooled text and five time ids (original
    size, crop, aesthetic score) of 256 Fourier features each."""
    return UNet2DConfig(
        block_out_channels=(384, 768, 1536, 1536),
        layers_per_block=2,
        cross_attention_dim=1280,
        num_heads=(6, 12, 24, 24),
        down_block_has_attn=(False, True, True, False),
        transformer_depth=(0, 4, 4, 0),
        mid_transformer_depth=4,
        addition_embed_type="text_time",
        addition_time_embed_dim=256,
        projection_class_embeddings_input_dim=2560,
    )


def tiny_unet2d_config(attention_type: str = "default") -> UNet2DConfig:
    return UNet2DConfig(
        block_out_channels=(32, 64, 64, 64),
        cross_attention_dim=64,
        num_heads=(2, 2, 2, 2),
        norm_num_groups=8,
        attention_type=attention_type,
        gligen_positive_len=64,
    )


def unet2d_leaves(key, cfg: UNet2DConfig):
    """lvd_tpu's UNet2D tree (``init_unet2d``) with its keys, undrawn: every
    module takes the next key of ``split(key, 256)`` in lvd_tpu's order of
    construction (not the 3D UNet's fold_in stream)."""
    boc = cfg.block_out_channels
    temb = cfg.time_embed_dim
    gated = cfg.attention_type == "gated"
    keys = iter(prng.split(key, 256))

    params = {
        "conv_in": init.conv(next(keys), 3, 3, cfg.in_channels, boc[0]),
        "time_embedding": {"linear_1": init.linear(next(keys), boc[0], temb),
                           "linear_2": init.linear(next(keys), temb, temb)},
    }
    if cfg.addition_embed_type == "text_time":
        params["add_embedding"] = {
            "linear_1": init.linear(next(keys), cfg.projection_class_embeddings_input_dim, temb),
            "linear_2": init.linear(next(keys), temb, temb)}

    def layer(cin, cout, with_attn, depth):
        p = {"resnet": u3._resnet_leaves(next(keys), cin, cout, temb)}
        if with_attn:
            p["attn"] = u3._spatial_transformer_leaves(next(keys), cout, cfg.cross_attention_dim,
                                                       gated, depth)
        return p

    down, ch = [], boc[0]
    for i, cout in enumerate(boc):
        block = {"layers": [layer(ch if j == 0 else cout, cout, cfg.down_block_has_attn[i],
                                  cfg.transformer_depth[i])
                            for j in range(cfg.layers_per_block)]}
        if i < len(boc) - 1:
            block["downsample"] = init.conv(next(keys), 3, 3, cout, cout)
        down.append(block)
        ch = cout
    params["down_blocks"] = down
    params["mid_block"] = {
        "resnet_in": u3._resnet_leaves(next(keys), boc[-1], boc[-1], temb),
        "layers": [layer(boc[-1], boc[-1], True, cfg.mid_transformer_depth)],
    }
    up, rev = [], list(reversed(boc))
    rev_attn = list(reversed(cfg.down_block_has_attn))
    rev_depth = list(reversed(cfg.transformer_depth))
    prev = rev[0]
    for i, cout in enumerate(rev):
        skip_source = rev[min(i + 1, len(boc) - 1)]
        layers = []
        for j in range(cfg.layers_per_block + 1):
            skip_ch = skip_source if j == cfg.layers_per_block else cout
            layers.append(layer((prev if j == 0 else cout) + skip_ch, cout, rev_attn[i],
                                rev_depth[i]))
        block = {"layers": layers}
        if i < len(boc) - 1:
            block["upsample"] = init.conv(next(keys), 3, 3, cout, cout)
        up.append(block)
        prev = cout
    params["up_blocks"] = up
    params["conv_norm_out"] = init.norm(boc[0])
    params["conv_out"] = init.conv(next(keys), 3, 3, boc[0], cfg.out_channels)
    if gated:
        params["position_net"] = position_net_leaves(
            next(keys), cfg.gligen_positive_len, cfg.cross_attention_dim,
            cfg.gligen_fourier_freqs)
    return params


def init_unet2d(key, cfg: UNet2DConfig, device=None, dtype=torch.float32):
    """lvd_tpu's ``init_unet2d(key, cfg)`` drawn on ``device`` (the card
    unless asked)."""
    return init.draw(unet2d_leaves(key, cfg), device, dtype)


def apply_unet2d(params, cfg: UNet2DConfig, sample, timesteps, encoder_hidden_states, *,
                 gligen=None, added_cond=None, capture_keys: Sequence[tuple] = (),
                 remat: bool = False):
    """sample (B, H, W, C_in) channels-last; timesteps scalar or (B,);
    encoder_hidden_states (B, L, D); ``gligen`` None or {boxes (B, M, 4),
    masks (B, M), positive_embeddings (B, M, positive_len)} (a gated tree);
    ``added_cond`` the SDXL conditioning {text_embeds (B, D_pool), time_ids
    (B, K)}. Returns (noise_pred (B, H, W, C_out), aux {key: (B, heads, HW,
    L) fp32 probabilities of each captured site}). ``remat`` checkpoints
    every down and up layer (torch.utils.checkpoint)."""
    capture_keys = tuple(tuple(k) for k in capture_keys)
    b = sample.shape[0]
    boc = cfg.block_out_channels

    timesteps = torch.as_tensor(timesteps, device=sample.device)
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(b)
    t_emb = timestep_embedding(timesteps, boc[0]).to(sample.dtype)
    temb = time_embedding_mlp(params["time_embedding"], t_emb)
    if cfg.addition_embed_type == "text_time":
        # Each time id Fourier-embedded, joined to the pooled text embedding,
        # through a two-layer MLP into the time embedding.
        tid = torch.as_tensor(added_cond["time_ids"], device=sample.device).float().reshape(-1)
        tid_emb = timestep_embedding(tid, cfg.addition_time_embed_dim).reshape(b, -1)
        add = torch.cat([added_cond["text_embeds"].float(), tid_emb], dim=-1).to(sample.dtype)
        temb = temb + time_embedding_mlp(params["add_embedding"], add)
    context = encoder_hidden_states.to(sample.dtype)

    gligen_objs = None
    if gligen is not None:
        gligen_objs = apply_position_net(
            params["position_net"], gligen["boxes"].to(sample.dtype),
            gligen["masks"].to(sample.dtype), gligen["positive_embeddings"].to(sample.dtype),
            cfg.gligen_fourier_freqs)

    aux: dict = {}
    x = conv2d(params["conv_in"], sample)

    def run_layer(lp, x, key, with_attn, num_heads):
        layer_keys = [k for k in capture_keys if tuple(k[:3]) == key]

        def fn(x):
            local: dict = {}
            y = u3._resnet(lp["resnet"], x, temb, cfg)
            if with_attn:
                y = u3._spatial_transformer(lp["attn"], y, context, num_heads, cfg, key,
                                            capture_keys, local, gligen_objs)
            return (y, *(local[k] for k in layer_keys))

        if remat:
            y, *captured = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
        else:
            y, *captured = fn(x)
        aux.update(zip(layer_keys, captured))
        return y

    res_stack = [x]
    for i, block in enumerate(params["down_blocks"]):
        for j, lp in enumerate(block["layers"]):
            x = run_layer(lp, x, ("down", i, j), cfg.down_block_has_attn[i], cfg.num_heads[i])
            res_stack.append(x)
        if "downsample" in block:
            x = conv2d(block["downsample"], x, stride=2)
            res_stack.append(x)

    mid = params["mid_block"]
    x = u3._resnet(mid["resnet_in"], x, temb, cfg)
    for j, lp in enumerate(mid["layers"]):
        x = u3._spatial_transformer(lp["attn"], x, context, cfg.num_heads[-1], cfg,
                                    ("mid", 0, j), capture_keys, aux, gligen_objs)
        x = u3._resnet(lp["resnet"], x, temb, cfg)

    rev_heads = list(reversed(cfg.num_heads))
    rev_attn = list(reversed(cfg.down_block_has_attn))
    for i, block in enumerate(params["up_blocks"]):
        for j, lp in enumerate(block["layers"]):
            x = torch.cat([x, res_stack.pop()], dim=-1)
            x = run_layer(lp, x, ("up", i, j), rev_attn[i], rev_heads[i])
        if "upsample" in block:
            y = upsample_nearest_2x(x)
            if res_stack:
                th, tw = res_stack[-1].shape[1], res_stack[-1].shape[2]
                if (th, tw) != (y.shape[1], y.shape[2]):
                    # Odd sizes do not round-trip stride-2 conv + 2x upsample.
                    y = F.interpolate(x.permute(0, 3, 1, 2), size=(th, tw), mode="nearest-exact")
                    y = y.permute(0, 2, 3, 1)
            x = conv2d(block["upsample"], y)

    x = group_norm_silu(params["conv_norm_out"], x, cfg.norm_num_groups, cfg.norm_eps)
    return conv2d(params["conv_out"], x), aux
