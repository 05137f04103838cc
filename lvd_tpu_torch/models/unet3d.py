"""3D UNet apply function, ModelScope/Zeroscope architecture (counterpart of
lvd_tpu/models/unet3d.py:570-773, same topology and param tree).

Frames fold into the batch for every 2D op ((B, F, H, W, C) ->
(B*F, H, W, C)); temporal modules work on the frames-major (B, F, P, C)
stream. Routing follows lvd_tpu's shape predicates:
  * temporal attention pair -> kernel B where C <= 640, heads are 64 wide,
    the type is bf16 or fp32 and lvd_tpu's pixel group exists, on the
    frames-major stream where its frames-major group does, else after one
    relayout (temporal_attention.py:483-513, unet3d.py:431-439); the plain
    pair elsewhere;
  * feed-forward -> kernel C where its weights stay resident, C <= 640 in
    bf16 and C <= 320 in fp32 (geglu_fused.py:370-388);
  * temporal conv -> kernel D where lvd_tpu's predicate holds
    (temp_conv_fused.py:268-277), with the GroupNorm statistics a stock
    reduction;
  * attention -> kernel A at every non-capturing site on the card where
    lvd_tpu's ``pallas_ok`` holds, its chunked route elsewhere;
  * resnet GroupNorm -> SiLU -> 3x3 conv -> kernel I under
    ``LVD_ENABLE_FUSED_SC=1`` where spatial_conv_fused.supported holds;
  * q/k/v/out projections of the fused attention path -> kernel H under
    ``LVD_FUSED_LINEAR=1`` (ops/attention.py).
The kill switches ``LVD_DISABLE_FUSED_FF`` (ops/basic.feed_forward),
``LVD_DISABLE_FUSED_TC`` (``_temp_conv``) and ``LVD_DISABLE_FLASH``
(ops/attention.py) send their sites to stock ops, as in lvd_tpu.
Where lvd_tpu leaves a shape to XLA (C = 1280; C = 640 in fp32), the port
runs stock torch.
Each kernel wrapper is an autograd Function (backward kernels E, F and G, or
stock ops for D), so the guided energy differentiates through the walk.

Attention capture for guidance is a functional output, as in lvd_tpu:
``capture_keys`` names spatial cross-attention sites by hierarchical address
``(dir, block, layer, btb)``; their fp32 probabilities come back in ``aux``,
and ``capture_only`` ends the walk once every key is captured. GLIGEN, as in
lvd_tpu: ``gligen`` inputs go through the PositionNet once, after
``transformer_in``, and every spatial BasicTransformerBlock with a ``fuser``
runs the gated self-attention between its self- and cross-attention; the
temporal transformers take none.

Frame-sharded (sequence-parallel) walk, as lvd_tpu's ``spmd_axis``
(unet3d.py:394-551): with ``spmd_axis`` a parallel/comm.Group, each rank
holds a contiguous block of the frames and runs every per-frame op on it
alone. A temporal transformer psums its GroupNorm statistics over the
group, all_to_alls the stream from frame shards to pixel shards (pixels
zero-padded to a multiple of the group's size, the padding dropped after
the way back), runs the attention pair on its pixels (kernel B's route
decided on the shard) and all_to_alls back; a temporal conv psums its
GroupNorm statistics and runs SiLU and a stock (3,1,1) ``conv3d`` over its
frames extended by one halo frame from each neighbour (ppermute, zeros at
the video's ends), lvd_tpu's route: kernel D does not run sharded.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..config import UNet3DConfig
from ..ops import spatial_conv_fused, temp_conv_fused, temporal_attention
from ..ops.attention import attention
from ..ops.basic import (
    conv2d,
    conv3d,
    feed_forward,
    group_norm,
    group_norm_coeffs,
    group_norm_silu,
    layer_norm,
    linear,
    silu,
    time_embedding_mlp,
    timestep_embedding,
    upsample_nearest_2x,
)
from ..parallel import comm
from ..utils import prng
from . import init
from .gligen import apply_gated_self_attention, apply_position_net, position_net_leaves

# ---------------------------------------------------------------------------
# lvd_tpu's random weights in its key order (lvd_tpu/models/unet3d.py:70-304)
# ---------------------------------------------------------------------------


def _attention_leaves(key, query_dim, context_dim, inner_dim):
    k = prng.split(key, 4)
    return {
        "to_q": init.linear(k[0], query_dim, inner_dim, bias=False),
        "to_k": init.linear(k[1], context_dim, inner_dim, bias=False),
        "to_v": init.linear(k[2], context_dim, inner_dim, bias=False),
        "to_out": init.linear(k[3], inner_dim, query_dim),
    }


def _ff_leaves(key, dim, mult=4):
    k = prng.split(key, 2)
    return {"proj": init.linear(k[0], dim, dim * mult * 2),
            "out": init.linear(k[1], dim * mult, dim)}


def _btb_leaves(key, dim, context_dim, fuser_context=None):
    """A BasicTransformerBlock; ``context_dim=None`` makes attn2 a second
    self-attention (the temporal blocks)."""
    k = prng.split(key, 4)
    p = {
        "norm1": init.norm(dim),
        "attn1": _attention_leaves(k[0], dim, dim, dim),
        "norm2": init.norm(dim),
        "attn2": _attention_leaves(k[1], dim, context_dim or dim, dim),
        "norm3": init.norm(dim),
        "ff": _ff_leaves(k[2], dim),
    }
    if fuser_context is not None:
        fk = prng.split(k[3], 3)
        p["fuser"] = {
            "linear": init.linear(fk[0], fuser_context, dim),
            "attn": _attention_leaves(fk[1], dim, dim, dim),
            "ff": _ff_leaves(fk[2], dim),
            "norm1": init.norm(dim),
            "norm2": init.norm(dim),
            "alpha_attn": init.zeros(),
            "alpha_dense": init.zeros(),
        }
    return p


def _spatial_transformer_leaves(key, channels, context_dim, gated, depth=1):
    """``depth`` transformer blocks from keys 2 .. 1 + depth of
    ``split(key, 2 + depth)`` (lvd_tpu's ``_init_spatial_transformer``)."""
    k = prng.split(key, 2 + depth)
    return {
        "norm": init.norm(channels),
        "proj_in": init.linear(k[0], channels, channels),
        "blocks": [_btb_leaves(k[2 + i], channels, context_dim,
                               fuser_context=context_dim if gated else None)
                   for i in range(depth)],
        "proj_out": init.linear(k[1], channels, channels, scale=1e-5),
    }


def _temporal_transformer_leaves(key, channels, inner_dim):
    k = prng.split(key, 3)
    return {
        "norm": init.norm(channels),
        "proj_in": init.linear(k[0], channels, inner_dim),
        "blocks": [_btb_leaves(k[1], inner_dim, None)],
        "proj_out": init.linear(k[2], inner_dim, channels, scale=1e-5),
    }


def _resnet_leaves(key, cin, cout, temb_dim):
    k = prng.split(key, 4)
    p = {
        "norm1": init.norm(cin),
        "conv1": init.conv(k[0], 3, 3, cin, cout),
        "time_emb_proj": init.linear(k[1], temb_dim, cout),
        "norm2": init.norm(cout),
        "conv2": init.conv(k[2], 3, 3, cout, cout),
    }
    if cin != cout:
        p["conv_shortcut"] = init.conv(k[3], 1, 1, cin, cout)
    return p


def _temp_conv_leaves(key, channels):
    k = prng.split(key, 4)
    return {f"conv{i + 1}": {"norm": init.norm(channels),
                             "conv": init.conv3d(k[i], 3, channels, channels, zero=i == 3)}
            for i in range(4)}


def unet3d_leaves(key, cfg: UNet3DConfig):
    """lvd_tpu's UNet tree (``init_unet3d``) with its keys, undrawn: every
    module takes the next key of the stream ``fold_in(key, 1), fold_in(key,
    2), ...`` in lvd_tpu's order of construction."""
    boc = cfg.block_out_channels
    temb = cfg.time_embed_dim
    gated = cfg.attention_type == "gated"
    counter = [0]

    def next_key():
        counter[0] += 1
        return prng.fold_in(key, counter[0])

    params = {
        "conv_in": init.conv(next_key(), 3, 3, cfg.in_channels, boc[0]),
        "time_embedding": {"linear_1": init.linear(next_key(), boc[0], temb),
                           "linear_2": init.linear(next_key(), temb, temb)},
        "transformer_in": _temporal_transformer_leaves(
            next_key(), boc[0], cfg.transformer_in_num_heads * cfg.attention_head_dim),
    }

    def layer(cin, cout, with_attn):
        p = {"resnet": _resnet_leaves(next_key(), cin, cout, temb),
             "temp_conv": _temp_conv_leaves(next_key(), cout)}
        if with_attn:
            p["attn"] = _spatial_transformer_leaves(next_key(), cout, cfg.cross_attention_dim,
                                                    gated)
            p["temp_attn"] = _temporal_transformer_leaves(next_key(), cout, cout)
        return p

    down, ch = [], boc[0]
    for i, cout in enumerate(boc):
        is_final = i == len(boc) - 1
        block = {"layers": [layer(ch if j == 0 else cout, cout, not is_final)
                            for j in range(cfg.layers_per_block)]}
        if not is_final:
            block["downsample"] = init.conv(next_key(), 3, 3, cout, cout)
        down.append(block)
        ch = cout
    params["down_blocks"] = down
    params["mid_block"] = {
        "resnet_in": _resnet_leaves(next_key(), boc[-1], boc[-1], temb),
        "temp_conv_in": _temp_conv_leaves(next_key(), boc[-1]),
        "layers": [layer(boc[-1], boc[-1], True)],
    }
    up, rev = [], list(reversed(boc))
    prev = rev[0]
    for i, cout in enumerate(rev):
        skip_source = rev[min(i + 1, len(boc) - 1)]
        layers = []
        for j in range(cfg.layers_per_block + 1):
            skip_ch = skip_source if j == cfg.layers_per_block else cout
            layers.append(layer((prev if j == 0 else cout) + skip_ch, cout, i > 0))
        block = {"layers": layers}
        if i < len(boc) - 1:
            block["upsample"] = init.conv(next_key(), 3, 3, cout, cout)
        up.append(block)
        prev = cout
    params["up_blocks"] = up
    params["conv_norm_out"] = init.norm(boc[0])
    params["conv_out"] = init.conv(next_key(), 3, 3, boc[0], cfg.out_channels)
    if gated:
        params["position_net"] = position_net_leaves(
            next_key(), cfg.gligen_positive_len, cfg.cross_attention_dim,
            cfg.gligen_fourier_freqs)
    return params


def init_unet3d(key, cfg: UNet3DConfig, device=None, dtype=torch.float32):
    """lvd_tpu's ``init_unet3d(key, cfg)`` drawn on ``device`` (the card
    unless asked)."""
    return init.draw(unet3d_leaves(key, cfg), device, dtype)


def _btb_apply(p, x, context, num_heads, capture=False, gligen_objs=None):
    """Spatial BasicTransformerBlock: self-attention, the GLIGEN fuser (with
    grounding tokens, where the block has one), cross-attention, FF.
    Returns (x, cross-attention probabilities if ``capture``)."""
    x = x + attention(p["attn1"], layer_norm(p["norm1"], x), None, num_heads)[0]
    if gligen_objs is not None and "fuser" in p:
        x = apply_gated_self_attention(p["fuser"], x, gligen_objs, num_heads)
    h, probs = attention(p["attn2"], layer_norm(p["norm2"], x), context, num_heads,
                         return_probs=capture)
    x = x + h
    return x + feed_forward(p["ff"], layer_norm(p["norm3"], x)), probs


def _spatial_transformer(p, x, context, num_heads, cfg, key=None, capture_keys=(), aux=None,
                         gligen_objs=None):
    n, h, w, c = x.shape
    residual = x
    y = group_norm(p["norm"], x, cfg.norm_num_groups, cfg.transformer_norm_eps)
    y = linear(p["proj_in"], y.reshape(n, h * w, c))
    for bi, block in enumerate(p["blocks"]):
        full_key = None if key is None else key + (bi,)
        capture = full_key in capture_keys
        y, probs = _btb_apply(block, y, context, num_heads, capture, gligen_objs)
        if capture:
            aux[full_key] = probs
    y = linear(p["proj_out"], y)
    return y.reshape(n, h, w, c) + residual


def _a2a_frames_to_pixels(y, group):
    """(B, F_local, P, C) -> (B, F, P_padded / n, C); returns it and P."""
    p = y.shape[2]
    pad = (-p) % comm.axis_size(group)
    if pad:
        y = F.pad(y, (0, 0, 0, pad))
    return comm.all_to_all(y, group, split_axis=2, concat_axis=1), p


def _a2a_pixels_to_frames(y, group, orig_p):
    """The inverse of _a2a_frames_to_pixels; drops the pixel padding."""
    return comm.all_to_all(y, group, split_axis=1, concat_axis=2)[:, :, :orig_p]


def _temporal_transformer(p, x, num_frames, num_heads, cfg, spmd_axis=None):
    n, h, w, c = x.shape
    b = n // num_frames
    residual = x
    y = x.reshape(b, num_frames, h * w, c)
    y = group_norm(p["norm"], y, cfg.norm_num_groups, cfg.transformer_norm_eps,
                   axis_name=spmd_axis)
    y = linear(p["proj_in"], y)
    if spmd_axis is not None:
        y, orig_p = _a2a_frames_to_pixels(y, spmd_axis)
    # As lvd_tpu (unet3d.py:431-439): the frames-major stream where kernel B
    # takes it, else one relayout and the pixels-major pair.
    fm = temporal_attention.supported_frames_major(y, num_heads)
    if not fm:
        y = y.transpose(1, 2)
    for block in p["blocks"]:
        y = temporal_attention.temporal_attention_pair(block, y, num_heads, frames_major=fm)
        y = y + feed_forward(block["ff"], layer_norm(block["norm3"], y))
    if not fm:
        y = y.transpose(1, 2)
    if spmd_axis is not None:
        y = _a2a_pixels_to_frames(y, spmd_axis, orig_p)
    y = linear(p["proj_out"], y)
    return y.reshape(n, h, w, c) + residual


def _gn_silu_conv(norm_p, conv_p, x, cfg):
    """GroupNorm -> SiLU -> 3x3 conv; under ``LVD_ENABLE_FUSED_SC=1`` (read
    per call, as lvd_tpu reads it) the shapes lvd_tpu's predicate routes take
    kernel I with its prologue, the GroupNorm statistics kernel K; elsewhere
    kernels K and L (``affine_silu``) before cuDNN's conv."""
    if (os.environ.get("LVD_ENABLE_FUSED_SC") == "1"
            and tuple(conv_p["w"].shape[:2]) == (3, 3)
            and spatial_conv_fused.supported(x, conv_p["w"])):
        a, b = group_norm_coeffs(norm_p, x, cfg.norm_num_groups, cfg.norm_eps)
        bias = conv_p.get("b")
        if bias is None:
            bias = torch.zeros(conv_p["w"].shape[-1], dtype=x.dtype, device=x.device)
        return spatial_conv_fused.norm_silu_conv2d(x, a, b, conv_p["w"], bias)
    return conv2d(conv_p, group_norm_silu(norm_p, x, cfg.norm_num_groups, cfg.norm_eps))


def _resnet(p, x, temb, cfg):
    h = _gn_silu_conv(p["norm1"], p["conv1"], x, cfg)
    h = h + linear(p["time_emb_proj"], silu(temb))[:, None, None, :]
    h = _gn_silu_conv(p["norm2"], p["conv2"], h, cfg)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


def _halo_conv3d_frames(conv_p, y, group):
    """The (3,1,1) conv over frame-sharded (B, F_local, P, C) input: each
    rank's boundary frames go to its neighbours by ppermute, and the ranks
    at the video's ends receive ppermute's zeros, the conv's padding."""
    n = comm.axis_size(group)
    prev = comm.ppermute(y[:, -1:], group, [(i, i + 1) for i in range(n - 1)])
    nxt = comm.ppermute(y[:, :1], group, [(i + 1, i) for i in range(n - 1)])
    ext = torch.cat([prev, y, nxt], dim=1)
    return conv3d(conv_p, ext[:, :, :, None, :], padding=((0, 0), (0, 0), (0, 0)))[:, :, :, 0]


def _temp_conv(p, x, num_frames, cfg, spmd_axis=None):
    n, h, w, c = x.shape
    b = n // num_frames
    y4 = x.reshape(b, num_frames, h * w, c)
    identity = y4
    if spmd_axis is not None:
        for name in ("conv1", "conv2", "conv3", "conv4"):
            blk = p[name]
            y4 = group_norm_silu(blk["norm"], y4, cfg.norm_num_groups, 1e-5,
                                 axis_name=spmd_axis)
            y4 = _halo_conv3d_frames(blk["conv"], y4, spmd_axis)
        return (identity + y4).reshape(n, h, w, c)
    if os.environ.get("LVD_DISABLE_FUSED_TC") != "1" and temp_conv_fused.supported(y4):
        for name in ("conv1", "conv2", "conv3", "conv4"):
            blk = p[name]
            a, bc = group_norm_coeffs(blk["norm"], y4, cfg.norm_num_groups, 1e-5)
            y4 = temp_conv_fused.norm_silu_temporal_conv(
                y4, a, bc, blk["conv"]["w"], blk["conv"]["b"])
        return (identity + y4).reshape(n, h, w, c)
    y = x.reshape(b, num_frames, h, w, c)
    for name in ("conv1", "conv2", "conv3", "conv4"):
        blk = p[name]
        y = conv3d(blk["conv"], group_norm_silu(blk["norm"], y, cfg.norm_num_groups, 1e-5))
    return (x.reshape(b, num_frames, h, w, c) + y).reshape(n, h, w, c)


def _cross_attn_layer(p, x, temb, context, num_frames, num_heads, cfg, key=None,
                      capture_keys=(), aux=None, gligen_objs=None, spmd_axis=None):
    x = _resnet(p["resnet"], x, temb, cfg)
    x = _temp_conv(p["temp_conv"], x, num_frames, cfg, spmd_axis)
    x = _spatial_transformer(p["attn"], x, context, num_heads, cfg, key, capture_keys, aux,
                             gligen_objs)
    return _temporal_transformer(p["temp_attn"], x, num_frames, num_heads, cfg, spmd_axis)


def apply_unet3d(params, cfg: UNet3DConfig, sample, timesteps, encoder_hidden_states, *,
                 gligen=None, capture_keys: Sequence[tuple] = (), capture_only: bool = False,
                 remat: bool = False, spmd_axis=None):
    """sample (B, F, H, W, C_in) channels-last; timesteps scalar or (B,);
    encoder_hidden_states (B, L, D); ``gligen`` None or {boxes (B*F, M, 4),
    masks (B*F, M), positive_embeddings (B*F, M, positive_len)}, the
    per-frame grounding inputs flattened into the B*F batch (a gated tree
    only). Returns noise_pred (B, F, H, W, C_out);
    with ``capture_keys``, (noise_pred, aux {key: (B*F, heads, HW, L) fp32
    probabilities of each captured site}), noise_pred None when
    ``capture_only`` ends the walk at the last captured site. ``remat``
    checkpoints each UNet layer below the deepest width
    (torch.utils.checkpoint), for the energy's backward. ``spmd_axis``: a
    parallel/comm.Group over which the frames are sharded; ``sample`` holds
    this rank's F_local frames, the GLIGEN inputs are its (B*F_local, ...)
    rows, the captured maps its frames'."""
    capture_keys = tuple(tuple(k) for k in capture_keys)
    if capture_only and not capture_keys:
        raise ValueError("capture_only requires capture_keys")
    b, f, h, w, _ = sample.shape
    boc = cfg.block_out_channels

    timesteps = torch.as_tensor(timesteps, device=sample.device)
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(b)
    t_emb = timestep_embedding(timesteps, boc[0]).to(sample.dtype)
    temb = time_embedding_mlp(params["time_embedding"], t_emb).repeat_interleave(f, dim=0)
    context = encoder_hidden_states.to(sample.dtype).repeat_interleave(f, dim=0)

    x = conv2d(params["conv_in"], sample.reshape(b * f, h, w, sample.shape[-1]))
    x = _temporal_transformer(params["transformer_in"], x, f, cfg.transformer_in_num_heads, cfg,
                              spmd_axis)

    gligen_objs = None
    if gligen is not None:
        gligen_objs = apply_position_net(
            params["position_net"], gligen["boxes"].to(x.dtype), gligen["masks"].to(x.dtype),
            gligen["positive_embeddings"].to(x.dtype), cfg.gligen_fourier_freqs)

    aux: dict = {}

    def run_layer(lp, x, key, with_attn, num_heads):
        layer_keys = [k for k in capture_keys if tuple(k[:3]) == key]

        def fn(x):
            local: dict = {}
            if with_attn:
                y = _cross_attn_layer(lp, x, temb, context, f, num_heads, cfg, key,
                                      capture_keys, local, gligen_objs, spmd_axis)
            else:
                y = _temp_conv(lp["temp_conv"], _resnet(lp["resnet"], x, temb, cfg), f, cfg,
                               spmd_axis)
            return (y, *(local[k] for k in layer_keys))

        if remat and num_heads * cfg.attention_head_dim < boc[-1]:
            y, *captured = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
        else:
            y, *captured = fn(x)
        aux.update(zip(layer_keys, captured))
        return y

    def have_all_keys():
        return capture_only and len(aux) == len(capture_keys)

    res_stack = [x]
    for i, block in enumerate(params["down_blocks"]):
        is_final = i == len(boc) - 1
        for j, lp in enumerate(block["layers"]):
            x = run_layer(lp, x, ("down", i, j), not is_final, cfg.num_heads(boc[i]))
            if have_all_keys():
                return None, aux
            res_stack.append(x)
        if "downsample" in block:
            x = conv2d(block["downsample"], x, stride=2)
            res_stack.append(x)

    mid = params["mid_block"]
    num_heads = cfg.num_heads(boc[-1])
    x = _resnet(mid["resnet_in"], x, temb, cfg)
    x = _temp_conv(mid["temp_conv_in"], x, f, cfg, spmd_axis)
    for j, lp in enumerate(mid["layers"]):
        x = _spatial_transformer(lp["attn"], x, context, num_heads, cfg, ("mid", 0, j),
                                 capture_keys, aux, gligen_objs)
        if have_all_keys():
            return None, aux
        x = _temporal_transformer(lp["temp_attn"], x, f, num_heads, cfg, spmd_axis)
        x = _resnet(lp["resnet"], x, temb, cfg)
        x = _temp_conv(lp["temp_conv"], x, f, cfg, spmd_axis)

    rev = list(reversed(boc))
    for i, block in enumerate(params["up_blocks"]):
        for j, lp in enumerate(block["layers"]):
            x = torch.cat([x, res_stack.pop()], dim=-1)
            x = run_layer(lp, x, ("up", i, j), i > 0, cfg.num_heads(rev[i]))
            if have_all_keys():
                return None, aux
        if "upsample" in block:
            y = upsample_nearest_2x(x)
            if res_stack:
                th, tw = res_stack[-1].shape[1], res_stack[-1].shape[2]
                if (th, tw) != (y.shape[1], y.shape[2]):
                    # Odd sizes do not round-trip stride-2 conv + 2x upsample.
                    y = F.interpolate(x.permute(0, 3, 1, 2), size=(th, tw), mode="nearest-exact")
                    y = y.permute(0, 2, 3, 1)
            x = conv2d(block["upsample"], y)

    x = _gn_silu_conv(params["conv_norm_out"], params["conv_out"], x, cfg)
    out = x.reshape(b, f, h, w, cfg.out_channels)
    return (out, aux) if capture_keys else out
