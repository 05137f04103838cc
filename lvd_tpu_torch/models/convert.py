"""Offline weight converter: HF diffusers/transformers checkpoints -> the
param trees of this package and lvd_tpu (the port's copy of
lvd_tpu/models/convert.py; the npz files it writes are the ones lvd_tpu's
converter writes, so either package reads the other's output).

One-time, host-side, numpy only. Reads the torch state dicts of
- UNet3DConditionModel   (unet/diffusion_pytorch_model.safetensors)
- CLIPTextModel          (text_encoder/model.safetensors)
- AutoencoderKL          (vae/diffusion_pytorch_model.safetensors)
and emits flat .npz trees loadable by models/loader.py, transposing to the
channels-last conventions (linear (in,out); conv HWIO / DHWIO).

Usage:
  python -m lvd_tpu_torch.models.convert --src <hf_checkpoint_dir> \
      --dst $LVD_CHECKPOINT_ROOT/<name> [--gated | --sdxl-refiner]

The converter validates the result against the shape walk of the matching
config (``*_leaves``: the same tree structure and shapes as the random
init, undrawn) — wrong-key bugs fail loudly instead of producing silent
quality bugs.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from ..config import CLIPTextConfig, UNet3DConfig, VAEConfig
from ..utils import prng
from . import init


# -- primitive converters -----------------------------------------------------


def _t(x):
    x = np.asarray(x)
    # np.ascontiguousarray promotes 0-d scalars (GLIGEN alpha gates) to 1-d.
    return np.ascontiguousarray(x) if x.ndim else x


def lin(sd: Dict, prefix: str) -> dict:
    out = {"w": _t(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["b"] = _t(sd[f"{prefix}.bias"])
    return out


def conv2d_p(sd: Dict, prefix: str) -> dict:
    # torch (O, I, kh, kw) -> HWIO
    return {
        "w": _t(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0),
        "b": _t(sd[f"{prefix}.bias"]),
    }


def conv3d_p(sd: Dict, prefix: str) -> dict:
    # torch (O, I, kt, kh, kw) -> DHWIO
    return {
        "w": _t(sd[f"{prefix}.weight"]).transpose(2, 3, 4, 1, 0),
        "b": _t(sd[f"{prefix}.bias"]),
    }


def norm_p(sd: Dict, prefix: str) -> dict:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def attn_p(sd: Dict, prefix: str) -> dict:
    return {
        "to_q": lin(sd, f"{prefix}.to_q"),
        "to_k": lin(sd, f"{prefix}.to_k"),
        "to_v": lin(sd, f"{prefix}.to_v"),
        "to_out": lin(sd, f"{prefix}.to_out.0"),
    }


def ff_p(sd: Dict, prefix: str) -> dict:
    # diffusers FeedForward: net.0 = GEGLU(proj), net.2 = Linear out
    return {
        "proj": lin(sd, f"{prefix}.net.0.proj"),
        "out": lin(sd, f"{prefix}.net.2"),
    }


def btb_p(sd: Dict, prefix: str, gated: bool = False) -> dict:
    p = {
        "norm1": norm_p(sd, f"{prefix}.norm1"),
        "attn1": attn_p(sd, f"{prefix}.attn1"),
        "norm2": norm_p(sd, f"{prefix}.norm2"),
        "attn2": attn_p(sd, f"{prefix}.attn2"),
        "norm3": norm_p(sd, f"{prefix}.norm3"),
        "ff": ff_p(sd, f"{prefix}.ff"),
    }
    if gated and f"{prefix}.fuser.alpha_attn" in sd:
        p["fuser"] = {
            "linear": lin(sd, f"{prefix}.fuser.linear"),
            "attn": attn_p(sd, f"{prefix}.fuser.attn"),
            "ff": ff_p(sd, f"{prefix}.fuser.ff"),
            "norm1": norm_p(sd, f"{prefix}.fuser.norm1"),
            "norm2": norm_p(sd, f"{prefix}.fuser.norm2"),
            "alpha_attn": _t(sd[f"{prefix}.fuser.alpha_attn"]),
            "alpha_dense": _t(sd[f"{prefix}.fuser.alpha_dense"]),
        }
    return p


def spatial_transformer_p(sd: Dict, prefix: str, gated: bool) -> dict:
    return {
        "norm": norm_p(sd, f"{prefix}.norm"),
        "proj_in": lin(sd, f"{prefix}.proj_in"),
        "blocks": [btb_p(sd, f"{prefix}.transformer_blocks.0", gated)],
        "proj_out": lin(sd, f"{prefix}.proj_out"),
    }


def temporal_transformer_p(sd: Dict, prefix: str) -> dict:
    return {
        "norm": norm_p(sd, f"{prefix}.norm"),
        "proj_in": lin(sd, f"{prefix}.proj_in"),
        "blocks": [btb_p(sd, f"{prefix}.transformer_blocks.0")],
        "proj_out": lin(sd, f"{prefix}.proj_out"),
    }


def resnet_p(sd: Dict, prefix: str, temb: bool = True) -> dict:
    p = {
        "norm1": norm_p(sd, f"{prefix}.norm1"),
        "conv1": conv2d_p(sd, f"{prefix}.conv1"),
        "norm2": norm_p(sd, f"{prefix}.norm2"),
        "conv2": conv2d_p(sd, f"{prefix}.conv2"),
    }
    if temb and f"{prefix}.time_emb_proj.weight" in sd:
        p["time_emb_proj"] = lin(sd, f"{prefix}.time_emb_proj")
    if f"{prefix}.conv_shortcut.weight" in sd:
        p["conv_shortcut"] = conv2d_p(sd, f"{prefix}.conv_shortcut")
    return p


def temp_conv_p(sd: Dict, prefix: str) -> dict:
    # diffusers TemporalConvLayer: conv1 = [GN, SiLU, Conv3d] (conv at .2);
    # conv2..conv4 = [GN, SiLU, Dropout, Conv3d] (conv at .3).
    out = {}
    for i in range(1, 5):
        conv_idx = 2 if i == 1 else 3
        out[f"conv{i}"] = {
            "norm": norm_p(sd, f"{prefix}.conv{i}.0"),
            "conv": conv3d_p(sd, f"{prefix}.conv{i}.{conv_idx}"),
        }
    return out


# -- model converters ----------------------------------------------------------


def convert_unet3d(sd: Dict, cfg: UNet3DConfig) -> dict:
    gated = cfg.attention_type == "gated"
    n_blocks = cfg.num_blocks

    def layer(res_prefix, tc_prefix, attn_prefix, tattn_prefix, with_attn):
        p = {
            "resnet": resnet_p(sd, res_prefix),
            "temp_conv": temp_conv_p(sd, tc_prefix),
        }
        if with_attn:
            p["attn"] = spatial_transformer_p(sd, attn_prefix, gated)
            p["temp_attn"] = temporal_transformer_p(sd, tattn_prefix)
        return p

    params = {
        "conv_in": conv2d_p(sd, "conv_in"),
        "time_embedding": {
            "linear_1": lin(sd, "time_embedding.linear_1"),
            "linear_2": lin(sd, "time_embedding.linear_2"),
        },
        "transformer_in": temporal_transformer_p(sd, "transformer_in"),
        "conv_norm_out": norm_p(sd, "conv_norm_out"),
        "conv_out": conv2d_p(sd, "conv_out"),
    }

    down = []
    for i in range(n_blocks):
        is_final = i == n_blocks - 1
        block = {
            "layers": [
                layer(
                    f"down_blocks.{i}.resnets.{j}",
                    f"down_blocks.{i}.temp_convs.{j}",
                    f"down_blocks.{i}.attentions.{j}",
                    f"down_blocks.{i}.temp_attentions.{j}",
                    with_attn=not is_final,
                )
                for j in range(cfg.layers_per_block)
            ]
        }
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            block["downsample"] = conv2d_p(sd, f"down_blocks.{i}.downsamplers.0.conv")
        down.append(block)
    params["down_blocks"] = down

    params["mid_block"] = {
        "resnet_in": resnet_p(sd, "mid_block.resnets.0"),
        "temp_conv_in": temp_conv_p(sd, "mid_block.temp_convs.0"),
        "layers": [
            {
                "attn": spatial_transformer_p(sd, "mid_block.attentions.0", gated),
                "temp_attn": temporal_transformer_p(sd, "mid_block.temp_attentions.0"),
                "resnet": resnet_p(sd, "mid_block.resnets.1"),
                "temp_conv": temp_conv_p(sd, "mid_block.temp_convs.1"),
            }
        ],
    }

    up = []
    for i in range(n_blocks):
        with_attn = i > 0
        block = {
            "layers": [
                layer(
                    f"up_blocks.{i}.resnets.{j}",
                    f"up_blocks.{i}.temp_convs.{j}",
                    f"up_blocks.{i}.attentions.{j}",
                    f"up_blocks.{i}.temp_attentions.{j}",
                    with_attn=with_attn,
                )
                for j in range(cfg.layers_per_block + 1)
            ]
        }
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            block["upsample"] = conv2d_p(sd, f"up_blocks.{i}.upsamplers.0.conv")
        up.append(block)
    params["up_blocks"] = up

    if gated and "position_net.linears.0.weight" in sd:
        params["position_net"] = {
            "linears_0": lin(sd, "position_net.linears.0"),
            "linears_1": lin(sd, "position_net.linears.2"),
            "linears_2": lin(sd, "position_net.linears.4"),
            "null_positive_feature": _t(sd["position_net.null_positive_feature"]),
            "null_position_feature": _t(sd["position_net.null_position_feature"]),
        }
    return params


def convert_unet2d(sd: Dict, cfg) -> dict:
    """HF UNet2DConditionModel (SD1.x / SDXL-refiner) -> unet2d pytree.

    ``cfg``: models.unet2d.UNet2DConfig (drives attention placement and
    per-layer transformer depth).
    """
    gated = cfg.attention_type == "gated"

    def spatial(prefix: str, depth: int) -> dict:
        return {
            "norm": norm_p(sd, f"{prefix}.norm"),
            "proj_in": lin(sd, f"{prefix}.proj_in"),
            "blocks": [
                btb_p(sd, f"{prefix}.transformer_blocks.{k}", gated)
                for k in range(depth)
            ],
            "proj_out": lin(sd, f"{prefix}.proj_out"),
        }

    def layer(res_prefix, attn_prefix, with_attn, depth):
        p = {"resnet": resnet_p(sd, res_prefix)}
        if with_attn:
            p["attn"] = spatial(attn_prefix, depth)
        return p

    params = {
        "conv_in": conv2d_p(sd, "conv_in"),
        "time_embedding": {
            "linear_1": lin(sd, "time_embedding.linear_1"),
            "linear_2": lin(sd, "time_embedding.linear_2"),
        },
        "conv_norm_out": norm_p(sd, "conv_norm_out"),
        "conv_out": conv2d_p(sd, "conv_out"),
    }
    if "add_embedding.linear_1.weight" in sd:
        params["add_embedding"] = {
            "linear_1": lin(sd, "add_embedding.linear_1"),
            "linear_2": lin(sd, "add_embedding.linear_2"),
        }

    n = cfg.num_blocks
    down = []
    for i in range(n):
        block = {
            "layers": [
                layer(
                    f"down_blocks.{i}.resnets.{j}",
                    f"down_blocks.{i}.attentions.{j}",
                    cfg.down_block_has_attn[i],
                    cfg.transformer_depth[i],
                )
                for j in range(cfg.layers_per_block)
            ]
        }
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            block["downsample"] = conv2d_p(sd, f"down_blocks.{i}.downsamplers.0.conv")
        down.append(block)
    params["down_blocks"] = down

    params["mid_block"] = {
        "resnet_in": resnet_p(sd, "mid_block.resnets.0"),
        "layers": [
            {
                "attn": spatial("mid_block.attentions.0", cfg.mid_transformer_depth),
                "resnet": resnet_p(sd, "mid_block.resnets.1"),
            }
        ],
    }

    rev_attn = list(reversed(cfg.down_block_has_attn))
    rev_depth = list(reversed(cfg.transformer_depth))
    up = []
    for i in range(n):
        block = {
            "layers": [
                layer(
                    f"up_blocks.{i}.resnets.{j}",
                    f"up_blocks.{i}.attentions.{j}",
                    rev_attn[i],
                    rev_depth[i],
                )
                for j in range(cfg.layers_per_block + 1)
            ]
        }
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            block["upsample"] = conv2d_p(sd, f"up_blocks.{i}.upsamplers.0.conv")
        up.append(block)
    params["up_blocks"] = up

    if gated and "position_net.linears.0.weight" in sd:
        params["position_net"] = {
            "linears_0": lin(sd, "position_net.linears.0"),
            "linears_1": lin(sd, "position_net.linears.2"),
            "linears_2": lin(sd, "position_net.linears.4"),
            "null_positive_feature": _t(sd["position_net.null_positive_feature"]),
            "null_position_feature": _t(sd["position_net.null_position_feature"]),
        }
    return params


def convert_clip_text(sd: Dict, cfg: CLIPTextConfig) -> dict:
    pre = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    params = {
        "token_embedding": _t(sd[f"{pre}embeddings.token_embedding.weight"]),
        "position_embedding": _t(sd[f"{pre}embeddings.position_embedding.weight"]),
        "final_layer_norm": norm_p(sd, f"{pre}final_layer_norm"),
        "layers": [],
    }
    i = 0
    while f"{pre}encoder.layers.{i}.self_attn.q_proj.weight" in sd:
        lp = f"{pre}encoder.layers.{i}"
        params["layers"].append(
            {
                "layer_norm1": norm_p(sd, f"{lp}.layer_norm1"),
                "q_proj": lin(sd, f"{lp}.self_attn.q_proj"),
                "k_proj": lin(sd, f"{lp}.self_attn.k_proj"),
                "v_proj": lin(sd, f"{lp}.self_attn.v_proj"),
                "out_proj": lin(sd, f"{lp}.self_attn.out_proj"),
                "layer_norm2": norm_p(sd, f"{lp}.layer_norm2"),
                "fc1": lin(sd, f"{lp}.mlp.fc1"),
                "fc2": lin(sd, f"{lp}.mlp.fc2"),
            }
        )
        i += 1
    if f"{pre}text_projection.weight" in sd or "text_projection.weight" in sd:
        key = (
            f"{pre}text_projection"
            if f"{pre}text_projection.weight" in sd
            else "text_projection"
        )
        params["text_projection"] = {"w": _t(sd[f"{key}.weight"]).T}
    return params


def _vae_attn_p(sd: Dict, prefix: str) -> dict:
    # diffusers >=0.18 uses Attention with group_norm/to_q..to_out.0
    if f"{prefix}.group_norm.weight" in sd:
        return {
            "norm": norm_p(sd, f"{prefix}.group_norm"),
            "to_q": lin(sd, f"{prefix}.to_q"),
            "to_k": lin(sd, f"{prefix}.to_k"),
            "to_v": lin(sd, f"{prefix}.to_v"),
            "to_out": lin(sd, f"{prefix}.to_out.0"),
        }
    # legacy AttnBlock naming (query/key/value/proj_attn)
    return {
        "norm": norm_p(sd, f"{prefix}.norm"),
        "to_q": lin(sd, f"{prefix}.query"),
        "to_k": lin(sd, f"{prefix}.key"),
        "to_v": lin(sd, f"{prefix}.value"),
        "to_out": lin(sd, f"{prefix}.proj_attn"),
    }


def convert_vae(sd: Dict, cfg: VAEConfig) -> dict:
    n_blocks = len(cfg.block_out_channels)

    enc = {"conv_in": conv2d_p(sd, "encoder.conv_in")}
    blocks = []
    for i in range(n_blocks):
        block = {
            "resnets": [
                resnet_p(sd, f"encoder.down_blocks.{i}.resnets.{j}", temb=False)
                for j in range(cfg.layers_per_block)
            ]
        }
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            block["downsample"] = conv2d_p(
                sd, f"encoder.down_blocks.{i}.downsamplers.0.conv"
            )
        blocks.append(block)
    enc["down_blocks"] = blocks
    enc["mid"] = {
        "resnet_1": resnet_p(sd, "encoder.mid_block.resnets.0", temb=False),
        "attn": _vae_attn_p(sd, "encoder.mid_block.attentions.0"),
        "resnet_2": resnet_p(sd, "encoder.mid_block.resnets.1", temb=False),
    }
    enc["conv_norm_out"] = norm_p(sd, "encoder.conv_norm_out")
    enc["conv_out"] = conv2d_p(sd, "encoder.conv_out")

    dec = {"conv_in": conv2d_p(sd, "decoder.conv_in")}
    dec["mid"] = {
        "resnet_1": resnet_p(sd, "decoder.mid_block.resnets.0", temb=False),
        "attn": _vae_attn_p(sd, "decoder.mid_block.attentions.0"),
        "resnet_2": resnet_p(sd, "decoder.mid_block.resnets.1", temb=False),
    }
    blocks = []
    for i in range(n_blocks):
        block = {
            "resnets": [
                resnet_p(sd, f"decoder.up_blocks.{i}.resnets.{j}", temb=False)
                for j in range(cfg.layers_per_block + 1)
            ]
        }
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            block["upsample"] = conv2d_p(
                sd, f"decoder.up_blocks.{i}.upsamplers.0.conv"
            )
        blocks.append(block)
    dec["up_blocks"] = blocks
    dec["conv_norm_out"] = norm_p(sd, "decoder.conv_norm_out")
    dec["conv_out"] = conv2d_p(sd, "decoder.conv_out")

    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": conv2d_p(sd, "quant_conv"),
        "post_quant_conv": conv2d_p(sd, "post_quant_conv"),
    }


# -- validation & IO ------------------------------------------------------------


def flatten_tree(tree, prefix=""):
    """dict/list tree -> {path: leaf} with '/'-joined paths (lvd_tpu's
    ``flatten_pytree``); numpy and tensor leaves become numpy arrays, the
    undrawn leaves of the shape walks (models/init.py) stay as they are."""
    if isinstance(tree, (init.Normal, init.Const)):
        return {prefix.rstrip("/"): tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        if hasattr(tree, "detach"):
            tree = tree.detach().cpu().numpy()
        return {prefix.rstrip("/"): np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}/"))
    return out


def save_params(path: str, params):
    """The tree as one npz of '/'-joined keys (lvd_tpu's ``save_params``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flatten_tree(params))


# Buffers some checkpoints serialize that carry no weights.
_IGNORABLE_KEY_SUFFIXES = ("position_ids",)


class RecordingStateDict(dict):
    """State dict recording which keys a converter consumed, so silent drops
    of source tensors (the dangerous wrong-key failure mode) are detectable."""

    def __init__(self, data):
        super().__init__(data)
        self.used: set = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)


def verify_conversion(sd: "RecordingStateDict", converted, name: str,
                      verbose: bool = False) -> None:
    """Audit a finished conversion: every source tensor must have been
    consumed (modulo known no-weight buffers), and the total L2 mass must be
    conserved by the layout transposes. With ``verbose``, prints a
    per-tensor norm table for eyeball comparison against the torch side —
    the `--verify` runbook mode (see RUNBOOK.md)."""
    unconsumed = sorted(
        k for k in set(sd) - sd.used
        if not k.endswith(_IGNORABLE_KEY_SUFFIXES)
    )
    flat = flatten_tree(converted)
    if verbose:
        print(f"[verify:{name}] per-tensor norms (converted pytree):")
        for k in sorted(flat):
            arr = np.asarray(flat[k], np.float64)
            print(f"  {k:<90s} {str(arr.shape):<22s} "
                  f"norm={np.linalg.norm(arr):.6e}")
    src_sq = sum(
        float((np.asarray(dict.__getitem__(sd, k), np.float64) ** 2).sum())
        for k in sd.used
    )
    dst_sq = sum(float((np.asarray(v, np.float64) ** 2).sum()) for v in flat.values())
    print(
        f"[verify:{name}] {len(sd)} source tensors, {len(sd.used)} consumed, "
        f"{len(flat)} emitted; sum|w|^2 src={src_sq:.6e} dst={dst_sq:.6e}"
    )
    if unconsumed:
        msg = (
            f"{name}: {len(unconsumed)} source tensors were NOT consumed by "
            f"the converter (first 10): {unconsumed[:10]}"
        )
        raise ValueError(msg)
    if not np.isclose(src_sq, dst_sq, rtol=1e-6):
        raise ValueError(
            f"{name}: weight mass not conserved: src {src_sq!r} != dst {dst_sq!r}"
        )


def check_sdxl_unet_config(hf: dict, cfg) -> None:
    """Field-by-field comparison of a real HF unet/config.json against the
    layout constants our sdxl_refiner_config assumes
    (reference scripts/upsample.py:160-177 loads this checkpoint directly).

    Raises with every mismatch listed — `--sdxl-refiner` conversion must not
    silently proceed with wrong constants."""
    problems = []

    def want(field, expected):
        if field in hf and hf[field] != expected:
            problems.append(f"{field}: config.json {hf[field]!r} != ours {expected!r}")

    want("in_channels", cfg.in_channels)
    want("out_channels", cfg.out_channels)
    want("block_out_channels", list(cfg.block_out_channels))
    want("layers_per_block", cfg.layers_per_block)
    want("cross_attention_dim", cfg.cross_attention_dim)
    want("norm_num_groups", cfg.norm_num_groups)
    want("addition_embed_type", cfg.addition_embed_type)
    want("addition_time_embed_dim", cfg.addition_time_embed_dim)
    want(
        "projection_class_embeddings_input_dim",
        cfg.projection_class_embeddings_input_dim,
    )
    # diffusers quirk: when num_attention_heads is absent, attention_head_dim
    # actually carries the per-block *head count*.
    heads = hf.get("num_attention_heads") or hf.get("attention_head_dim")
    if heads is not None:
        heads = list(heads) if isinstance(heads, (list, tuple)) else [
            heads
        ] * len(cfg.block_out_channels)
        if heads != list(cfg.num_heads):
            problems.append(
                f"attention heads: config.json {heads!r} != ours {list(cfg.num_heads)!r}"
            )
    if "down_block_types" in hf:
        has_attn = [t.startswith("CrossAttn") for t in hf["down_block_types"]]
        if has_attn != list(cfg.down_block_has_attn):
            problems.append(
                f"down_block_types attention placement {has_attn!r} != "
                f"ours {list(cfg.down_block_has_attn)!r}"
            )
    if "transformer_layers_per_block" in hf:
        t = hf["transformer_layers_per_block"]
        t = list(t) if isinstance(t, (list, tuple)) else [
            t if a else 0 for a in cfg.down_block_has_attn
        ]
        if t != list(cfg.transformer_depth):
            problems.append(
                f"transformer_layers_per_block {t!r} != ours "
                f"{list(cfg.transformer_depth)!r}"
            )
    if problems:
        raise ValueError(
            "SDXL refiner unet/config.json does not match sdxl_refiner_config:\n  "
            + "\n  ".join(problems)
        )


def validate_against_init(converted, init_params, name: str):
    """Tree structure + leaf shapes must match the random-init tree: the
    port's shape walk (``*_leaves``, undrawn) or a drawn tree."""
    got = {k: v.shape for k, v in flatten_tree(converted).items()}
    want = {k: tuple(v.shape) for k, v in flatten_tree(init_params).items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    wrong = sorted(
        k for k in set(got) & set(want) if tuple(got[k]) != tuple(want[k])
    )
    if missing or extra or wrong:
        msgs = []
        if missing:
            msgs.append(f"missing {len(missing)}: {missing[:5]}")
        if extra:
            msgs.append(f"extra {len(extra)}: {extra[:5]}")
        if wrong:
            msgs.append(
                f"shape-mismatched {len(wrong)}: "
                f"{[(k, want[k], got[k]) for k in wrong[:5]]}"
            )
        raise ValueError(f"{name} conversion mismatch: " + "; ".join(msgs))


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a .safetensors or torch .bin state dict as numpy arrays."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        try:
            return load_file(path)
        except Exception:
            from safetensors import safe_open

            out = {}
            with safe_open(path, framework="pt") as f:
                for k in f.keys():
                    t = f.get_tensor(k)
                    out[k] = t.to(torch.float32).numpy()
            return out
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def _find_weights(dirpath: str) -> Optional[str]:
    for name in (
        "diffusion_pytorch_model.safetensors",
        "model.safetensors",
        "diffusion_pytorch_model.bin",
        "pytorch_model.bin",
        "diffusion_pytorch_model.fp16.safetensors",
        "pytorch_model.fp16.bin",
    ):
        p = os.path.join(dirpath, name)
        if os.path.exists(p):
            return p
    return None


def convert_sdxl_refiner(src: str, dst: str, validate: bool = True,
                         verify: bool = False):
    """Convert an SDXL-refiner checkpoint (unet + text_encoder_2 + vae)."""
    from . import clip as clip_mod
    from . import unet2d as unet2d_mod
    from . import vae as vae_mod

    key = prng.prng_key(0)  # the shape walks need a key; nothing is drawn
    os.makedirs(dst, exist_ok=True)

    unet_cfg = unet2d_mod.sdxl_refiner_config()
    unet_cfg_path = os.path.join(src, "unet", "config.json")
    if os.path.exists(unet_cfg_path):
        check_sdxl_unet_config(json.load(open(unet_cfg_path)), unet_cfg)
        print("unet/config.json matches sdxl_refiner_config")
    sd = RecordingStateDict(
        load_torch_state_dict(_find_weights(os.path.join(src, "unet")))
    )
    unet = convert_unet2d(sd, unet_cfg)
    verify_conversion(sd, unet, "sdxl-unet", verbose=verify)
    if validate:
        validate_against_init(
            unet, unet2d_mod.unet2d_leaves(key, unet_cfg), "sdxl-unet"
        )
    save_params(os.path.join(dst, "unet.npz"), unet)

    clip_cfg = CLIPTextConfig(
        hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
        num_attention_heads=20, projection_dim=1280,
    )
    te_dir = os.path.join(src, "text_encoder_2")
    if not os.path.isdir(te_dir):
        te_dir = os.path.join(src, "text_encoder")
    sd = RecordingStateDict(load_torch_state_dict(_find_weights(te_dir)))
    clip = convert_clip_text(sd, clip_cfg)
    verify_conversion(sd, clip, "sdxl-clip", verbose=verify)
    if validate:
        validate_against_init(
            clip,
            clip_mod.clip_text_leaves(key, clip_cfg, with_projection=True),
            "sdxl-clip",
        )
    save_params(os.path.join(dst, "clip.npz"), clip)

    sd = RecordingStateDict(
        load_torch_state_dict(_find_weights(os.path.join(src, "vae")))
    )
    vae = convert_vae(sd, VAEConfig(scaling_factor=0.13025))
    verify_conversion(sd, vae, "sdxl-vae", verbose=verify)
    if validate:
        validate_against_init(
            vae, vae_mod.vae_leaves(key, VAEConfig()), "sdxl-vae"
        )
    save_params(os.path.join(dst, "vae.npz"), vae)

    for sub in ("tokenizer_2", "tokenizer"):
        tok = os.path.join(src, sub)
        if os.path.isdir(tok):
            for name in ("vocab.json", "merges.txt"):
                p = os.path.join(tok, name)
                if os.path.exists(p):
                    shutil.copy(p, os.path.join(dst, name))
            break
    print(f"SDXL refiner converted to {dst}")


def convert_checkpoint(src: str, dst: str, gated: bool = False,
                       validate: bool = True, verify: bool = False):
    """Convert a full HF text-to-video checkpoint directory."""
    from . import clip as clip_mod
    from . import unet3d as unet_mod
    from . import vae as vae_mod

    key = prng.prng_key(0)  # the shape walks need a key; nothing is drawn
    os.makedirs(dst, exist_ok=True)

    # UNet
    unet_cfg_path = os.path.join(src, "unet", "config.json")
    unet_cfg = UNet3DConfig(
        attention_type="gated" if gated else "default"
    )
    if os.path.exists(unet_cfg_path):
        hf = json.load(open(unet_cfg_path))
        unet_cfg = UNet3DConfig(
            in_channels=hf.get("in_channels", 4),
            out_channels=hf.get("out_channels", 4),
            block_out_channels=tuple(hf.get("block_out_channels", (320, 640, 1280, 1280))),
            layers_per_block=hf.get("layers_per_block", 2),
            cross_attention_dim=hf.get("cross_attention_dim", 1024),
            attention_head_dim=hf.get("attention_head_dim", 64),
            norm_num_groups=hf.get("norm_num_groups", 32),
            attention_type="gated"
            if (gated or hf.get("attention_type") == "gated")
            else "default",
        )
    sd = RecordingStateDict(
        load_torch_state_dict(_find_weights(os.path.join(src, "unet")))
    )
    unet = convert_unet3d(sd, unet_cfg)
    verify_conversion(sd, unet, "unet", verbose=verify)
    if validate:
        validate_against_init(
            unet, unet_mod.unet3d_leaves(key, unet_cfg), "unet"
        )
    save_params(os.path.join(dst, "unet.npz"), unet)
    print(f"unet: {len(sd)} torch tensors converted")

    # CLIP text encoder
    clip_cfg = CLIPTextConfig()
    clip_cfg_path = os.path.join(src, "text_encoder", "config.json")
    if os.path.exists(clip_cfg_path):
        hf = json.load(open(clip_cfg_path))
        clip_cfg = CLIPTextConfig(
            vocab_size=hf.get("vocab_size", 49408),
            hidden_size=hf.get("hidden_size", 1024),
            intermediate_size=hf.get("intermediate_size", 4096),
            num_hidden_layers=hf.get("num_hidden_layers", 23),
            num_attention_heads=hf.get("num_attention_heads", 16),
            hidden_act=hf.get("hidden_act", "gelu"),
        )
    sd = RecordingStateDict(
        load_torch_state_dict(_find_weights(os.path.join(src, "text_encoder")))
    )
    clip = convert_clip_text(sd, clip_cfg)
    verify_conversion(sd, clip, "clip", verbose=verify)
    if validate:
        validate_against_init(
            clip, clip_mod.clip_text_leaves(key, clip_cfg), "clip"
        )
    save_params(os.path.join(dst, "clip.npz"), clip)
    print(f"clip: {len(sd)} torch tensors converted ({len(clip['layers'])} layers)")

    # VAE
    vae_cfg = VAEConfig()
    vae_cfg_path = os.path.join(src, "vae", "config.json")
    if os.path.exists(vae_cfg_path):
        hf = json.load(open(vae_cfg_path))
        vae_cfg = VAEConfig(
            in_channels=hf.get("in_channels", 3),
            out_channels=hf.get("out_channels", 3),
            latent_channels=hf.get("latent_channels", 4),
            block_out_channels=tuple(
                hf.get("block_out_channels", (128, 256, 512, 512))
            ),
            layers_per_block=hf.get("layers_per_block", 2),
            norm_num_groups=hf.get("norm_num_groups", 32),
            scaling_factor=hf.get("scaling_factor", 0.18215),
        )
    sd = RecordingStateDict(
        load_torch_state_dict(_find_weights(os.path.join(src, "vae")))
    )
    vae = convert_vae(sd, vae_cfg)
    verify_conversion(sd, vae, "vae", verbose=verify)
    if validate:
        validate_against_init(
            vae, vae_mod.vae_leaves(key, vae_cfg), "vae"
        )
    save_params(os.path.join(dst, "vae.npz"), vae)
    print(f"vae: {len(sd)} torch tensors converted")

    # Tokenizer files travel along for the real CLIP BPE.
    tok_src = os.path.join(src, "tokenizer")
    if os.path.isdir(tok_src):
        for name in ("vocab.json", "merges.txt"):
            p = os.path.join(tok_src, name)
            if os.path.exists(p):
                shutil.copy(p, os.path.join(dst, name))

    # Record configs for the loader.
    with open(os.path.join(dst, "lvd_tpu_config.json"), "w") as f:
        json.dump(
            {
                "unet": dataclass_dict(unet_cfg),
                "clip": dataclass_dict(clip_cfg),
                "vae": dataclass_dict(vae_cfg),
            },
            f,
            indent=2,
        )
    print(f"Converted checkpoint written to {dst}")


def dataclass_dict(dc):
    import dataclasses

    return dataclasses.asdict(dc)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src", required=True, help="HF checkpoint directory")
    p.add_argument("--dst", required=True, help="Output directory")
    p.add_argument("--gated", action="store_true", help="GLIGEN checkpoint")
    p.add_argument("--sdxl-refiner", action="store_true",
                   help="Convert an SDXL refiner instead of a T2V checkpoint")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--verify", action="store_true",
                   help="Print per-tensor norms of the converted pytree for "
                        "auditing against the torch state dict (RUNBOOK.md)")
    args = p.parse_args(argv)
    if args.sdxl_refiner:
        convert_sdxl_refiner(
            args.src, args.dst, validate=not args.no_validate, verify=args.verify
        )
    else:
        convert_checkpoint(
            args.src, args.dst, gated=args.gated,
            validate=not args.no_validate, verify=args.verify,
        )


if __name__ == "__main__":
    main()
