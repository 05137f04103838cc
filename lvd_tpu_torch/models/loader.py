"""Weights for the port: the bridge from lvd_tpu's param trees, an npz
reader, the checkpoint loader, lvd_tpu's random and tiny weights (counterpart
of lvd_tpu/models/loader.py), and this package's own seeded full-width
weights (``random_pipeline_models``), which ``chip_smoke.py``'s gates read.

Param trees are nested dicts/lists of tensors with lvd_tpu's keys and
layouts (linears (din, dout), convs HWIO), so one tree feeds both packages.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import config as config_mod
from ..text.tokenizer import load_tokenizer
from ..utils import prng
from ..utils.device import resolve_device
from . import init
from .clip import clip_text_leaves, init_clip_text
from .unet3d import init_unet3d, unet3d_leaves
from .vae import init_vae, vae_leaves


def unflatten_tree(flat: dict):
    """{'a/0/w': array} -> {'a': [{'w': array}]}; integer-keyed levels become
    lists (lvd_tpu/models/loader.py:29-72 ``unflatten_pytree``)."""
    root: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def params_from_numpy(tree, device=None, dtype=torch.float32):
    """lvd_tpu's param pytree as numpy arrays (nested, or flat with
    '/'-joined keys) -> the same tree of tensors on ``device``; floating
    arrays take ``dtype``, integer arrays keep theirs."""
    device = resolve_device(device)
    if isinstance(tree, dict) and any("/" in k for k in tree):
        tree = unflatten_tree(tree)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        t = torch.from_numpy(np.array(node))
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return convert(tree)


def load_params_npz(path: str, device=None, dtype=torch.float32):
    """Reads a converted ``{unet,clip,vae}.npz`` (flat '/'-joined keys)."""
    with np.load(path) as data:
        return params_from_numpy({k: data[k] for k in data.files}, device, dtype)


def cast_tree(tree, dtype, device=None):
    """The same tree with floating tensors in ``dtype`` (and all on
    ``device`` when given); tensors already there are not copied."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, dtype, device) for v in tree]
    return tree.to(device=device, dtype=dtype if tree.is_floating_point() else tree.dtype)


_WALK_KEY = prng.prng_key(0)  # the walks need a key; a generator replaces its draws


def random_unet3d(cfg: config_mod.UNet3DConfig, generator: torch.Generator, device=None,
                  dtype=torch.float32):
    """lvd_tpu's UNet tree (``unet3d_leaves``) drawn from ``generator``."""
    return init.draw(unet3d_leaves(_WALK_KEY, cfg), device, dtype, generator=generator)


def random_pipeline_models(preset, generator: torch.Generator, device=None,
                           dtype=torch.bfloat16):
    """Full-width random weights for a preset (name or ModelPreset): lvd_tpu's
    trees and scales (models/init.py), every Normal drawn from ``generator``
    (which must live on ``device``) in the trees' walk order instead of from
    its key. The values are not lvd_tpu's (those come from ``_drawn_models``);
    chip_smoke.py's gates were set on them. The VAE is its decoder half."""
    from ..pipeline import PipelineModels

    if isinstance(preset, str):
        preset = config_mod.PRESETS[preset]
    device = resolve_device(device)
    draw = lambda tree: init.draw(tree, device, dtype, generator=generator)
    unet = random_unet3d(preset.unet, generator, device, dtype)
    clip = draw(clip_text_leaves(_WALK_KEY, preset.clip))
    # The decoder's mid attention first: the order the smoke's gates were read on.
    leaves = vae_leaves(_WALK_KEY, preset.vae)
    mid = leaves["decoder"]["mid"]
    attn, mid["attn"] = draw(mid["attn"]), {}
    vae = draw({"decoder": leaves["decoder"], "post_quant_conv": leaves["post_quant_conv"]})
    vae["decoder"]["mid"]["attn"] = attn
    return PipelineModels(preset=preset, unet_params=unet, clip_params=clip,
                          vae_params=vae, tokenizer=load_tokenizer(None))


def _checkpoint_dir(preset: config_mod.ModelPreset):
    root = os.environ.get("LVD_CHECKPOINT_ROOT", "")
    if not root or not preset.checkpoint:
        return None
    d = os.path.join(root, preset.checkpoint.replace("/", "--"))
    return d if os.path.isdir(d) else None


def _drawn_models(preset: config_mod.ModelPreset, seed: int, device, dtype):
    """lvd_tpu's random weights for ``preset``: ``split(PRNGKey(seed), 3)``
    feeds ``init_unet3d``, ``init_clip_text`` and ``init_vae`` (lvd_tpu's
    key order, models/init.py), drawn on ``device``."""
    from ..pipeline import PipelineModels

    k = prng.split(prng.prng_key(seed), 3)
    return PipelineModels(
        preset=preset,
        unet_params=init_unet3d(k[0], preset.unet, device, dtype),
        clip_params=init_clip_text(k[1], preset.clip, device=device, dtype=dtype),
        vae_params=init_vae(k[2], preset.vae, device, dtype),
        tokenizer=load_tokenizer(None),
    )


def load_pipeline_models(preset_name: str, device=None, dtype=torch.float32):
    """A preset's converted checkpoint, ``$LVD_CHECKPOINT_ROOT/<checkpoint>/
    {unet,clip,vae}.npz`` and its tokenizer (lvd_tpu/models/loader.py:90-128),
    as tensors of ``dtype`` on ``device`` (the card unless asked). Without
    one, ``LVD_ALLOW_RANDOM_WEIGHTS=1`` gives lvd_tpu's random weights from
    seed 0, drawn on ``device`` in its key order, else it raises."""
    from ..pipeline import PipelineModels

    preset = config_mod.PRESETS[preset_name]
    ckpt = _checkpoint_dir(preset)
    device = resolve_device(device)
    if ckpt is not None:
        return PipelineModels(
            preset=preset,
            unet_params=load_params_npz(os.path.join(ckpt, "unet.npz"), device, dtype),
            clip_params=load_params_npz(os.path.join(ckpt, "clip.npz"), device, dtype),
            vae_params=load_params_npz(os.path.join(ckpt, "vae.npz"), device, dtype),
            tokenizer=load_tokenizer(ckpt),
        )
    if os.environ.get("LVD_ALLOW_RANDOM_WEIGHTS") != "1":
        raise FileNotFoundError(
            f"No converted checkpoint for preset {preset_name!r} under "
            f"LVD_CHECKPOINT_ROOT; run `python -m lvd_tpu.models.convert` on the "
            "HF checkpoint first, or set LVD_ALLOW_RANDOM_WEIGHTS=1 for a "
            "weightless smoke run.")
    print(f"[lvd_tpu] No checkpoint for {preset_name!r}; using RANDOM weights "
          "(LVD_ALLOW_RANDOM_WEIGHTS=1). Outputs will be noise.")
    return _drawn_models(preset, 0, device, dtype)


def tiny_pipeline_models(seed: int = 0, attention_type: str = "default", device=None,
                         dtype=torch.float32):
    """lvd_tpu's miniature models (models/loader.py:133-153): its tiny
    preset, full topology at tiny widths, with its random weights."""
    preset = config_mod.ModelPreset(
        name="tiny",
        unet=config_mod.tiny_unet_config(attention_type),
        clip=config_mod.tiny_clip_config(),
        vae=config_mod.tiny_vae_config(),
        scheduler=config_mod.SchedulerConfig(),
        height=64,
        width=96,
        default_num_frames=4,
        base_attn_dim=(8, 12),
    )
    return _drawn_models(preset, seed, device, dtype)
