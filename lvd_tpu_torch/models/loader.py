"""Weights for the port: the bridge from lvd_tpu's param trees, an npz
reader, the checkpoint loader, and full-width random weights (counterpart of
lvd_tpu/models/loader.py).

Param trees are nested dicts/lists of tensors with lvd_tpu's keys and
layouts (linears (din, dout), convs HWIO), so one tree feeds both packages.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import config as config_mod
from ..text.tokenizer import load_tokenizer
from ..utils.device import resolve_device


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


# ---------------------------------------------------------------------------
# Random initialization with lvd_tpu's scale rules (unet3d.py:70-98,
# clip.py:18-64, vae.py:18-128): normal * fan_in^-1/2, zero biases, unit
# norms, zero where lvd_tpu zero-inits. The values differ from JAX's.
# ---------------------------------------------------------------------------


class _Init:
    def __init__(self, generator: torch.Generator, device, dtype):
        self.gen, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, scale):
        t = torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)
        return (t * scale).to(self.dtype)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def linear(self, din, dout, bias=True, scale=None):
        p = {"w": self.normal((din, dout), din ** -0.5 if scale is None else scale)}
        if bias:
            p["b"] = self.zeros((dout,))
        return p

    def conv(self, kh, kw, din, dout, zero=False):
        w = (self.zeros((kh, kw, din, dout)) if zero
             else self.normal((kh, kw, din, dout), (kh * kw * din) ** -0.5))
        return {"w": w, "b": self.zeros((dout,))}

    def conv3d(self, kt, din, dout, zero=False):
        w = (self.zeros((kt, 1, 1, din, dout)) if zero
             else self.normal((kt, 1, 1, din, dout), (kt * din) ** -0.5))
        return {"w": w, "b": self.zeros((dout,))}

    def norm(self, c):
        return {"scale": self.ones((c,)), "bias": self.zeros((c,))}

    def attention(self, query_dim, context_dim, inner_dim):
        return {
            "to_q": self.linear(query_dim, inner_dim, bias=False),
            "to_k": self.linear(context_dim, inner_dim, bias=False),
            "to_v": self.linear(context_dim, inner_dim, bias=False),
            "to_out": self.linear(inner_dim, query_dim),
        }

    def ff(self, dim, mult=4):
        return {"proj": self.linear(dim, dim * mult * 2), "out": self.linear(dim * mult, dim)}

    def btb(self, dim, context_dim, fuser_context=None):
        p = {
            "norm1": self.norm(dim), "attn1": self.attention(dim, dim, dim),
            "norm2": self.norm(dim), "attn2": self.attention(dim, context_dim, dim),
            "norm3": self.norm(dim), "ff": self.ff(dim),
        }
        if fuser_context is not None:  # GLIGEN's gated self-attention, gates shut
            p["fuser"] = {
                "linear": self.linear(fuser_context, dim),
                "attn": self.attention(dim, dim, dim), "ff": self.ff(dim),
                "norm1": self.norm(dim), "norm2": self.norm(dim),
                "alpha_attn": self.zeros(()), "alpha_dense": self.zeros(()),
            }
        return p

    def position_net(self, positive_len, out_dim, fourier_freqs):
        position_dim = fourier_freqs * 2 * 4
        return {
            "linears_0": self.linear(positive_len + position_dim, 512),
            "linears_1": self.linear(512, 512),
            "linears_2": self.linear(512, out_dim),
            "null_positive_feature": self.zeros((positive_len,)),
            "null_position_feature": self.zeros((position_dim,)),
        }

    def resnet(self, cin, cout, temb_dim):
        p = {
            "norm1": self.norm(cin), "conv1": self.conv(3, 3, cin, cout),
            "time_emb_proj": self.linear(temb_dim, cout),
            "norm2": self.norm(cout), "conv2": self.conv(3, 3, cout, cout),
        }
        if cin != cout:
            p["conv_shortcut"] = self.conv(1, 1, cin, cout)
        return p


def random_unet3d(cfg: config_mod.UNet3DConfig, init: _Init):
    """lvd_tpu's UNet tree (``init_unet3d``); ``attention_type="gated"``
    adds a GLIGEN fuser to every spatial BasicTransformerBlock and the
    PositionNet (lvd_tpu/models/unet3d.py:124-149, gligen.py:32-49)."""
    if cfg.attention_type not in ("default", "gated"):
        raise ValueError(f"attention_type {cfg.attention_type!r}")
    gated = cfg.attention_type == "gated"
    boc = cfg.block_out_channels
    temb = cfg.time_embed_dim

    def temporal_transformer(channels, inner):
        return {
            "norm": init.norm(channels), "proj_in": init.linear(channels, inner),
            "blocks": [init.btb(inner, inner)],
            "proj_out": init.linear(inner, channels, scale=1e-5),
        }

    def temp_conv(c):
        return {f"conv{i + 1}": {"norm": init.norm(c), "conv": init.conv3d(3, c, c, zero=i == 3)}
                for i in range(4)}

    def layer(cin, cout, with_attn):
        p = {"resnet": init.resnet(cin, cout, temb), "temp_conv": temp_conv(cout)}
        if with_attn:
            p["attn"] = {
                "norm": init.norm(cout), "proj_in": init.linear(cout, cout),
                "blocks": [init.btb(cout, cfg.cross_attention_dim,
                                    cfg.cross_attention_dim if gated else None)],
                "proj_out": init.linear(cout, cout, scale=1e-5),
            }
            p["temp_attn"] = temporal_transformer(cout, cout)
        return p

    params = {
        "conv_in": init.conv(3, 3, cfg.in_channels, boc[0]),
        "time_embedding": {"linear_1": init.linear(boc[0], temb),
                           "linear_2": init.linear(temb, temb)},
        "transformer_in": temporal_transformer(
            boc[0], cfg.transformer_in_num_heads * cfg.attention_head_dim),
    }
    down, ch = [], boc[0]
    for i, cout in enumerate(boc):
        is_final = i == len(boc) - 1
        block = {"layers": [layer(ch if j == 0 else cout, cout, not is_final)
                            for j in range(cfg.layers_per_block)]}
        if not is_final:
            block["downsample"] = init.conv(3, 3, cout, cout)
        down.append(block)
        ch = cout
    params["down_blocks"] = down
    params["mid_block"] = {
        "resnet_in": init.resnet(boc[-1], boc[-1], temb),
        "temp_conv_in": temp_conv(boc[-1]),
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
            block["upsample"] = init.conv(3, 3, cout, cout)
        up.append(block)
        prev = cout
    params["up_blocks"] = up
    params["conv_norm_out"] = init.norm(boc[0])
    params["conv_out"] = init.conv(3, 3, boc[0], cfg.out_channels)
    if gated:
        params["position_net"] = init.position_net(
            cfg.gligen_positive_len, cfg.cross_attention_dim, cfg.gligen_fourier_freqs)
    return params


def random_clip_text(cfg: config_mod.CLIPTextConfig, init: _Init):
    d = cfg.hidden_size
    return {
        "token_embedding": init.normal((cfg.vocab_size, d), 0.02),
        "position_embedding": init.normal((cfg.max_position_embeddings, d), 0.02),
        "final_layer_norm": init.norm(d),
        "layers": [
            {
                "layer_norm1": init.norm(d),
                "q_proj": init.linear(d, d), "k_proj": init.linear(d, d),
                "v_proj": init.linear(d, d), "out_proj": init.linear(d, d),
                "layer_norm2": init.norm(d),
                "fc1": init.linear(d, cfg.intermediate_size),
                "fc2": init.linear(cfg.intermediate_size, d),
            }
            for _ in range(cfg.num_hidden_layers)
        ],
    }


def random_vae_decoder(cfg: config_mod.VAEConfig, init: _Init):
    """The decoder half of lvd_tpu's VAE tree (the port decodes only)."""
    boc = cfg.block_out_channels

    def resnet(cin, cout):
        p = {"norm1": init.norm(cin), "conv1": init.conv(3, 3, cin, cout),
             "norm2": init.norm(cout), "conv2": init.conv(3, 3, cout, cout)}
        if cin != cout:
            p["conv_shortcut"] = init.conv(1, 1, cin, cout)
        return p

    attn = {"norm": init.norm(boc[-1]), **{n: init.linear(boc[-1], boc[-1])
                                           for n in ("to_q", "to_k", "to_v", "to_out")}}
    dec = {"conv_in": init.conv(3, 3, cfg.latent_channels, boc[-1]),
           "mid": {"resnet_1": resnet(boc[-1], boc[-1]), "attn": attn,
                   "resnet_2": resnet(boc[-1], boc[-1])}}
    blocks, rev = [], list(reversed(boc))
    ch = rev[0]
    for i, cout in enumerate(rev):
        block = {"resnets": [resnet(ch if j == 0 else cout, cout)
                             for j in range(cfg.layers_per_block + 1)]}
        if i < len(boc) - 1:
            block["upsample"] = init.conv(3, 3, cout, cout)
        blocks.append(block)
        ch = cout
    dec["up_blocks"] = blocks
    dec["conv_norm_out"] = init.norm(boc[0])
    dec["conv_out"] = init.conv(3, 3, boc[0], cfg.out_channels)
    return {"decoder": dec,
            "post_quant_conv": init.conv(1, 1, cfg.latent_channels, cfg.latent_channels)}


def random_pipeline_models(preset, generator: torch.Generator, device=None,
                           dtype=torch.bfloat16):
    """Full-width random weights for a preset (name or ModelPreset), drawn
    from ``generator`` (which must live on ``device``)."""
    from ..pipeline import PipelineModels

    if isinstance(preset, str):
        preset = config_mod.PRESETS[preset]
    init = _Init(generator, resolve_device(device), dtype)
    return PipelineModels(
        preset=preset,
        unet_params=random_unet3d(preset.unet, init),
        clip_params=random_clip_text(preset.clip, init),
        vae_params=random_vae_decoder(preset.vae, init),
        tokenizer=load_tokenizer(None),
    )


def _checkpoint_dir(preset: config_mod.ModelPreset):
    root = os.environ.get("LVD_CHECKPOINT_ROOT", "")
    if not root or not preset.checkpoint:
        return None
    d = os.path.join(root, preset.checkpoint.replace("/", "--"))
    return d if os.path.isdir(d) else None


def load_pipeline_models(preset_name: str, device=None, dtype=torch.float32):
    """A preset's converted checkpoint, ``$LVD_CHECKPOINT_ROOT/<checkpoint>/
    {unet,clip,vae}.npz`` and its tokenizer (lvd_tpu/models/loader.py:90-128),
    as tensors of ``dtype`` on ``device`` (the card unless asked). Without
    one, ``LVD_ALLOW_RANDOM_WEIGHTS=1`` gives this package's random weights
    from seed 0 (``random_pipeline_models``; lvd_tpu draws other values from
    its JAX keys, ROADMAP A3), else it raises."""
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
    gen = torch.Generator(device=device).manual_seed(0)
    return random_pipeline_models(preset, gen, device, dtype)
