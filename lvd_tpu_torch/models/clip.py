"""CLIP text encoder, HF ``CLIPTextModel`` architecture (counterpart of
lvd_tpu/models/clip.py): causal pre-LN transformer on a param dict, with
``CLIPTextModelWithProjection``'s projected pooled output and the
penultimate hidden state for the SDXL refiner."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import CLIPTextConfig
from ..ops.basic import layer_norm, linear
from ..utils import prng
from . import init


def clip_text_leaves(key, cfg: CLIPTextConfig, with_projection: bool = False):
    """lvd_tpu's CLIP text tree (``init_clip_text``, models/clip.py:29-66) with
    its keys, undrawn: the keys of ``split(key, 16 + 8 * layers)`` in turn."""
    keys = iter(prng.split(key, 16 + 8 * cfg.num_hidden_layers))
    d = cfg.hidden_size
    params = {
        "token_embedding": init.Normal(next(keys), (cfg.vocab_size, d), 0.02),
        "position_embedding": init.Normal(next(keys), (cfg.max_position_embeddings, d), 0.02),
        "final_layer_norm": init.norm(d),
        "layers": [],
    }
    if with_projection:  # CLIPTextModelWithProjection (the SDXL text encoders)
        params["text_projection"] = {
            "w": init.Normal(next(keys), (d, cfg.projection_dim), d ** -0.5)}
    for _ in range(cfg.num_hidden_layers):
        params["layers"].append({
            "layer_norm1": init.norm(d),
            "q_proj": init.linear(next(keys), d, d),
            "k_proj": init.linear(next(keys), d, d),
            "v_proj": init.linear(next(keys), d, d),
            "out_proj": init.linear(next(keys), d, d),
            "layer_norm2": init.norm(d),
            "fc1": init.linear(next(keys), d, cfg.intermediate_size),
            "fc2": init.linear(next(keys), cfg.intermediate_size, d),
        })
    return params


def init_clip_text(key, cfg: CLIPTextConfig, with_projection: bool = False, device=None,
                   dtype=torch.float32):
    """lvd_tpu's ``init_clip_text(key, cfg, with_projection)`` drawn on
    ``device`` (the card unless asked)."""
    return init.draw(clip_text_leaves(key, cfg, with_projection), device, dtype)


def _attn(p, x, num_heads, causal_bias):
    b, s, d = x.shape
    hd = d // num_heads

    def heads(t):
        return t.reshape(b, s, num_heads, hd).transpose(1, 2)

    q = heads(linear(p["q_proj"], x))
    k = heads(linear(p["k_proj"], x))
    v = heads(linear(p["v_proj"], x))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5 + causal_bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)
    return linear(p["out_proj"], out.transpose(1, 2).reshape(b, s, d))


def _act(x, kind: str):
    if kind == "gelu":
        return F.gelu(x)
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(kind)


def apply_clip_text(params, cfg: CLIPTextConfig, input_ids, eos_token_id: int = 49407,
                    return_penultimate: bool = False):
    """input_ids (B, L) int -> {"last_hidden_state": (B, L, D),
    "pooler_output": (B, D)} (the hidden state at the first eos); with
    ``return_penultimate`` also "penultimate_hidden_state" (the input of the
    last layer, which the SDXL refiner conditions on), and "text_embeds"
    (the pooled output through the bias-free projection) where the params
    carry a ``text_projection``."""
    b, s = input_ids.shape
    x = params["token_embedding"][input_ids] + params["position_embedding"][None, :s]
    causal = torch.triu(
        torch.full((s, s), -1e9, dtype=torch.float32, device=x.device), diagonal=1)[None, None]
    penultimate = None
    for i, layer in enumerate(params["layers"]):
        if return_penultimate and i == len(params["layers"]) - 1:
            penultimate = x
        h = layer_norm(layer["layer_norm1"], x, cfg.layer_norm_eps)
        x = x + _attn(layer, h, cfg.num_attention_heads, causal)
        h = layer_norm(layer["layer_norm2"], x, cfg.layer_norm_eps)
        x = x + linear(layer["fc2"], _act(linear(layer["fc1"], h), cfg.hidden_act))
    x = layer_norm(params["final_layer_norm"], x, cfg.layer_norm_eps)
    eos_pos = (input_ids == eos_token_id).int().argmax(dim=-1)
    pooled = x[torch.arange(b, device=x.device), eos_pos]
    out = {"last_hidden_state": x, "pooler_output": pooled}
    if penultimate is not None:
        out["penultimate_hidden_state"] = penultimate
    if "text_projection" in params:
        out["text_embeds"] = linear(params["text_projection"], pooled)
    return out
