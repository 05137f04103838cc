"""CLIP text encoder, HF ``CLIPTextModel`` architecture (counterpart of
lvd_tpu/models/clip.py): causal pre-LN transformer on a param dict."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import CLIPTextConfig
from ..ops.basic import layer_norm, linear


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


def apply_clip_text(params, cfg: CLIPTextConfig, input_ids, eos_token_id: int = 49407):
    """input_ids (B, L) int -> {"last_hidden_state": (B, L, D),
    "pooler_output": (B, D)} (the hidden state at the first eos)."""
    b, s = input_ids.shape
    x = params["token_embedding"][input_ids] + params["position_embedding"][None, :s]
    causal = torch.triu(
        torch.full((s, s), -1e9, dtype=torch.float32, device=x.device), diagonal=1)[None, None]
    for layer in params["layers"]:
        h = layer_norm(layer["layer_norm1"], x, cfg.layer_norm_eps)
        x = x + _attn(layer, h, cfg.num_attention_heads, causal)
        h = layer_norm(layer["layer_norm2"], x, cfg.layer_norm_eps)
        x = x + linear(layer["fc2"], _act(linear(layer["fc1"], h), cfg.hidden_act))
    x = layer_norm(params["final_layer_norm"], x, cfg.layer_norm_eps)
    eos_pos = (input_ids == eos_token_id).int().argmax(dim=-1)
    pooled = x[torch.arange(b, device=x.device), eos_pos]
    return {"last_hidden_state": x, "pooler_output": pooled}
