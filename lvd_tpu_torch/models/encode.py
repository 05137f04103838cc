"""Prompt-encoding helpers of the image path (counterpart of
lvd_tpu/models/encode.py): the CFG pair of a prompt batch, the two forms of
prompt embeddings, and the stacking of nested attention-map lists. The
video pipeline encodes its pair with ``TextToVideoPipeline.encode_prompt``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import CLIPTextConfig
from .clip import apply_clip_text


@torch.no_grad()
def encode_prompts(clip_params, clip_cfg: CLIPTextConfig, tokenizer, prompts: Sequence[str],
                   negative_prompt: str = "", one_uncond_input_only: bool = False):
    """(text_embeddings, uncond_embeddings, cond_embeddings), with
    text_embeddings = [uncond; cond] (the image path's CFG convention); with
    ``one_uncond_input_only`` the negative prompt is encoded once and
    broadcast to the prompts' count. On the device of the CLIP params."""
    uncond_prompts = [negative_prompt] * (1 if one_uncond_input_only else len(prompts))
    ids = np.stack([np.asarray(tokenizer.encode_padded(p), np.int64)
                    for p in list(uncond_prompts) + list(prompts)])
    device = clip_params["token_embedding"].device
    hidden = apply_clip_text(clip_params, clip_cfg,
                             torch.from_numpy(ids).to(device))["last_hidden_state"]
    n_uncond = len(uncond_prompts)
    uncond, cond = hidden[:n_uncond], hidden[n_uncond:]
    if one_uncond_input_only and len(prompts) > 1:
        uncond = uncond.expand(cond.shape)
    return torch.cat([uncond, cond], dim=0), uncond, cond


def process_input_embeddings(input_embeddings):
    """Either (text, uncond, cond) or a stacked [uncond; cond] tensor, as the
    tuple form."""
    if isinstance(input_embeddings, (tuple, list)):
        text, uncond, cond = input_embeddings
        return text, uncond, cond
    n = input_embeddings.shape[0]
    if n % 2:
        raise ValueError("Stacked embeddings must pair uncond/cond")
    return input_embeddings, input_embeddings[: n // 2], input_embeddings[n // 2:]


def attn_list_to_tensor(cross_attention_probs):
    """Nested per-timestep / per-block attention-map lists stacked into one
    numpy array."""
    if isinstance(cross_attention_probs, (list, tuple)):
        return np.stack([attn_list_to_tensor(x) for x in cross_attention_probs])
    if isinstance(cross_attention_probs, torch.Tensor):
        return cross_attention_probs.detach().cpu().numpy()
    return np.asarray(cross_attention_probs)
