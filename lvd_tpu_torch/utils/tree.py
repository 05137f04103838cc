"""The param tree's leaves by path, and back: nested dicts and lists (as
the models build them) with tensor leaves, which stay the same objects."""

from __future__ import annotations

from typing import Dict

import torch


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tree's leaves by '/'-joined path (lists by index), in key order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


def unflatten_like(tree, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """``tree``'s structure with the leaves of ``flat``."""
    if isinstance(tree, dict):
        return {k: unflatten_like(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [unflatten_like(v, flat, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return flat[prefix.rstrip("/")]
