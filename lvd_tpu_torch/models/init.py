"""lvd_tpu's random weights, key for key.

lvd_tpu's ``init_*`` functions (models/{unet3d,clip,vae,gligen}.py) split
and fold JAX keys down a param tree and draw each weight as
``jax.random.normal(key, shape, float32) * scale``; biases and norm offsets
are zeros, norm scales ones. The port's ``*_leaves`` functions walk the same
tree and derive the same keys on the host (a key is a pair of ints,
utils/prng.py), and return it with the leaves still undrawn: ``Normal`` (key,
shape, scale) or ``Const`` (shape, value). ``draw`` then makes each leaf a
tensor on the device asked for, so a full-width draw runs on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import prng
from ..utils.device import resolve_device


class Normal(NamedTuple):
    """``jax.random.normal(key, shape, float32) * scale``."""

    key: prng.Key
    shape: Tuple[int, ...]
    scale: float


class Const(NamedTuple):
    """``jnp.full(shape, value, float32)`` (lvd_tpu's zeros and ones)."""

    shape: Tuple[int, ...]
    value: float


def draw(tree, device=None, dtype=torch.float32, generator=None):
    """The tree with every leaf made a tensor of ``dtype`` on ``device`` (the
    card unless asked); each Normal is drawn in fp32 there, scaled in fp32,
    then cast. With ``generator`` (a torch.Generator on ``device``) each
    Normal is drawn from it instead, in the tree's walk order, and its key is
    not used: the port's own seeded weights (loader.random_pipeline_models)."""
    device = resolve_device(device)

    def normal(leaf):
        if generator is None:
            return prng.normal_key(leaf.key, leaf.shape, device)
        return torch.randn(leaf.shape, generator=generator, device=device,
                           dtype=torch.float32)

    def make(node):
        if isinstance(node, Normal):
            return (normal(node) * node.scale).to(dtype)
        if isinstance(node, Const):
            return torch.full(node.shape, node.value, dtype=dtype, device=device)
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return [make(v) for v in node]

    return make(tree)


def zeros(*shape):
    return Const(tuple(shape), 0.0)


def norm(c):
    return {"scale": Const((c,), 1.0), "bias": zeros(c)}


def linear(key, din, dout, bias=True, scale=None):
    p = {"w": Normal(key, (din, dout), din ** -0.5 if scale is None else scale)}
    if bias:
        p["b"] = zeros(dout)
    return p


def conv(key, kh, kw, din, dout, zero=False):
    shape = (kh, kw, din, dout)
    w = Const(shape, 0.0) if zero else Normal(key, shape, (kh * kw * din) ** -0.5)
    return {"w": w, "b": zeros(dout)}


def conv3d(key, kt, din, dout, zero=False):
    shape = (kt, 1, 1, din, dout)
    w = Const(shape, 0.0) if zero else Normal(key, shape, (kt * din) ** -0.5)
    return {"w": w, "b": zeros(dout)}
