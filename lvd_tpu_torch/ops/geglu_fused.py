"""Fused GEGLU feed-forward: kernel C and its plain version (counterpart of
lvd_tpu/ops/geglu_fused.py).

``geglu_mlp(p, x)`` computes ``(x W1h + b1h) * gelu(x W1g + b1g) W2 + b2`` on
(..., C) input with the standard ff params {"proj": {w, b}, "out": {w, b}}.
On a CUDA tensor it launches kernel C (csrc/geglu.cu, replacing
``_fused_rows_resident``), which keeps the 4C-wide inner activation on
chip; on a CPU tensor it runs ``_unfused``.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import _build

# GELU form of the gate, the switch lvd_tpu reads (geglu_fused.py:28-37):
# "tanh" (default) or "exact" (erf, the torch reference's form).
GELU_FORM = os.environ.get("LVD_GELU_FORM", "tanh")

MAX_CHANNELS = 640


def _unfused(x, w1, b1, w2, b2):
    h = x @ w1 + b1.to(x.dtype)
    a, gate = h.chunk(2, dim=-1)
    inner = a * F.gelu(gate, approximate="tanh" if GELU_FORM == "tanh" else "none")
    return inner @ w2 + b2.to(x.dtype)


def supported(w1, w2, x) -> bool:
    """lvd_tpu's routing predicate (geglu_fused.py:370-388), the resident
    form's C <= 640."""
    c = x.shape[-1]
    inner = w2.shape[0]
    rows = x.numel() // c
    return inner % 256 == 0 and c % 64 == 0 and c <= MAX_CHANNELS and rows >= 2048


def _weights(p, dtype):
    return [t.to(dtype) for t in (p["proj"]["w"], p["proj"]["b"], p["out"]["w"], p["out"]["b"])]


def geglu_mlp_plain(p, x):
    return _unfused(x, *_weights(p, x.dtype))


def geglu_mlp(p, x):
    if x.device.type == "cpu":
        return geglu_mlp_plain(p, x)
    w1, b1, w2, b2 = _weights(p, x.dtype)
    lead = x.shape[:-1]
    c = x.shape[-1]
    rows = x.reshape(-1, c)
    rows = _build.kernel_input(rows, torch.bfloat16, "geglu_mlp x")
    w1, b1, w2, b2 = (_build.kernel_input(t, torch.bfloat16, "geglu_mlp weights")
                      for t in (w1, b1, w2, b2))
    inner = w2.shape[0]
    if w1.shape != (c, 2 * inner) or w2.shape != (inner, c):
        raise ValueError(f"geglu_mlp: w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)} for C={c}")
    out = torch.empty_like(rows)
    err = _build.lib().lvd_geglu(
        rows.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), rows.shape[0], c, inner, int(GELU_FORM != "tanh"),
        _build.stream_of(rows))
    _build.check(err, "geglu_mlp")
    geglu_mlp.launches += 1
    return out.reshape(*lead, c)


geglu_mlp.launches = 0
