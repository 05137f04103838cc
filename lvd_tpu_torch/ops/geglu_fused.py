"""Fused GEGLU feed-forward: kernel C (forward), kernel G (dx-only
backward) and their plain versions (counterpart of
lvd_tpu/ops/geglu_fused.py).

``geglu_mlp(p, x)`` computes ``(x W1h + b1h) * gelu(x W1g + b1g) W2 + b2`` on
(..., C) input with the standard ff params {"proj": {w, b}, "out": {w, b}}.
It is a ``torch.autograd.Function`` in x: on CUDA tensors the forward
launches kernel C (csrc/geglu.cu, replacing ``_fused_rows_resident``), which
keeps the 4C-wide inner activation on chip, and the backward kernel G
(csrc/geglu_bwd.cu, replacing ``_fused_rows_bwd_resident``); on CPU tensors
they run ``_unfused`` and ``geglu_mlp_bwd_plain``. Weight gradients are not
part of this slice: on the card a parameter that requires grad raises, on
the CPU the plain formulation's autograd gives them.
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
BWD_ROWS = 32  # rows per block of kernel G


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


def gelu_val_grad(g, form: str):
    """(gelu(g), gelu'(g)) in fp32, closed form (lvd_tpu's
    ``_gelu_val_grad``): the tanh form as g * sigmoid(2z); the exact form
    with the erf CDF and the Gaussian pdf."""
    if form == "tanh":
        z = g + 0.044715 * g * g * g
        sig = torch.sigmoid(1.5957691216057308 * z)
        dz = 1.0 + 3.0 * 0.044715 * g * g
        return g * sig, sig + g * sig * (1.0 - sig) * 1.5957691216057308 * dz
    cdf = 0.5 * (1.0 + torch.erf(g * 2.0 ** -0.5))
    pdf = 0.3989422804014327 * torch.exp(-0.5 * g * g)
    return g * cdf, cdf + g * pdf


def geglu_mlp_bwd_plain(p, x, dy):
    """dx of ``geglu_mlp`` for the cotangent ``dy``: the math of lvd_tpu's
    ``_geglu_bwd_kernel_resident`` (h, g and d_inner = dy W2^T in fp32; the
    gated cotangents dh = d_inner * gelu(g) and dg = d_inner * h * gelu'(g)
    cast to x's type; dx = dh W1h^T + dg W1g^T in fp32)."""
    w1, b1, w2, _ = (t.float() for t in _weights(p, x.dtype))
    inner = w2.shape[0]
    c = x.shape[-1]
    rows = x.reshape(-1, c).float()
    hg = rows @ w1 + b1
    h, g = hg[:, :inner], hg[:, inner:]
    d_inner = dy.reshape(-1, c).float() @ w2.transpose(0, 1)
    u, du = gelu_val_grad(g, GELU_FORM)
    dh = (d_inner * u).to(x.dtype).float()
    dg = (d_inner * h * du).to(x.dtype).float()
    dx = dh @ w1[:, :inner].transpose(0, 1) + dg @ w1[:, inner:].transpose(0, 1)
    return dx.to(x.dtype).reshape(x.shape)


def _kernel_weights(p, x, name):
    w1, b1, w2, b2 = (_build.kernel_input(t, x.dtype, f"{name} weights")
                      for t in _weights(p, x.dtype))
    c = x.shape[-1]
    inner = w2.shape[0]
    if w1.shape != (c, 2 * inner) or w2.shape != (inner, c):
        raise ValueError(f"{name}: w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)} for C={c}")
    return w1, b1, w2, b2


def _launch_forward(p, x):
    """Kernel C on a CUDA tensor."""
    _build.refuse_grad("geglu_mlp", x)
    c = x.shape[-1]
    code = _build.dtype_code(x, "geglu_mlp")
    rows = _build.kernel_input(x.reshape(-1, c), x.dtype, "geglu_mlp x")
    w1, b1, w2, b2 = _kernel_weights(p, rows, "geglu_mlp")
    out = torch.empty_like(rows)
    err = _build.lib().lvd_geglu(
        rows.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), rows.shape[0], c, w2.shape[0], int(GELU_FORM != "tanh"), code,
        _build.stream_of(rows))
    _build.check(err, "geglu_mlp")
    geglu_mlp.launches += 1
    return out.reshape(x.shape)


def geglu_mlp_bwd(p, x, dy):
    """dx: kernel G on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return geglu_mlp_bwd_plain(p, x, dy)
    _build.refuse_grad("geglu_mlp_bwd", x, dy)
    c = x.shape[-1]
    code = _build.dtype_code(x, "geglu_mlp_bwd")
    rows = _build.kernel_input(x.reshape(-1, c), x.dtype, "geglu_mlp_bwd x")
    drows = _build.kernel_input(dy.reshape(-1, c), x.dtype, "geglu_mlp_bwd dy")
    if drows.shape != rows.shape:
        raise ValueError(f"geglu_mlp_bwd: dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    w1, b1, w2, _ = _kernel_weights(p, rows, "geglu_mlp_bwd")
    n = rows.shape[0]
    # In fp32 kernel G accumulates dx in the output itself, 32 rows a block.
    padded = n if x.dtype == torch.bfloat16 else -(-n // BWD_ROWS) * BWD_ROWS
    dx = torch.empty((padded, c), dtype=x.dtype, device=x.device)
    err = _build.lib().lvd_geglu_bwd(
        rows.data_ptr(), drows.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        dx.data_ptr(), n, c, w2.shape[0], int(GELU_FORM != "tanh"), code,
        _build.stream_of(rows))
    _build.check(err, "geglu_mlp_bwd")
    geglu_mlp_bwd.launches += 1
    return dx[:n].reshape(x.shape)


class Geglu(torch.autograd.Function):
    """Forward kernel C, backward kernel G in x (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, p):
        out = geglu_mlp_plain(p, x) if x.device.type == "cpu" else _launch_forward(p, x)
        ctx.save_for_backward(x)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return geglu_mlp_bwd(ctx.p, x, dy), None


def geglu_mlp(p, x):
    if _build.params_need_grad(p):
        if x.device.type != "cpu":
            raise RuntimeError("geglu_mlp: weight gradients come with the training slice "
                               "(ROADMAP A6)")
        return geglu_mlp_plain(p, x)
    return Geglu.apply(x, p)


geglu_mlp.launches = 0
geglu_mlp_bwd.launches = 0
