"""Fused GEGLU feed-forward: kernel C (resident forward), kernel J
(k-streaming forward), kernel G (dx-only backward) and their plain versions
(counterpart of lvd_tpu/ops/geglu_fused.py).

``geglu_mlp(p, x)`` computes ``(x W1h + b1h) * gelu(x W1g + b1g) W2 + b2`` on
(..., C) input with the standard ff params {"proj": {w, b}, "out": {w, b}}.
It is a ``torch.autograd.Function`` in x, routed as lvd_tpu routes it:
- forward: where lvd_tpu's ``_fused_rows`` takes its resident form and
  kernel C's template covers C, kernel C (csrc/geglu.cu, replacing
  ``_fused_rows_resident``); everywhere else kernel J (csrc/geglu_stream.cu,
  replacing the k-streaming branch of ``_fused_rows``);
- dx: where lvd_tpu's ``_fused_bwd`` takes its resident dx kernel, kernel G
  (csrc/geglu_bwd.cu, replacing ``_fused_rows_bwd_resident``; any width that
  route gives it); everywhere else the autograd VJP of ``_unfused`` on stock
  ops, lvd_tpu's own route.
On CPU tensors each kernel is replaced by its plain version. Weight
gradients are not part of this slice: on the card a parameter that requires
grad raises, on the CPU the plain formulation's autograd gives them.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import _build

# GELU form of the gate, the switch lvd_tpu reads (geglu_fused.py:28-37):
# "tanh" (default) or "exact" (erf, the torch reference's form).
GELU_FORM = os.environ.get("LVD_GELU_FORM", "tanh")

MAX_CHANNELS = 640  # the widest C of kernel C and of kernel G's resident form
BWD_ROWS = 32  # rows per block of kernel G
STREAM_INNER = 256  # kernel J's inner dim must be a multiple (lvd_tpu's block_k)


def _gelu(g):
    return F.gelu(g, approximate="tanh" if GELU_FORM == "tanh" else "none")


def _unfused(x, w1, b1, w2, b2):
    h = x @ w1 + b1.to(x.dtype)
    a, gate = h.chunk(2, dim=-1)
    return (a * _gelu(gate)) @ w2 + b2.to(x.dtype)


def _resident_form_ok(c, inner, itemsize, chunk_mod):
    """lvd_tpu's resident-weights gate (geglu_fused.py:184-191): w1h + w1g +
    w2 fit its 10 MiB weight budget and the inner dim chunks evenly
    (forward in 4s, backward in 8s)."""
    return 3 * c * inner * itemsize <= 10 * 1024 * 1024 and inner % chunk_mod == 0


def _covers(c, inner):
    """Whether kernel C, and kernel G's resident form, are built for this
    width (C = 64..640 in steps of 64, inner in 64-wide chunks); G takes
    every other width in a general form."""
    return c % 64 == 0 and 0 < c <= MAX_CHANNELS and inner % 64 == 0


def supported(w1, w2, x) -> bool:
    """lvd_tpu's routing predicate (geglu_fused.py:370-388) without its
    backend test: only where the resident form applies, so the element size
    counts (the fp32 C = 640 feed-forward stays on stock ops)."""
    c = x.shape[-1]
    inner = w2.shape[0]
    rows = x.numel() // c
    return (x.dtype in (torch.bfloat16, torch.float32)
            and inner % 256 == 0 and c % 8 == 0 and rows >= 2048
            and _resident_form_ok(c, inner, x.element_size(), 8))


def forward_kernel(c, inner, dtype) -> str:
    """"C" where lvd_tpu's ``_fused_rows`` takes its resident form (:203) and
    kernel C covers the width, else "J" (the k-streaming form)."""
    return "C" if _resident_form_ok(c, inner, dtype.itemsize, 4) and _covers(c, inner) else "J"


def dx_route(c, inner, dtype) -> str:
    """"G" where lvd_tpu's ``_fused_bwd`` takes its resident dx kernel
    (:350-364), else "stock" (the VJP of ``_unfused``)."""
    return "G" if _resident_form_ok(c, inner, dtype.itemsize, 8) else "stock"


def _weights(p, dtype):
    return [t.to(dtype) for t in (p["proj"]["w"], p["proj"]["b"], p["out"]["w"], p["out"]["b"])]


def geglu_mlp_plain(p, x):
    return _unfused(x, *_weights(p, x.dtype))


def geglu_stream_plain(p, x):
    """Kernel J's plain version, at the rounding points of lvd_tpu's
    ``_geglu_kernel``: h and g in fp32, the gated activation rounded to x's
    type, W2 accumulated in fp32 with b2, then cast to x's type."""
    w1, b1, w2, b2 = (t.float() for t in _weights(p, x.dtype))
    inner = w2.shape[0]
    hg = x.reshape(-1, x.shape[-1]).float() @ w1 + b1
    gated = (hg[:, :inner] * _gelu(hg[:, inner:])).to(x.dtype).float()
    return (gated @ w2 + b2).to(x.dtype).reshape(x.shape)


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


def geglu_stream(p, x):
    """Kernel J on a CUDA tensor: the k-streaming forward, for any row
    count, any C % 8 == 0 (wide C in output-column slices) and
    inner % 256 == 0."""
    _build.refuse_grad("geglu_stream", x)
    c = x.shape[-1]
    code = _build.dtype_code(x, "geglu_stream")
    rows = _build.kernel_input(x.reshape(-1, c), x.dtype, "geglu_stream x")
    w1, b1, w2, b2 = _kernel_weights(p, rows, "geglu_stream")
    inner = w2.shape[0]
    if c % 8 or inner % STREAM_INNER:
        raise ValueError(f"geglu_stream: C={c}, inner={inner}; kernel J takes C % 8 == 0 and "
                         f"inner % {STREAM_INNER} == 0 (lvd_tpu's streaming form raises on "
                         "such an inner too)")
    out = torch.empty_like(rows)
    err = _build.lib().lvd_geglu_stream(
        rows.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), rows.shape[0], c, inner, int(GELU_FORM != "tanh"), code,
        _build.stream_of(rows))
    _build.check(err, "geglu_stream")
    geglu_stream.launches += 1
    return out.reshape(x.shape)


def geglu_mlp_bwd(p, x, dy):
    """dx: kernel G on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return geglu_mlp_bwd_plain(p, x, dy)
    _build.refuse_grad("geglu_mlp_bwd", x, dy)
    c, inner = x.shape[-1], p["out"]["w"].shape[0]
    code = _build.dtype_code(x, "geglu_mlp_bwd")
    rows = _build.kernel_input(x.reshape(-1, c), x.dtype, "geglu_mlp_bwd x")
    drows = _build.kernel_input(dy.reshape(-1, c), x.dtype, "geglu_mlp_bwd dy")
    if drows.shape != rows.shape:
        raise ValueError(f"geglu_mlp_bwd: dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    w1, b1, w2, _ = _kernel_weights(p, rows, "geglu_mlp_bwd")
    n = rows.shape[0]
    # In fp32 kernel G's resident form accumulates dx in the output itself,
    # 32 rows a block; every other width writes dx rows directly.
    resident_fp32 = x.dtype == torch.float32 and _covers(c, inner)
    padded = -(-n // BWD_ROWS) * BWD_ROWS if resident_fp32 else n
    dx = torch.empty((padded, c), dtype=x.dtype, device=x.device)
    err = _build.lib().lvd_geglu_bwd(
        rows.data_ptr(), drows.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        dx.data_ptr(), n, c, w2.shape[0], int(GELU_FORM != "tanh"), code,
        _build.stream_of(rows))
    _build.check(err, "geglu_mlp_bwd")
    geglu_mlp_bwd.launches += 1
    return dx[:n].reshape(x.shape)


def _unfused_dx(p, x, dy):
    """dx where lvd_tpu has no dx kernel: the VJP of ``_unfused``."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(_unfused(leaf, *_weights(p, x.dtype)), leaf, dy)
    return dx


class Geglu(torch.autograd.Function):
    """Forward kernel C or J, dx kernel G or the stock VJP, as lvd_tpu
    routes them (plain versions of the kernels on the CPU)."""

    @staticmethod
    def forward(ctx, x, p):
        resident = forward_kernel(x.shape[-1], p["out"]["w"].shape[0], x.dtype) == "C"
        if x.device.type == "cpu":
            out = geglu_mlp_plain(p, x) if resident else geglu_stream_plain(p, x)
        else:
            out = _launch_forward(p, x) if resident else geglu_stream(p, x)
        ctx.save_for_backward(x)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        if dx_route(x.shape[-1], ctx.p["out"]["w"].shape[0], x.dtype) == "G":
            return geglu_mlp_bwd(ctx.p, x, dy), None
        return _unfused_dx(ctx.p, x, dy), None


def geglu_mlp(p, x):
    if _build.params_need_grad(p):
        if x.device.type != "cpu":
            raise RuntimeError("geglu_mlp: weight gradients come with the training slice "
                               "(ROADMAP A6)")
        return geglu_mlp_plain(p, x)
    return Geglu.apply(x, p)


geglu_mlp.launches = 0
geglu_stream.launches = 0
geglu_mlp_bwd.launches = 0
