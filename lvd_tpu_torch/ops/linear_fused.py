"""Resident-weights linear: kernel H (csrc/linear.cu) and its plain version
(counterpart of lvd_tpu/ops/linear_fused.py).

lvd_tpu routes the q/k/v and output projections of its fused attention path
through ``_fused_rows`` when ``LVD_FUSED_LINEAR=1`` (ops/attention.py reads
the switch); ``supported`` copies its predicate without the TPU-backend
test, so the same projections route here. ``linear(p, x)`` flattens the
leading dims and runs ``LinearCore``, a ``torch.autograd.Function``: on CUDA
tensors the forward launches kernel H (bias always, zeros when the weight
has none, as lvd_tpu passes it), the backward takes dx through kernel H on
W^T (read transposed, no copy) where ``supported(W^T, dy)`` holds, else a
stock product, and dw and db as stock products, as lvd_tpu leaves them to
XLA. On CPU tensors both run their plain versions.

Kernel H has two forms, by element type (``kernel_form``): ``wgmma`` in
bf16 (K % 64 == 0) and ``mma_sync`` (TF32) in fp32 (K % 32 == 0), both with
N % 128 == 0, which lvd_tpu's predicate guarantees for the forward and the
dx call; ``linear_rows.launches_by_form`` counts each.
"""

from __future__ import annotations

import torch

from . import _build

MAX_WEIGHT_BYTES = 6 * 1024 * 1024  # lvd_tpu's VMEM budget for the resident weight


def supported(w, x) -> bool:
    """lvd_tpu's predicate (linear_fused.py:99-111): C % 128 == 0,
    N % 128 == 0 and C * N * itemsize <= 6 MB."""
    c, n = w.shape
    return (x.dim() >= 2 and x.shape[-1] == c and c % 128 == 0 and n % 128 == 0
            and c * n * x.element_size() <= MAX_WEIGHT_BYTES)


FORMS = ("wgmma", "mma_sync")
BLOCK_N = 128  # output columns per block of either form
BLOCK_K = {torch.bfloat16: 64, torch.float32: 32}  # K chunk of each form


def kernel_form(dtype, k: int, n: int):
    """Kernel H's form for an (R, k) x (k, n) product of this type, or None
    where it takes none (n % 128 or k % BLOCK_K)."""
    if dtype not in BLOCK_K or n % BLOCK_N or k % BLOCK_K[dtype]:
        return None
    return "wgmma" if dtype == torch.bfloat16 else "mma_sync"


def linear_plain(x, w, b=None):
    """x (R, C) @ w (C, N) (+ b), fp32 accumulation and the bias added
    before the one rounding to x's type (lvd_tpu's ``_linear_kernel``)."""
    y = x.float() @ w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def linear_rows(x, w, b=None, trans_w: bool = False):
    """x (R, K) @ w (+ b): w is (K, N), or (N, K) read as its transpose with
    ``trans_w``. Kernel H on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return linear_plain(x, w.transpose(0, 1) if trans_w else w, b)
    _build.refuse_grad("linear", x, w, *(() if b is None else (b,)))
    code = _build.dtype_code(x, "linear")
    x = _build.kernel_input(x, x.dtype, "linear x")
    w = _build.kernel_input(w, x.dtype, "linear w")
    b = None if b is None else _build.kernel_input(b, x.dtype, "linear b")
    r, k = x.shape
    n = w.shape[0] if trans_w else w.shape[1]
    form = kernel_form(x.dtype, k, n)
    if (w.shape[1] if trans_w else w.shape[0]) != k or (b is not None and b.shape != (n,)) \
            or form is None:
        raise ValueError(f"linear: x {tuple(x.shape)}, w {tuple(w.shape)} (trans_w={trans_w}); "
                         f"kernel H takes N % {BLOCK_N} == 0 and K % {BLOCK_K[x.dtype]} == 0")
    y = torch.empty((r, n), dtype=x.dtype, device=x.device)
    err = _build.lib().lvd_linear(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
        r, k, n, int(trans_w), code, _build.stream_of(x))
    _build.check(err, "linear")
    linear_rows.launches += 1
    linear_rows.launches_by_form[form] += 1
    return y


class LinearCore(torch.autograd.Function):
    """lvd_tpu's ``_linear_core``: forward kernel H; backward dx through
    kernel H on W^T where supported, dw = x^T dy and db = sum(dy) stock."""

    @staticmethod
    def forward(ctx, x2d, w, b):
        ctx.save_for_backward(x2d, w)
        return linear_rows(x2d, w, b)

    @staticmethod
    def backward(ctx, dy):
        x2d, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if supported(w.transpose(0, 1), dy):
                dx = linear_rows(dy, w, None, trans_w=True)
            else:
                dx = dy @ w.transpose(0, 1).to(dy.dtype)
        if ctx.needs_input_grad[1]:
            dw = (x2d.float().transpose(0, 1) @ dy.float()).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = dy.float().sum(0).to(w.dtype)
        return dx, dw, db


def linear(p, x):
    """Drop-in for ops.basic.linear on supported shapes: flattens the
    leading dims, runs ``LinearCore``, restores the shape."""
    w = p["w"].to(x.dtype)
    b = p.get("b")
    b = torch.zeros(w.shape[1], dtype=x.dtype, device=x.device) if b is None else b.to(x.dtype)
    y = LinearCore.apply(x.reshape(-1, x.shape[-1]), w, b)
    return y.reshape(*x.shape[:-1], w.shape[1])


def maybe_linear(p, x):
    """``linear`` where this weight fits the kernel, else the stock product
    (the per-weight check: cross-attention k/v project from C_enc)."""
    if supported(p["w"], x):
        return linear(p, x)
    from .basic import linear as base_linear

    return base_linear(p, x)


linear_rows.launches = 0
linear_rows.launches_by_form = dict.fromkeys(FORMS, 0)
