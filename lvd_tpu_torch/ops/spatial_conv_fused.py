"""Fused GroupNorm-apply + SiLU + 3x3 SAME conv: kernel I with its prologue
(csrc/conv3x3.cu) and its plain version (counterpart of
lvd_tpu/ops/spatial_conv_fused.py).

lvd_tpu routes a resnet's GroupNorm -> SiLU -> conv through ``_fused`` when
``LVD_ENABLE_FUSED_SC=1`` (models/unet3d._gn_silu_conv reads the switch)
and ``supported`` holds; ``supported`` and ``_block_co_for`` copy its
predicate without the TPU-backend test, so the same convs route here (the
CUDA kernel's tiles are its own). ``norm_silu_conv2d(x, a, b, conv_w,
conv_b)`` takes (N, H, W, Cin) frames, the per-(frame, channel) GroupNorm
affine (a, b) fp32 from ``ops.basic.group_norm_coeffs`` and the HWIO weight
(3, 3, Cin, Cout). It is a ``torch.autograd.Function``: on CUDA tensors the
forward launches kernel I, on CPU tensors it runs ``_unfused``. Its
backward is the stock VJP of ``_unfused`` recomputed, as lvd_tpu's is XLA's
VJP of the same function; it returns dx, da, db, dw and dbias, so the
latent gradient also flows through the GroupNorm statistics a and b. The
kernel's form follows ``conv3x3.launch_plan``, counted per form in
``norm_silu_conv2d.launches_by_form``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, conv3x3

_VMEM_BUDGET = 12 * 1024 * 1024  # lvd_tpu's working-set budget for one plane


def _block_co_for(rows: int, cin: int, cout: int, itemsize: int) -> int:
    """lvd_tpu's output-channel block (spatial_conv_fused.py:92-107): 0 when
    the plane does not fit its budget."""
    budget = _VMEM_BUDGET - rows * cin * itemsize * 3
    if budget <= 0:
        return 0
    for co in (cout, 512, 256, 128):
        if cout % co == 0 and (co == cout or co % 128 == 0) and (
                9 * cin * co * itemsize + 4 * rows * co + rows * co * itemsize <= budget):
            return co
    return 0


def supported(x, w) -> bool:
    """lvd_tpu's routing predicate (spatial_conv_fused.py:209-218)."""
    _, h, wdim, cin = x.shape
    cout = w.shape[-1]
    return (x.dtype in (torch.bfloat16, torch.float32) and cin % 8 == 0 and cout % 8 == 0
            and _block_co_for(h * wdim, cin, cout, x.element_size()) > 0)


def _unfused(x, a, b, w, bias):
    """silu(x * a + b) in fp32, rounded to x's type, then the 3x3 SAME conv
    in x's type plus bias (lvd_tpu's ``_unfused``); w is (9, Cin, Cout)."""
    z = x.float() * a[:, None, None, :] + b[:, None, None, :]
    z = F.silu(z).to(x.dtype)
    wk = w.to(x.dtype).reshape(3, 3, w.shape[-2], w.shape[-1]).permute(3, 2, 0, 1)
    y = F.conv2d(z.permute(0, 3, 1, 2), wk, padding=1).permute(0, 2, 3, 1)
    return y + bias.to(x.dtype)


def norm_silu_conv2d_plain(x, a, b, conv_w, conv_b):
    return _unfused(x, a, b, conv_w.reshape(9, conv_w.shape[-2], conv_w.shape[-1]), conv_b)


def _launch_forward(x, a, b, w, bias):
    """Kernel I with its prologue on CUDA tensors; w is (9, Cin, Cout)."""
    _build.refuse_grad("norm_silu_conv2d", x, a, b, w, bias)
    x = _build.kernel_input(x, x.dtype, "norm_silu_conv2d x")
    a = _build.kernel_input(a, torch.float32, "norm_silu_conv2d a")
    b = _build.kernel_input(b, torch.float32, "norm_silu_conv2d b")
    w = _build.kernel_input(w, x.dtype, "norm_silu_conv2d w")
    bias = _build.kernel_input(bias, x.dtype, "norm_silu_conv2d bias")
    n, cin, cout = x.shape[0], x.shape[-1], w.shape[-1]
    if x.dim() != 4 or w.shape != (9, cin, cout) or a.shape != (n, cin) or b.shape != (n, cin) \
            or bias.shape != (cout,):
        raise ValueError(f"norm_silu_conv2d: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"a {tuple(a.shape)}, bias {tuple(bias.shape)}")
    return conv3x3.launch(x, a, b, w, bias, "norm_silu_conv2d", norm_silu_conv2d)


class NormSiluConv2d(torch.autograd.Function):
    """Forward kernel I (``_unfused`` on the CPU); backward the stock-op VJP
    of ``_unfused`` recomputed, for every input that needs a gradient."""

    @staticmethod
    def forward(ctx, x, a, b, w, bias):
        out = _unfused(x, a, b, w, bias) if x.device.type == "cpu" else \
            _launch_forward(x, a, b, w, bias)
        ctx.save_for_backward(x, a, b, w, bias)
        return out

    @staticmethod
    def backward(ctx, dy):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
            y = _unfused(*leaves)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return tuple(next(grads) if n else None for n in need)


def norm_silu_conv2d(x, a, b, conv_w, conv_b):
    """Fused GN-apply + SiLU + 3x3 SAME conv on (N, H, W, Cin); conv_w is the
    HWIO weight (3, 3, Cin, Cout)."""
    w = conv_w.reshape(9, conv_w.shape[-2], conv_w.shape[-1]).to(x.dtype)
    return NormSiluConv2d.apply(x, a, b, w, conv_b.to(x.dtype))


norm_silu_conv2d.launches = 0
norm_silu_conv2d.launches_by_form = dict.fromkeys(conv3x3.FORMS, 0)
