"""3x3 stride-1 SAME conv on channels-last frames: kernel I without its
prologue (csrc/conv3x3.cu) and its plain version (counterpart of
lvd_tpu/ops/conv3x3.py).

``conv3x3(x, w)`` takes x (BF, H, W, C) and the HWIO weight (3, 3, C, N),
no bias. On CUDA tensors that ``supported`` (lvd_tpu's predicate without its
TPU-backend test) accepts it launches kernel I; on CUDA tensors it rejects,
it runs ``F.conv2d``, as lvd_tpu runs ``lax.conv_general_dilated`` there:
lvd_tpu's own route for those shapes. On CPU tensors it runs
``conv3x3_plain``. lvd_tpu does not route this entry point into the UNet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

_VMEM_BUDGET = 14 * 1024 * 1024  # lvd_tpu's budget: weights + halo window + acc + out
_BLOCK_ROWS = 8


def supported(x, w) -> bool:
    """lvd_tpu's predicate (conv3x3.py:96-112): H % 8 == 0, C and N multiples
    of 64, resident weights and a double-buffered halo window in budget."""
    if x.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        return False
    _, h, wd, c = x.shape
    n = w.shape[-1]
    if h % 8 or c % 64 or n % 64:
        return False
    item = x.element_size()
    weights = 9 * c * n * item
    window = 2 * (_BLOCK_ROWS + 2) * (wd + 2) * c * item
    acc = _BLOCK_ROWS * wd * n * 4
    out = 2 * _BLOCK_ROWS * wd * n * item
    return weights + window + acc + out <= _VMEM_BUDGET


def _conv_nhwc(x, w):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_plain(x, w):
    """Kernel I's plain version without prologue: the 3x3 SAME conv in x's
    type."""
    return _conv_nhwc(x, w)


def _launch(x, w):
    """Kernel I without prologue or bias on CUDA tensors; w is (3, 3, C, N)."""
    _build.refuse_grad("conv3x3", x, w)
    code = _build.dtype_code(x, "conv3x3")
    x = _build.kernel_input(x, x.dtype, "conv3x3 x")
    bf, h, wd, c = x.shape
    n = w.shape[-1]
    if tuple(w.shape) != (3, 3, c, n):
        raise ValueError(f"conv3x3: x {tuple(x.shape)}, w {tuple(w.shape)}")
    w9 = _build.kernel_input(w.reshape(9, c, n), x.dtype, "conv3x3 w")
    out = torch.empty((bf, h, wd, n), dtype=x.dtype, device=x.device)
    err = _build.lib().lvd_conv3x3(
        x.data_ptr(), None, None, w9.data_ptr(), None, out.data_ptr(),
        bf, h, wd, c, n, 0, code, _build.stream_of(x))
    _build.check(err, "conv3x3")
    conv3x3.launches += 1
    return out


def conv3x3(x, w):
    """3x3 stride-1 SAME NHWC conv: x (BF, H, W, C) * w (3, 3, C, N)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if not supported(x, w):
        return _conv_nhwc(x, w)  # lvd_tpu's lax.conv_general_dilated route
    return _launch(x, w)


conv3x3.launches = 0
