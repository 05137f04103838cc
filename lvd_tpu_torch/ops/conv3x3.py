"""3x3 stride-1 SAME conv on channels-last frames: kernel I without its
prologue (csrc/conv3x3.cu) and its plain version (counterpart of
lvd_tpu/ops/conv3x3.py).

``conv3x3(x, w)`` takes x (BF, H, W, C) and the HWIO weight (3, 3, C, N),
no bias. On CUDA tensors that ``supported`` (lvd_tpu's predicate without its
TPU-backend test) accepts it launches kernel I; on CUDA tensors it rejects,
it runs ``F.conv2d``, as lvd_tpu runs ``lax.conv_general_dilated`` there:
lvd_tpu's own route for those shapes. On CPU tensors it runs
``conv3x3_plain``. lvd_tpu does not route this entry point into the UNet.

``launch_plan`` chooses kernel I's form for both of its wrappers (this one
and ``spatial_conv_fused``): the halo-window form (``wgmma`` in bf16,
``mma_sync`` in fp32) where Cin and Cout are multiples of 64 and the window
fits, else the ``wmma`` form. ``window_start`` and ``tap_window_rows`` are
the kernel's index arithmetic, which the CPU tests hold to lvd_tpu's conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

_VMEM_BUDGET = 14 * 1024 * 1024  # lvd_tpu's budget: weights + halo window + acc + out
_BLOCK_ROWS = 8

BLOCK_PIXELS = 128  # output pixels per block of the halo-window form (flattened over frames)
MAX_BOX_ROWS = 256  # rows of one TMA box
FORMS = ("wgmma", "mma_sync", "wmma")


def launch_plan(w: int, cin: int, cout: int, dtype) -> dict:
    """Kernel I's form and launch parameters for frames of width ``w``.

    The halo-window form takes Cin % 64 == 0 and Cout % 64 == 0 (every UNet
    conv and every conv3x3() shape) with a window of BLOCK_PIXELS + 2W + 2
    rows that fits two TMA boxes (W <= 191); it runs ``wgmma`` in bf16 and
    ``mma_sync`` in fp32. Every other width (Cin or Cout % 64 != 0, which
    only row 12's %8 predicate admits) takes the ``wmma`` form. The window
    is loaded as ``boxes`` boxes of ``box_rows`` rows (a multiple of 8, so
    the second box starts on a 1024-byte boundary); ``block_cout`` output
    channels per block (128 in bf16 where Cout % 128 == 0, else 64)."""
    rows = BLOCK_PIXELS + 2 * w + 2
    if cin % 64 or cout % 64 or rows > 2 * MAX_BOX_ROWS:
        return {"form": "wmma", "code": 0, "box_rows": 0, "boxes": 0, "block_cout": 64}
    boxes = 1 if rows <= MAX_BOX_ROWS else 2
    box_rows = -(-rows // (8 * boxes)) * 8  # ceil(rows / boxes), rounded up to 8
    bf16 = dtype == torch.bfloat16
    return {"form": "wgmma" if bf16 else "mma_sync", "code": 1, "window_rows": rows,
            "box_rows": box_rows, "boxes": boxes,
            "block_cout": 128 if bf16 and cout % 128 == 0 else 64}


def window_start(p0: int, w: int) -> int:
    """The flattened (N*H*W) row of window row 0 for the tile at pixel p0:
    the pixel a tap (-1, -1) of pixel p0 reads."""
    return p0 - w - 1


def tap_window_rows(p0: int, n: int, h: int, w: int):
    """(BLOCK_PIXELS, 9) int tensor: the window row that tap (dy, dx), tap =
    3 * (dy + 1) + (dx + 1), of pixel p0 + i reads, or -1 where the tap lies
    outside the pixel's frame (an H edge, a W edge that would wrap to the
    neighbouring row, a frame boundary) or p0 + i lies past the N frames;
    the kernel reads a zero row there."""
    i = torch.arange(BLOCK_PIXELS)
    p = p0 + i
    rem = p % (h * w)
    py, px = rem // w, rem % w
    cols = []
    for tap in range(9):
        dy, dx = tap // 3 - 1, tap % 3 - 1
        ok = (p < n * h * w) & (py + dy >= 0) & (py + dy < h) & (px + dx >= 0) & (px + dx < w)
        cols.append(torch.where(ok, i + (dy + 1) * w + (dx + 1), torch.full_like(i, -1)))
    return torch.stack(cols, dim=1)


def launch(x, a, b, w9, bias, name: str, counter):
    """Kernel I on CUDA tensors, in the form ``launch_plan`` chooses: x (N,
    H, W, Cin), w9 (9, Cin, Cout); with the prologue a and b are (N, Cin)
    fp32 (else None), bias (Cout,) or None. Counts the launch on
    ``counter`` (its ``launches`` and ``launches_by_form``)."""
    n, h, wd, cin = x.shape
    cout = w9.shape[-1]
    plan = launch_plan(wd, cin, cout, x.dtype)
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.lib().lvd_conv3x3(
        x.data_ptr(), ptr(a), ptr(b), w9.data_ptr(), ptr(bias), out.data_ptr(),
        n, h, wd, cin, cout, int(a is not None), plan["code"], plan["box_rows"], plan["boxes"],
        plan["block_cout"], _build.dtype_code(x, name), _build.stream_of(x))
    _build.check(err, name)
    counter.launches += 1
    counter.launches_by_form[plan["form"]] += 1
    return out


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
    x = _build.kernel_input(x, x.dtype, "conv3x3 x")
    c, n = x.shape[-1], w.shape[-1]
    if x.dim() != 4 or tuple(w.shape) != (3, 3, c, n):
        raise ValueError(f"conv3x3: x {tuple(x.shape)}, w {tuple(w.shape)}")
    w9 = _build.kernel_input(w.reshape(9, c, n), x.dtype, "conv3x3 w")
    return launch(x, None, None, w9, None, "conv3x3", conv3x3)


def conv3x3(x, w):
    """3x3 stride-1 SAME NHWC conv: x (BF, H, W, C) * w (3, 3, C, N)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if not supported(x, w):
        return _conv_nhwc(x, w)  # lvd_tpu's lax.conv_general_dilated route
    return _launch(x, w)


conv3x3.launches = 0
conv3x3.launches_by_form = dict.fromkeys(FORMS, 0)
