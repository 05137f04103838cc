"""Fused GroupNorm-apply + SiLU + (3,1,1) temporal conv: kernel D and its
plain version (counterpart of lvd_tpu/ops/temp_conv_fused.py).

``norm_silu_temporal_conv(x, a, b, conv_w, conv_b)`` takes the frames-major
(B, F, P, C) stream, the per-(batch, channel) GroupNorm affine (a, b) fp32
from ``ops.basic.group_norm_coeffs`` and the conv3d weight (3, 1, 1, C, C).
It is a ``torch.autograd.Function``: on a CUDA tensor the forward launches
kernel D (csrc/temp_conv.cu, replacing ``_fused``), on a CPU tensor it runs
``_unfused``. Kernel D has two forms on one frame-window implicit GEMM
(``launch_plan``): ``wgmma`` in bf16 and ``mma_sync`` (TF32) in fp32;
``norm_silu_temporal_conv.launches_by_form`` counts each. The plan (the
form, pixels a window, its first frame, the frame groups, a group's m64
tiles and window rows) is passed to the kernel, which refuses one it was
not built for; ``tap_rows`` derives the windows' index arithmetic from it,
which the CPU tests hold to lvd_tpu's kernel. Kernel D takes every shape
lvd_tpu's predicate routes to its kernel (``supported`` is
``lvd_tpu_routes``): any F, in frame groups of at most 32 frames, and any
C % 8 == 0. lvd_tpu has no Pallas backward here (its
``_stage_bwd`` is XLA's VJP of the unfused recompute), so the backward
recomputes ``_unfused``
with stock torch ops and returns the gradients of every input that needs
one: dx, da and db (a and b are GroupNorm statistics of x, so the latent
gradient flows through them too), and the weight and bias gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build


def _unfused(x, a, b, w, bias):
    """silu(x*a + b) in fp32, rounded to x's type, then the three
    frame-shifted (rows, C) products (zero outside [0, F)) plus bias — the
    same function as lvd_tpu's ``_unfused`` / ``_unfused_shifted``."""
    z = x.float() * a[:, None, None, :] + b[:, None, None, :]
    z = F.silu(z).to(x.dtype)
    w = w.to(x.dtype)
    y = z @ w[1]
    y[:, 1:] += z[:, :-1] @ w[0]
    y[:, :-1] += z[:, 1:] @ w[2]
    return y + bias.to(x.dtype)


FORMS = ("wgmma", "mma_sync")
PIXEL_TILE = 8  # pixels of one window: a frame is one 8-row, 1024-byte swizzle atom
START_FRAME = -1  # a window's first frame, relative to its group's first
MAX_GROUP = 32  # frames a group: four m64 tiles of accumulators in registers


def launch_plan(f: int, dtype) -> dict:
    """Kernel D's form and launch plan for F frames of this type, which the
    kernel checks: ``wgmma`` in bf16, ``mma_sync`` (TF32) in fp32, on the
    same windows of PIXEL_TILE pixels. The F output frames fall into
    ``frame_groups`` = ceil(F / 32) groups of ``frame_group`` = G =
    ceil(F / groups) frames (the last may hold fewer); the window of the
    group from frame f0 holds frames f0 + START_FRAME .. f0 + G
    (``loaded_rows`` = 8 (G + 2) rows loaded, zero outside [0, F)), its
    8 G output rows fill ``m_tiles`` m64 tiles, and it has ``window_rows``
    rows, so that every m64 tile's taps, which reach two frames past it,
    stay inside."""
    bf16 = dtype == torch.bfloat16
    groups = -(-f // MAX_GROUP)
    g = -(-f // groups)
    m_tiles = -(-PIXEL_TILE * g // 64)
    return {"form": "wgmma" if bf16 else "mma_sync", "code": 1 if bf16 else 2,
            "pixel_tile": PIXEL_TILE, "start_frame": START_FRAME, "frame_group": g,
            "frame_groups": groups, "m_tiles": m_tiles,
            "window_rows": 64 * m_tiles + 2 * PIXEL_TILE, "loaded_rows": PIXEL_TILE * (g + 2)}


def tap_rows(f: int):
    """(3, 64 * m_tiles) int tensor: the window row that output row r of a
    group (frame r // 8 of the group, pixel r % 8 of the tile) reads for tap
    k: r + 8 k, so tap k of m64 tile t is the window from row 64 t + 8 k
    on."""
    plan = launch_plan(f, torch.bfloat16)
    m = 64 * plan["m_tiles"]
    return torch.arange(m)[None, :] + plan["pixel_tile"] * torch.arange(3)[:, None]


def window_frames(f: int):
    """Per frame group, the frames its window holds (first to last,
    START_FRAME before the group to one past it): frames outside [0, F) are
    zero there."""
    plan = launch_plan(f, torch.bfloat16)
    g = plan["frame_group"]
    return [list(range(i * g + START_FRAME, i * g + g + 1))
            for i in range(plan["frame_groups"])]


def _block_p_for(c: int) -> int:
    """lvd_tpu's pixel block (temp_conv_fused.py:135-139)."""
    return 64 if c <= 384 else (32 if c <= 640 else 16)


def _block_co_for(c: int) -> int:
    """lvd_tpu's output-channel block (temp_conv_fused.py:142-150); 0 where
    it has none."""
    if c <= 640:
        return c
    return next((co for co in (256, 128, 64) if c % co == 0), 0)


def lvd_tpu_routes(x) -> bool:
    """lvd_tpu's predicate (temp_conv_fused.py:268-277) without its backend
    test: bf16 or fp32, C % 8 == 0, an output-channel block, and a
    (F, pixel block, C) tile of at most 4 MiB."""
    _, f, p, c = x.shape
    return (x.dtype in (torch.bfloat16, torch.float32) and c % 8 == 0
            and _block_co_for(c) > 0
            and f * min(p, _block_p_for(c)) * c * x.element_size() <= 4 * 1024 * 1024)


def supported(x) -> bool:
    """Kernel D wherever lvd_tpu routes its kernel; every other shape runs
    ``_unfused`` on stock ops, as lvd_tpu's runs its ``_unfused``."""
    return lvd_tpu_routes(x)


def norm_silu_temporal_conv_plain(x, a, b, conv_w, conv_b):
    w = conv_w.reshape(3, conv_w.shape[-2], conv_w.shape[-1])
    return _unfused(x, a, b, w, conv_b)


def _launch_forward(x, a, b, w, bias):
    """Kernel D on CUDA tensors; w is (3, C, C) in x's type."""
    _build.refuse_grad("norm_silu_temporal_conv", x, a, b, w, bias)
    c = x.shape[-1]
    code = _build.dtype_code(x, "norm_silu_temporal_conv")
    x = _build.kernel_input(x, x.dtype, "norm_silu_temporal_conv x")
    a = _build.kernel_input(a, torch.float32, "norm_silu_temporal_conv a")
    b = _build.kernel_input(b, torch.float32, "norm_silu_temporal_conv b")
    w = _build.kernel_input(w, x.dtype, "norm_silu_temporal_conv w")
    bias = _build.kernel_input(bias, x.dtype, "norm_silu_temporal_conv bias")
    bsz, f, p, _ = x.shape
    if w.shape != (3, c, c) or a.shape != (bsz, c) or b.shape != (bsz, c):
        raise ValueError(
            f"norm_silu_temporal_conv: x {tuple(x.shape)}, w {tuple(w.shape)}, a {tuple(a.shape)}")
    plan = launch_plan(f, x.dtype)
    out = torch.empty_like(x)
    err = _build.lib().lvd_temp_conv(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), bsz, f, p, c, plan["code"], plan["pixel_tile"], plan["start_frame"],
        plan["frame_group"], plan["frame_groups"], plan["m_tiles"], plan["window_rows"], code,
        _build.stream_of(x))
    _build.check(err, "norm_silu_temporal_conv")
    norm_silu_temporal_conv.launches += 1
    norm_silu_temporal_conv.launches_by_form[plan["form"]] += 1
    return out


class NormSiluTemporalConv(torch.autograd.Function):
    """Forward kernel D (``_unfused`` on the CPU); backward the stock-op VJP
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


def norm_silu_temporal_conv(x, a, b, conv_w, conv_b):
    w = conv_w.reshape(3, conv_w.shape[-2], conv_w.shape[-1]).to(x.dtype)
    return NormSiluTemporalConv.apply(x, a, b, w, conv_b.to(x.dtype))


norm_silu_temporal_conv.launches = 0
norm_silu_temporal_conv.launches_by_form = dict.fromkeys(FORMS, 0)
