"""Kernel selfcheck on the card (counterpart of lvd_tpu/ops/selfcheck.py).

Every kernel of the guided Zeroscope path, with and without lvd_tpu's two
opt-in switches, runs at every shape that path gives it, in bf16, and is
held to its plain PyTorch version run on fp32 copies of the same inputs,
with lvd_tpu's selfcheck gate: max|kernel - plain| / max|plain| <= 2e-2, or
4.5e-2 for the temporal pair and its backward (lvd_tpu/ops/selfcheck.py:28,
441-445). The forwards A-D and the resnet convs (kernel I with its
prologue, row 12) run at the shapes of the 576x320, 24-frame CFG forward
(batch 2 x 24); the projections (kernel H, row 14) at the q/k/v/out and
text k/v shapes, with the dx call of their backward; the backwards E-G at
the shapes of the guided energy walk (the cond-only UNet walk of batch 24
down to the last captured site). The public entry points conv3x3() (kernel
I without prologue, row 13) and sdpa() (kernel A with one head, row 1, and
E in its backward; D = 192 and 256 in their D-sliced form) run at L0-sized
shapes; kernel J (row 9), which the public geglu_mlp() runs where lvd_tpu's
``_fused_rows`` streams its weights, at the feed-forward shapes of that
branch (C = 1280 in bf16; C = 640 and 1280 in fp32). A backward is checked on
each of its outputs (dq, dk and dv for E; dq alone where the walk asks for no
dk/dv, at the text cross-attention).

Each kernel also runs in fp32 at its largest path shape, against the plain
version in fp32 with TF32 off, gated at 5e-3 and below the same shape's
bf16 reading, so a kernel that rounded fp32 to bf16 would fail. Every
reference runs with ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` off.

Each shape is also timed with CUDA events: the kernel, the plain version
on the same inputs, and where one PyTorch call computes the same function
(``scaled_dot_product_attention`` and its backward for A, E and sdpa,
``F.conv2d`` for kernel I, ``torch.addmm`` for H) that call as a yardstick
(the port never calls it). ``bound_ms`` is the least time the card could
take: the larger of the operations over the tensor-core peak of the type
(bf16, or TF32 for fp32) and the bytes (each input read once, each output
written once) over the memory rate. ``run()`` is called by chip_smoke.py
and tests/test_torch_gpu.py.
"""

from __future__ import annotations

import contextlib
import json

import torch
import torch.nn.functional as F

from . import (attention, conv3x3, geglu_fused, linear_fused, packed_attention,
               spatial_conv_fused, temp_conv_fused, temporal_attention)

# NVIDIA H100 SXM data sheet, dense: tensor-core peaks and the HBM3 rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}  # fp32 products run in TF32
PEAK_BYTES_PER_S = 3.35e12

DEFAULT_TOL = 2e-2
PAIR_TOL = 4.5e-2
FP32_TOL = 5e-3

# The shapes the 576x320, 24-frame CFG forward gives each kernel.
ATTN_SHAPES = [  # (batch, S_q, S_k, C): self-attention at L0/L1, cross at every level
    (48, 2880, 2880, 320), (48, 720, 720, 640),
    (48, 2880, 77, 320), (48, 720, 77, 640), (48, 180, 77, 1280), (48, 45, 77, 1280),
    (48, 180, 180, 1280), (48, 45, 45, 1280),
]
PAIR_SHAPES = [(2, 24, 2880, 320), (2, 24, 2880, 512), (2, 24, 720, 640)]  # (B, F, P, C)
GEGLU_SHAPES = [(138240, 320), (138240, 512), (34560, 640)]  # (rows, C), inner = 4C
TCONV_SHAPES = [(2, 24, 2880, 320), (2, 24, 720, 640), (2, 24, 180, 1280), (2, 24, 45, 1280)]
# Resnet convs spatial_conv_fused.supported routes in bf16: (N, H, W, Cin, Cout).
SCONV_SHAPES = (
    [(48, 20, 36, cin, 640) for cin in (320, 640, 960, 1280)]
    + [(48, 10, 18, cin, 1280) for cin in (640, 1280, 1920, 2560)]
    + [(48, 5, 9, cin, 1280) for cin in (1280, 2560)])
# Projections linear_fused.supported routes: (rows, C, N); q/k/v/out at L1
# and L2, the text k/v (48 x 77 rows, 1024 -> 640 or 1280).
LINEAR_SHAPES = [(34560, 640, 640), (8640, 1280, 1280), (3696, 1024, 640),
                 (3696, 1024, 1280)]
# The public entry points: conv3x3() at the L0 resnet widths, sdpa() (B, H, S, D).
CONV3X3_SHAPES = [(48, 40, 72, cin, 320) for cin in (320, 640, 960)]
SDPA_SHAPES = [(48, 5, 2880, 64), (8, 4, 1024, 128), (8, 4, 1024, 192), (8, 4, 1024, 256)]
# Kernel J (rows, C), inner = 4C, where lvd_tpu's _fused_rows streams: in bf16
# the L2 feed-forward of the CFG forward (2 x 24 x 180 rows), L3, and the L2
# of the cond-only guided walk; in fp32 (the pipeline's default) L1 and L2.
# (34560, 640) runs in bf16 too, as the reading its fp32 check must beat.
GEGLU_STREAM_SHAPES = [(8640, 1280), (2160, 1280), (4320, 1280), (34560, 640)]
GEGLU_STREAM_FP32_SHAPES = [(34560, 640), (8640, 1280)]
# The shapes the guided energy walk's backward gives each backward kernel.
ATTN_BWD_SHAPES = [  # (batch, S_q, S_k, C): self-attention at every level, uncaptured cross
    (24, 2880, 2880, 320), (24, 720, 720, 640), (24, 180, 180, 1280), (24, 45, 45, 1280),
    (24, 2880, 77, 320), (24, 720, 77, 640), (24, 180, 77, 1280), (24, 45, 77, 1280),
]
PAIR_BWD_SHAPES = [(1, 24, 2880, 320), (1, 24, 2880, 512), (1, 24, 720, 640)]
GEGLU_BWD_SHAPES = [(69120, 320), (69120, 512), (17280, 640)]

_A = "lvd_tpu/ops/pallas_attention.py"
SOURCES = {  # kernel wrapper -> (CUDA source, the TPU kernels it replaces)
    "attention_packed": ("lvd_tpu_torch/csrc/packed_attention.cu",
                         f"{_A}:135 _pallas_attention_heads; {_A}:540 _pallas_attention_shortkey"),
    "temporal_attention_pair": ("lvd_tpu_torch/csrc/temporal_attention.cu",
                                "lvd_tpu/ops/temporal_attention.py:282 _pallas_pair"),
    "geglu_mlp": ("lvd_tpu_torch/csrc/geglu.cu",
                  "lvd_tpu/ops/geglu_fused.py:159 _fused_rows_resident"),
    "norm_silu_temporal_conv": ("lvd_tpu_torch/csrc/temp_conv.cu",
                                "lvd_tpu/ops/temp_conv_fused.py:153 _fused"),
    "attention_packed_bwd": ("lvd_tpu_torch/csrc/packed_attention_bwd.cu",
                             f"{_A}:235 _pallas_attention_bwd; {_A}:348 _pallas_attention_bwd_heads"),
    "temporal_attention_pair_bwd": ("lvd_tpu_torch/csrc/temporal_attention_bwd.cu",
                                    "lvd_tpu/ops/temporal_attention.py:348 _pallas_pair_bwd"),
    "geglu_mlp_bwd": ("lvd_tpu_torch/csrc/geglu_bwd.cu",
                      "lvd_tpu/ops/geglu_fused.py:299 _fused_rows_bwd_resident"),
    "linear": ("lvd_tpu_torch/csrc/linear.cu", "lvd_tpu/ops/linear_fused.py:69 _fused_rows"),
    "norm_silu_conv2d": ("lvd_tpu_torch/csrc/conv3x3.cu",
                         "lvd_tpu/ops/spatial_conv_fused.py:110 _fused"),
    "conv3x3": ("lvd_tpu_torch/csrc/conv3x3.cu", "lvd_tpu/ops/conv3x3.py:64 _conv3x3_pallas"),
    "sdpa": ("lvd_tpu_torch/csrc/packed_attention.cu", f"{_A}:109 _pallas_attention"),
    "geglu_stream": ("lvd_tpu_torch/csrc/geglu_stream.cu",
                     "lvd_tpu/ops/geglu_fused.py:194 _fused_rows"),
}


def time_ms(fn, warmup: int = 2, iters: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def exact_fp32():
    """fp32 products and convolutions in full fp32 (cuDNN runs fp32 convs in
    TF32 by default), for the references."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def bound(flops: float, nbytes: float, dtype=torch.bfloat16):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _rel_err(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def _randn(gen, shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32) * scale


def _linear_p(gen, din, dout, bias=True):
    p = {"w": _randn(gen, (din, dout), din ** -0.5)}
    if bias:
        p["b"] = _randn(gen, (dout,), 0.1)
    return p


def _norm_p(gen, c):
    return {"scale": 1.0 + _randn(gen, (c,), 0.1), "bias": _randn(gen, (c,), 0.1)}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _ref(fn, *args):
    """The plain version on fp32 copies of the inputs, TF32 off."""
    with exact_fp32():
        return fn(*(_cast(a, torch.float32) if isinstance(a, (dict, torch.Tensor)) else a
                    for a in args))


def _record(name, shape, dtype, out, ref, tol, ms, plain_ms, flops, nbytes, library_ms=None):
    """One check's record; ``out`` and ``ref`` may be tuples (a backward's
    outputs), each held to the gate on its own."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    errs = [_rel_err(o, r) for o, r in zip(outs, refs)]
    err = max(e for e, _ in errs)
    rel = max(r for _, r in errs)
    finite = all(torch.isfinite(o).all().item() for o in outs)
    if dtype == torch.float32:
        tol = FP32_TOL
    b_ms, b_by = bound(flops, nbytes, dtype)
    return {"name": name, "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "rel_err": rel, "tol": tol, "ok": bool(rel <= tol and finite),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}


def check_attention(gen, shape, dtype=torch.bfloat16):
    b, s_q, s_k, c = shape
    heads = c // 64
    q, k, v = (_randn(gen, (b, s, c)).to(dtype) for s in (s_q, s_k, s_k))
    scale = 64 ** -0.5
    out = packed_attention.attention_packed(q, k, v, scale, heads)
    ref = _ref(packed_attention.attention_packed_plain, q, k, v, scale, heads)
    ms = time_ms(lambda: packed_attention.attention_packed(q, k, v, scale, heads))
    plain_ms = time_ms(lambda: packed_attention.attention_packed_plain(q, k, v, scale, heads),
                       1, 2)
    split = lambda t: t.view(b, t.shape[1], heads, 64).transpose(1, 2)
    qh, kh, vh = split(q), split(k), split(v)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
    flops = 4.0 * b * heads * s_q * s_k * 64
    nbytes = q.element_size() * (2 * b * s_q * c + 2 * b * s_k * c)
    return _record("attention_packed", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms, flops,
                   nbytes, lib_ms)


def _pair_params(gen, c):
    attn = lambda: {n: _linear_p(gen, c, c, bias=False) for n in ("to_q", "to_k", "to_v")} | {
        "to_out": _linear_p(gen, c, c)}
    return {"norm1": _norm_p(gen, c), "attn1": attn(), "norm2": _norm_p(gen, c), "attn2": attn()}


def check_pair(gen, shape, dtype=torch.bfloat16):
    b, f, pdim, c = shape
    heads = c // 64
    p = _cast(_pair_params(gen, c), dtype)
    y = _randn(gen, shape).to(dtype)
    fn = lambda: temporal_attention.temporal_attention_pair(p, y, heads, 1e-5, frames_major=True)
    out = fn()
    ref = _ref(temporal_attention._pair_ref_fm, p, y, heads, 1e-5)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: temporal_attention._pair_ref_fm(p, y, heads, 1e-5), 1, 2)
    rows = b * f * pdim
    flops = 2 * (2.0 * rows * c * 4 * c + 4.0 * rows * f * c)
    nbytes = y.element_size() * (2 * rows * c + 2 * 4 * c * c) + 4.0 * 2 * 3 * c
    return _record("temporal_attention_pair", shape, dtype, out, ref, PAIR_TOL, ms, plain_ms,
                   flops, nbytes)


def _geglu_args(pp, xx):
    return xx, pp["proj"]["w"], pp["proj"]["b"], pp["out"]["w"], pp["out"]["b"]


def check_geglu(gen, shape, dtype=torch.bfloat16):
    rows, c = shape
    inner = 4 * c
    p = _cast({"proj": _linear_p(gen, c, 2 * inner), "out": _linear_p(gen, inner, c)}, dtype)
    x = _randn(gen, (rows, c)).to(dtype)
    out = geglu_fused.geglu_mlp(p, x)
    ref = _ref(lambda pp, xx: geglu_fused._unfused(*_geglu_args(pp, xx)), p, x)
    ms = time_ms(lambda: geglu_fused.geglu_mlp(p, x))
    plain_ms = time_ms(lambda: geglu_fused._unfused(*_geglu_args(p, x)), 1, 2)
    flops = 6.0 * rows * c * inner
    nbytes = x.element_size() * (2 * rows * c + 3 * c * inner + 2 * inner + c)
    return _record("geglu_mlp", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms, flops, nbytes)


def check_geglu_stream(gen, shape, dtype=torch.bfloat16):
    """Kernel J, launched directly (the public geglu_mlp() routes to it
    wherever lvd_tpu's _fused_rows streams)."""
    rows, c = shape
    inner = 4 * c
    p = _cast({"proj": _linear_p(gen, c, 2 * inner), "out": _linear_p(gen, inner, c)}, dtype)
    x = _randn(gen, (rows, c)).to(dtype)
    fn = lambda: geglu_fused.geglu_stream(p, x)
    out = _launched(geglu_fused.geglu_stream, fn)
    ref = _ref(geglu_fused.geglu_stream_plain, p, x)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: geglu_fused.geglu_stream_plain(p, x), 1, 2)
    flops = 6.0 * rows * c * inner
    nbytes = x.element_size() * (2 * rows * c + 3 * c * inner + 2 * inner + c)
    return _record("geglu_stream", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms, flops,
                   nbytes)


def check_temp_conv(gen, shape, dtype=torch.bfloat16):
    b, f, pdim, c = shape
    x = _randn(gen, shape).to(dtype)
    a = 1.0 + _randn(gen, (b, c), 0.1)
    sh = _randn(gen, (b, c), 0.1)
    w = _randn(gen, (3, 1, 1, c, c), (3 * c) ** -0.5).to(dtype)
    bias = _randn(gen, (c,), 0.1).to(dtype)
    fn = lambda: temp_conv_fused.norm_silu_temporal_conv(x, a, sh, w, bias)
    out = fn()
    ref = _ref(temp_conv_fused.norm_silu_temporal_conv_plain, x, a, sh, w, bias)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: temp_conv_fused.norm_silu_temporal_conv_plain(x, a, sh, w, bias),
                       1, 2)
    n = b * f * pdim
    flops = 6.0 * n * c * c
    nbytes = x.element_size() * (2 * n * c + 3 * c * c + c) + 4.0 * 2 * b * c
    return _record("norm_silu_temporal_conv", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms,
                   flops, nbytes)


def check_attention_bwd(gen, shape, dtype=torch.bfloat16):
    b, s_q, s_k, c = shape
    heads = c // 64
    q, k, v = (_randn(gen, (b, s, c)).to(dtype) for s in (s_q, s_k, s_k))
    do = _randn(gen, (b, s_q, c)).to(dtype)
    scale = 64 ** -0.5
    # Kernel E reads the log-sum-exp kernel A writes for it.
    o, lse = packed_attention.attention_packed_with_lse(q, k, v, scale, heads)
    # The energy walk needs dk/dv at self-attention only (cross-attention
    # keys come from the text); check and time the call the walk makes.
    need_kv = s_q == s_k
    fn = lambda: packed_attention.attention_packed_bwd(q, k, v, o, do, scale, heads, need_kv,
                                                       lse=lse)
    out = fn()
    ref = _ref(packed_attention.attention_packed_bwd_plain, q, k, v, o, do, scale, heads)
    if not need_kv:
        out, ref = out[:1], ref[:1]
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: packed_attention.attention_packed_bwd_plain(
        q, k, v, o, do, scale, heads), 1, 2)
    split = lambda t: t.view(b, t.shape[1], heads, 64).transpose(1, 2).detach()
    qh, kh, vh = (split(t).requires_grad_(need) for t, need in
                  ((q, True), (k, need_kv), (v, need_kv)))
    with torch.enable_grad():
        sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    wanted = [t for t in (qh, kh, vh) if t.requires_grad]
    lib_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, wanted, split(do),
                                                 retain_graph=True))
    products = 5 if need_kv else 3  # QK^T, dO V^T, dS K (+ P^T dO, dS^T Q)
    flops = 2.0 * products * b * s_q * s_k * c
    nbytes = q.element_size() * (3 * b * s_q * c + (2 * b * s_k * c) * (2 if need_kv else 1)
                                 + b * s_q * c)
    return _record("attention_packed_bwd", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms,
                   flops, nbytes, lib_ms)


def check_pair_bwd(gen, shape, dtype=torch.bfloat16):
    b, f, pdim, c = shape
    heads = c // 64
    p = _cast(_pair_params(gen, c), dtype)
    y = _randn(gen, shape).to(dtype)
    dy = _randn(gen, shape).to(dtype)
    plain = lambda pp, yy, dd: temporal_attention.temporal_attention_pair_bwd_plain(
        pp, yy, dd, heads, 1e-5, frames_major=True)
    fn = lambda: temporal_attention.temporal_attention_pair_bwd(p, y, dy, heads, 1e-5,
                                                                frames_major=True)
    out = fn()
    ref = _ref(plain, p, y, dy)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: plain(p, y, dy), 1, 2)
    rows = b * f * pdim
    # Forward recompute (qkv1, attn1, out1, qkv2) and two attention VJPs
    # (dO, scores, dV, dP, dQ, dK, dz): 30 C^2 + 24 F C operations a row.
    flops = rows * (30.0 * c * c + 24.0 * f * c)
    nbytes = y.element_size() * (3 * rows * c + 2 * 4 * c * c) + 4.0 * 2 * 3 * c
    return _record("temporal_attention_pair_bwd", shape, dtype, out, ref, PAIR_TOL, ms, plain_ms,
                   flops, nbytes)


def check_geglu_bwd(gen, shape, dtype=torch.bfloat16):
    rows, c = shape
    inner = 4 * c
    p = _cast({"proj": _linear_p(gen, c, 2 * inner), "out": _linear_p(gen, inner, c)}, dtype)
    x = _randn(gen, (rows, c)).to(dtype)
    dy = _randn(gen, (rows, c)).to(dtype)
    out = geglu_fused.geglu_mlp_bwd(p, x, dy)
    ref = _ref(geglu_fused.geglu_mlp_bwd_plain, p, x, dy)
    ms = time_ms(lambda: geglu_fused.geglu_mlp_bwd(p, x, dy))
    plain_ms = time_ms(lambda: geglu_fused.geglu_mlp_bwd_plain(p, x, dy), 1, 2)
    flops = 10.0 * rows * c * inner  # h, g, d_inner and the two halves of dx
    nbytes = x.element_size() * (3 * rows * c + 3 * c * inner + 2 * inner)
    return _record("geglu_mlp_bwd", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms, flops,
                   nbytes)


def _launched(wrapper, fn):
    """Runs fn and raises unless it launched ``wrapper``'s kernel once."""
    before = wrapper.launches
    out = fn()
    if wrapper.launches != before + 1:
        raise RuntimeError(f"{wrapper.__name__}: the call did not launch its kernel")
    return out


def _nchw_conv(x, w, bias=None):
    """F.conv2d on a channels-last view (cuDNN), the yardstick of kernel I."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias, padding=1)


def check_spatial_conv(gen, shape, dtype=torch.bfloat16):
    n, h, w_, cin, cout = shape
    x = _randn(gen, (n, h, w_, cin)).to(dtype)
    a = 1.0 + _randn(gen, (n, cin), 0.1)
    sh = _randn(gen, (n, cin), 0.1)
    w = _randn(gen, (3, 3, cin, cout), (9 * cin) ** -0.5).to(dtype)
    bias = _randn(gen, (cout,), 0.1).to(dtype)
    if not spatial_conv_fused.supported(x, w):
        raise RuntimeError(f"norm_silu_conv2d: {shape} {dtype} is not a routed shape")
    fn = lambda: spatial_conv_fused.norm_silu_conv2d(x, a, sh, w, bias)
    out = _launched(spatial_conv_fused.norm_silu_conv2d, fn)
    ref = _ref(spatial_conv_fused.norm_silu_conv2d_plain, x, a, sh, w, bias)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: spatial_conv_fused.norm_silu_conv2d_plain(x, a, sh, w, bias),
                       1, 2)
    lib_ms = time_ms(lambda: _nchw_conv(x, w, bias))
    pix = n * h * w_
    flops = 18.0 * pix * cin * cout
    nbytes = x.element_size() * (pix * (cin + cout) + 9 * cin * cout + cout) + 4.0 * 2 * n * cin
    return _record("norm_silu_conv2d", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms, flops,
                   nbytes, lib_ms)


def check_conv3x3(gen, shape, dtype=torch.bfloat16):
    n, h, w_, cin, cout = shape
    x = _randn(gen, (n, h, w_, cin)).to(dtype)
    w = _randn(gen, (3, 3, cin, cout), (9 * cin) ** -0.5).to(dtype)
    if not conv3x3.supported(x, w):
        raise RuntimeError(f"conv3x3: {shape} {dtype} is not a routed shape")
    fn = lambda: conv3x3.conv3x3(x, w)
    out = _launched(conv3x3.conv3x3, fn)
    ref = _ref(conv3x3.conv3x3_plain, x, w)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: conv3x3.conv3x3_plain(x, w), 1, 2)
    lib_ms = time_ms(lambda: _nchw_conv(x, w))
    pix = n * h * w_
    flops = 18.0 * pix * cin * cout
    nbytes = x.element_size() * (pix * (cin + cout) + 9 * cin * cout)
    return _record("conv3x3", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms, flops, nbytes,
                   lib_ms)


def check_linear(gen, shape, dtype=torch.bfloat16):
    """The forward projection and the dx call of its backward (W read
    transposed), each a record of kernel H."""
    rows, c, n = shape
    x = _randn(gen, (rows, c)).to(dtype)
    w = _randn(gen, (c, n), c ** -0.5).to(dtype)
    b = _randn(gen, (n,), 0.1).to(dtype)
    dy = _randn(gen, (rows, n)).to(dtype)
    item = x.element_size()
    fwd = lambda: linear_fused.linear_rows(x, w, b)
    out = _launched(linear_fused.linear_rows, fwd)
    ref = _ref(linear_fused.linear_plain, x, w, b)
    records = [_record(
        "linear", shape, dtype, out, ref, DEFAULT_TOL, time_ms(fwd),
        time_ms(lambda: linear_fused.linear_plain(x, w, b), 1, 2), 2.0 * rows * c * n,
        item * (rows * c + c * n + n + rows * n), time_ms(lambda: torch.addmm(b, x, w)))]
    bwd = lambda: linear_fused.linear_rows(dy, w, None, trans_w=True)
    out = _launched(linear_fused.linear_rows, bwd)
    ref = _ref(lambda dd, ww: linear_fused.linear_plain(dd, ww.transpose(0, 1)), dy, w)
    records.append(_record(
        "linear", [rows, n, c, "dx"], dtype, out, ref, DEFAULT_TOL, time_ms(bwd),
        time_ms(lambda: linear_fused.linear_plain(dy, w.transpose(0, 1)), 1, 2),
        2.0 * rows * c * n, item * (rows * n + c * n + rows * c),
        time_ms(lambda: torch.matmul(dy, w.transpose(0, 1)))))
    return records


def check_sdpa(gen, shape, dtype=torch.bfloat16):
    """The public sdpa() with long keys, forward (kernel A, one head) and
    backward (kernel E), through autograd."""
    b, h, s, d = shape
    q, k, v = (_randn(gen, shape).to(dtype).requires_grad_(True) for _ in range(3))
    do = _randn(gen, shape).to(dtype)
    scale = d ** -0.5
    flat = lambda t: t.detach().reshape(b * h, s, d)
    with torch.no_grad():
        out = _launched(packed_attention.attention_packed, lambda: attention.sdpa(q, k, v)[0])
    with torch.enable_grad():
        o_graph = attention.sdpa(q, k, v)[0]
    grads = _launched(packed_attention.attention_packed_bwd,
                      lambda: torch.autograd.grad(o_graph, (q, k, v), do, retain_graph=True))
    ref_o = _ref(packed_attention.attention_packed_plain, flat(q), flat(k), flat(v), scale, 1)
    ref_g = _ref(packed_attention.attention_packed_bwd_plain, flat(q), flat(k), flat(v),
                 flat(o_graph), flat(do), scale, 1)
    item = q.element_size()
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: attention.sdpa(qd, kd, vd))
        plain_ms = time_ms(lambda: packed_attention.attention_packed_plain(
            flat(q), flat(k), flat(v), scale, 1), 1, 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, scale=scale))
    records = [_record("sdpa", shape, dtype, out.reshape(b * h, s, d), ref_o, DEFAULT_TOL,
                       fwd_ms, plain_ms, 4.0 * b * h * s * s * d, item * 4 * b * h * s * d,
                       lib_ms)]
    bwd_ms = time_ms(lambda: torch.autograd.grad(o_graph, (q, k, v), do, retain_graph=True))
    plain_bwd_ms = time_ms(lambda: packed_attention.attention_packed_bwd_plain(
        flat(q), flat(k), flat(v), flat(o_graph), flat(do), scale, 1), 1, 2)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                     retain_graph=True))
    records.append(_record(
        "sdpa_bwd", shape, dtype, tuple(g.reshape(b * h, s, d) for g in grads), ref_g,
        DEFAULT_TOL, bwd_ms, plain_bwd_ms, 10.0 * b * h * s * s * d, item * 8 * b * h * s * d,
        lib_bwd_ms))
    return records


BF16_PLAN = ([(check_attention, s) for s in ATTN_SHAPES]
             + [(check_pair, s) for s in PAIR_SHAPES]
             + [(check_geglu, s) for s in GEGLU_SHAPES]
             + [(check_temp_conv, s) for s in TCONV_SHAPES]
             + [(check_attention_bwd, s) for s in ATTN_BWD_SHAPES]
             + [(check_pair_bwd, s) for s in PAIR_BWD_SHAPES]
             + [(check_geglu_bwd, s) for s in GEGLU_BWD_SHAPES]
             + [(check_linear, s) for s in LINEAR_SHAPES]
             + [(check_spatial_conv, s) for s in SCONV_SHAPES]
             + [(check_conv3x3, s) for s in CONV3X3_SHAPES]
             + [(check_sdpa, s) for s in SDPA_SHAPES]
             + [(check_geglu_stream, s) for s in GEGLU_STREAM_SHAPES])
# Each kernel in fp32 at its first (largest) path shape, sdpa() at every head
# dim, and kernel J at its fp32 shapes.
FP32_PLAN = [(fn, shapes[0]) for fn, shapes in (
    (check_attention, ATTN_SHAPES), (check_pair, PAIR_SHAPES), (check_geglu, GEGLU_SHAPES),
    (check_temp_conv, TCONV_SHAPES), (check_attention_bwd, ATTN_BWD_SHAPES),
    (check_pair_bwd, PAIR_BWD_SHAPES), (check_geglu_bwd, GEGLU_BWD_SHAPES),
    (check_linear, LINEAR_SHAPES), (check_spatial_conv, SCONV_SHAPES),
    (check_conv3x3, CONV3X3_SHAPES))] + [(check_sdpa, s) for s in SDPA_SHAPES] + [
    (check_geglu_stream, s) for s in GEGLU_STREAM_FP32_SHAPES]
PLAN = ([(fn, s, torch.bfloat16) for fn, s in BF16_PLAN]
        + [(fn, s, torch.float32) for fn, s in FP32_PLAN])


def run(seed: int = 0, emit=print, plan=None):
    """Runs every check of ``plan`` (default PLAN, every bf16 check before
    the fp32 ones); returns the list of records (one per shape, type and
    call), each emitted as a JSON line. An fp32 record also carries the same
    check's bf16 reading and fails unless it lies below it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    records = []
    bf16 = {}
    for fn, shape, dtype in (PLAN if plan is None else plan):
        recs = fn(gen, shape, dtype)
        torch.cuda.synchronize()
        for rec in recs if isinstance(recs, list) else [recs]:
            key = (rec["name"], str(rec["shape"]))
            if dtype == torch.bfloat16:
                bf16[key] = rec["rel_err"]
            elif key in bf16:
                rec["bf16_rel_err"] = bf16[key]
                rec["ok"] = bool(rec["ok"] and rec["rel_err"] < bf16[key])
            records.append(rec)
            emit(json.dumps(rec))
        torch.cuda.empty_cache()
    return records
