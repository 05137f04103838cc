"""Kernel selfcheck on the card (counterpart of lvd_tpu/ops/selfcheck.py).

Every kernel of the guided Zeroscope path runs at every shape that path
gives it, in bf16, and is held to its plain PyTorch version run on fp32
copies of the same inputs, with lvd_tpu's selfcheck gate:
max|kernel - plain| / max|plain| <= 2e-2, or 4.5e-2 for the temporal pair
and its backward (lvd_tpu/ops/selfcheck.py:28,441-445). The forwards A-D
run at the shapes of the 576x320, 24-frame CFG forward (batch 2 x 24); the
backwards E-G at the shapes of the guided energy walk (the cond-only UNet
walk of batch 24 down to the last captured site). A backward is checked on
each of its outputs (dq, dk and dv for E; dq alone where the walk asks for
no dk/dv, at the text cross-attention). Each shape is also timed with
CUDA events: the kernel, the plain version on the same bf16 inputs, and for
kernel A ``torch.nn.functional.scaled_dot_product_attention`` (for E its
backward) as a yardstick (the port never calls it). ``bound_ms`` is the
least time the card could take: the larger of the operations over the bf16
tensor-core peak and the bytes (each input read once, each output written
once) over the memory rate. ``run()`` is called by chip_smoke.py and
tests/test_torch_gpu.py.
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from . import geglu_fused, packed_attention, temp_conv_fused, temporal_attention

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

DEFAULT_TOL = 2e-2
PAIR_TOL = 4.5e-2

# The shapes the 576x320, 24-frame CFG forward gives each kernel.
ATTN_SHAPES = [  # (batch, S_q, S_k, C): self-attention at L0/L1, cross at every level
    (48, 2880, 2880, 320), (48, 720, 720, 640),
    (48, 2880, 77, 320), (48, 720, 77, 640), (48, 180, 77, 1280), (48, 45, 77, 1280),
    (48, 180, 180, 1280), (48, 45, 45, 1280),
]
PAIR_SHAPES = [(2, 24, 2880, 320), (2, 24, 2880, 512), (2, 24, 720, 640)]  # (B, F, P, C)
GEGLU_SHAPES = [(138240, 320), (138240, 512), (34560, 640)]  # (rows, C), inner = 4C
TCONV_SHAPES = [(2, 24, 2880, 320), (2, 24, 720, 640), (2, 24, 180, 1280), (2, 24, 45, 1280)]
# The shapes the guided energy walk's backward gives each backward kernel.
ATTN_BWD_SHAPES = [  # (batch, S_q, S_k, C): self-attention at every level, uncaptured cross
    (24, 2880, 2880, 320), (24, 720, 720, 640), (24, 180, 180, 1280), (24, 45, 45, 1280),
    (24, 2880, 77, 320), (24, 720, 77, 640), (24, 180, 77, 1280), (24, 45, 77, 1280),
]
PAIR_BWD_SHAPES = [(1, 24, 2880, 320), (1, 24, 2880, 512), (1, 24, 720, 640)]
GEGLU_BWD_SHAPES = [(69120, 320), (69120, 512), (17280, 640)]

SOURCES = {
    "attention_packed": ("lvd_tpu_torch/csrc/packed_attention.cu",
                         "lvd_tpu/ops/pallas_attention.py:135 _pallas_attention_heads; "
                         "lvd_tpu/ops/pallas_attention.py:540 _pallas_attention_shortkey"),
    "temporal_attention_pair": ("lvd_tpu_torch/csrc/temporal_attention.cu",
                                "lvd_tpu/ops/temporal_attention.py:282 _pallas_pair"),
    "geglu_mlp": ("lvd_tpu_torch/csrc/geglu.cu",
                  "lvd_tpu/ops/geglu_fused.py:159 _fused_rows_resident"),
    "norm_silu_temporal_conv": ("lvd_tpu_torch/csrc/temp_conv.cu",
                                "lvd_tpu/ops/temp_conv_fused.py:153 _fused"),
    "attention_packed_bwd": ("lvd_tpu_torch/csrc/packed_attention_bwd.cu",
                             "lvd_tpu/ops/pallas_attention.py:235 _pallas_attention_bwd; "
                             "lvd_tpu/ops/pallas_attention.py:348 _pallas_attention_bwd_heads"),
    "temporal_attention_pair_bwd": ("lvd_tpu_torch/csrc/temporal_attention_bwd.cu",
                                    "lvd_tpu/ops/temporal_attention.py:348 _pallas_pair_bwd"),
    "geglu_mlp_bwd": ("lvd_tpu_torch/csrc/geglu_bwd.cu",
                      "lvd_tpu/ops/geglu_fused.py:299 _fused_rows_bwd_resident"),
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


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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


def _record(name, shape, out, ref, tol, ms, plain_ms, flops, nbytes, library_ms=None):
    """One check's record; ``out`` and ``ref`` may be tuples (a backward's
    outputs), each held to the gate on its own."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    errs = [_rel_err(o, r) for o, r in zip(outs, refs)]
    err = max(e for e, _ in errs)
    rel = max(r for _, r in errs)
    finite = all(torch.isfinite(o).all().item() for o in outs)
    b_ms, b_by = bound(flops, nbytes)
    return {"name": name, "shape": list(shape), "max_abs_err": err, "rel_err": rel,
            "tol": tol, "ok": bool(rel <= tol and finite),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}


def check_attention(gen, shape):
    b, s_q, s_k, c = shape
    heads = c // 64
    q, k, v = (_randn(gen, (b, s, c)).to(torch.bfloat16) for s in (s_q, s_k, s_k))
    scale = 64 ** -0.5
    out = packed_attention.attention_packed(q, k, v, scale, heads)
    ref = packed_attention.attention_packed_plain(q.float(), k.float(), v.float(), scale, heads)
    ms = time_ms(lambda: packed_attention.attention_packed(q, k, v, scale, heads))
    plain_ms = time_ms(lambda: packed_attention.attention_packed_plain(q, k, v, scale, heads),
                       1, 2)
    split = lambda t: t.view(b, t.shape[1], heads, 64).transpose(1, 2)
    qh, kh, vh = split(q), split(k), split(v)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
    flops = 4.0 * b * heads * s_q * s_k * 64
    nbytes = 2.0 * (2 * b * s_q * c + 2 * b * s_k * c)
    return _record("attention_packed", shape, out, ref, DEFAULT_TOL, ms, plain_ms, flops,
                   nbytes, lib_ms)


def _pair_params(gen, c):
    attn = lambda: {n: _linear_p(gen, c, c, bias=False) for n in ("to_q", "to_k", "to_v")} | {
        "to_out": _linear_p(gen, c, c)}
    return {"norm1": _norm_p(gen, c), "attn1": attn(), "norm2": _norm_p(gen, c), "attn2": attn()}


def check_pair(gen, shape):
    b, f, pdim, c = shape
    heads = c // 64
    p = _cast(_pair_params(gen, c), torch.bfloat16)
    y = _randn(gen, shape).to(torch.bfloat16)
    fn = lambda: temporal_attention.temporal_attention_pair(p, y, heads, 1e-5, frames_major=True)
    out = fn()
    ref = temporal_attention._pair_ref_fm(_cast(p, torch.float32), y.float(), heads, 1e-5)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: temporal_attention._pair_ref_fm(p, y, heads, 1e-5), 1, 2)
    rows = b * f * pdim
    flops = 2 * (2.0 * rows * c * 4 * c + 4.0 * rows * f * c)
    nbytes = 2.0 * (2 * rows * c + 2 * 4 * c * c) + 4.0 * 2 * 3 * c
    return _record("temporal_attention_pair", shape, out, ref, PAIR_TOL, ms, plain_ms, flops,
                   nbytes)


def check_geglu(gen, shape):
    rows, c = shape
    inner = 4 * c
    p = _cast({"proj": _linear_p(gen, c, 2 * inner), "out": _linear_p(gen, inner, c)},
              torch.bfloat16)
    x = _randn(gen, (rows, c)).to(torch.bfloat16)
    out = geglu_fused.geglu_mlp(p, x)
    pf = _cast(p, torch.float32)
    args = lambda pp, xx: (xx, pp["proj"]["w"], pp["proj"]["b"], pp["out"]["w"], pp["out"]["b"])
    ref = geglu_fused._unfused(*args(pf, x.float()))
    ms = time_ms(lambda: geglu_fused.geglu_mlp(p, x))
    plain_ms = time_ms(lambda: geglu_fused._unfused(*args(p, x)), 1, 2)
    flops = 6.0 * rows * c * inner
    nbytes = 2.0 * (2 * rows * c + 3 * c * inner + 2 * inner + c)
    return _record("geglu_mlp", shape, out, ref, DEFAULT_TOL, ms, plain_ms, flops, nbytes)


def check_temp_conv(gen, shape):
    b, f, pdim, c = shape
    x = _randn(gen, shape).to(torch.bfloat16)
    a = 1.0 + _randn(gen, (b, c), 0.1)
    sh = _randn(gen, (b, c), 0.1)
    w = _randn(gen, (3, 1, 1, c, c), (3 * c) ** -0.5).to(torch.bfloat16)
    bias = _randn(gen, (c,), 0.1).to(torch.bfloat16)
    fn = lambda: temp_conv_fused.norm_silu_temporal_conv(x, a, sh, w, bias)
    out = fn()
    ref = temp_conv_fused._unfused(x.float(), a, sh, w.float().reshape(3, c, c), bias.float())
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: temp_conv_fused._unfused(x, a, sh, w.reshape(3, c, c), bias),
                       1, 2)
    n = b * f * pdim
    flops = 6.0 * n * c * c
    nbytes = 2.0 * (2 * n * c + 3 * c * c + c) + 4.0 * 2 * b * c
    return _record("norm_silu_temporal_conv", shape, out, ref, DEFAULT_TOL, ms, plain_ms,
                   flops, nbytes)


def check_attention_bwd(gen, shape):
    b, s_q, s_k, c = shape
    heads = c // 64
    q, k, v = (_randn(gen, (b, s, c)).to(torch.bfloat16) for s in (s_q, s_k, s_k))
    do = _randn(gen, (b, s_q, c)).to(torch.bfloat16)
    scale = 64 ** -0.5
    with torch.no_grad():
        o = packed_attention.attention_packed(q, k, v, scale, heads)
    # The energy walk needs dk/dv at self-attention only (cross-attention
    # keys come from the text); check and time the call the walk makes.
    need_kv = s_q == s_k
    fn = lambda: packed_attention.attention_packed_bwd(q, k, v, o, do, scale, heads, need_kv)
    out = fn()
    ref = packed_attention.attention_packed_bwd_plain(
        *(t.float() for t in (q, k, v, o, do)), scale, heads)
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
    nbytes = 2.0 * (3 * b * s_q * c + (2 * b * s_k * c) * (2 if need_kv else 1) + b * s_q * c)
    return _record("attention_packed_bwd", shape, out, ref, DEFAULT_TOL, ms, plain_ms, flops,
                   nbytes, lib_ms)


def check_pair_bwd(gen, shape):
    b, f, pdim, c = shape
    heads = c // 64
    p = _cast(_pair_params(gen, c), torch.bfloat16)
    y = _randn(gen, shape).to(torch.bfloat16)
    dy = _randn(gen, shape).to(torch.bfloat16)
    fn = lambda: temporal_attention.temporal_attention_pair_bwd(p, y, dy, heads, 1e-5,
                                                                frames_major=True)
    out = fn()
    ref = temporal_attention.temporal_attention_pair_bwd_plain(
        _cast(p, torch.float32), y.float(), dy.float(), heads, 1e-5, frames_major=True)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: temporal_attention.temporal_attention_pair_bwd_plain(
        p, y, dy, heads, 1e-5, frames_major=True), 1, 2)
    rows = b * f * pdim
    # Forward recompute (qkv1, attn1, out1, qkv2) and two attention VJPs
    # (dO, scores, dV, dP, dQ, dK, dz): 30 C^2 + 24 F C operations a row.
    flops = rows * (30.0 * c * c + 24.0 * f * c)
    nbytes = 2.0 * (3 * rows * c + 2 * 4 * c * c) + 4.0 * 2 * 3 * c
    return _record("temporal_attention_pair_bwd", shape, out, ref, PAIR_TOL, ms, plain_ms,
                   flops, nbytes)


def check_geglu_bwd(gen, shape):
    rows, c = shape
    inner = 4 * c
    p = _cast({"proj": _linear_p(gen, c, 2 * inner), "out": _linear_p(gen, inner, c)},
              torch.bfloat16)
    x = _randn(gen, (rows, c)).to(torch.bfloat16)
    dy = _randn(gen, (rows, c)).to(torch.bfloat16)
    out = geglu_fused.geglu_mlp_bwd(p, x, dy)
    ref = geglu_fused.geglu_mlp_bwd_plain(_cast(p, torch.float32), x.float(), dy.float())
    ms = time_ms(lambda: geglu_fused.geglu_mlp_bwd(p, x, dy))
    plain_ms = time_ms(lambda: geglu_fused.geglu_mlp_bwd_plain(p, x, dy), 1, 2)
    flops = 10.0 * rows * c * inner  # h, g, d_inner and the two halves of dx
    nbytes = 2.0 * (3 * rows * c + 3 * c * inner + 2 * inner)
    return _record("geglu_mlp_bwd", shape, out, ref, DEFAULT_TOL, ms, plain_ms, flops, nbytes)


PLAN = ([(check_attention, s) for s in ATTN_SHAPES]
        + [(check_pair, s) for s in PAIR_SHAPES]
        + [(check_geglu, s) for s in GEGLU_SHAPES]
        + [(check_temp_conv, s) for s in TCONV_SHAPES]
        + [(check_attention_bwd, s) for s in ATTN_BWD_SHAPES]
        + [(check_pair_bwd, s) for s in PAIR_BWD_SHAPES]
        + [(check_geglu_bwd, s) for s in GEGLU_BWD_SHAPES])


def run(seed: int = 0, emit=print):
    """Runs every check; returns the list of records (one per shape)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    records = []
    for fn, shape in PLAN:
        rec = fn(gen, shape)
        torch.cuda.synchronize()
        records.append(rec)
        emit(json.dumps(rec))
        torch.cuda.empty_cache()
    return records

