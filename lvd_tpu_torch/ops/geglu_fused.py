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
On CPU tensors each kernel is replaced by its plain version. Kernel C has
three forms (``launch_plan``): ``wgmma`` in bf16 and ``mma_sync`` in fp32
(64-row blocks, W1 passed with its columns interleaved, ``interleave_w1``)
and the kept ``wmma`` form for fp32 C > 384;
``geglu_mlp.launches_by_form`` counts each. The plan (rows a block, inner
columns a chunk, blocks on one row tile) is passed to the kernel, which
refuses one it was not built for; ``gemm1_columns`` and ``output_blocks``
derive the wgmma form's chunk plan from it, which the CPU tests hold to
lvd_tpu's resident kernel. Kernel G has three forms (``bwd_launch_plan``):
``wgmma`` in bf16 at the resident widths (kernel C's structure: 64-row
blocks, the interleaved W1, dx columns split between two blocks at
C >= 384, ``dx_columns``) in bf16 and, on TF32 wgmma with its operands
rounded to TF32 on each call (``tf32_operands``), in fp32; its first
version ``wmma`` when named; and the ``general`` form at every other width;
``geglu_mlp_bwd.launches_by_form`` counts each. Kernel J has two forms
(``stream_launch_plan``): ``wgmma`` in bf16, two passes of 128 x 128 tiles (x times the interleaved W1 with the
gate in the epilogue into a transient gated tensor in the stream's type,
``gated_chunks``; then gated W2 + b2), and its first version ``wmma`` in
fp32; ``geglu_stream.launches_by_form`` counts each. Weight and bias
gradients come from the stock VJP of ``_unfused``, recomputed, as lvd_tpu's
custom VJP gives them, beside dx from the route above.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import _build

# GELU form of the gate, the switch lvd_tpu reads (geglu_fused.py:28-37):
# "tanh" (default) or "exact" (erf, the torch reference's form).
GELU_FORM = os.environ.get("LVD_GELU_FORM", "tanh")

MAX_CHANNELS = 640  # the widest C of kernel C and of kernel G's resident forms
BWD_ROWS = 32  # rows per block of kernel G's first version (fp32 pads dx to it)
STREAM_INNER = 256  # kernel J's inner dim must be a multiple (lvd_tpu's block_k)


FORMS = ("wgmma", "mma_sync", "wmma")
F32_MAX_CHANNELS = 384  # the widest C of the mma_sync form (its x tile stays resident)
INNER_CHUNK = 64  # inner columns a chunk, every form: 32 for each of two warpgroups


def launch_plan(c: int, dtype) -> dict:
    """Kernel C's form at width ``c`` and its launch plan, which the kernel
    checks: ``wgmma`` in bf16 (every width the route gives it: C = 64..640
    step 64, inner % 64 == 0), 64 rows a block, and at C >= 448 ``split``
    = 2 blocks on each 64-row tile, each writing half of the output blocks
    and recomputing GEMM1, so that a thread's accumulators fit the 168
    registers a block of 9 warps leaves it; in fp32 ``mma_sync`` (TF32) up
    to F32_MAX_CHANNELS, 64 rows a block, and the kept ``wmma`` form wider,
    32 rows a block (lvd_tpu's route gives fp32 C >= 448 to kernel C only
    with an inner dimension well under 4C)."""
    if dtype == torch.bfloat16:
        form, code, rows, split = "wgmma", 1, 64, 2 if c // 64 >= 7 else 1
    elif c <= F32_MAX_CHANNELS:
        form, code, rows, split = "mma_sync", 2, 64, 1
    else:
        form, code, rows, split = "wmma", 0, 32, 1
    return {"form": form, "code": code, "row_block": rows, "inner_chunk": INNER_CHUNK,
            "split": split}


def gemm1_columns(k: int, wg: int, inner: int):
    """The 64 columns of w1 (C, 2 inner) = [W1h | W1g] that warpgroup
    ``wg``'s first product of inner chunk ``k`` reads, in the order its
    accumulator holds them: the chunk's 32 inner columns 64 k + 32 wg ..
    of W1h, then the same 32 of W1g."""
    cols = INNER_CHUNK * k + INNER_CHUNK // 2 * wg + torch.arange(INNER_CHUNK // 2)
    return torch.cat([cols, inner + cols])


def interleave_w1(w1, inner: int):
    """w1 (C, 2 inner) = [W1h | W1g] with its columns interleaved in 32s,
    [h 0..31 | g 0..31 | h 32..63 | g 32..63 | ...], as the wgmma and
    mma_sync forms read it: its 64-column block 2 k + wg is
    ``w1[:, gemm1_columns(k, wg, inner)]``, one TMA box in bf16. A copy made
    per call (the selfcheck times it, ``copy_ms``); reading W1 as stored,
    in 32-column boxes, measured slower on an H100 (PERF.md)."""
    c = w1.shape[0]
    return w1.reshape(c, 2, inner // 32, 32).transpose(1, 2).reshape(c, 2 * inner)



def output_blocks(c: int, wg: int, half: int = 0):
    """The 64-column output blocks warpgroup ``wg`` of the wgmma block
    writing share ``half`` of them (of the plan's ``split``) stores:
    o0 + 2 i + wg, within the share."""
    n = c // 64
    share = -(-n // launch_plan(c, torch.bfloat16)["split"])
    o0 = half * share
    return [o0 + b for b in range(wg, min(share, n - o0), 2)]


BWD_FORMS = ("wgmma", "wmma", "general")
BWD_FORM_CODES = {"wmma": 0, "wgmma": 1, "general": 2}


def bwd_launch_plan(c: int, inner: int, dtype, form: str = None) -> dict:
    """Kernel G's form at width (c, inner) and its launch plan, which the
    kernel checks: ``wgmma`` at the resident widths (C = 64..640 step 64,
    inner % 64 == 0; W1 passed interleaved, ``interleave_w1``), 64 rows a
    block, ``split`` = 2 blocks on each 64-row tile at C >= 384, each
    warpgroup writing ``wg_columns`` = C / (2 split) dx columns in pieces of
    ``piece`` columns (32 in bf16; 16 in fp32, the TF32 form, whose W1 is
    also passed transposed); the first version ``wmma`` only when named (32
    rows a block); the ``general`` form everywhere else (32 rows a block,
    one block per 64-column dx slice). ``form`` names one of the resident
    forms instead (the selfcheck times the first version beside the new
    one)."""
    if form is None:
        form = "wgmma" if _covers(c, inner) else "general"
    piece = 0
    if form == "wgmma":
        split = 2 if c // 64 >= 6 else 1
        rows, wg_columns = 64, c // (2 * split)
        piece = 32 if dtype == torch.bfloat16 else 16
    elif form == "wmma":
        rows, split, wg_columns = BWD_ROWS, 1, 0
    else:
        rows, split, wg_columns = BWD_ROWS, -(-c // 64), 0
    return {"form": form, "code": BWD_FORM_CODES[form], "row_block": rows,
            "inner_chunk": INNER_CHUNK, "split": split, "wg_columns": wg_columns,
            "piece": piece}


def dx_columns(c: int, half: int, wg: int, dtype=torch.bfloat16):
    """The dx columns warpgroup ``wg`` of the wgmma form's block ``half``
    (of the plan's ``split``) writes: ``wg_columns`` from
    (2 half + wg) * wg_columns on, in ``piece``-column GEMM2 pieces
    (``dx_pieces``)."""
    n = bwd_launch_plan(c, 4 * c, dtype)["wg_columns"]
    return range((2 * half + wg) * n, (2 * half + wg + 1) * n)


def dx_pieces(c: int, half: int, wg: int, dtype=torch.bfloat16):
    """``dx_columns`` as the GEMM2 pieces that write them, in order: 32
    columns each in bf16, 16 in fp32 (the TF32 form's m64n16 products; a
    bf16 piece reaching past the warpgroup's columns stores only its own)."""
    cols = dx_columns(c, half, wg, dtype)
    piece = bwd_launch_plan(c, 4 * c, dtype)["piece"]
    return [range(q, min(q + piece, cols.stop)) for q in range(cols.start, cols.stop, piece)]


def tf32_round(t):
    """t rounded to TF32 (round to nearest, ties away from zero), a new
    tensor: the operand rounding of kernel G's first version, through the
    kernel's own rounding pass on the card; on the CPU the same rounding
    of the fp32 bits."""
    if t.device.type == "cpu":
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    out = torch.empty_like(t)
    _build.check(_build.lib().lvd_geglu_bwd_round(t.data_ptr(), out.data_ptr(), t.numel(),
                                                 _build.stream_of(t)), "geglu_mlp_bwd round")
    return out


def tf32_operands(x, dy, w1, w2, inner):
    """The fp32 wgmma form's operands, staged on each call: x, dy, the
    interleaved W1, its transpose (the K-major B of GEMM1: TF32 wgmma takes
    no transposed operand) and W2, each rounded to TF32 (``tf32_round``)."""
    w1 = interleave_w1(w1, inner)
    return [tf32_round(t) for t in (x, dy, w1, w1.transpose(0, 1).contiguous(), w2)]


STREAM_FORMS = ("wgmma", "wmma")
STREAM_FORM_CODES = {"wmma": 0, "wgmma": 1}


def stream_launch_plan(dtype, form: str = None) -> dict:
    """Kernel J's form and launch plan, which the kernel checks: ``wgmma``
    in bf16, tiles of ``row_block`` = 128 rows, each pass-1 tile 128
    interleaved W1 columns giving ``inner_chunk`` = 64 gated columns, each
    pass-2 tile ``column_block`` = 128 output columns; the first version
    ``wmma`` in fp32 (16 rows a block, 128-wide inner chunks, 128-column W2
    tiles). ``form`` names one of them instead (the selfcheck times the
    first version beside the new one)."""
    if form is None:
        form = "wgmma" if dtype == torch.bfloat16 else "wmma"
    rows, chunk = (128, 64) if form == "wgmma" else (16, 128)
    return {"form": form, "code": STREAM_FORM_CODES[form], "row_block": rows,
            "inner_chunk": chunk, "column_block": 128}


def gated_chunks():
    """The pass-1 epilogue of kernel J's wgmma form: for each 8-column chunk
    q of a tile's 64 gated columns, the chunks of the 128-column
    accumulator (x times 128 columns of ``interleave_w1``'s W1: [h | g | h |
    g] of 32 inner columns each) that hold its h and its g."""
    return [(8 * (q // 4) + q % 4, 8 * (q // 4) + q % 4 + 4) for q in range(8)]


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
    """Kernel C on a CUDA tensor, in the form and plan ``launch_plan``
    gives."""
    _build.refuse_grad("geglu_mlp", x)
    c = x.shape[-1]
    code = _build.dtype_code(x, "geglu_mlp")
    rows = _build.kernel_input(x.reshape(-1, c), x.dtype, "geglu_mlp x")
    w1, b1, w2, b2 = _kernel_weights(p, rows, "geglu_mlp")
    plan = launch_plan(c, x.dtype)
    if plan["form"] != "wmma":
        w1 = interleave_w1(w1, w2.shape[0])
    out = torch.empty_like(rows)
    err = _build.lib().lvd_geglu(
        rows.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), rows.shape[0], c, w2.shape[0], int(GELU_FORM != "tanh"), plan["code"],
        plan["row_block"], plan["inner_chunk"], plan["split"], code, _build.stream_of(rows))
    _build.check(err, "geglu_mlp")
    geglu_mlp.launches += 1
    geglu_mlp.launches_by_form[plan["form"]] += 1
    return out.reshape(x.shape)


def geglu_stream(p, x, form: str = None):
    """Kernel J on a CUDA tensor: the k-streaming forward, for any row
    count, any C % 8 == 0 and inner % 256 == 0, in the form and plan
    ``stream_launch_plan`` gives (or the form ``form`` names)."""
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
    plan = stream_launch_plan(x.dtype, form)
    gated = None
    if plan["form"] == "wgmma":
        w1 = interleave_w1(w1, inner)
        gated = torch.empty((rows.shape[0], inner), dtype=x.dtype, device=x.device)
    out = torch.empty_like(rows)
    err = _build.lib().lvd_geglu_stream(
        rows.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        None if gated is None else gated.data_ptr(), out.data_ptr(), rows.shape[0], c, inner,
        int(GELU_FORM != "tanh"), plan["code"], plan["row_block"], plan["inner_chunk"],
        plan["column_block"], code, _build.stream_of(rows))
    _build.check(err, "geglu_stream")
    geglu_stream.launches += 1
    geglu_stream.launches_by_form[plan["form"]] += 1
    return out.reshape(x.shape)


def geglu_mlp_bwd(p, x, dy, form: str = None):
    """dx: kernel G on CUDA tensors, in the form ``bwd_launch_plan`` gives
    (or the resident one ``form`` names), the plain version on CPU
    tensors."""
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
    plan = bwd_launch_plan(c, inner, x.dtype, form)
    n = rows.shape[0]
    exact = int(GELU_FORM != "tanh")
    if plan["form"] == "wgmma" and x.dtype == torch.float32:
        dx = torch.empty_like(rows)
        ops = tf32_operands(rows, drows, w1, w2, inner)
        err = _build.lib().lvd_geglu_bwd_tf32(
            *[t.data_ptr() for t in ops[:4]], b1.data_ptr(), ops[4].data_ptr(), dx.data_ptr(),
            n, c, inner, exact, plan["row_block"], plan["inner_chunk"], plan["split"],
            _build.stream_of(rows))
    else:
        if plan["form"] == "wgmma":
            w1 = interleave_w1(w1, inner)
        # In fp32 the first version accumulates dx in the output itself, 32
        # rows a block; every other form writes dx rows directly.
        resident_fp32 = x.dtype == torch.float32 and plan["form"] == "wmma"
        padded = -(-n // BWD_ROWS) * BWD_ROWS if resident_fp32 else n
        dx = torch.empty((padded, c), dtype=x.dtype, device=x.device)
        err = _build.lib().lvd_geglu_bwd(
            rows.data_ptr(), drows.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            dx.data_ptr(), n, c, inner, exact, plan["code"], plan["row_block"],
            plan["inner_chunk"], plan["split"], code, _build.stream_of(rows))
    _build.check(err, "geglu_mlp_bwd")
    geglu_mlp_bwd.launches += 1
    geglu_mlp_bwd.launches_by_form[plan["form"]] += 1
    return dx[:n].reshape(x.shape)


def _unfused_dx(p, x, dy):
    """dx where lvd_tpu has no dx kernel: the VJP of ``_unfused``."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(_unfused(leaf, *_weights(p, x.dtype)), leaf, dy)
    return dx


def _unfused_grads(x, dy, leaves, need):
    """lvd_tpu's unfused recompute VJP: the gradients of ``_unfused`` on
    stock ops for the inputs (x, w1, b1, w2, b2) that ``need`` marks, None
    for the others."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip([x, *leaves], need)]
        out = _unfused(inputs[0], *[t.to(x.dtype) for t in inputs[1:]])
        grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], dy))
    return [next(grads) if n else None for n in need]


class Geglu(torch.autograd.Function):
    """Forward kernel C or J, dx kernel G or the stock VJP, as lvd_tpu
    routes them (plain versions of the kernels on the CPU). The weights
    (w1, b1, w2, b2) are inputs too: where one needs a gradient, the
    weights' and biases' gradients come from the stock VJP of ``_unfused``,
    recomputed (lvd_tpu's ``_fused_bwd``), while dx still takes the route
    above."""

    @staticmethod
    def forward(ctx, x, p, *leaves):
        resident = forward_kernel(x.shape[-1], p["out"]["w"].shape[0], x.dtype) == "C"
        if x.device.type == "cpu":
            out = geglu_mlp_plain(p, x) if resident else geglu_stream_plain(p, x)
        else:
            out = _launch_forward(p, x) if resident else geglu_stream(p, x)
        ctx.save_for_backward(x, *leaves)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, dy):
        x, *leaves = ctx.saved_tensors
        need_x, need_leaves = ctx.needs_input_grad[0], ctx.needs_input_grad[2:]
        kernel = dx_route(x.shape[-1], ctx.p["out"]["w"].shape[0], x.dtype) == "G"
        dx, dleaves = None, [None] * len(leaves)
        if any(need_leaves):
            dx, *dleaves = _unfused_grads(x, dy, leaves, (need_x and not kernel, *need_leaves))
        if need_x and dx is None:
            dx = geglu_mlp_bwd(ctx.p, x, dy) if kernel else _unfused_dx(ctx.p, x, dy)
        return (dx, None, *dleaves)


def geglu_mlp(p, x):
    return Geglu.apply(x, p, p["proj"]["w"], p["proj"]["b"], p["out"]["w"], p["out"]["b"])


geglu_mlp.launches = 0
geglu_mlp.launches_by_form = dict.fromkeys(FORMS, 0)
geglu_stream.launches = 0
geglu_stream.launches_by_form = dict.fromkeys(STREAM_FORMS, 0)
geglu_mlp_bwd.launches = 0
geglu_mlp_bwd.launches_by_form = dict.fromkeys(BWD_FORMS, 0)
