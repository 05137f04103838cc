"""Fused temporal double self-attention: kernel B (forward), kernel F
(dy-only backward) and their plain versions (counterpart of
lvd_tpu/ops/temporal_attention.py).

``temporal_attention_pair(p, y, heads, eps, frames_major)`` runs
LN1 -> attn1 -> +res -> LN2 -> attn2 -> +res over the frame axis of
(B, P, F, C) input, or of the (B, F, P, C) stream with ``frames_major``. It
is a ``torch.autograd.Function`` in y where lvd_tpu's predicate for the
layout holds (``supported`` / ``supported_frames_major``, its pixel-group
clause included), the plain formulation on stock ops elsewhere: on CUDA
tensors the forward launches kernel B (csrc/temporal_attention.cu,
replacing ``_pallas_pair``) and the backward kernel F
(csrc/temporal_attention_bwd.cu, replacing ``_pallas_pair_bwd``); on CPU
tensors they run ``_pair_ref`` / ``_pair_ref_fm`` and
``temporal_attention_pair_bwd_plain``. The backward is routed as lvd_tpu's
``_fused_pair_bwd`` routes it (``bwd_route``, from its ``_pick_g_bwd``):
kernel F where the layout's own backward tile exists, kernel F on the
frames-major stream where only the pixels-major tile does (lvd_tpu
transposes around its kernel there; F's strides read either layout), and
elsewhere the autograd VJP of ``_pair_ref`` / ``_pair_ref_fm`` on stock ops,
lvd_tpu's unfused route. Kernels B and F have two forms each
(``launch_plan``, ``bwd_launch_plan``, passed to the kernel, which refuses
any other): ``wgmma`` in bf16 (64-row blocks of whole pixels,
``block_rows``, keys masked to the row's pixel, ``key_mask``; F's weight
ring in the order ``bwd_stages`` lists) and the first version ``wmma`` in
fp32; ``launches_by_form`` counts each. Weight and bias gradients come
from the stock VJP of the plain pair, recomputed, as lvd_tpu's custom VJP
gives them, beside y's from the route above. The FF stage stays outside
(ops.geglu_fused).
"""

from __future__ import annotations

import torch

from ..utils.tree import flatten, unflatten_like
from . import _build

HEAD_DIM = 64
MAX_CHANNELS = 640

PAIR_PARAMS = ("norm1", "attn1", "norm2", "attn2")  # the params the pair reads

FORMS = ("wgmma", "wmma")
FORM_CODES = {"wmma": 0, "wgmma": 1}
ROW_BLOCK = 64  # rows a block of the wgmma form: one m64 tile
MAX_SMEM = 232448  # bytes of shared memory a block may use


def _wmma_tile(f: int, c: int, itemsize: int):
    """The first version's tile (csrc/temporal_attention.cu `wmma_tile`):
    the first of G = 4, 2, 1 pixels whose R = G F rows (rounded up to 16,
    at most 128) fit its shared-memory layout, the residual rows in shared
    memory if they fit, else in the output. (G, R), or (0, 0)."""
    pad = 32 // itemsize
    take = lambda nbytes: -(-nbytes // 128) * 128
    for ys_smem in (True, False):
        for g in (4, 2, 1):
            r = -(-g * f // 16) * 16
            rows = take(r * (c + pad) * itemsize)
            heads = take(r * (HEAD_DIM + pad) * itemsize)
            total = ((3 if ys_smem else 2) * rows + 3 * heads + take(r * r * 4)
                     + take(r * r * itemsize) + take(8 * 256 * 4))
            if r <= 128 and total <= MAX_SMEM:
                return g, r
    return 0, 0


def launch_plan(f: int, c: int, dtype, form: str = None) -> dict:
    """Kernel B's form for F frames and C channels of this type, and its
    launch plan, which the kernel checks: ``wgmma`` in bf16 up to F = 64,
    one block per ``row_block`` = 64 rows holding ``pixels`` = 64 // F
    whole pixels (row r: pixel r // F, frame r % F, ``block_rows``); the first version
    ``wmma`` in fp32 and past F = 64, G pixels in R rows as its tile search
    picks them (``_wmma_tile``). ``form`` names one of them instead (the
    selfcheck times the first version beside the new one)."""
    if form is None:
        form = "wgmma" if dtype == torch.bfloat16 and f <= ROW_BLOCK else "wmma"
    if form == "wgmma":
        rows, pixels = ROW_BLOCK, ROW_BLOCK // f
    else:
        pixels, rows = _wmma_tile(f, c, dtype.itemsize)
    return {"form": form, "code": FORM_CODES[form], "row_block": rows, "pixels": pixels}


def block_rows(f: int, p: int, block: int):
    """(pixel, frame, valid) of the 64 rows of the wgmma form's pixel block
    ``block``: row r holds frame r % F of pixel block * G + r // F; rows
    past G F or past P are padding (zero, never stored)."""
    plan = launch_plan(f, MAX_CHANNELS, torch.bfloat16)
    r = torch.arange(plan["row_block"])
    pixel = block * plan["pixels"] + r // f
    return pixel, r % f, (r < plan["pixels"] * f) & (pixel < p)


def key_mask(f: int):
    """(64, 64) bool: the keys each row of a wgmma block attends to, those
    of its own pixel (row // F == key // F)."""
    r = torch.arange(ROW_BLOCK)
    return (r[:, None] // f) == (r[None, :] // f)


def _pick_g_bwd(pdim: int, c: int, frames_major: bool = False) -> int:
    """lvd_tpu's backward pixel group (temporal_attention.py:325-345): the
    first of its measured tiles that divides P, (10, 16, 12, 8, 6, 5, 4)
    pixels-major at C <= 384 and (6, 5, 4) wider; frames-major (8, 16) at
    C <= 384 and none wider. 0 where none fits."""
    if frames_major:
        order = (8, 16) if c <= 384 else ()
    else:
        order = (10, 16, 12, 8, 6, 5, 4) if c <= 384 else (6, 5, 4)
    return next((g for g in order if pdim % g == 0), 0)


def bwd_route(pdim: int, c: int, frames_major: bool = False) -> str:
    """The backward's route, lvd_tpu's ``_fused_pair_bwd`` clause for clause
    (temporal_attention.py:452-478): "kernel" where the layout's own tile
    exists, "pixels_major" where a frames-major stream has only the
    pixels-major tile (lvd_tpu runs that kernel between two transposes; the
    port launches kernel F on the stream as it is), else "stock" (the VJP of
    the plain pair)."""
    if _pick_g_bwd(pdim, c, frames_major) > 0:
        return "kernel"
    if frames_major and _pick_g_bwd(pdim, c) > 0:
        return "pixels_major"
    return "stock"


def _wmma_bwd_tile(f: int, c: int, itemsize: int):
    """Kernel F's first version's tile (csrc/temporal_attention_bwd.cu
    `pick_tile`): the first of G = 2, 1 pixels whose R = G F rows (rounded
    up to 16, at most 64) fit its shared-memory layout, x in shared memory
    if it fits, else in the workspace. (G, R), or (0, 0)."""
    pad = 32 // itemsize
    take = lambda nbytes: -(-nbytes // 128) * 128
    for xs_smem in (True, False):
        for g in (2, 1):
            r = -(-g * f // 16) * 16
            rows = take(r * (c + pad) * itemsize)
            head = take(r * (HEAD_DIM + pad) * itemsize)
            total = ((2 if xs_smem else 1) * rows + 7 * head + 2 * take(r * r * 4)
                     + 2 * take(r * r * itemsize) + take(16 * r) + take(8 * 256 * 4))
            if r <= 64 and total <= MAX_SMEM:
                return g, r
    return 0, 0


def bwd_launch_plan(f: int, c: int, dtype, form: str = None) -> dict:
    """Kernel F's form and launch plan, which the kernel checks: ``wgmma``
    in bf16 up to F = 64, 64-row tiles of ``pixels`` = 64 // F whole pixels
    (kernel B's ``block_rows``), one persistent block per SM walking them;
    the first version ``wmma`` in fp32 and past F = 64, G pixels in R rows as
    its tile search picks them (``_wmma_bwd_tile``). ``form`` names one of
    them instead (the selfcheck times the first version beside the new
    one)."""
    if form is None:
        form = "wgmma" if dtype == torch.bfloat16 and f <= ROW_BLOCK else "wmma"
    if form == "wgmma":
        rows, pixels = ROW_BLOCK, ROW_BLOCK // f
    else:
        pixels, rows = _wmma_bwd_tile(f, c, dtype.itemsize)
    return {"form": form, "code": FORM_CODES[form], "row_block": rows, "pixels": pixels}


def bwd_stages(c: int):
    """The order in which the wgmma form's producer streams one 64-row
    tile's operands through its ring, as its two consumer warpgroups take
    them. A stage is two 64 x 64 weight boxes, (matrix, (column, row) of
    warpgroup 0's box, (column, row) of warpgroup 1's) of the stacked
    ``wqkv`` (C, 3C) or ``wo`` (C, C) of attention 1 or 2, or one tile of
    the block's workspace, ("dqkv1" / "dqkv2", k): columns 64 k.. of
    [dq | dk | dv]. In order: the forward (per head pair j, k, v and q of
    heads 2 j and 2 j + 1 as C / 64 column boxes; attention 1's output
    projection, output blocks 2 i and 2 i + 1; attention 2's k, v, q), then
    per attention, 2 before 1: dO (per head pair, the heads' rows of wo as
    C / 64 boxes read as wo^T), and dz (per pair of 64-column output blocks,
    each of the 3C / 64 contraction steps a workspace tile, then the blocks'
    rows of wqkv read as wqkv^T)."""
    h = c // 64
    pairs = -(-h // 2)
    stages = []

    def boxes(m, c0, r0, dc, dr):
        stages.append((m, (c0, r0), (c0 + dc, r0 + dr)))

    for at in "12":
        for j in range(pairs):
            for m in range(3):
                for kt in range(h):
                    boxes("wqkv" + at, (0 if m == 2 else m + 1) * c + 128 * j, 64 * kt, 64, 0)
        if at == "1":
            for i in range(pairs):
                for kt in range(h):
                    boxes("wo1", 128 * i, 64 * kt, 64, 0)
    for at in "21":
        for j in range(pairs):
            for kt in range(h):
                boxes("wo" + at, 64 * kt, 128 * j, 0, 64)
        for i in range(pairs):
            for kt in range(3 * h):
                stages.append(("dqkv" + at, kt))
                boxes("wqkv" + at, 64 * kt, 128 * i, 0, 64)
    return stages


def _ln_stats(p, x, eps):
    """LayerNorm with fp32 one-pass statistics: (z in x's type, xhat, rstd)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    return (xhat * p["scale"].float() + p["bias"].float()).to(x.dtype), xhat, rstd


def _ref_ln(p, x, eps):
    return _ln_stats(p, x, eps)[0]


def _ref_attn(pa, y, num_heads):
    """Self-attention over axis 2 of (B, P, F, C): bf16-rounded q/k/v,
    fp32 logits and softmax, probabilities and head outputs in y's type."""
    d = y.shape[-1] // num_heads
    q, k, v = (y @ pa[n]["w"].to(y.dtype) for n in ("to_q", "to_k", "to_v"))
    outs = []
    for h in range(num_heads):
        sl = slice(h * d, (h + 1) * d)
        logits = torch.matmul(q[..., sl].float(), k[..., sl].float().transpose(-1, -2))
        probs = torch.softmax(logits * d ** -0.5, dim=-1).to(y.dtype)
        outs.append(torch.matmul(probs.float(), v[..., sl].float()).to(y.dtype))
    o = torch.cat(outs, dim=-1)
    out = torch.matmul(o.float(), pa["to_out"]["w"].to(y.dtype).float())
    return (out + pa["to_out"]["b"].float()).to(y.dtype)


def _pair_ref(p, y, num_heads, eps):
    y = y + _ref_attn(p["attn1"], _ref_ln(p["norm1"], y, eps), num_heads)
    y = y + _ref_attn(p["attn2"], _ref_ln(p["norm2"], y, eps), num_heads)
    return y


def _pair_ref_fm(p, y, num_heads, eps):
    """Frames-major plain version: transposes around ``_pair_ref``."""
    return _pair_ref(p, y.transpose(1, 2), num_heads, eps).transpose(1, 2)


def _pick_g(pdim: int, frames_major: bool = False) -> int:
    """lvd_tpu's pixel group (temporal_attention.py:483-497): the first of
    its measured tiles that divides P; frames-major tiles must be 16 or 8
    pixels, or all of P up to 16. 0 where none fits."""
    order = (16, 8) if frames_major else (16, 12, 10, 8, 6, 5, 4)
    g = next((g for g in order if pdim % g == 0), 0)
    return pdim if g == 0 and frames_major and pdim <= 16 else g


def _supported(pdim: int, c: int, num_heads: int, dtype, frames_major: bool = False) -> bool:
    """lvd_tpu's ``_supported`` (temporal_attention.py:501-513) without its
    backend test: bf16 or fp32, 64-wide heads, C <= 640 and a pixel
    group."""
    return (dtype in (torch.bfloat16, torch.float32) and c // num_heads == HEAD_DIM
            and c <= MAX_CHANNELS and _pick_g(pdim, frames_major) > 0)


def supported(y, num_heads: int) -> bool:
    """lvd_tpu's predicate for the pixels-major (B, P, F, C) stream."""
    _, pdim, _, c = y.shape
    return _supported(pdim, c, num_heads, y.dtype)


def supported_frames_major(y, num_heads: int) -> bool:
    """lvd_tpu's predicate for the frames-major (B, F, P, C) stream."""
    _, _, pdim, c = y.shape
    return _supported(pdim, c, num_heads, y.dtype, frames_major=True)


def _attn_weights(pa, ln, dtype):
    """One attention's kernel operands: LayerNorm and output bias fp32, the
    fused (C, 3C) qkv and (C, C) output weights in the stream's type."""
    f32 = lambda t: t.float().contiguous()
    cast = lambda t: t.to(dtype).contiguous()
    wqkv = torch.cat([pa["to_q"]["w"], pa["to_k"]["w"], pa["to_v"]["w"]], dim=1)
    return [f32(ln["scale"]), f32(ln["bias"]), cast(wqkv), cast(pa["to_out"]["w"]),
            f32(pa["to_out"]["b"])]


def _pair_weights(p, dtype):
    return _attn_weights(p["attn1"], p["norm1"], dtype) + _attn_weights(p["attn2"], p["norm2"],
                                                                        dtype)


def temporal_attention_pair_plain(p, y, num_heads: int, eps: float = 1e-5,
                                  frames_major: bool = False):
    ref = _pair_ref_fm if frames_major else _pair_ref
    return ref(p, y, num_heads, eps)


def _ln_bwd(dz, xhat, rstd, p):
    g = dz * p["scale"].float()
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * xhat).mean(dim=-1, keepdim=True)
    return rstd * (g - m1 - xhat * m2)


def _qkv(pa, z):
    """The fused (..., 3C) projection in fp32 from z in its own type."""
    w = torch.cat([pa["to_q"]["w"], pa["to_k"]["w"], pa["to_v"]["w"]], dim=1).to(z.dtype)
    return z.float() @ w.float()


def _heads(qkv, num_heads):
    """q, k, v of every head: (..., H, F, 64) each, fp32."""
    c = qkv.shape[-1] // 3
    split = lambda t: t.reshape(*t.shape[:-1], num_heads, c // num_heads).transpose(-2, -3)
    return split(qkv[..., :c]), split(qkv[..., c:2 * c]), split(qkv[..., 2 * c:])


def _attn_dz(pa, u, qkv, num_heads, dt):
    """Input gradient of one self-attention at its LayerNorm output, the math
    of lvd_tpu's ``_attn_dz`` per pixel: u (..., F, C) fp32 -> dz fp32."""
    q, k, v = (t.to(dt).float() for t in _heads(qkv, num_heads))
    d = q.shape[-1]
    scale = d ** -0.5
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    c = u.shape[-1]
    wo = pa["to_out"]["w"].to(dt).float().reshape(num_heads, d, c)
    do = (u.to(dt).float().unsqueeze(-3) @ wo.transpose(-1, -2)).to(dt).float()
    dv = p.to(dt).float().transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    tmp = dp * p
    dl = ((tmp - p * tmp.sum(dim=-1, keepdim=True)) * scale).to(dt).float()
    dq = dl @ k
    dk = dl.transpose(-1, -2) @ q
    merge = lambda t: t.transpose(-2, -3).flatten(-2)
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(dt).float()
    w = torch.cat([pa["to_q"]["w"], pa["to_k"]["w"], pa["to_v"]["w"]], dim=1).to(dt).float()
    return dqkv @ w.transpose(0, 1)


def temporal_attention_pair_bwd_plain(p, y, dy, num_heads: int, eps: float = 1e-5,
                                      frames_major: bool = False):
    """dy of the pair for the cotangent ``dy``: the math of lvd_tpu's
    ``_tattn_bwd_kernel`` (recompute LN1 -> attn1 -> +res -> LN2 -> qkv2,
    then the attention and LayerNorm input VJPs twice), in y's type where
    the kernel rounds and fp32 elsewhere."""
    if frames_major:
        y, dy = y.transpose(1, 2), dy.transpose(1, 2)
    dt = y.dtype
    z1, xhat1, rstd1 = _ln_stats(p["norm1"], y, eps)
    x1 = y + _ref_attn(p["attn1"], z1, num_heads)
    z2, xhat2, rstd2 = _ln_stats(p["norm2"], x1, eps)
    qkv1, qkv2 = _qkv(p["attn1"], z1), _qkv(p["attn2"], z2)
    u2 = dy.float()
    dx1 = u2 + _ln_bwd(_attn_dz(p["attn2"], u2, qkv2, num_heads, dt), xhat2, rstd2, p["norm2"])
    dx0 = dx1 + _ln_bwd(_attn_dz(p["attn1"], dx1, qkv1, num_heads, dt), xhat1, rstd1,
                        p["norm1"])
    dx0 = dx0.to(dt)
    return dx0.transpose(1, 2) if frames_major else dx0


def _layout(y, frames_major):
    if frames_major:
        b, f, pdim, c = y.shape
        return (b, f, pdim, c), (f * pdim * c, pdim * c, c)
    b, pdim, f, c = y.shape
    return (b, f, pdim, c), (f * pdim * c, c, f * c)


def _launch_forward(p, y, num_heads, eps, frames_major, form=None):
    """Kernel B on a CUDA tensor, in the form and plan ``launch_plan``
    gives (or the form ``form`` names)."""
    _build.refuse_grad("temporal_attention_pair", y)
    code = _build.dtype_code(y, "temporal_attention_pair")
    y = _build.kernel_input(y, y.dtype, "temporal_attention_pair y")
    (b, f, pdim, c), strides = _layout(y, frames_major)
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"temporal_attention_pair: C={c} is not {num_heads} heads of {HEAD_DIM}")
    plan = launch_plan(f, c, y.dtype, form)
    weights = _pair_weights(p, y.dtype)
    out = torch.empty_like(y)
    err = _build.lib().lvd_temporal_pair(
        y.data_ptr(), out.data_ptr(), *[w.data_ptr() for w in weights],
        b, f, pdim, c, num_heads, *strides, float(eps), plan["code"], plan["row_block"],
        plan["pixels"], code, _build.stream_of(y))
    _build.check(err, "temporal_attention_pair")
    temporal_attention_pair.launches += 1
    temporal_attention_pair.launches_by_form[plan["form"]] += 1
    return out


def temporal_attention_pair_bwd(p, y, dy, num_heads: int, eps: float = 1e-5,
                                frames_major: bool = False, form: str = None):
    """dy of the pair: kernel F on CUDA tensors, in the form and plan
    ``bwd_launch_plan`` gives (or the form ``form`` names), the plain version
    on CPU."""
    if y.device.type == "cpu":
        return temporal_attention_pair_bwd_plain(p, y, dy, num_heads, eps, frames_major)
    _build.refuse_grad("temporal_attention_pair_bwd", y, dy)
    code = _build.dtype_code(y, "temporal_attention_pair_bwd")
    y = _build.kernel_input(y, y.dtype, "temporal_attention_pair_bwd y")
    dy = _build.kernel_input(dy, y.dtype, "temporal_attention_pair_bwd dy")
    (b, f, pdim, c), strides = _layout(y, frames_major)
    if c != num_heads * HEAD_DIM or dy.shape != y.shape:
        raise ValueError(f"temporal_attention_pair_bwd: y {tuple(y.shape)}, dy "
                         f"{tuple(dy.shape)} with {num_heads} heads of {HEAD_DIM}")
    plan = bwd_launch_plan(f, c, y.dtype, form)
    weights = _pair_weights(p, y.dtype)
    lib = _build.lib()
    ws_bytes = lib.lvd_temporal_pair_bwd_workspace(b, f, pdim, c, plan["code"], code)
    if ws_bytes < 0:
        raise ValueError(f"temporal_attention_pair_bwd: unsupported shape {tuple(y.shape)}")
    ws = torch.empty(ws_bytes // 4, dtype=torch.float32, device=y.device)
    out = torch.empty_like(y)
    err = lib.lvd_temporal_pair_bwd(
        y.data_ptr(), dy.data_ptr(), out.data_ptr(), *[w.data_ptr() for w in weights],
        ws.data_ptr(), b, f, pdim, c, num_heads, *strides, float(eps), plan["code"],
        plan["row_block"], plan["pixels"], code, _build.stream_of(y))
    _build.check(err, "temporal_attention_pair_bwd")
    temporal_attention_pair_bwd.launches += 1
    temporal_attention_pair_bwd.launches_by_form[plan["form"]] += 1
    return out


def _stock_dy(p, y, dy, num_heads, eps, frames_major):
    """dy where lvd_tpu has no backward tile: the autograd VJP of the plain
    pair, in y's type (lvd_tpu's unfused recompute VJP)."""
    with torch.enable_grad():
        leaf = y.detach().requires_grad_(True)
        out = temporal_attention_pair_plain(p, leaf, num_heads, eps, frames_major)
        (dx,) = torch.autograd.grad(out, leaf, dy)
    return dx


def _recompute_grads(p, y, dy, num_heads, eps, frames_major, need_y, need_leaves):
    """lvd_tpu's unfused recompute VJP: the gradients of the plain pair, on
    stock ops, for y (where ``need_y``) and the param leaves that
    ``need_leaves`` marks; None for the others."""
    with torch.enable_grad():
        y_in = y.detach().requires_grad_(need_y)
        leaves = {path: t.detach().requires_grad_(n)
                  for (path, t), n in zip(flatten(p).items(), need_leaves)}
        out = temporal_attention_pair_plain(unflatten_like(p, leaves), y_in,
                                            num_heads, eps, frames_major)
        inputs = [y_in, *leaves.values()]
        grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], dy))
    return [next(grads) if t.requires_grad else None for t in inputs]


class TemporalPair(torch.autograd.Function):
    """Forward kernel B, backward kernel F or the stock VJP in y, as lvd_tpu
    routes them (``bwd_route``; plain versions of the kernels on the CPU).
    The param leaves are inputs too: where one needs a gradient, the
    weights' and biases' gradients come from the stock VJP of the plain
    pair, recomputed (lvd_tpu's ``_fused_pair_bwd``), while y's still takes
    the route above."""

    @staticmethod
    def forward(ctx, y, p, num_heads, eps, frames_major, *leaves):
        if y.device.type == "cpu":
            out = temporal_attention_pair_plain(p, y, num_heads, eps, frames_major)
        else:
            out = _launch_forward(p, y, num_heads, eps, frames_major)
        ctx.save_for_backward(y)
        ctx.args = (p, num_heads, eps, frames_major)
        return out

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        p, num_heads, eps, frames_major = ctx.args
        need_y, need_leaves = ctx.needs_input_grad[0], ctx.needs_input_grad[5:]
        pdim = y.shape[2] if frames_major else y.shape[1]
        stock = bwd_route(pdim, y.shape[-1], frames_major) == "stock"
        dx, dleaves = None, [None] * len(need_leaves)
        if any(need_leaves):
            dx, *dleaves = _recompute_grads(p, y, dy, num_heads, eps, frames_major,
                                            stock and need_y, need_leaves)
        if need_y and dx is None:
            dx = (_stock_dy(p, y, dy, num_heads, eps, frames_major) if stock
                  else temporal_attention_pair_bwd(p, y, dy, num_heads, eps, frames_major))
        return (dx, None, None, None, None, *dleaves)


def temporal_attention_pair(p, y, num_heads: int, eps: float = 1e-5,
                            frames_major: bool = False):
    """The pair on either layout, routed as lvd_tpu routes it: kernel B (the
    plain version on the CPU) where lvd_tpu's predicate for the layout
    holds, the plain formulation on stock ops elsewhere."""
    routed = supported_frames_major if frames_major else supported
    if not routed(y, num_heads):
        return temporal_attention_pair_plain(p, y, num_heads, eps, frames_major)
    own = {k: p[k] for k in PAIR_PARAMS}  # a transformer block also holds its FF
    return TemporalPair.apply(y, own, int(num_heads), float(eps), bool(frames_major),
                              *flatten(own).values())


temporal_attention_pair.launches = 0
temporal_attention_pair.launches_by_form = dict.fromkeys(FORMS, 0)
temporal_attention_pair_bwd.launches = 0
temporal_attention_pair_bwd.launches_by_form = dict.fromkeys(FORMS, 0)
