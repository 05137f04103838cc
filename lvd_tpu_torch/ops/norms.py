"""GroupNorm and LayerNorm: kernels K, L and M (csrc/norms.cu) and their
plain versions (counterpart of lvd_tpu/ops/basic.py:59-155).

lvd_tpu leaves ``group_norm_coeffs``, ``group_norm`` and ``layer_norm`` to
XLA, which fuses each elementwise chain; these kernels are the port's
counterpart of those fusions (no Pallas kernel is replaced, and every
Pallas routing predicate stays lvd_tpu's). Each public function runs a
``torch.autograd.Function``: on a CUDA tensor its forward launches a
kernel, on a CPU tensor it runs the plain version, today's stock-op body.
Every backward is the plain version's VJP in closed form on stock ops
(K's ``sums`` form recomputes the group sums on CUDA): dx, and dscale and
dbias for the trainer; a Function saves x and its (N, C) or parameter
inputs, no fp32 copy of the activation.

- K, ``group_norm_stats``: one read of x (N, R, C), per-channel fp32 sums of
  x and x*x over chunks of rows, then per group, and either the (N, C) fp32
  affine (a, b) (form ``coeffs``) or, frame-sharded, the (N, G) sums that
  go through ``comm.psum`` and the plain arithmetic (form ``sums``). The
  chunks (``launch_plan``, ``chunk_ranges``) depend on C, the type and R
  alone, so a sample's statistics are the same bits alone or in a batch.
- L, ``group_norm_apply``: y = x * a + b with lvd_tpu's rounding points
  (forms ``affine`` and ``affine_silu``, SiLU on the rounded value).
- M, ``layer_norm_rows``: LayerNorm over rows, fp32 statistics, one rounding
  (forms ``affine`` and ``normalize``, lvd_tpu's ``p is None``).

They take bf16, fp16 and fp32, any row count and C % 8 == 0; a CUDA shape
they cannot take raises. ``ops/plain.py``'s ``plain_route`` swaps the public
functions for their plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

THREADS = 256        # K and L: threads a block
CHUNK_BYTES = 65536  # K and L: bytes of one slab a chunk reads
# The element types these kernels take, by the code their entry points read.
DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
STATS_FORMS = {"coeffs": 1, "sums": 2}
APPLY_FORMS = {"affine": 1, "affine_silu": 2}
LN_FORMS = {"affine": 1, "normalize": 2}


def launch_plan(c: int, dtype) -> dict:
    """K's and L's geometry for C channels of this type, which the kernels
    check: ``vec`` values a 16-byte vector, C / vec vectors in ``slabs``
    slabs of at most 256 (``slab_vecs``), ``row_lanes`` = 256 // slab_vecs
    threads down the rows, and ``chunk_rows`` rows a chunk: 64 KB of a slab,
    rounded up to a multiple of row_lanes. It depends on C and the type
    alone."""
    vec = 16 // (torch.finfo(dtype).bits // 8)
    cv = c // vec
    slabs = -(-cv // THREADS)
    slab_vecs = -(-cv // slabs)
    row_lanes = THREADS // slab_vecs
    want = -(-CHUNK_BYTES // (slab_vecs * 16))
    return {"vec": vec, "slabs": slabs, "slab_vecs": slab_vecs, "row_lanes": row_lanes,
            "chunk_rows": -(-want // row_lanes) * row_lanes}


def chunk_count(rows: int, plan: dict) -> int:
    return -(-rows // plan["chunk_rows"])


def chunk_ranges(rows: int, plan: dict):
    """The [start, stop) rows of each of a sample's chunks, in the order
    K's second pass sums them."""
    step = plan["chunk_rows"]
    return [(r, min(r + step, rows)) for r in range(0, rows, step)]


def lane_rows(start: int, stop: int, plan: dict, lane: int):
    """The rows row lane ``lane`` of a chunk sums, in order."""
    return list(range(start + lane, stop, plan["row_lanes"]))


# ---- plain versions (lvd_tpu/ops/basic.py:59-155) ----

def group_sums_plain(xr, num_groups: int):
    """Per-group fp32 sums of x and x*x of xr (N, R, C), per channel first."""
    n, _, c = xr.shape
    g = num_groups
    s1c = xr.sum(dim=1, dtype=torch.float32)
    x32 = xr.float()
    s2c = (x32 * x32).sum(dim=1)
    del x32
    return s1c.view(n, g, c // g).sum(-1), s2c.view(n, g, c // g).sum(-1)


def _coeffs_from_sums(p, s1, s2, per_group, c, num_groups, eps, axis_name, count_override):
    g = num_groups
    if axis_name is not None:
        from ..parallel import comm

        s1 = comm.psum(s1, axis_name)
        s2 = comm.psum(s2, axis_name)
        per_group = per_group * comm.axis_size(axis_name)
    if count_override is not None:
        per_group = count_override
    mean_g = s1 / per_group
    var_g = torch.clamp(s2 / per_group - mean_g * mean_g, min=0.0)
    inv_g = torch.rsqrt(var_g + eps)
    inv_c = inv_g.repeat_interleave(c // g, dim=1)
    mean_c = mean_g.repeat_interleave(c // g, dim=1)
    a = inv_c * p["scale"].float()[None, :]
    b = p["bias"].float()[None, :] - mean_c * a
    return a, b


def group_norm_coeffs_plain(p, x, num_groups: int = 32, eps: float = 1e-5, axis_name=None,
                            count_override: Optional[int] = None):
    """Per-channel affine GroupNorm coefficients (a, b), both (N, C) fp32,
    such that ``y = x * a + b``. One-pass fp32 statistics (m2 - mean^2),
    as lvd_tpu computes them. ``axis_name``: a parallel/comm.Group over
    which x is sharded (frames across ranks): the group sums are psummed
    and the per-group count scaled by the group's size; ``count_override``
    is the exact count where the shard carries zero padding."""
    n, c = x.shape[0], x.shape[-1]
    xr = x.reshape(n, -1, c)
    s1, s2 = group_sums_plain(xr, num_groups)
    return _coeffs_from_sums(p, s1, s2, xr.shape[1] * (c // num_groups), c, num_groups, eps,
                             axis_name, count_override)


def group_norm_apply_plain(xr, a, b, silu: bool = False):
    """xr (N, R, C) * a + b with a and b (N, C) fp32 cast to x's type, in x's
    type (lvd_tpu/ops/basic.py:140), then SiLU where asked."""
    y = xr * a[:, None, :].to(xr.dtype) + b[:, None, :].to(xr.dtype)
    return F.silu(y) if silu else y


def group_norm_plain(p, x, num_groups: int = 32, eps: float = 1e-5, axis_name=None,
                     count_override: Optional[int] = None):
    """GroupNorm over channels-last input of any rank >= 2; statistics per
    (batch, group) over all non-batch axes (and over ``axis_name``'s ranks,
    see group_norm_coeffs_plain), applied in the input dtype."""
    n, c = x.shape[0], x.shape[-1]
    a, b = group_norm_coeffs_plain(p, x, num_groups, eps, axis_name, count_override)
    return group_norm_apply_plain(x.reshape(n, -1, c), a, b).reshape(x.shape)


def group_norm_silu_plain(p, x, num_groups: int = 32, eps: float = 1e-5, axis_name=None,
                          count_override: Optional[int] = None):
    return F.silu(group_norm_plain(p, x, num_groups, eps, axis_name, count_override))


def layer_norm_plain(p: Optional[dict], x, eps: float = 1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    m2 = (x32 * x32).mean(dim=-1, keepdim=True)
    var = torch.clamp(m2 - mean * mean, min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if p is not None:
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---- the kernels' launches (CUDA tensors) ----

def _dtype_code(t, name):
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{name}: kernels K-M take bf16, fp16 or fp32, got {t.dtype}")
    return code


def _input(t, dtype, name):
    """A contiguous, 256-byte aligned CUDA tensor of ``dtype`` (the kernels
    load 16-byte vectors)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 256 else t


def _check_shape(name, shape, n, rows, c, num_groups=1):
    """Raises, naming the shape, unless C % 8 == 0, the groups divide C, and
    1 <= N <= 65535 and 1 <= rows < 2^31."""
    if (c <= 0 or c % 8 or num_groups <= 0 or c % num_groups or not 1 <= n <= 65535
            or not 1 <= rows < 2 ** 31):
        raise ValueError(f"{name}: shape {tuple(shape)} (C = {c}, {num_groups} groups) is not "
                         "one kernels K-M take: C % 8 == 0, groups dividing C, 1 <= N <= 65535, "
                         "1 <= rows < 2^31")


def group_norm_stats(xr, scale, bias, num_groups: int, eps: float, count, form: str = "coeffs"):
    """Kernel K on xr (N, R, C): form ``coeffs`` returns (a, b), each (N, C)
    fp32, from ``count`` values a group; form ``sums`` the (N, G) fp32 sums
    of x and x*x (scale, bias and count unread)."""
    _build.refuse_grad("group_norm_stats", xr, *(() if scale is None else (scale, bias)))
    code = _dtype_code(xr, "group_norm_stats")
    n, r, c = xr.shape
    _check_shape("group_norm_stats", xr.shape, n, r, c, num_groups)
    xr = _input(xr, xr.dtype, "group_norm_stats x")
    plan = launch_plan(c, xr.dtype)
    chunks = chunk_count(r, plan)
    part = torch.empty((2, n, chunks, c), dtype=torch.float32, device=xr.device)
    width = c if form == "coeffs" else num_groups
    out = [torch.empty((n, width), dtype=torch.float32, device=xr.device) for _ in range(2)]
    pcode = 1
    if form == "coeffs":
        scale = _input(scale, scale.dtype, "group_norm_stats scale")
        bias = _input(bias, scale.dtype, "group_norm_stats bias")
        pcode = _dtype_code(scale, "group_norm_stats scale")
        if scale.shape != (c,) or bias.shape != (c,):
            raise ValueError(f"group_norm_stats: scale {tuple(scale.shape)}, bias "
                             f"{tuple(bias.shape)} for C = {c}")
    err = _build.lib().lvd_gn_stats(
        xr.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        None if form == "sums" else scale.data_ptr(), None if form == "sums" else bias.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), n, r, c, num_groups, STATS_FORMS[form],
        plan["vec"], plan["slabs"], plan["slab_vecs"], plan["row_lanes"], plan["chunk_rows"],
        chunks, float(count), float(eps), pcode, code, _build.stream_of(xr))
    _build.check(err, "group_norm_stats")
    group_norm_stats.launches += 1
    group_norm_stats.launches_by_form[form] += 1
    return out[0], out[1]


def group_norm_apply(xr, a, b, silu: bool = False):
    """Kernel L on xr (N, R, C) with a, b (N, C) fp32: ``affine`` or
    ``affine_silu``."""
    _build.refuse_grad("group_norm_apply", xr, a, b)
    code = _dtype_code(xr, "group_norm_apply")
    n, r, c = xr.shape
    _check_shape("group_norm_apply", xr.shape, n, r, c)
    xr = _input(xr, xr.dtype, "group_norm_apply x")
    a = _input(a, torch.float32, "group_norm_apply a")
    b = _input(b, torch.float32, "group_norm_apply b")
    if a.shape != (n, c) or b.shape != (n, c):
        raise ValueError(f"group_norm_apply: x {tuple(xr.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    form = "affine_silu" if silu else "affine"
    plan = launch_plan(c, xr.dtype)
    y = torch.empty_like(xr)
    err = _build.lib().lvd_gn_apply(
        xr.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), n, r, c, APPLY_FORMS[form],
        plan["vec"], plan["slabs"], plan["slab_vecs"], plan["row_lanes"], plan["chunk_rows"],
        chunk_count(r, plan), code, _build.stream_of(xr))
    _build.check(err, "group_norm_apply")
    group_norm_apply.launches += 1
    group_norm_apply.launches_by_form[form] += 1
    return y


def layer_norm_rows(x2, scale, bias, eps: float):
    """Kernel M on x2 (rows, C): form ``affine`` with scale and bias (C,),
    ``normalize`` without (both None)."""
    _build.refuse_grad("layer_norm_rows", x2, *(() if scale is None else (scale, bias)))
    code = _dtype_code(x2, "layer_norm_rows")
    rows, c = x2.shape
    _check_shape("layer_norm_rows", x2.shape, 1, rows, c)
    x2 = _input(x2, x2.dtype, "layer_norm_rows x")
    form, pcode = "normalize", 1
    if scale is not None:
        form = "affine"
        scale = _input(scale, scale.dtype, "layer_norm_rows scale")
        bias = _input(bias, scale.dtype, "layer_norm_rows bias")
        pcode = _dtype_code(scale, "layer_norm_rows scale")
        if scale.shape != (c,) or bias.shape != (c,):
            raise ValueError(f"layer_norm_rows: scale {tuple(scale.shape)}, bias "
                             f"{tuple(bias.shape)} for C = {c}")
    y = torch.empty_like(x2)
    err = _build.lib().lvd_layer_norm(
        x2.data_ptr(), None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), rows, c, LN_FORMS[form],
        float(eps), pcode, code, _build.stream_of(x2))
    _build.check(err, "layer_norm_rows")
    layer_norm_rows.launches += 1
    layer_norm_rows.launches_by_form[form] += 1
    return y


# ---- autograd: forward a kernel (plain on the CPU), backward the plain VJP ----
# Each backward is the plain version's VJP in closed form on stock ops, the
# same arithmetic autograd takes through it, without recomputing the plain
# forward or entering autograd again.

def _coeffs_fn(xr, scale, bias, num_groups, eps, count):
    s1, s2 = group_sums_plain(xr, num_groups)
    return _coeffs_from_sums({"scale": scale, "bias": bias}, s1, s2, count, xr.shape[-1],
                             num_groups, eps, None, None)


def _group_sums(xr, num_groups):
    """The (N, G) sums of x and x*x: K's ``sums`` form on CUDA, the plain
    sums on the CPU."""
    if xr.device.type == "cpu":
        return group_sums_plain(xr, num_groups)
    return group_norm_stats(xr, None, None, num_groups, 0.0, 1, "sums")


def _sums_vjp(xr, ds1, ds2):
    """dx in x's type of the per-group sums of x (fp32 accumulation) and of
    x*x in fp32, from their (N, G) cotangents."""
    c = xr.shape[-1]
    per_channel = lambda t: t.repeat_interleave(c // t.shape[1], dim=1)[:, None, :]
    return per_channel(ds1).to(xr.dtype) + (2.0 * xr.float() * per_channel(ds2)).to(xr.dtype)


class GroupNormCoeffs(torch.autograd.Function):
    """(a, b) of xr (N, R, C): kernel K's ``coeffs`` form."""

    @staticmethod
    def forward(ctx, xr, scale, bias, num_groups, eps, count):
        ctx.save_for_backward(xr, scale, bias)
        ctx.args = (num_groups, eps, count)
        if xr.device.type == "cpu":
            return _coeffs_fn(xr, scale, bias, num_groups, eps, count)
        return group_norm_stats(xr, scale, bias, num_groups, eps, count)

    @staticmethod
    def backward(ctx, da, db):
        xr, scale, bias = ctx.saved_tensors
        num_groups, eps, count = ctx.args
        n, _, c = xr.shape
        s1, s2 = _group_sums(xr, num_groups)
        mean = s1 / count
        var = s2 / count - mean * mean
        inv = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
        inv_c = inv.repeat_interleave(c // num_groups, dim=1)
        mean_c = mean.repeat_interleave(c // num_groups, dim=1)
        a = inv_c * scale.float()
        da = da - db * mean_c  # b = bias - mean_c * a
        per_group = lambda t: t.view(n, num_groups, -1).sum(-1)
        dvar = per_group(da * scale.float()) * (-0.5) * inv * inv * inv * (var >= 0)
        dmean = -per_group(db * a) - 2.0 * mean * dvar
        need = ctx.needs_input_grad
        dx = _sums_vjp(xr, dmean / count, dvar / count) if need[0] else None
        dscale = (da * inv_c).sum(0).to(scale.dtype) if need[1] else None
        dbias = db.sum(0).to(bias.dtype) if need[2] else None
        return dx, dscale, dbias, None, None, None


class GroupSums(torch.autograd.Function):
    """The (N, G) sums of x and x*x of xr: kernel K's ``sums`` form."""

    @staticmethod
    def forward(ctx, xr, num_groups):
        ctx.save_for_backward(xr)
        return _group_sums(xr, num_groups)

    @staticmethod
    def backward(ctx, ds1, ds2):
        (xr,) = ctx.saved_tensors
        return _sums_vjp(xr, ds1, ds2), None


class GroupNormApply(torch.autograd.Function):
    """xr * a + b (+ SiLU): kernel L."""

    @staticmethod
    def forward(ctx, xr, a, b, silu):
        ctx.save_for_backward(xr, a, b)
        ctx.silu = silu
        if xr.device.type == "cpu":
            return group_norm_apply_plain(xr, a, b, silu)
        return group_norm_apply(xr, a, b, silu)

    @staticmethod
    def backward(ctx, dy):
        xr, a, b = ctx.saved_tensors
        at = a[:, None, :].to(xr.dtype)
        if ctx.silu:
            dy = torch.ops.aten.silu_backward(dy, xr * at + b[:, None, :].to(xr.dtype))
        need = ctx.needs_input_grad
        return (dy * at if need[0] else None,
                (dy * xr).sum(1).float() if need[1] else None,
                dy.sum(1).float() if need[2] else None, None)


class LayerNorm(torch.autograd.Function):
    """LayerNorm of x2 (rows, C): kernel M."""

    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        ctx.save_for_backward(x2, scale, bias)
        ctx.eps = eps
        if x2.device.type == "cpu":
            return layer_norm_plain(None if scale is None else {"scale": scale, "bias": bias},
                                    x2, eps)
        return layer_norm_rows(x2, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x2, scale, bias = ctx.saved_tensors
        need = ctx.needs_input_grad
        x32, c = x2.float(), x2.shape[-1]
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean
        rstd = torch.rsqrt(torch.clamp(var, min=0.0) + ctx.eps)
        xc = x32 - mean
        g = dy.float()
        dscale = dbias = None
        if scale is not None:
            if need[1]:
                dscale = (g * (xc * rstd)).sum(0).to(scale.dtype)
            if need[2]:
                dbias = g.sum(0).to(bias.dtype)
            g = g * scale.float()
        dx = None
        if need[0]:
            dvar = (g * xc).sum(-1, keepdim=True) * (-0.5) * rstd * rstd * rstd * (var >= 0)
            dmean = -(g.sum(-1, keepdim=True) * rstd) - 2.0 * mean * dvar
            dx = (g * rstd + dmean / c + dvar * (2.0 / c) * x32).to(x2.dtype)
        return dx, dscale, dbias, None


# ---- the public functions (ops/basic.py calls them; plain_route swaps them) ----

def group_norm_coeffs(p, x, num_groups: int = 32, eps: float = 1e-5, axis_name=None,
                      count_override: Optional[int] = None):
    """group_norm_coeffs_plain's (a, b) through kernel K: its ``coeffs`` form
    unsharded, its ``sums`` form (then psum and the plain arithmetic) where
    ``axis_name`` is set."""
    n, c = x.shape[0], x.shape[-1]
    xr = x.reshape(n, -1, c)
    per_group = xr.shape[1] * (c // num_groups)
    if axis_name is None:
        count = per_group if count_override is None else count_override
        return GroupNormCoeffs.apply(xr, p["scale"], p["bias"], num_groups, eps, count)
    s1, s2 = GroupSums.apply(xr, num_groups)
    return _coeffs_from_sums(p, s1, s2, per_group, c, num_groups, eps, axis_name,
                             count_override)


def _group_norm(p, x, num_groups, eps, axis_name, count_override, silu):
    n, c = x.shape[0], x.shape[-1]
    a, b = group_norm_coeffs(p, x, num_groups, eps, axis_name, count_override)
    return GroupNormApply.apply(x.reshape(n, -1, c), a, b, silu).reshape(x.shape)


def group_norm(p, x, num_groups: int = 32, eps: float = 1e-5, axis_name=None,
               count_override: Optional[int] = None):
    """group_norm_plain through kernels K and L (``affine``)."""
    return _group_norm(p, x, num_groups, eps, axis_name, count_override, False)


def group_norm_silu(p, x, num_groups: int = 32, eps: float = 1e-5, axis_name=None,
                    count_override: Optional[int] = None):
    """silu(group_norm_plain(...)) through kernels K and L (``affine_silu``)."""
    return _group_norm(p, x, num_groups, eps, axis_name, count_override, True)


def layer_norm(p: Optional[dict], x, eps: float = 1e-5):
    """layer_norm_plain through kernel M over the rows of x (..., C)."""
    scale, bias = (None, None) if p is None else (p["scale"], p["bias"])
    y = LayerNorm.apply(x.reshape(-1, x.shape[-1]), scale, bias, eps)
    return y.reshape(x.shape)


group_norm_stats.launches = 0
group_norm_stats.launches_by_form = dict.fromkeys(STATS_FORMS, 0)
group_norm_apply.launches = 0
group_norm_apply.launches_by_form = dict.fromkeys(APPLY_FORMS, 0)
layer_norm_rows.launches = 0
layer_norm_rows.launches_by_form = dict.fromkeys(LN_FORMS, 0)
