"""GroupNorm and LayerNorm: kernels K, L and M (csrc/norms.cu), their
backwards N and O (csrc/norms_bwd.cu), and their plain versions
(counterpart of lvd_tpu/ops/basic.py:59-155 and of its VJPs).

lvd_tpu leaves ``group_norm_coeffs``, ``group_norm`` and ``layer_norm`` to
XLA, which fuses each elementwise chain, forward and (under ``jax.grad``)
backward; these kernels are the port's counterpart of those fusions (no
Pallas kernel is replaced, and every Pallas routing predicate stays
lvd_tpu's). Each public function runs a ``torch.autograd.Function``: on a
CUDA tensor its forward launches a kernel and its backward launches N or O,
on a CPU tensor both run the plain versions (``*_plain``, ``*_bwd_plain``:
the VJPs in closed form with their rounding points stated). A Function
saves x, its (N, C) or parameter inputs and, where an input needs a
gradient, the forward's fp32 statistics (mean, inv or rstd, and the
variance clamp's mask), no fp32 copy of the activation.

- K, ``group_norm_stats``: one read of x (N, R, C), per-channel fp32 sums of
  x and x*x over chunks of rows, then per group, and either the (N, C) fp32
  affine (a, b) (form ``coeffs``; also the (3, N, G) statistics N reads) or,
  frame-sharded, the (N, G) sums that go through ``comm.psum`` and the
  plain arithmetic (form ``sums``). The chunks (``launch_plan``,
  ``chunk_ranges``) depend on C, the type and R alone, so a sample's
  statistics are the same bits alone or in a batch.
- L, ``group_norm_apply``: y = x * a + b with lvd_tpu's rounding points
  (forms ``affine`` and ``affine_silu``, SiLU on the rounded value).
- M, ``layer_norm_rows``: LayerNorm over rows, fp32 statistics, one rounding
  (forms ``affine`` and ``normalize``, lvd_tpu's ``p is None``).
- N, ``group_norm_bwd``: dx (and dscale, dbias where asked) of K then L
  (forms ``affine``, ``affine_silu``: ``GroupNorm``), of K's coefficients
  alone (``coeffs``: ``GroupNormCoeffs``, before kernels D and I), of K's
  sums (``sums``: ``GroupSums``) and of L alone (``apply``,
  ``apply_silu``: ``GroupNormApply``), the last two frame-sharded, on K's
  plan, so a sample's gradient is the same bits alone or in a batch.
- O, ``layer_norm_bwd``: dx of M a warp a row from M's saved statistics
  (form ``dx``), and dscale, dbias summed over rows on K's plan
  (``dx_params``).

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
GN_BWD_FORMS = {"affine": 1, "affine_silu": 2, "coeffs": 3, "sums": 4, "apply": 5,
                "apply_silu": 6}
LN_BWD_FORMS = {"dx": 1, "dx_params": 2}


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


def _moments(s1, s2, count, eps):
    """mean, the unclamped variance (one pass: m2 - mean^2) and rsqrt of
    the clamped one plus eps, from fp32 sums of x and x*x over ``count``
    values."""
    mean = s1 / count
    var = s2 / count - mean * mean
    return mean, var, torch.rsqrt(torch.clamp(var, min=0.0) + eps)


def _coeffs_from_sums(p, s1, s2, per_group, c, num_groups, eps, axis_name, count_override):
    g = num_groups
    if axis_name is not None:
        from ..parallel import comm

        s1 = comm.psum(s1, axis_name)
        s2 = comm.psum(s2, axis_name)
        per_group = per_group * comm.axis_size(axis_name)
    if count_override is not None:
        per_group = count_override
    mean_g, _, inv_g = _moments(s1, s2, per_group, eps)
    return _coeffs_from_moments(p["scale"], p["bias"], mean_g, inv_g, c)


def _coeffs_from_moments(scale, bias, mean_g, inv_g, c):
    """The (N, C) fp32 affine (a, b) from the (N, G) mean and inv."""
    g = mean_g.shape[1]
    inv_c = inv_g.repeat_interleave(c // g, dim=1)
    mean_c = mean_g.repeat_interleave(c // g, dim=1)
    a = inv_c * scale.float()[None, :]
    b = bias.float()[None, :] - mean_c * a
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


def _row_moments(x32, eps):
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean
    return mean, var, torch.rsqrt(torch.clamp(var, min=0.0) + eps)


def layer_norm_plain(p: Optional[dict], x, eps: float = 1e-5):
    x32 = x.float()
    mean, _, rstd = _row_moments(x32, eps)
    y = (x32 - mean) * rstd
    if p is not None:
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---- plain backwards (the VJPs of the plain versions in closed form) ----
# ``stats`` is the forward's (3, N, G) or (3, rows) fp32: mean, inv (rstd),
# and 1 where the variance was not clamped at 0 (the clamp's gradient mask).
# The rounding points are the plain forward's: L's (a, b) are cast to x's
# type, so their cotangents are sums in x's type; ``group_sums_bwd_plain``'s
# two terms round to x's type and add there; LayerNorm's dx is fp32, rounded
# once.

def group_stats_plain(xr, num_groups, eps, count):
    """K's (3, N, G) statistics of xr (N, R, C) over ``count`` values a
    group."""
    mean, var, inv = _moments(*group_sums_plain(xr, num_groups), count, eps)
    return torch.stack([mean, inv, (var >= 0).float()])


def layer_norm_stats_plain(x2, eps):
    """M's (3, rows) statistics of x2 (rows, C)."""
    mean, var, rstd = _row_moments(x2.float(), eps)
    return torch.stack([mean[:, 0], rstd[:, 0], (var[:, 0] >= 0).float()])


def group_sums_bwd_terms(xr, ds1, ds2):
    """The two terms of group_sums_bwd_plain's dx, ds1 (N, 1, C) and 2 x ds2
    (N, R, C), each rounded to x's type."""
    c = xr.shape[-1]
    per_channel = lambda t: t.repeat_interleave(c // t.shape[1], dim=1)[:, None, :]
    return per_channel(ds1).to(xr.dtype), (2.0 * xr.float() * per_channel(ds2)).to(xr.dtype)


def group_sums_bwd_plain(xr, ds1, ds2):
    """dx in x's type of the per-group sums of x (fp32 accumulation) and of
    x*x in fp32, from their (N, G) cotangents: each term rounded to x's
    type, then their sum."""
    t1, t2 = group_sums_bwd_terms(xr, ds1, ds2)
    return t1 + t2


def _per_channel_stats(stats, c):
    mean, inv, _ = stats
    g = mean.shape[1]
    return mean.repeat_interleave(c // g, dim=1), inv.repeat_interleave(c // g, dim=1)


def group_coeffs_sums_bwd_plain(da, db, scale, stats, count):
    """The (N, G) cotangents (ds1, ds2) of K's group sums of x and x*x from
    the (N, C) fp32 cotangents of its (a, b) over ``count`` values a group:
    dmean / count and dvar / count."""
    n, c = da.shape
    mean, inv, keep = stats
    mean_c, inv_c = _per_channel_stats(stats, c)
    da = da - db * mean_c  # b = bias - mean_c * a
    per_group = lambda t: t.view(n, mean.shape[1], -1).sum(-1)
    dvar = per_group(da * scale.float()) * (-0.5) * inv * inv * inv * keep
    dmean = -per_group(db * (inv_c * scale.float())) - 2.0 * mean * dvar
    return dmean / count, dvar / count


def group_norm_coeffs_bwd_plain(xr, da, db, scale, stats, count, params=False):
    """(dx, dscale, dbias) of K's (a, b) of xr from their (N, C) fp32
    cotangents: dmean and dvar per group, then the sums' dx; dscale and
    dbias (in scale's type) where ``params``."""
    dx = group_sums_bwd_plain(xr, *group_coeffs_sums_bwd_plain(da, db, scale, stats, count))
    if not params:
        return dx, None, None
    mean_c, inv_c = _per_channel_stats(stats, xr.shape[-1])
    return (dx, ((da - db * mean_c) * inv_c).sum(0).to(scale.dtype),
            db.sum(0).to(scale.dtype))


def group_norm_apply_bwd_plain(xr, dy, a, b, silu=False):
    """(dx, da, db) of L (+ SiLU) of xr from dy: dz (SiLU's derivative at
    L's rounded z, in x's type), dx = dz * a in x's type, and the (N, C)
    cotangents of (a, b) as sums in x's type (L casts them to it), then
    fp32."""
    at = a[:, None, :].to(xr.dtype)
    dz = dy
    if silu:
        dz = torch.ops.aten.silu_backward(dy, xr * at + b[:, None, :].to(xr.dtype))
    return dz * at, (dz * xr).sum(1).float(), dz.sum(1).float()


def group_norm_bwd_plain(xr, dy, a, b, scale, stats, count, silu=False, params=False):
    """(dx, dscale, dbias) of K then L (+ SiLU) of xr from dy: L's, then
    K's from the cotangents of (a, b); the two dx terms added in x's
    type."""
    dx_l, da, db = group_norm_apply_bwd_plain(xr, dy, a, b, silu)
    dx, dscale, dbias = group_norm_coeffs_bwd_plain(xr, da, db, scale, stats, count, params)
    return dx_l + dx, dscale, dbias


def layer_norm_bwd_plain(x2, dy, scale, stats, params=False):
    """(dx, dscale, dbias) of LayerNorm over the rows of x2 (scale None:
    ``normalize``), all in fp32, dx rounded once to x's type, dscale and
    dbias (in scale's type) where ``params``."""
    mean, rstd, keep = (t[:, None] for t in stats)
    x32, c = x2.float(), x2.shape[-1]
    xc = x32 - mean
    g = dy.float()
    dscale = dbias = None
    if params:
        dscale = (g * (xc * rstd)).sum(0).to(scale.dtype)
        dbias = g.sum(0).to(scale.dtype)
    if scale is not None:
        g = g * scale.float()
    dvar = (g * xc).sum(-1, keepdim=True) * (-0.5) * rstd * rstd * rstd * keep
    dmean = -(g.sum(-1, keepdim=True) * rstd) - 2.0 * mean * dvar
    return (g * rstd + dmean / c + dvar * (2.0 / c) * x32).to(x2.dtype), dscale, dbias


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


def _checked(t, shape, name):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {tuple(t.shape)}, expected {tuple(shape)}")
    return t


def _check_shape(name, shape, n, rows, c, num_groups=1):
    """Raises, naming the shape, unless C % 8 == 0, the groups divide C, and
    1 <= N <= 65535 and 1 <= rows < 2^31."""
    if (c <= 0 or c % 8 or num_groups <= 0 or c % num_groups or not 1 <= n <= 65535
            or not 1 <= rows < 2 ** 31):
        raise ValueError(f"{name}: shape {tuple(shape)} (C = {c}, {num_groups} groups) is not "
                         "one kernels K-M take: C % 8 == 0, groups dividing C, 1 <= N <= 65535, "
                         "1 <= rows < 2^31")


def group_norm_stats(xr, scale, bias, num_groups: int, eps: float, count, form: str = "coeffs",
                     stats: bool = False):
    """Kernel K on xr (N, R, C): form ``coeffs`` returns (a, b), each (N, C)
    fp32, from ``count`` values a group, and with ``stats`` also the (3, N,
    G) fp32 statistics kernel N reads (mean, inv, the clamp's mask); form
    ``sums`` the (N, G) fp32 sums of x and x*x (scale, bias and count
    unread)."""
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
    if stats:
        out.append(torch.empty((3, n, num_groups), dtype=torch.float32, device=xr.device))
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
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr() if stats else None, n, r, c,
        num_groups, STATS_FORMS[form],
        plan["vec"], plan["slabs"], plan["slab_vecs"], plan["row_lanes"], plan["chunk_rows"],
        chunks, float(count), float(eps), pcode, code, _build.stream_of(xr))
    _build.check(err, "group_norm_stats")
    group_norm_stats.launches += 1
    group_norm_stats.launches_by_form[form] += 1
    return tuple(out)


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


def layer_norm_rows(x2, scale, bias, eps: float, stats: bool = False):
    """Kernel M on x2 (rows, C): form ``affine`` with scale and bias (C,),
    ``normalize`` without (both None); with ``stats`` also the (3, rows)
    fp32 statistics kernel O reads (mean, rstd, the clamp's mask)."""
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
    st = torch.empty((3, rows), dtype=torch.float32, device=x2.device) if stats else None
    err = _build.lib().lvd_layer_norm(
        x2.data_ptr(), None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        None if st is None else st.data_ptr(), rows, c, LN_FORMS[form], float(eps), pcode, code,
        _build.stream_of(x2))
    _build.check(err, "layer_norm_rows")
    layer_norm_rows.launches += 1
    layer_norm_rows.launches_by_form[form] += 1
    return (y, st) if stats else y


def _params_input(scale, c, name):
    """scale (C,) as a kernel input and its type's code."""
    scale = _input(scale, scale.dtype, name)
    if scale.shape != (c,):
        raise ValueError(f"{name}: {tuple(scale.shape)} for C = {c}")
    return scale, _dtype_code(scale, name)


def group_norm_bwd(form: str, xr, *, dy=None, a=None, b=None, da=None, db=None, scale=None,
                   stats=None, ds=None, count=1, params: bool = False):
    """Kernel N on xr (N, R, C), returning (dx, dscale, dbias) (the last two
    None unless ``params``). Forms ``affine`` / ``affine_silu``: dy the
    cotangent of L's output, a, b K's (N, C) coefficients; ``coeffs``: da,
    db the (N, C) cotangents of K's (a, b); both with scale (C,) and K's
    (3, N, G) ``stats`` over ``count`` values a group. ``sums``: ds (2, N,
    G), the cotangents of K's sums of x and x*x. ``apply`` / ``apply_silu``
    (L alone): dy, a, b as in ``affine``, returning (dx, da, db), the (N, C)
    fp32 cotangents of (a, b); their chunk sums run 8 channels a block."""
    _build.refuse_grad("group_norm_bwd", *(t for t in (xr, dy, da, db, ds) if t is not None))
    apply_only = form in ("apply", "apply_silu")
    if form not in GN_BWD_FORMS or (params and (form == "sums" or apply_only)):
        raise ValueError(f"group_norm_bwd: no form {form!r}{' with params' if params else ''}")
    code = _dtype_code(xr, "group_norm_bwd")
    n, r, c = xr.shape
    g = c // 8 if apply_only else (ds if form == "sums" else stats).shape[-1]
    _check_shape("group_norm_bwd", xr.shape, n, r, c, max(g, 1))
    xr = _input(xr, xr.dtype, "group_norm_bwd x")
    plan = launch_plan(c, xr.dtype)
    chunks = chunk_count(r, plan)
    f32 = lambda t, name, shape: _checked(_input(t, torch.float32, name), shape, name)
    pcode, ptrs = 1, {}
    if form not in ("coeffs", "sums"):
        ptrs["dy"] = _checked(_input(dy, xr.dtype, "group_norm_bwd dy"), xr.shape, "dy")
        ptrs["a"], ptrs["b"] = f32(a, "a", (n, c)), f32(b, "b", (n, c))
        ptrs["part1"], ptrs["part2"] = torch.empty((2, n, chunks, c), dtype=torch.float32,
                                                   device=xr.device)
    if form == "coeffs":
        ptrs["da"], ptrs["db"] = f32(da, "da", (n, c)), f32(db, "db", (n, c))
    if form in ("affine", "affine_silu", "coeffs"):
        scale, pcode = _params_input(scale, c, "group_norm_bwd scale")
        ptrs["scale"], ptrs["stats"] = scale, f32(stats, "stats", (3, n, g))
        if form != "coeffs":
            ptrs["ds"] = torch.empty((2, n, g), dtype=torch.float32, device=xr.device)
    elif form == "sums":
        ptrs["ds"] = f32(ds, "ds", (2, n, g))
    ptrs["dx"] = torch.empty_like(xr)
    if params or apply_only:
        ptrs["terms"] = torch.empty((2, n, c), dtype=torch.float32, device=xr.device)
    if params:
        ptrs["dscale"], ptrs["dbias"] = torch.empty((2, c), dtype=scale.dtype, device=xr.device)
    ptr = lambda key: None if ptrs.get(key) is None else ptrs[key].data_ptr()
    err = _build.lib().lvd_gn_bwd(
        xr.data_ptr(), *map(ptr, ("dy", "a", "b", "da", "db", "scale", "stats", "ds", "part1",
                                  "part2", "terms", "dx", "dscale", "dbias")),
        n, r, c, g, GN_BWD_FORMS[form], plan["vec"], plan["slabs"], plan["slab_vecs"],
        plan["row_lanes"], plan["chunk_rows"], chunks, float(count), pcode, code,
        _build.stream_of(xr))
    _build.check(err, "group_norm_bwd")
    group_norm_bwd.launches += 1
    group_norm_bwd.launches_by_form[form] += 1
    if apply_only:
        return ptrs["dx"], ptrs["terms"][0], ptrs["terms"][1]
    return ptrs["dx"], ptrs.get("dscale"), ptrs.get("dbias")


def layer_norm_bwd(x2, dy, scale, stats, params: bool = False):
    """Kernel O on x2 (rows, C): (dx, dscale, dbias) of LayerNorm from dy,
    scale (C,) or None (``normalize``) and M's (3, rows) ``stats``; form
    ``dx_params`` (``params``) also sums dscale and dbias over the rows."""
    _build.refuse_grad("layer_norm_bwd", x2, dy)
    code = _dtype_code(x2, "layer_norm_bwd")
    rows, c = x2.shape
    _check_shape("layer_norm_bwd", x2.shape, 1, rows, c)
    form = "dx_params" if params else "dx"
    if stats is None:
        raise ValueError("layer_norm_bwd: takes M's statistics")
    if params and scale is None:
        raise ValueError("layer_norm_bwd: dx_params takes scale")
    x2 = _input(x2, x2.dtype, "layer_norm_bwd x")
    dy = _checked(_input(dy, x2.dtype, "layer_norm_bwd dy"), x2.shape, "dy")
    pcode = 1
    if scale is not None:
        scale, pcode = _params_input(scale, c, "layer_norm_bwd scale")
    stats = _checked(_input(stats, torch.float32, "layer_norm_bwd stats"), (3, rows), "stats")
    plan = launch_plan(c, x2.dtype)
    chunks = chunk_count(rows, plan)
    dx = torch.empty_like(x2)
    part = dparams = (None, None)
    if params:
        part = torch.empty((2, chunks, c), dtype=torch.float32, device=x2.device)
        dparams = torch.empty((2, c), dtype=scale.dtype, device=x2.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.lib().lvd_layer_norm_bwd(
        x2.data_ptr(), dy.data_ptr(), ptr(scale), stats.data_ptr(), dx.data_ptr(), ptr(part[0]),
        ptr(part[1]), ptr(dparams[0]), ptr(dparams[1]), rows, c, LN_BWD_FORMS[form],
        plan["vec"], plan["slabs"], plan["slab_vecs"], plan["row_lanes"], plan["chunk_rows"],
        chunks, pcode, code, _build.stream_of(x2))
    _build.check(err, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    layer_norm_bwd.launches_by_form[form] += 1
    return (dx, *dparams)


# ---- autograd: forward K-M, backward N and O (the plain versions on the CPU) ----
# Each backward computes every gradient its kernel gives and returns those
# asked for; ``once_differentiable``: a second derivative raises.

def _coeffs_and_stats(ctx, xr, scale, bias, num_groups, eps, count):
    """K's (a, b) and, where an input of the Function needs a gradient,
    its (3, N, G) statistics (else None): the kernel on CUDA, the plain
    versions on the CPU."""
    want = any(ctx.needs_input_grad[:3])
    if xr.device.type != "cpu":
        out = group_norm_stats(xr, scale, bias, num_groups, eps, count, stats=want)
        return out if want else (*out, None)
    stats = group_stats_plain(xr, num_groups, eps, count)
    return (*_coeffs_from_moments(scale, bias, stats[0], stats[1], xr.shape[-1]), stats)


def _asked(grads, need):
    return tuple(g if n else None for g, n in zip(grads, need))


class GroupNorm(torch.autograd.Function):
    """GroupNorm (+ SiLU) of xr (N, R, C): kernel K, then L; backward N
    (``affine`` / ``affine_silu``)."""

    @staticmethod
    def forward(ctx, xr, scale, bias, num_groups, eps, count, silu):
        a, b, stats = _coeffs_and_stats(ctx, xr, scale, bias, num_groups, eps, count)
        ctx.save_for_backward(xr, scale, a, b, stats)
        ctx.args = (count, silu)
        if xr.device.type == "cpu":
            return group_norm_apply_plain(xr, a, b, silu)
        return group_norm_apply(xr, a, b, silu)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        xr, scale, a, b, stats = ctx.saved_tensors
        count, silu = ctx.args
        need = ctx.needs_input_grad
        params = need[1] or need[2]
        if xr.device.type == "cpu":
            grads = group_norm_bwd_plain(xr, dy, a, b, scale, stats, count, silu, params)
        else:
            grads = group_norm_bwd("affine_silu" if silu else "affine", xr, dy=dy, a=a, b=b,
                                   scale=scale, stats=stats, count=count, params=params)
        return (*_asked(grads, need[:3]), None, None, None, None)


class GroupNormCoeffs(torch.autograd.Function):
    """(a, b) of xr (N, R, C): kernel K's ``coeffs`` form; backward N
    (``coeffs``)."""

    @staticmethod
    def forward(ctx, xr, scale, bias, num_groups, eps, count):
        a, b, stats = _coeffs_and_stats(ctx, xr, scale, bias, num_groups, eps, count)
        ctx.save_for_backward(xr, scale, stats)
        ctx.count = count
        return a, b

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, da, db):
        xr, scale, stats = ctx.saved_tensors
        need = ctx.needs_input_grad
        params = need[1] or need[2]
        if xr.device.type == "cpu":
            grads = group_norm_coeffs_bwd_plain(xr, da, db, scale, stats, ctx.count, params)
        else:
            grads = group_norm_bwd("coeffs", xr, da=da, db=db, scale=scale, stats=stats,
                                   count=ctx.count, params=params)
        return (*_asked(grads, need[:3]), None, None, None)


class GroupSums(torch.autograd.Function):
    """The (N, G) sums of x and x*x of xr: kernel K's ``sums`` form;
    backward N (``sums``)."""

    @staticmethod
    def forward(ctx, xr, num_groups):
        ctx.save_for_backward(xr)
        if xr.device.type == "cpu":
            return group_sums_plain(xr, num_groups)
        return group_norm_stats(xr, None, None, num_groups, 0.0, 1, "sums")

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ds1, ds2):
        (xr,) = ctx.saved_tensors
        if xr.device.type == "cpu":
            return group_sums_bwd_plain(xr, ds1, ds2), None
        return group_norm_bwd("sums", xr, ds=torch.stack([ds1, ds2]))[0], None


class GroupNormApply(torch.autograd.Function):
    """xr * a + b (+ SiLU) with (a, b) from the frame-sharded statistics:
    kernel L; backward N (``apply`` / ``apply_silu``)."""

    @staticmethod
    def forward(ctx, xr, a, b, silu):
        ctx.save_for_backward(xr, a, b)
        ctx.silu = silu
        if xr.device.type == "cpu":
            return group_norm_apply_plain(xr, a, b, silu)
        return group_norm_apply(xr, a, b, silu)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        xr, a, b = ctx.saved_tensors
        if xr.device.type == "cpu":
            grads = group_norm_apply_bwd_plain(xr, dy, a, b, ctx.silu)
        else:
            grads = group_norm_bwd("apply_silu" if ctx.silu else "apply", xr, dy=dy, a=a, b=b)
        return (*_asked(grads, ctx.needs_input_grad[:3]), None)


class LayerNorm(torch.autograd.Function):
    """LayerNorm of x2 (rows, C): kernel M; backward O."""

    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        if x2.device.type == "cpu":
            y = layer_norm_plain(None if scale is None else {"scale": scale, "bias": bias}, x2,
                                 eps)
            stats = layer_norm_stats_plain(x2, eps)
        elif any(ctx.needs_input_grad[:3]):
            y, stats = layer_norm_rows(x2, scale, bias, eps, stats=True)
        else:  # no backward reads the statistics
            y, stats = layer_norm_rows(x2, scale, bias, eps), None
        ctx.save_for_backward(x2, scale, stats)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x2, scale, stats = ctx.saved_tensors
        need = ctx.needs_input_grad
        params = scale is not None and (need[1] or need[2])
        if x2.device.type == "cpu":
            grads = layer_norm_bwd_plain(x2, dy, scale, stats, params)
        else:
            grads = layer_norm_bwd(x2, dy, scale, stats, params)
        return (*_asked(grads, need[:3]), None)


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
    xr = x.reshape(n, -1, c)
    if axis_name is None:
        count = xr.shape[1] * (c // num_groups) if count_override is None else count_override
        return GroupNorm.apply(xr, p["scale"], p["bias"], num_groups, eps, count,
                               silu).reshape(x.shape)
    a, b = group_norm_coeffs(p, x, num_groups, eps, axis_name, count_override)
    return GroupNormApply.apply(xr, a, b, silu).reshape(x.shape)


def group_norm(p, x, num_groups: int = 32, eps: float = 1e-5, axis_name=None,
               count_override: Optional[int] = None):
    """group_norm_plain through kernels K and L (``affine``); backward N."""
    return _group_norm(p, x, num_groups, eps, axis_name, count_override, False)


def group_norm_silu(p, x, num_groups: int = 32, eps: float = 1e-5, axis_name=None,
                    count_override: Optional[int] = None):
    """silu(group_norm_plain(...)) through kernels K and L (``affine_silu``);
    backward N."""
    return _group_norm(p, x, num_groups, eps, axis_name, count_override, True)


def layer_norm(p: Optional[dict], x, eps: float = 1e-5):
    """layer_norm_plain through kernel M over the rows of x (..., C);
    backward O."""
    scale, bias = (None, None) if p is None else (p["scale"], p["bias"])
    y = LayerNorm.apply(x.reshape(-1, x.shape[-1]), scale, bias, eps)
    return y.reshape(x.shape)


group_norm_stats.launches = 0
group_norm_stats.launches_by_form = dict.fromkeys(STATS_FORMS, 0)
group_norm_apply.launches = 0
group_norm_apply.launches_by_form = dict.fromkeys(APPLY_FORMS, 0)
layer_norm_rows.launches = 0
layer_norm_rows.launches_by_form = dict.fromkeys(LN_FORMS, 0)
group_norm_bwd.launches = 0
group_norm_bwd.launches_by_form = dict.fromkeys(GN_BWD_FORMS, 0)
layer_norm_bwd.launches = 0
layer_norm_bwd.launches_by_form = dict.fromkeys(LN_BWD_FORMS, 0)
