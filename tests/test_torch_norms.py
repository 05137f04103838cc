"""Kernels K-O's functions (ops/norms.py) against lvd_tpu on the CPU.

GroupNorm statistics, GroupNorm, silu(GroupNorm) and LayerNorm (with and
without params) go through their autograd Functions, which run the plain
versions on CPU tensors, forward (K, L, M) and backward (N, O); values and
the VJPs (dx, dscale, dbias) are held to lvd_tpu/ops/basic.py and
``jax.vjp`` at 1e-5 of max|ref| in fp32, on inputs drawn with numpy, and in
bf16 (dx alone with frozen params, as the guided update asks, and every
gradient) at BF16_TOL. K's launch plan is checked without a card: its
chunks and row lanes cover each row of a sample exactly once, they do not
depend on N, and the statistics summed in that order match lvd_tpu's; N's
and O's reductions modelled in their kernels' order match lvd_tpu's
gradients and give a sample's the same bits alone or in a batch. The tiny
UNet3D's norm sites are counted against the launch counts chip_smoke.py
gates on the card: per CFG forward, and per guided update's backward.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu.ops import basic as jb
from lvd_tpu_torch.ops import _build
from lvd_tpu_torch.ops import basic as tb
from lvd_tpu_torch.ops import norms

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny shapes: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close_rel(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max|d|/max|ref| = {err:.3g} > {tol}"


def _inputs(seed, shape, c):
    rng = np.random.default_rng(seed)
    x = _normal(rng, shape) + 0.5  # a non-zero mean, as activations carry
    return x, 1.0 + _normal(rng, (c,), 0.1), _normal(rng, (c,), 0.1)


def _jax_value_and_vjp(fn, args, cts):
    """fn(*args) and its VJP at ``cts``, in one jitted call (one compile)."""
    def run(args, cts):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cts)

    return jax.jit(run)(tuple(map(jnp.asarray, args)), jax.tree_util.tree_map(jnp.asarray, cts))


def _functions(kind, groups, eps, count):
    """(lvd_tpu's function, the port's) of (x, scale, bias)."""
    jp = lambda s, b: {"scale": s, "bias": b}
    if kind == "coeffs":
        return (lambda x, s, b: jb.group_norm_coeffs(jp(s, b), x, groups, eps,
                                                     count_override=count),
                lambda x, s, b: tb.group_norm_coeffs(jp(s, b), x, groups, eps,
                                                     count_override=count))
    if kind == "group_norm":
        return (lambda x, s, b: jb.group_norm(jp(s, b), x, groups, eps),
                lambda x, s, b: tb.group_norm(jp(s, b), x, groups, eps))
    if kind == "group_norm_silu":
        return (lambda x, s, b: jax.nn.silu(jb.group_norm(jp(s, b), x, groups, eps)),
                lambda x, s, b: tb.group_norm_silu(jp(s, b), x, groups, eps))
    if kind == "layer_norm":
        return (lambda x, s, b: jb.layer_norm(jp(s, b), x, eps),
                lambda x, s, b: tb.layer_norm(jp(s, b), x, eps))
    return (lambda x: jb.layer_norm(None, x, eps), lambda x: tb.layer_norm(None, x, eps))


# (kind, x shape, groups, eps, count_override): N = 1, 2 and 48; groups of 1,
# 10 and 40 channels; eps 1e-5 and 1e-6; 5-D input; rows (R = 125 at C = 80
# in fp32, chunk 208) that are not a multiple of K's chunk.
CASES = [
    ("coeffs", (1, 37, 80), 8, 1e-5, None),
    ("coeffs", (2, 3, 5, 7, 320), 8, 1e-6, None),
    ("coeffs", (48, 6, 32), 32, 1e-5, None),
    ("coeffs", (2, 125, 80), 8, 1e-5, 1300),
    ("group_norm", (1, 37, 80), 8, 1e-6, None),
    ("group_norm", (2, 4, 5, 6, 320), 8, 1e-5, None),
    ("group_norm", (48, 6, 32), 32, 1e-6, None),
    ("group_norm_silu", (2, 125, 80), 8, 1e-5, None),
    ("group_norm_silu", (48, 3, 4, 40), 4, 1e-6, None),
    ("group_norm_silu", (1, 9, 8, 16), 16, 1e-5, None),
    ("layer_norm", (2, 37, 80), None, 1e-5, None),
    ("layer_norm", (48, 6, 320), None, 1e-6, None),
    ("layer_norm_none", (3, 11, 64), None, 1e-5, None),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}")
def test_norm_values_and_vjps_match_lvd_tpu(case):
    kind, shape, groups, eps, count = case
    c = shape[-1]
    x, s, b = _inputs(len(shape) * 7 + c, shape, c)
    j_fn, t_fn = _functions(kind, groups, eps, count)
    args = (x,) if kind == "layer_norm_none" else (x, s, b)
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    t_out = t_fn(*leaves)
    t_outs = t_out if isinstance(t_out, tuple) else (t_out,)
    rng = np.random.default_rng(99)
    cts = [_normal(rng, o.shape) for o in t_outs]
    j_outs, j_grads = _jax_value_and_vjp(j_fn, args, tuple(cts) if len(cts) > 1 else cts[0])
    j_outs = j_outs if isinstance(j_outs, tuple) else (j_outs,)
    for got, want in zip(t_outs, j_outs):
        _close_rel(got.detach().numpy(), want)
    t_grads = torch.autograd.grad(t_outs, leaves, [torch.from_numpy(ct) for ct in cts])
    assert len(t_grads) == len(j_grads)
    for got, want in zip(t_grads, j_grads):
        _close_rel(got.numpy(), want)


def test_sharded_sums_form_matches_lvd_tpu(monkeypatch):
    """Frame-sharded statistics over an axis of one rank (psum the identity):
    K's ``sums`` Function, then the psum and the plain arithmetic, give
    lvd_tpu's (a, b) and VJP; tests/test_torch_parallel.py runs the same
    route over four gloo ranks."""
    from lvd_tpu_torch.parallel import comm

    monkeypatch.setattr(comm, "psum", lambda t, group: t)
    monkeypatch.setattr(comm, "axis_size", lambda group: 1)
    x, s, b = _inputs(3, (2, 6, 5, 80), 80)
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, s, b)]
    t_out = norms.group_norm_coeffs({"scale": leaves[1], "bias": leaves[2]}, leaves[0], 8, 1e-5,
                                    axis_name="frames", count_override=1000)
    rng = np.random.default_rng(8)
    cts = tuple(_normal(rng, o.shape) for o in t_out)
    j_out, j_grads = _jax_value_and_vjp(lambda x, s, b: jb.group_norm_coeffs(
        {"scale": s, "bias": b}, x, 8, 1e-5, count_override=1000), (x, s, b), cts)
    for got, want in zip(t_out, j_out):
        _close_rel(got.detach().numpy(), want)
    grads = torch.autograd.grad(t_out, leaves, [torch.from_numpy(ct) for ct in cts])
    for got, want in zip(grads, j_grads):
        _close_rel(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("c", [64, 256, 320, 512, 640, 1024, 1280, 1920, 2560, 3072])
def test_stats_plan_covers_each_row_once(c, dtype):
    """K's and L's plan at the port's widths: slabs of at most 256 16-byte
    vectors covering C, row lanes filling at most 256 threads, chunks of at
    least 64 KB of a slab; the chunks and their row lanes cover each row of
    a sample exactly once, at row counts that are and are not a multiple of
    the chunk."""
    plan = norms.launch_plan(c, dtype)
    vec, sv = plan["vec"], plan["slab_vecs"]
    assert vec * torch.finfo(dtype).bits == 128 and sv <= norms.THREADS
    assert plan["slabs"] * sv * vec >= c > (plan["slabs"] - 1) * sv * vec
    assert plan["row_lanes"] == norms.THREADS // sv >= 1
    assert plan["chunk_rows"] % plan["row_lanes"] == 0
    assert plan["chunk_rows"] * sv * 16 >= norms.CHUNK_BYTES
    for rows in (1, plan["chunk_rows"], 3 * plan["chunk_rows"] + 5, 2880):
        seen = []
        for start, stop in norms.chunk_ranges(rows, plan):
            for lane in range(plan["row_lanes"]):
                seen += norms.lane_rows(start, stop, plan, lane)
        assert sorted(seen) == list(range(rows))
        assert len(norms.chunk_ranges(rows, plan)) == norms.chunk_count(rows, plan)


def _k_order(x, scale, bias, groups, eps, count, dtype):
    """K's coefficients summed in its order (chunks, row lanes, channels of
    a group) in fp32, one sample at a time."""
    n, rows, c = x.shape
    plan = norms.launch_plan(c, dtype)
    a, b = np.zeros((n, c), np.float32), np.zeros((n, c), np.float32)
    cpg = c // groups
    for i in range(n):
        part1, part2 = [], []
        for start, stop in norms.chunk_ranges(rows, plan):
            lanes = [x[i, norms.lane_rows(start, stop, plan, lane)]
                     for lane in range(plan["row_lanes"])]
            part1.append(np.sum([v.sum(0, dtype=np.float32) for v in lanes], 0, np.float32))
            part2.append(np.sum([(v * v).sum(0, dtype=np.float32) for v in lanes], 0,
                                np.float32))
        s1 = np.sum(part1, 0, np.float32).reshape(groups, cpg).sum(1, dtype=np.float32)
        s2 = np.sum(part2, 0, np.float32).reshape(groups, cpg).sum(1, dtype=np.float32)
        mean = s1 / np.float32(count)
        inv = 1.0 / np.sqrt(np.maximum(s2 / np.float32(count) - mean * mean, 0) + eps)
        a[i] = np.repeat(inv, cpg) * scale
        b[i] = bias - np.repeat(mean, cpg) * a[i]
    return a, b


@pytest.mark.parametrize("n", [1, 2, 48])
def test_stats_in_kernel_order_match_lvd_tpu_and_do_not_change_with_n(n):
    """The statistics summed in K's order match lvd_tpu's group_norm_coeffs
    at 1e-5, and a sample's chunks are the same alone or in a batch of N
    (the plan takes C and the type, the chunks R: nothing takes N)."""
    rows, c, groups = 500, 80, 8
    x, s, b = _inputs(n, (n, rows, c), c)
    plan = norms.launch_plan(c, torch.float32)
    assert rows % plan["chunk_rows"] and norms.chunk_count(rows, plan) > 1
    got = _k_order(x, s, b, groups, 1e-5, rows * c // groups, torch.float32)
    want = jb.group_norm_coeffs({"scale": jnp.asarray(s), "bias": jnp.asarray(b)},
                                jnp.asarray(x), groups, 1e-5)
    for g, w in zip(got, want):
        _close_rel(g, w)
    alone = _k_order(x[:1], s, b, groups, 1e-5, rows * c // groups, torch.float32)
    assert np.array_equal(alone[0], got[0][:1]) and np.array_equal(alone[1], got[1][:1])


def test_plain_route_swaps_the_norm_functions():
    from lvd_tpu_torch.ops.plain import plain_route

    names = ("group_norm_coeffs", "group_norm", "group_norm_silu", "layer_norm")
    routed = {n: getattr(norms, n) for n in names}
    with plain_route():
        for n in names:
            assert getattr(norms, n) is getattr(norms, f"{n}_plain")
    assert all(getattr(norms, n) is routed[n] for n in names)


def test_norm_wrappers_take_plain_path_on_cpu_without_counting(monkeypatch):
    """On CPU tensors every norm Function runs its plain versions, forward
    (K-M) and backward (N, O), without reaching the library or counting a
    launch."""

    def no_library():
        raise AssertionError("a CPU tensor must not reach the CUDA library")

    monkeypatch.setattr(_build, "lib", no_library)
    wrappers = (norms.group_norm_stats, norms.group_norm_apply, norms.layer_norm_rows,
                norms.group_norm_bwd, norms.layer_norm_bwd)
    before = [(w.launches, dict(w.launches_by_form)) for w in wrappers]
    x, s, b = _inputs(5, (2, 7, 64), 64)
    xt = torch.from_numpy(x).requires_grad_(True)
    p = {"scale": torch.from_numpy(s).requires_grad_(True), "bias": torch.from_numpy(b)}
    outs = [tb.group_norm_silu(p, xt, 8), tb.group_norm(p, xt, 8), tb.layer_norm(p, xt),
            tb.layer_norm(None, xt), torch.stack(tb.group_norm_coeffs(p, xt, 8)),
            torch.stack(norms.GroupSums.apply(xt, 8))]
    torch.autograd.grad(sum(o.sum() for o in outs), [xt, p["scale"]])
    assert [(w.launches, dict(w.launches_by_form)) for w in wrappers] == before


@pytest.mark.parametrize("shape,groups", [((2, 5, 12), 4), ((2, 5, 64), 6), ((0, 5, 64), 8)])
def test_stats_and_apply_raise_on_shapes_they_cannot_take(shape, groups):
    """A non-CPU tensor of a shape K-M cannot take (C % 8, groups not
    dividing C, no sample) raises and names the shape, before any launch
    (meta tensors stand for the card's here)."""
    x = torch.empty(shape, device="meta")
    a = torch.empty(shape[0], shape[2], device="meta")
    with pytest.raises(ValueError, match=str(shape).replace("(", r"\(").replace(")", r"\)")):
        norms.group_norm_stats(x, None, None, groups, 1e-5, 1, "sums")
    if shape[2] % 8:
        with pytest.raises(ValueError, match="C = 12"):
            norms.group_norm_apply(x, a, a)
        with pytest.raises(ValueError, match="C = 12"):
            norms.layer_norm_rows(x.reshape(-1, shape[2]), None, None, 1e-5)


def test_unet_norm_sites_match_the_gated_launch_counts(monkeypatch):
    """The tiny UNet3D (Zeroscope's topology) calls K, L (by form) and M
    exactly as often in one forward as chip_smoke.norm_launches derives from
    its param tree, which the smoke gates per CFG forward on the card."""
    import chip_smoke
    from lvd_tpu_torch.config import PRESETS, tiny_unet_config
    from lvd_tpu_torch.models.unet3d import apply_unet3d, init_unet3d, unet3d_leaves
    from lvd_tpu_torch.utils import prng

    calls = {"group_norm_stats": 0, "affine": 0, "affine_silu": 0, "layer_norm_rows": 0}

    def counted(fn, keys):
        def run(*args):
            for key in keys(args):
                calls[key] += 1
            return fn(*args)
        return run

    # GroupNorm runs K then L (its last argument: SiLU); GroupNormCoeffs K.
    monkeypatch.setattr(norms.GroupNorm, "apply", counted(
        norms.GroupNorm.apply,
        lambda args: ("group_norm_stats", "affine_silu" if args[6] else "affine")))
    monkeypatch.setattr(norms.GroupNormCoeffs, "apply", counted(
        norms.GroupNormCoeffs.apply, lambda args: ("group_norm_stats",)))
    monkeypatch.setattr(norms.LayerNorm, "apply", counted(norms.LayerNorm.apply,
                                                          lambda args: ("layer_norm_rows",)))
    cfg = tiny_unet_config()
    params = init_unet3d(prng.prng_key(0), cfg, device="cpu")
    rng = np.random.default_rng(4)
    sample = torch.from_numpy(_normal(rng, (2, 2, 8, 8, 4)))
    text = torch.from_numpy(_normal(rng, (2, 5, cfg.cross_attention_dim)))
    with torch.no_grad():
        apply_unet3d(params, cfg, sample, 500, text)
    want = chip_smoke.norm_launches(params)
    assert calls == {"group_norm_stats": want["group_norm_stats"],
                     "affine": want["group_norm_apply"]["affine"],
                     "affine_silu": want["group_norm_apply"]["affine_silu"],
                     "layer_norm_rows": want["layer_norm_rows"]}
    full = chip_smoke.norm_launches(unet3d_leaves(prng.prng_key(0), PRESETS["zeroscope"].unet))
    assert (full["group_norm_stats"], sum(full["group_norm_apply"].values()),
            full["layer_norm_rows"]) == (166, 78, 65)


# ---- the backwards: kernels N and O (their plain versions on the CPU) ----

# Of max|ref| in bf16: both sides round x, dy, L's output and the cotangents
# of L's (a, b) to bf16, in different orders (read: at most 1.3e-2).
BF16_TOL = 2e-2


# (kind, x shape, groups, dtype, params): dx alone with frozen params (the
# guided update) in fp32 and bf16, and every gradient in bf16.
BWD_CASES = [
    ("group_norm", (2, 4, 5, 6, 320), 8, "float32", False),
    ("group_norm_silu", (2, 125, 80), 8, "float32", False),
    ("coeffs", (2, 125, 80), 8, "float32", False),
    ("layer_norm", (2, 37, 80), None, "float32", False),
    ("group_norm", (2, 4, 5, 6, 320), 8, "bfloat16", False),
    ("group_norm_silu", (48, 3, 4, 40), 4, "bfloat16", False),
    ("coeffs", (2, 125, 80), 8, "bfloat16", False),
    ("layer_norm", (48, 6, 320), None, "bfloat16", False),
    ("layer_norm_none", (3, 11, 64), None, "bfloat16", False),
    ("group_norm_silu", (2, 125, 80), 8, "bfloat16", True),
    ("coeffs", (2, 3, 5, 7, 320), 8, "bfloat16", True),
    ("layer_norm", (2, 37, 80), None, "bfloat16", True),
]


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}-{c[3]}-{c[4]}")
def test_norm_backwards_with_frozen_params_and_in_bf16_match_lvd_tpu(case):
    """The Functions' backwards (N's and O's plain versions on the CPU)
    against ``jax.vjp`` of lvd_tpu's functions: dx alone with the params
    frozen (plain tensors, as in the guided update), at 1e-5 in fp32 and
    BF16_TOL in bf16, and dx, dscale and dbias in bf16 (inputs, params and
    cotangents rounded to bf16 for both)."""
    kind, shape, groups, dname, params = case
    c = shape[-1]
    x, s, b = _inputs(len(shape) * 11 + c, shape, c)
    rng = np.random.default_rng(17)
    j_dt, t_dt = {"float32": (jnp.float32, torch.float32),
                  "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dname]
    j_fn, t_fn = _functions(kind, groups, 1e-5, None)
    args = [torch.from_numpy(a).to(t_dt) for a in ((x,) if kind == "layer_norm_none" else
                                                     (x, s, b))]
    leaves = [a.requires_grad_(True) for a in (args if params else args[:1])]
    t_out = t_fn(*args)
    t_outs = t_out if isinstance(t_out, tuple) else (t_out,)
    cts = [torch.from_numpy(_normal(rng, o.shape)).to(o.dtype) for o in t_outs]
    t_grads = torch.autograd.grad(t_outs, leaves, cts)
    # The same values in the same types for lvd_tpu: x and params in the
    # case's type, each cotangent in its output's (K's (a, b) are fp32).
    j_args = [jnp.asarray(a.detach().float().numpy()).astype(j_dt) for a in args]
    j_cts = [jnp.asarray(ct.float().numpy()).astype(jnp.float32 if ct.dtype == torch.float32
                                                    else j_dt) for ct in cts]
    n_diff = len(leaves)
    _, j_grads = _jax_value_and_vjp(lambda *d: j_fn(*d, *j_args[n_diff:]), j_args[:n_diff],
                                    tuple(j_cts) if len(j_cts) > 1 else j_cts[0])
    tol = TOL if dname == "float32" else BF16_TOL
    for got, want in zip(t_grads, j_grads):
        assert got.dtype == t_dt
        _close_rel(got.float().numpy(), np.asarray(want, np.float32), tol)


def test_norm_backwards_are_once_differentiable():
    """A second derivative through a norm raises instead of going through
    a kernel's first-order backward."""
    x, s, b = _inputs(6, (2, 7, 64), 64)
    xt = torch.from_numpy(x).requires_grad_(True)
    p = {"scale": torch.from_numpy(s), "bias": torch.from_numpy(b)}
    for fn in (lambda: tb.group_norm_silu(p, xt, 8), lambda: tb.layer_norm(p, xt),
               lambda: torch.stack(tb.group_norm_coeffs(p, xt, 8))):
        (g,) = torch.autograd.grad((fn() ** 2).sum(), xt, create_graph=True)
        with pytest.raises(RuntimeError, match="once_differentiable"):
            g.sum().backward()


def _order_sum(values):
    """Left-to-right fp32 sum of a sequence of fp32 arrays (the kernels'
    sequential adds)."""
    acc = np.zeros_like(values[0], dtype=np.float32)
    for v in values:
        acc = (acc + v).astype(np.float32)
    return acc


def _n_order(x, dy, a, b, scale, stats, count, silu):
    """Kernel N's ``affine`` / ``affine_silu`` form in its order, fp32, one
    sample at a time: pass 1's chunks and row lanes (K's plan), the
    finish's strided lanes over the chunks and then the lanes in order, the
    group's channels in order; returns dx and the (N, C) terms dscale and
    dbias sum over N."""
    f32 = np.float32
    n, rows, c = x.shape
    plan = norms.launch_plan(c, torch.float32)
    g = stats.shape[-1]
    cpg = c // g
    lanes_c = min(cpg, norms.THREADS)
    lanes_j = norms.THREADS // lanes_c
    dx = np.zeros_like(x)
    terms = np.zeros((2, n, c), f32)
    for i in range(n):
        z = (x[i] * a[i] + b[i]).astype(f32)
        if silu:
            sg = (f32(1) / (f32(1) + np.exp(-z))).astype(f32)
            dz = (dy[i] * sg * (f32(1) + z * (f32(1) - sg))).astype(f32)
        else:
            dz = dy[i]
        part1, part2 = [], []
        for start, stop in norms.chunk_ranges(rows, plan):
            lanes = [norms.lane_rows(start, stop, plan, lane) for lane in range(plan["row_lanes"])]
            part1.append(_order_sum([_order_sum(list(dz[r] * x[i, r] for r in rows_))
                                     if rows_ else np.zeros(c, f32) for rows_ in lanes]))
            part2.append(_order_sum([_order_sum(list(dz[r] for r in rows_))
                                     if rows_ else np.zeros(c, f32) for rows_ in lanes]))
        chunks = len(part1)
        da, db = (_order_sum([_order_sum([part[j] for j in range(jl, chunks, lanes_j)])
                              if jl < chunks else np.zeros(c, f32) for jl in range(lanes_j)])
                  for part in (part1, part2))
        mean, inv, keep = stats[:, i]
        ds1, ds2 = np.zeros(g, f32), np.zeros(g, f32)
        for k in range(g):
            u = v = f32(0)
            for ch in range(k * cpg, (k + 1) * cpg):
                dap = f32(da[ch] - f32(db[ch] * mean[k]))
                u = f32(u + f32(dap * scale[ch]))
                v = f32(v + f32(db[ch] * f32(inv[k] * scale[ch])))
            dvar = f32(f32(f32(f32(f32(u * f32(-0.5)) * inv[k]) * inv[k]) * inv[k]) * keep[k])
            dmean = f32(-v - f32(f32(2 * mean[k]) * dvar))
            ds1[k], ds2[k] = f32(dmean / f32(count)), f32(dvar / f32(count))
        s1c, s2c = np.repeat(ds1, cpg), np.repeat(ds2, cpg)
        dx[i] = (dz * a[i] + (s1c + (2 * x[i]) * s2c).astype(f32)).astype(f32)
        terms[0, i] = ((da - db * np.repeat(mean, cpg)).astype(f32) * np.repeat(inv, cpg))
        terms[1, i] = db
    return dx, terms


def _o_order(x2, dy, scale, stats):
    """Kernel O's dx in its order, fp32: lane l of a row's warp sums vectors
    l, l + 32, ... (4 values each in fp32) in order, then five butterfly
    steps; and dscale, dbias over rows on K's plan, then the finish's
    strided lanes over the chunks."""
    f32 = np.float32
    rows, c = x2.shape
    vec = 4
    dx = np.zeros_like(x2)
    for r in range(rows):
        mean, rstd, keep = stats[:, r]
        g = (dy[r] * scale).astype(f32)
        gx = (g * (x2[r] - mean).astype(f32)).astype(f32)
        lanes = np.zeros((2, 32), f32)
        for lane in range(32):
            idx = [i * vec + e for i in range(lane, c // vec, 32) for e in range(vec)]
            for k in idx:
                lanes[0, lane] = f32(lanes[0, lane] + g[k])
                lanes[1, lane] = f32(lanes[1, lane] + gx[k])
        for o in (16, 8, 4, 2, 1):
            lanes = (lanes + lanes[:, np.arange(32) ^ o]).astype(f32)
        sg, sgx = lanes[:, 0]
        dvar = f32(f32(f32(f32(f32(sgx * f32(-0.5)) * rstd) * rstd) * rstd) * keep)
        dmean = f32(-f32(sg * rstd) - f32(f32(2 * mean) * dvar))
        dx[r] = ((g * rstd + f32(dmean / f32(c))).astype(f32)
                 + f32(dvar * f32(f32(2) / f32(c))) * x2[r]).astype(f32)
    plan = norms.launch_plan(c, torch.float32)
    xhat = ((x2 - stats[0][:, None]).astype(f32) * stats[1][:, None]).astype(f32)
    t1 = (dy * xhat).astype(f32)
    parts = []
    for start, stop in norms.chunk_ranges(rows, plan):
        lanes = [norms.lane_rows(start, stop, plan, lane) for lane in range(plan["row_lanes"])]
        parts.append([_order_sum([_order_sum([t[r] for r in rows_]) if rows_ else
                                  np.zeros(c, f32) for rows_ in lanes]) for t in (t1, dy)])
    dparams = [_order_sum([_order_sum([parts[j][k] for j in range(lane, len(parts), 8)])
                           if lane < len(parts) else np.zeros(c, f32) for lane in range(8)])
               for k in range(2)]
    return dx, dparams


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_bwd_in_kernel_order_matches_lvd_tpu_and_does_not_change_with_n(silu):
    """Kernel N's order (``_n_order``) gives lvd_tpu's dx, dscale and dbias
    (``jax.vjp`` of group_norm, then silu) at 1e-5, and a sample's dx and
    param terms are the same bits alone as in a batch of three (nothing in
    the order takes N)."""
    n, rows, c, groups = 3, 250, 80, 8
    x, s, b = _inputs(20 + silu, (n, rows, c), c)
    dy = _normal(np.random.default_rng(21), (n, rows, c))
    plan = norms.launch_plan(c, torch.float32)
    assert norms.chunk_count(rows, plan) > 1 and rows % plan["chunk_rows"]
    count = rows * c // groups
    xt = torch.from_numpy(x)
    a, bb = (t.numpy() for t in norms.group_norm_coeffs_plain(
        {"scale": torch.from_numpy(s), "bias": torch.from_numpy(b)}, xt, groups, 1e-5))
    stats = norms.group_stats_plain(xt, groups, 1e-5, count).numpy()
    dx, terms = _n_order(x, dy, a, bb, s, stats, count, silu)
    fn = lambda x, s, b: jb.group_norm({"scale": s, "bias": b}, x, groups, 1e-5)
    j_fn = (lambda *t: jax.nn.silu(fn(*t))) if silu else fn
    _, (jdx, jds, jdb) = _jax_value_and_vjp(j_fn, (x, s, b), dy)
    _close_rel(dx, jdx)
    _close_rel(terms[0].sum(0), jds)
    _close_rel(terms[1].sum(0), jdb)
    alone, alone_terms = _n_order(x[1:2], dy[1:2], a[1:2], bb[1:2], s, stats[:, 1:2], count, silu)
    assert np.array_equal(alone[0], dx[1]) and np.array_equal(alone_terms[:, 0], terms[:, 1])


def test_layer_norm_bwd_in_kernel_order_matches_lvd_tpu():
    """Kernel O's order (``_o_order``: dx a warp a row, dscale and dbias on
    K's plan over the rows) gives lvd_tpu's ``jax.vjp`` of layer_norm at
    1e-5, and a row's dx does not depend on the rows around it."""
    rows, c = 300, 80
    x, s, b = _inputs(23, (rows, c), c)
    dy = _normal(np.random.default_rng(24), (rows, c))
    stats = norms.layer_norm_stats_plain(torch.from_numpy(x), 1e-5).numpy()
    dx, (ds, db) = _o_order(x, dy, s, stats)
    _, (jdx, jds, jdb) = _jax_value_and_vjp(
        lambda x, s, b: jb.layer_norm({"scale": s, "bias": b}, x, 1e-5), (x, s, b), dy)
    _close_rel(dx, jdx)
    _close_rel(ds, jds)
    _close_rel(db, jdb)
    alone, _ = _o_order(x[7:8], dy[7:8], s, stats[:, 7:8])
    assert np.array_equal(alone[0], dx[7])


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("variant", ["other_order", "term_left_out", "term_rounded_once",
                                     "terms_fused"])
def test_bf16_gates_pass_another_sum_order_and_fail_a_misplaced_term(variant, silu):
    """The card's bf16 gates on N's dx (ops/selfcheck.py: dy with a mean of
    NORM_BWD_DY_MEAN, NORM_BWD_TOL of max|ref| against the plain version on
    fp32 copies, and in_type_reading against the plain version run in bf16
    within NORM_BWD_BITS_DIFFER): the plain version with its row sums in
    another order (rows permuted alike in x and dy, dx permuted back)
    passes both; a dx without the statistics' term fails the first; one
    that rounds that term once instead of its two parts, or adds all three
    terms in fp32 before one rounding, passes the first and fails the
    second."""
    from lvd_tpu_torch.ops import selfcheck

    n, rows, c, groups = 2, 1440, 320, 32
    rng = np.random.default_rng(30 + silu)
    dt = torch.bfloat16
    x = torch.from_numpy(_normal(rng, (n, rows, c)) + 0.5).to(dt)
    dy = torch.from_numpy(_normal(rng, (n, rows, c)) + selfcheck.NORM_BWD_DY_MEAN).to(dt)
    scale = torch.from_numpy(1.0 + _normal(rng, (c,), 0.1)).to(dt)
    bias = torch.from_numpy(_normal(rng, (c,), 0.1)).to(dt)
    count = rows * c // groups
    stats = norms.group_stats_plain(x, groups, 1e-5, count)
    a, b = norms._coeffs_from_moments(scale, bias, stats[0], stats[1], c)
    form = "affine_silu" if silu else "affine"
    kw = dict(a=a, b=b, scale=scale, stats=stats, count=count)
    want, addends = selfcheck.gn_bwd_in_type(form, x, dy=dy, **kw)
    assert torch.equal(want, norms.group_norm_bwd_plain(x, dy, a, b, scale, stats, count,
                                                        silu)[0])
    if variant == "other_order":
        perm = torch.from_numpy(rng.permutation(rows))
        got = torch.empty_like(want)
        got[:, perm] = selfcheck.gn_bwd_in_type(form, x[:, perm], dy=dy[:, perm], **kw)[0]
    else:
        dx_l, da, db = norms.group_norm_apply_bwd_plain(x, dy, a, b, silu)
        ds1, ds2 = (t.repeat_interleave(c // groups, dim=1)[:, None, :]
                    for t in norms.group_coeffs_sums_bwd_plain(da, db, scale, stats, count))
        term = ds1 + 2.0 * x.float() * ds2
        got = {"term_left_out": lambda: dx_l,
               "term_rounded_once": lambda: dx_l + term.to(dt),
               "terms_fused": lambda: (dx_l.float() + term).to(dt)}[variant]()
    ref = norms.group_norm_bwd_plain(x.float(), dy.float(), a, b, scale.float(), stats, count,
                                     silu)[0]
    rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
    _, share = selfcheck.in_type_reading(got, want, addends, groups)
    assert (rel <= selfcheck.NORM_BWD_TOL) == (variant != "term_left_out"), rel
    if variant != "term_left_out":
        assert (share <= selfcheck.NORM_BWD_BITS_DIFFER) == (variant == "other_order"), share


@pytest.mark.parametrize("call", ["form", "sums_params", "shape_gn", "shape_ln",
                                  "ln_params_without_scale", "ln_without_statistics"])
def test_backward_wrappers_raise_on_forms_and_shapes_they_cannot_take(call):
    """N refuses a form it does not know and ``sums`` with parameter
    gradients; N and O refuse C % 8 != 0 and name the shape; O takes M's
    statistics in either form, and ``dx_params`` needs scale. All before any launch
    (meta tensors stand for the card's)."""
    m = lambda *shape: torch.empty(shape, device="meta")
    x, x12 = m(2, 5, 64), m(2, 5, 12)
    run, match = {
        "form": (lambda: norms.group_norm_bwd("scale", x, ds=m(2, 2, 8)), "no form 'scale'"),
        "sums_params": (lambda: norms.group_norm_bwd("sums", x, ds=m(2, 2, 8), params=True),
                        "with params"),
        "shape_gn": (lambda: norms.group_norm_bwd("sums", x12, ds=m(2, 2, 4)),
                     r"\(2, 5, 12\)"),
        "shape_ln": (lambda: norms.layer_norm_bwd(x12[0], x12[0], None, None), r"\(5, 12\)"),
        "ln_params_without_scale": (lambda: norms.layer_norm_bwd(x[0], x[0], None, m(3, 5),
                                                                 params=True), "dx_params"),
        "ln_without_statistics": (lambda: norms.layer_norm_bwd(x[0], x[0], m(64), None),
                                  "M's statistics"),
    }[call]
    with pytest.raises(ValueError, match=match):
        run()


def test_energy_walk_runs_one_backward_per_norm_site_the_tree_gives(monkeypatch):
    """The tiny UNet's guided energy walk (Zeroscope's topology, the
    flagship's six captured sites) runs each norm Function's backward as
    often, by form, as chip_smoke.norm_bwd_launches derives from its param
    tree, which the smoke gates per guided update on the card; at
    Zeroscope's widths 26 + 38 + 76 N and 51 O."""
    import chip_smoke
    from lvd_tpu_torch.config import PRESETS, tiny_unet_config
    from lvd_tpu_torch.diffusion.guidance import OVERALL_GUIDANCE_ATTN_KEYS, GuidanceConfig
    from lvd_tpu_torch.diffusion.sampler import energy_and_grad, pack_to_tensors
    from lvd_tpu_torch.layout.rasterize import make_guidance_pack
    from lvd_tpu_torch.models.unet3d import init_unet3d, unet3d_leaves
    from lvd_tpu_torch.utils import prng

    calls = {"affine": 0, "affine_silu": 0, "coeffs": 0, "sums": 0, "apply": 0, "apply_silu": 0,
             "dx": 0, "dx_params": 0}

    def counted(fn, form):
        orig = fn.backward

        def backward(ctx, *grads):
            calls[form(ctx)] += 1
            return orig(ctx, *grads)
        monkeypatch.setattr(fn, "backward", staticmethod(backward))

    counted(norms.GroupNorm, lambda ctx: "affine_silu" if ctx.args[1] else "affine")
    counted(norms.GroupNormCoeffs, lambda ctx: "coeffs")
    counted(norms.GroupSums, lambda ctx: "sums")
    counted(norms.GroupNormApply, lambda ctx: "apply_silu" if ctx.silu else "apply")
    counted(norms.LayerNorm, lambda ctx: "dx")
    cfg = tiny_unet_config()
    params = init_unet3d(prng.prng_key(0), cfg, device="cpu")
    rng = np.random.default_rng(6)
    frames = 3
    boxes = [[[0.1 + 0.2 * f, 0.2, 0.5 + 0.2 * f, 0.8] for f in range(frames)]]
    pack = pack_to_tensors(make_guidance_pack(boxes, [[2]], OVERALL_GUIDANCE_ATTN_KEYS, (8, 12),
                                              0.25, 0.25), "cpu")
    lat = torch.from_numpy(_normal(rng, (1, frames, 8, 12, 4)))
    text = torch.from_numpy(_normal(rng, (1, 6, cfg.cross_attention_dim), 0.3))
    g_cfg = GuidanceConfig(loss_scale=2.5, fg_top_p=0.25, bg_top_p=0.25, bg_weight=2.0)
    energy_and_grad(params, cfg, lat, 500, text, pack, OVERALL_GUIDANCE_ATTN_KEYS, g_cfg,
                    torch.float32)
    want = chip_smoke.norm_bwd_launches(params, OVERALL_GUIDANCE_ATTN_KEYS)
    assert calls == {**want["group_norm_bwd"], **want["layer_norm_bwd"]}
    full = chip_smoke.norm_bwd_launches(unet3d_leaves(prng.prng_key(0), PRESETS["zeroscope"].unet),
                                        OVERALL_GUIDANCE_ATTN_KEYS)
    assert full == {"group_norm_bwd": {"affine": 26, "affine_silu": 38, "coeffs": 76, "sums": 0,
                                       "apply": 0, "apply_silu": 0},
                    "layer_norm_bwd": {"dx": 51, "dx_params": 0}}
