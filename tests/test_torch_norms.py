"""Kernels K, L and M's functions (ops/norms.py) against lvd_tpu on the CPU.

GroupNorm statistics, GroupNorm, silu(GroupNorm) and LayerNorm (with and
without params) go through their autograd Functions, which run the plain
versions on CPU tensors; values and the VJPs (dx, dscale, dbias) are held to
lvd_tpu/ops/basic.py and ``jax.vjp`` at 1e-5 of max|ref|, fp32, on inputs
drawn with numpy. K's launch plan is checked without a card: its chunks and
row lanes cover each row of a sample exactly once, they do not depend on N,
and the statistics summed in that order match lvd_tpu's. The tiny UNet3D's
norm sites are counted against the per-forward launch counts chip_smoke.py
gates on the card.
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
    """On CPU tensors every norm Function runs its plain version, forward and
    backward, without reaching the library or counting a launch."""

    def no_library():
        raise AssertionError("a CPU tensor must not reach the CUDA library")

    monkeypatch.setattr(_build, "lib", no_library)
    wrappers = (norms.group_norm_stats, norms.group_norm_apply, norms.layer_norm_rows)
    before = [(w.launches, dict(w.launches_by_form)) for w in wrappers]
    x, s, b = _inputs(5, (2, 7, 64), 64)
    xt = torch.from_numpy(x).requires_grad_(True)
    p = {"scale": torch.from_numpy(s).requires_grad_(True), "bias": torch.from_numpy(b)}
    outs = [tb.group_norm_silu(p, xt, 8), tb.group_norm(p, xt, 8), tb.layer_norm(p, xt),
            tb.layer_norm(None, xt), torch.stack(tb.group_norm_coeffs(p, xt, 8))]
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

    def counted(fn, key):
        def run(*args):
            name = key if key != "apply" else ("affine_silu" if args[3] else "affine")
            calls[name] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(norms.GroupNormCoeffs, "apply",
                        counted(norms.GroupNormCoeffs.apply, "group_norm_stats"))
    monkeypatch.setattr(norms.GroupNormApply, "apply", counted(norms.GroupNormApply.apply,
                                                               "apply"))
    monkeypatch.setattr(norms.LayerNorm, "apply", counted(norms.LayerNorm.apply,
                                                          "layer_norm_rows"))
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
