"""Parity of the port's ops with lvd_tpu on the CPU.

Inputs are drawn with numpy from fixed seeds and fed to both packages; the
port runs fp32 on the CPU, where each kernel wrapper runs its plain version.
Basic ops are held to lvd_tpu.ops.basic at atol/rtol 1e-5; each kernel's
plain version is held to the JAX function lvd_tpu's own tests run on the
CPU (its Pallas kernel in interpret mode, or its plain reference) within
1e-4 of max|ref|, at 64-wide heads and narrow widths (C = 128, 2 heads).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu.ops import basic as jb
from lvd_tpu.ops import geglu_fused as j_geglu
from lvd_tpu.ops import pallas_attention as j_pa
from lvd_tpu.ops import temp_conv_fused as j_tc
from lvd_tpu.ops import temporal_attention as j_ta
from lvd_tpu_torch.ops import basic as tb
from lvd_tpu_torch.ops import geglu_fused as t_geglu
from lvd_tpu_torch.ops import packed_attention as t_pa
from lvd_tpu_torch.ops import temp_conv_fused as t_tc
from lvd_tpu_torch.ops import temporal_attention as t_ta

KERNEL_TOL = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """numpy tree -> (jax tree, torch tree)."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def _lin(rng, din, dout, bias=True):
    p = {"w": _normal(rng, (din, dout), din ** -0.5)}
    if bias:
        p["b"] = _normal(rng, (dout,), 0.1)
    return p


def _norm(rng, c):
    return {"scale": 1.0 + _normal(rng, (c,), 0.1), "bias": _normal(rng, (c,), 0.1)}


def _close_rel(got, ref, tol=KERNEL_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max|d|/max|ref| = {err:.3g} > {tol}"


# ---------------------------------------------------------------------------
# ops/basic.py, op by op
# ---------------------------------------------------------------------------


def _case_linear(rng):
    p = _lin(rng, 48, 40)
    return (lambda pp, x: jb.linear(pp, x), lambda pp, x: tb.linear(pp, x), p,
            _normal(rng, (3, 7, 48)))


def _case_conv2d(rng, stride=1, padding=1):
    p = {"w": _normal(rng, (3, 3, 8, 12), 72 ** -0.5), "b": _normal(rng, (12,), 0.1)}
    if padding == 0:
        p["w"] = p["w"][:1, :1]
    return (lambda pp, x: jb.conv2d(pp, x, stride, padding),
            lambda pp, x: tb.conv2d(pp, x, stride, padding), p, _normal(rng, (2, 9, 11, 8)))


def _case_conv3d(rng):
    p = {"w": _normal(rng, (3, 1, 1, 8, 8), 24 ** -0.5), "b": _normal(rng, (8,), 0.1)}
    return (lambda pp, x: jb.conv3d(pp, x), lambda pp, x: tb.conv3d(pp, x), p,
            _normal(rng, (2, 5, 4, 6, 8)))


def _case_group_norm(rng):
    p = _norm(rng, 32)
    x = _normal(rng, (2, 3, 5, 7, 32), 2.0) + 0.5
    return (lambda pp, x: jb.group_norm(pp, x, 8, 1e-5),
            lambda pp, x: tb.group_norm(pp, x, 8, 1e-5), p, x)


def _case_group_norm_coeffs(rng):
    p = _norm(rng, 32)
    x = _normal(rng, (2, 4, 9, 32)) - 0.3
    return (lambda pp, x: jnp.stack(jb.group_norm_coeffs(pp, x, 8, 1e-6)),
            lambda pp, x: torch.stack(tb.group_norm_coeffs(pp, x, 8, 1e-6)), p, x)


def _case_layer_norm(rng):
    p = _norm(rng, 40)
    return (lambda pp, x: jb.layer_norm(pp, x, 1e-6), lambda pp, x: tb.layer_norm(pp, x, 1e-6),
            p, _normal(rng, (3, 5, 40), 3.0))


def _case_silu(rng):
    return (lambda pp, x: jb.silu(x), lambda pp, x: tb.silu(x), {}, _normal(rng, (4, 33), 3.0))


def _case_geglu(rng):
    p = _lin(rng, 16, 2 * 64)
    return (lambda pp, x: jb.geglu(pp, x), lambda pp, x: tb.geglu(pp, x), p,
            _normal(rng, (3, 5, 16)))


def _case_feed_forward(rng):
    p = {"proj": _lin(rng, 16, 128), "out": _lin(rng, 64, 16)}
    return (lambda pp, x: jb.feed_forward(pp, x), lambda pp, x: tb.feed_forward(pp, x), p,
            _normal(rng, (2, 9, 16)))


def _case_timestep_embedding(rng):
    t = np.array([0.0, 1.0, 250.0, 999.0], np.float32)
    return (lambda pp, x: jb.timestep_embedding(x, 33),
            lambda pp, x: tb.timestep_embedding(x, 33), {}, t)


def _case_time_embedding_mlp(rng):
    p = {"linear_1": _lin(rng, 32, 64), "linear_2": _lin(rng, 64, 64)}
    return (lambda pp, x: jb.time_embedding_mlp(pp, x),
            lambda pp, x: tb.time_embedding_mlp(pp, x), p, _normal(rng, (3, 32)))


def _case_upsample(rng):
    return (lambda pp, x: jb.upsample_nearest_2x(x), lambda pp, x: tb.upsample_nearest_2x(x),
            {}, _normal(rng, (2, 3, 5, 4)))


BASIC_CASES = {
    "linear": _case_linear,
    "conv2d": _case_conv2d,
    "conv2d_stride2": lambda rng: _case_conv2d(rng, stride=2),
    "conv2d_1x1": lambda rng: _case_conv2d(rng, padding=0),
    "conv3d": _case_conv3d,
    "group_norm": _case_group_norm,
    "group_norm_coeffs": _case_group_norm_coeffs,
    "layer_norm": _case_layer_norm,
    "silu": _case_silu,
    "geglu": _case_geglu,
    "feed_forward": _case_feed_forward,
    "timestep_embedding": _case_timestep_embedding,
    "time_embedding_mlp": _case_time_embedding_mlp,
    "upsample_nearest_2x": _case_upsample,
}


@pytest.mark.parametrize("name", sorted(BASIC_CASES))
def test_basic_op_matches_lvd_tpu(name):
    jfn, tfn, p, x = BASIC_CASES[name](_rng(sorted(BASIC_CASES).index(name)))
    jp, tp = _both(p)
    ref = np.asarray(jfn(jp, jnp.asarray(x)))
    got = tfn(tp, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Kernel A's plain version: attention_packed vs _heads_chunked
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def heads_chunked():
    return jax.jit(j_pa._heads_chunked, static_argnums=(3, 4))


@pytest.mark.parametrize("s_q,s_k", [(300, 300), (700, 520), (100, 77), (45, 45), (64, 180)])
def test_attention_packed_plain_matches_heads_chunked(heads_chunked, s_q, s_k):
    rng = _rng(s_q + s_k)
    c, heads = 128, 2
    q, k, v = (_normal(rng, (2, s, c)) for s in (s_q, s_k, s_k))
    ref = heads_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125, heads)
    got = t_pa.attention_packed(*(torch.from_numpy(a) for a in (q, k, v)), 0.125, heads)
    _close_rel(got.numpy(), ref)


def test_attention_dispatch_matches_lvd_tpu():
    """ops/attention.attention on short and long keys, with and without maps."""
    from lvd_tpu.ops import attention as j_attn
    from lvd_tpu_torch.ops import attention as t_attn

    rng = _rng(7)
    c, heads = 64, 2
    p = {n: _lin(rng, c, c, bias=False) for n in ("to_q", "to_k", "to_v")}
    p["to_out"] = _lin(rng, c, c)
    jp, tp = _both(p)
    x = _normal(rng, (2, 300, c))
    ctx = _normal(rng, (2, 77, c))
    for context, probs in ((None, False), (ctx, False), (ctx, True)):
        jc = None if context is None else jnp.asarray(context)
        tc = None if context is None else torch.from_numpy(context)
        jo, jpr = j_attn.attention(jp, jnp.asarray(x), jc, heads, return_probs=probs)
        to, tpr = t_attn.attention(tp, torch.from_numpy(x), tc, heads, return_probs=probs)
        _close_rel(to.numpy(), jo)
        if probs:
            _close_rel(tpr.numpy(), jpr)
        else:
            assert tpr is None and jpr is None


# ---------------------------------------------------------------------------
# Kernel B's plain versions: the temporal pair
# ---------------------------------------------------------------------------


def _pair_params(rng, c):
    def attn():
        p = {n: _lin(rng, c, c, bias=False) for n in ("to_q", "to_k", "to_v")}
        p["to_out"] = _lin(rng, c, c)
        return p

    return {"norm1": _norm(rng, c), "attn1": attn(), "norm2": _norm(rng, c), "attn2": attn()}


@pytest.fixture(scope="module")
def pair_case():
    rng = _rng(11)
    c, heads = 128, 2
    p = _pair_params(rng, c)
    y = _normal(rng, (2, 6, 16, c))  # (B, F, P, C) frames-major
    return p, y, heads


def test_temporal_pair_plain_matches_pallas_interpret(pair_case):
    p, y, heads = pair_case
    jp, tp = _both(p)
    ref = j_ta._pallas_pair(jp, jnp.asarray(y), heads, 8, 1e-5, frames_major=True,
                            interpret=True)
    got = t_ta.temporal_attention_pair(tp, torch.from_numpy(y), heads, 1e-5, frames_major=True)
    _close_rel(got.numpy(), ref)


@pytest.mark.parametrize("frames_major", [True, False])
def test_temporal_pair_plain_matches_pair_ref(pair_case, frames_major):
    p, y, heads = pair_case
    if not frames_major:
        y = np.ascontiguousarray(y.transpose(0, 2, 1, 3))
    jp, tp = _both(p)
    jref = j_ta._pair_ref_fm if frames_major else j_ta._pair_ref
    ref = jax.jit(lambda pp, yy: jref(pp, yy, heads, 1e-5))(jp, jnp.asarray(y))
    got = t_ta.temporal_attention_pair(tp, torch.from_numpy(y), heads, 1e-5,
                                       frames_major=frames_major)
    _close_rel(got.numpy(), ref)


# ---------------------------------------------------------------------------
# Kernel C's plain version: GEGLU
# ---------------------------------------------------------------------------


def test_geglu_plain_matches_unfused():
    rng = _rng(13)
    c, inner = 128, 512
    p = {"proj": _lin(rng, c, 2 * inner), "out": _lin(rng, inner, c)}
    x = _normal(rng, (4, 50, c))
    jp, tp = _both(p)
    ref = j_geglu._unfused(jnp.asarray(x).reshape(-1, c), jp["proj"]["w"], jp["proj"]["b"],
                           jp["out"]["w"], jp["out"]["b"]).reshape(x.shape)
    got = t_geglu.geglu_mlp(tp, torch.from_numpy(x))
    _close_rel(got.numpy(), ref)


# ---------------------------------------------------------------------------
# Kernel D's plain version: GN-apply + SiLU + temporal conv
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tconv_case():
    rng = _rng(17)
    c = 128
    x = _normal(rng, (2, 6, 16, c))
    a = 1.0 + _normal(rng, (2, c), 0.2)
    b = _normal(rng, (2, c), 0.2)
    w = _normal(rng, (3, 1, 1, c, c), (3 * c) ** -0.5)
    bias = _normal(rng, (c,), 0.1)
    return x, a, b, w, bias


@pytest.mark.parametrize("ref_kind", ["pallas_interpret", "unfused"])
def test_temp_conv_plain_matches_lvd_tpu(tconv_case, ref_kind):
    x, a, b, w, bias = tconv_case
    c = x.shape[-1]
    jargs = (jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
             jnp.asarray(w.reshape(3, c, c)), jnp.asarray(bias))
    if ref_kind == "pallas_interpret":
        ref = j_tc._fused(*jargs, interpret=True, block_p=8)
    else:
        ref = j_tc._unfused(*jargs)
    got = t_tc.norm_silu_temporal_conv(*(torch.from_numpy(t) for t in (x, a, b, w, bias)))
    _close_rel(got.numpy(), ref)
