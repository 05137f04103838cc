"""Gradients of the port's kernel ops against lvd_tpu on the CPU.

Inputs come from numpy seeds and go to both packages in fp32, at 64-wide
heads and narrow widths. The plain backward versions (what kernels E, F and
G compute) are held to lvd_tpu's Pallas backward kernels run in interpret
mode, within 1e-4 of max|ref|; each autograd Function (the only way into a
kernel on the card) is held on the CPU to ``jax.vjp`` of lvd_tpu's
function, within 1e-4 of max|ref| per gradient, temporal conv's da and db
included.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu.ops import geglu_fused as j_geglu
from lvd_tpu.ops import pallas_attention as j_pa
from lvd_tpu.ops import temp_conv_fused as j_tc
from lvd_tpu.ops import temporal_attention as j_ta
from lvd_tpu_torch.ops import geglu_fused as t_geglu
from lvd_tpu_torch.ops import packed_attention as t_pa
from lvd_tpu_torch.ops import temp_conv_fused as t_tc
from lvd_tpu_torch.ops import temporal_attention as t_ta

TOL = 1e-4


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


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _pair_params(rng, c):
    lin = lambda bias: {"w": _normal(rng, (c, c), c ** -0.5),
                        **({"b": _normal(rng, (c,), 0.1)} if bias else {})}
    attn = lambda: {"to_q": lin(False), "to_k": lin(False), "to_v": lin(False),
                    "to_out": lin(True)}
    norm = lambda: {"scale": 1.0 + _normal(rng, (c,), 0.1), "bias": _normal(rng, (c,), 0.1)}
    return {"norm1": norm(), "attn1": attn(), "norm2": norm(), "attn2": attn()}


def _ff_params(rng, c, inner):
    return {"proj": {"w": _normal(rng, (c, 2 * inner), c ** -0.5),
                     "b": _normal(rng, (2 * inner,), 0.1)},
            "out": {"w": _normal(rng, (inner, c), inner ** -0.5), "b": _normal(rng, (c,), 0.1)}}


# ---------------------------------------------------------------------------
# Kernel E's plain version against the interpreted TPU backward kernels
# ---------------------------------------------------------------------------


def _attn_case(seed, b, s_q, s_k, heads):
    rng = np.random.default_rng(seed)
    c = 64 * heads
    q, k, v = (_normal(rng, (b, s, c)) for s in (s_q, s_k, s_k))
    do = _normal(rng, (b, s_q, c))
    o = np.asarray(j_pa._heads_chunked(*map(jnp.asarray, (q, k, v)), 0.125, heads))
    return q, k, v, o, do


@pytest.mark.parametrize("s_q,s_k", [(200, 200), (112, 77), (45, 180)])
def test_attention_bwd_plain_matches_heads_kernel(s_q, s_k):
    q, k, v, o, do = _attn_case(s_q + s_k, 2, s_q, s_k, 2)
    want = j_pa._pallas_attention_bwd_heads(*map(jnp.asarray, (q, k, v, o, do)), 0.125,
                                            num_heads=2, block_q=64, interpret=True)
    got = t_pa.attention_packed_bwd_plain(*map(_t, (q, k, v, o, do)), 0.125, 2, block_q=128)
    for g, w in zip(got, want):
        _close_rel(g.numpy(), w)


def test_attention_bwd_plain_matches_bh_kernel_after_relayout():
    b, s, heads = 2, 200, 2  # 200 % 128: a ragged last query tile
    q, k, v, o, do = _attn_case(11, b, s, s, heads)
    to_bh = lambda t: jnp.asarray(t.reshape(b, s, heads, 64).transpose(0, 2, 1, 3)
                                  .reshape(b * heads, s, 64))
    from_bh = lambda t: np.asarray(t).reshape(b, heads, s, 64).transpose(0, 2, 1, 3).reshape(
        b, s, heads * 64)
    want = j_pa._pallas_attention_bwd(*map(to_bh, (q, k, v, o, do)), 0.125, block_q=128,
                                      interpret=True)
    got = t_pa.attention_packed_bwd_plain(*map(_t, (q, k, v, o, do)), 0.125, heads)
    for g, w in zip(got, want):
        _close_rel(g.numpy(), from_bh(w))


# ---------------------------------------------------------------------------
# Kernel F's plain version against the interpreted TPU pair backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames_major", [False, True])
def test_pair_bwd_plain_matches_pallas_pair_bwd(frames_major):
    rng = np.random.default_rng(21)
    b, pdim, f, c, heads = 1, 16, 8, 128, 2
    p = _pair_params(rng, c)
    y = _normal(rng, (b, pdim, f, c))
    ct = _normal(rng, (b, pdim, f, c))
    if frames_major:
        y, ct = y.transpose(0, 2, 1, 3).copy(), ct.transpose(0, 2, 1, 3).copy()
    want = j_ta._pallas_pair_bwd(_tree(p, jnp.asarray), jnp.asarray(y), jnp.asarray(ct), heads,
                                 8, 1e-5, frames_major=frames_major, interpret=True)
    got = t_ta.temporal_attention_pair_bwd_plain(_tree(p, _t), _t(y), _t(ct), heads, 1e-5,
                                                 frames_major=frames_major)
    _close_rel(got.numpy(), want)


# ---------------------------------------------------------------------------
# Kernel G's plain version against the interpreted TPU GEGLU backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["tanh", "exact"])
def test_geglu_bwd_plain_matches_resident_kernel(form, monkeypatch):
    monkeypatch.setattr(j_geglu, "GELU_FORM", form)
    monkeypatch.setattr(t_geglu, "GELU_FORM", form)
    rng = np.random.default_rng(31)
    r, c = 96, 128
    p = _ff_params(rng, c, 4 * c)
    x, dy = _normal(rng, (r, c)), _normal(rng, (r, c))
    want = j_geglu._fused_rows_bwd_resident(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(p["proj"]["w"]),
        jnp.asarray(p["proj"]["b"]), jnp.asarray(p["out"]["w"]), block_m=32, nk=2,
        interpret=True)
    got = t_geglu.geglu_mlp_bwd_plain(_tree(p, _t), _t(x), _t(dy))
    _close_rel(got.numpy(), want)


# ---------------------------------------------------------------------------
# The autograd Functions on the CPU against jax.vjp of lvd_tpu's functions
# ---------------------------------------------------------------------------


def _torch_vjp(fn, args, ct):
    leaves = [_t(a, grad=True) for a in args]
    out = fn(*leaves)
    out.backward(_t(ct))
    return out.detach().numpy(), [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("s_q,s_k", [(300, 300), (100, 77)])
def test_attention_function_grad_matches_jax_vjp(s_q, s_k):
    q, k, v, _, do = _attn_case(5 + s_k, 2, s_q, s_k, 2)
    out_j, vjp = jax.vjp(lambda q, k, v: j_pa.attention_packed(q, k, v, 0.125, 2),
                         *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    out_t, got = _torch_vjp(lambda q, k, v: t_pa.attention_packed(q, k, v, 0.125, 2),
                            (q, k, v), do)
    _close_rel(out_t, out_j)
    for g, w in zip(got, want):
        _close_rel(g, w)


@pytest.mark.parametrize("frames_major", [False, True])
def test_temporal_pair_function_grad_matches_jax_vjp(frames_major):
    rng = np.random.default_rng(41)
    p = _pair_params(rng, 128)
    shape = (1, 8, 12, 128) if frames_major else (1, 12, 8, 128)
    y, ct = _normal(rng, shape), _normal(rng, shape)
    jp = _tree(p, jnp.asarray)
    out_j, vjp = jax.vjp(lambda y: j_ta.temporal_attention_pair(
        jp, y, 2, 1e-5, frames_major=frames_major), jnp.asarray(y))
    (want,) = vjp(jnp.asarray(ct))
    tp = _tree(p, _t)
    out_t, (got,) = _torch_vjp(lambda y: t_ta.temporal_attention_pair(
        tp, y, 2, 1e-5, frames_major=frames_major), (y,), ct)
    _close_rel(out_t, out_j)
    _close_rel(got, want)


def test_temporal_pair_weight_grads_on_cpu_take_plain_autograd():
    """On the CPU a parameter that requires grad gets its gradient from the
    plain formulation (the kernels compute dy only)."""
    rng = np.random.default_rng(42)
    p = _pair_params(rng, 128)
    y = _normal(rng, (1, 8, 6, 128))
    jp = _tree(p, jnp.asarray)
    want = jax.grad(lambda pp: jnp.sum(j_ta.temporal_attention_pair(
        pp, jnp.asarray(y), 2, 1e-5, frames_major=True) ** 2))(jp)
    tp = _tree(p, lambda a: _t(a, grad=True))
    (t_ta.temporal_attention_pair(tp, _t(y), 2, 1e-5, frames_major=True) ** 2).sum().backward()
    _close_rel(tp["attn1"]["to_q"]["w"].grad.numpy(), want["attn1"]["to_q"]["w"])
    _close_rel(tp["norm2"]["scale"].grad.numpy(), want["norm2"]["scale"])


@pytest.mark.parametrize("form", ["tanh", "exact"])
def test_geglu_function_grad_matches_jax_vjp(form, monkeypatch):
    monkeypatch.setattr(j_geglu, "GELU_FORM", form)
    monkeypatch.setattr(t_geglu, "GELU_FORM", form)
    rng = np.random.default_rng(51)
    p = _ff_params(rng, 128, 512)
    x, dy = _normal(rng, (2, 40, 128)), _normal(rng, (2, 40, 128))
    args = lambda x: (x, p["proj"]["w"], p["proj"]["b"], p["out"]["w"], p["out"]["b"])
    # lvd_tpu's geglu_mlp off the TPU is its unfused formulation (the Pallas
    # kernel needs the TPU); its VJP is what the custom VJP falls back to.
    out_j, vjp = jax.vjp(lambda x: j_geglu._unfused(*map(jnp.asarray, args(x))),
                         jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    tp = _tree(p, _t)
    out_t, (got,) = _torch_vjp(lambda x: t_geglu.geglu_mlp(tp, x), (x,), dy)
    _close_rel(out_t, out_j)
    _close_rel(got, want)


def test_temp_conv_function_grads_include_da_db():
    rng = np.random.default_rng(61)
    bsz, f, pdim, c = 2, 6, 10, 64
    x = _normal(rng, (bsz, f, pdim, c))
    a = 1.0 + _normal(rng, (bsz, c), 0.1)
    b = _normal(rng, (bsz, c), 0.1)
    w = _normal(rng, (3, 1, 1, c, c), (3 * c) ** -0.5)
    bias = _normal(rng, (c,), 0.1)
    ct = _normal(rng, (bsz, f, pdim, c))
    out_j, vjp = jax.vjp(
        lambda x, a, b, w, bias: j_tc._unfused_shifted(x, a, b, w.reshape(3, c, c), bias),
        *map(jnp.asarray, (x, a, b, w, bias)))
    want = vjp(jnp.asarray(ct))
    out_t, got = _torch_vjp(t_tc.norm_silu_temporal_conv, (x, a, b, w, bias), ct)
    _close_rel(out_t, out_j)
    for g, wj in zip(got, want):
        _close_rel(g, wj)


def test_wrappers_route_through_autograd_functions():
    """Each kernel wrapper's output carries its Function's grad_fn, so no
    branch of the UNet can drop out of a gradient."""
    rng = np.random.default_rng(71)
    x = _t(_normal(rng, (1, 6, 4, 128)), grad=True)
    p = _tree(_pair_params(rng, 128), _t)
    ff = _tree(_ff_params(rng, 128, 512), _t)
    outs = {
        "PackedAttention": t_pa.attention_packed(x[0], x[0], x[0], 0.125, 2),
        "TemporalPair": t_ta.temporal_attention_pair(p, x, 2, 1e-5, frames_major=True),
        "Geglu": t_geglu.geglu_mlp(ff, x),
        "NormSiluTemporalConv": t_tc.norm_silu_temporal_conv(
            x, torch.ones(1, 128), torch.zeros(1, 128), _t(np.zeros((3, 1, 1, 128, 128),
                                                                    np.float32)),
            torch.zeros(128)),
    }
    for name, out in outs.items():
        assert name in type(out.grad_fn).__name__, (name, out.grad_fn)


def test_raw_launch_refuses_tensors_that_require_grad():
    from lvd_tpu_torch.ops import _build

    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd.Function"):
        _build.refuse_grad("kernel", x)
    with torch.no_grad():
        _build.refuse_grad("kernel", x)
    _build.refuse_grad("kernel", x.detach())
