"""Kernel J (row 9, the k-streaming GEGLU) and the GEGLU routing, on the CPU.

J runs only on the card; here its plain version (``geglu_stream_plain``) is
held to lvd_tpu's streaming kernel ``_fused_rows`` run as lvd_tpu's own tests
run it on the CPU (Pallas in interpret mode), on seeded numpy inputs, in both
GELU forms, at 1e-4 of max|ref|. The public ``geglu_mlp`` (forward and dx
through autograd) is held to lvd_tpu's ``geglu_mlp`` and ``jax.vjp`` at a
shape where lvd_tpu streams (fp32, C = 512, inner 2048: 12.6 MB of weights).
The port's routing (``supported()``, kernel C or J forward, kernel G or the
stock VJP for dx) is held to lvd_tpu's at the Zeroscope widths, in bf16 and
fp32, evaluated under a test-local patch of ``jax.default_backend`` that
answers "tpu" and spies on the kernels lvd_tpu would call.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu.ops import geglu_fused as j_gf
from lvd_tpu_torch.ops import geglu_fused as t_gf

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def on_tpu(monkeypatch):
    """lvd_tpu's predicates as its TPU routing evaluates them."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.fixture(params=["tanh", "exact"])
def gelu_form(request, monkeypatch):
    monkeypatch.setattr(j_gf, "GELU_FORM", request.param)
    monkeypatch.setattr(t_gf, "GELU_FORM", request.param)
    return request.param


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close_rel(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max|d|/max|ref| = {err:.3g} > {tol}"


def _ff(rng, c, inner):
    return {"proj": {"w": _normal(rng, (c, 2 * inner), c ** -0.5),
                     "b": _normal(rng, (2 * inner,), 0.1)},
            "out": {"w": _normal(rng, (inner, c), inner ** -0.5), "b": _normal(rng, (c,), 0.1)}}


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in p.items()}


@pytest.mark.parametrize("c", [64, 128])
def test_stream_plain_matches_interpreted_kernel(c, gelu_form):
    """Ragged rows (300 against block_m 128), two k steps of 256."""
    rng = np.random.default_rng(c)
    p = _ff(rng, c, 512)
    x = _normal(rng, (300, c))
    ref = j_gf._fused_rows(jnp.asarray(x), *(jnp.asarray(a) for a in (
        p["proj"]["w"], p["proj"]["b"], p["out"]["w"], p["out"]["b"])),
        block_m=128, block_k=256, interpret=True)
    got = t_gf.geglu_stream_plain(_tree(p, torch.from_numpy), torch.from_numpy(x))
    _close_rel(got.numpy(), ref)


def test_public_geglu_mlp_matches_lvd_tpu_where_it_streams(gelu_form, monkeypatch):
    """Forward (kernel J's route) and dx through autograd (the stock VJP)
    against lvd_tpu's geglu_mlp with its interpreted streaming kernel and
    jax.vjp; 600 rows are ragged against lvd_tpu's block_m of 512."""
    monkeypatch.setattr(j_gf, "_fused_rows", functools.partial(j_gf._fused_rows, interpret=True))
    rng = np.random.default_rng(7)
    c, inner = 512, 2048
    p = _ff(rng, c, inner)
    x, dy = _normal(rng, (2, 300, c)), _normal(rng, (2, 300, c))
    assert t_gf.forward_kernel(c, inner, torch.float32) == "J"
    assert t_gf.dx_route(c, inner, torch.float32) == "stock"
    jp = _tree(p, jnp.asarray)
    ref, vjp = jax.vjp(lambda a: j_gf.geglu_mlp(jp, a), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(dy))
    leaf = torch.from_numpy(x).requires_grad_(True)
    out = t_gf.geglu_mlp(_tree(p, torch.from_numpy), leaf)
    (dx,) = torch.autograd.grad(out, leaf, torch.from_numpy(dy))
    _close_rel(out.detach().numpy(), ref)
    _close_rel(dx.numpy(), ref_dx)


def _lvd_forward_route(c, inner, jdt, monkeypatch):
    """What lvd_tpu's ``_fused_rows`` runs at this width: its resident kernel,
    its streaming kernel, or a ValueError (inner not a multiple of block_k)."""
    taken = []
    monkeypatch.setattr(j_gf, "_fused_rows_resident",
                        lambda x, *a, **k: taken.append("resident") or jnp.zeros_like(x))
    monkeypatch.setattr(j_gf, "vma_pallas_call", lambda kernel, **k: (
        taken.append("stream") or (lambda *a: jnp.zeros(k["out_shape"].shape, jdt))))
    shapes = [(64, c), (c, 2 * inner), (2 * inner,), (inner, c), (c,)]
    try:
        jax.eval_shape(j_gf._fused_rows, *(jax.ShapeDtypeStruct(s, jdt) for s in shapes))
    except ValueError:
        return "raises"
    return taken[0]


def _lvd_dx_route(c, inner, jdt, monkeypatch):
    """Whether lvd_tpu's ``_fused_bwd`` takes its resident dx kernel."""
    taken = []
    monkeypatch.setattr(j_gf, "_fused_rows_bwd_resident",
                        lambda x, *a, **k: taken.append("G") or jnp.zeros_like(x))
    res = tuple(jax.ShapeDtypeStruct(s, jdt)
                for s in [(64, c), (c, 2 * inner), (2 * inner,), (inner, c), (c,)])
    jax.eval_shape(j_gf._fused_bwd, res, jax.ShapeDtypeStruct((64, c), jdt))
    return taken[0] if taken else "stock"


@pytest.mark.parametrize("c", [320, 512, 640, 648, 1280])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_routing_matches_lvd_tpu(on_tpu, monkeypatch, dtype, c):
    """supported() at 2047, 2048 and 138240 rows, kernel C or J forward and
    kernel G or the stock VJP for dx, against lvd_tpu's choices (inner =
    4C, as in every Zeroscope transformer block)."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    inner = 4 * c
    for rows in (2047, 2048, 138240):
        jx = jax.ShapeDtypeStruct((rows, c), jdt)
        tx = torch.empty((rows, c), dtype=tdt, device="meta")
        want = j_gf.supported(jnp.zeros((c, 2 * inner)), jnp.zeros((inner, c)), jx)
        got = t_gf.supported(torch.empty(c, 2 * inner), torch.empty(inner, c), tx)
        assert got == want, (rows, c, dtype)
    route = _lvd_forward_route(c, inner, jdt, monkeypatch)
    kernel = t_gf.forward_kernel(c, inner, tdt)
    if route == "resident":
        # Kernel C where its template covers the width, kernel J elsewhere.
        assert kernel == ("C" if c % 64 == 0 and c <= 640 else "J"), (c, dtype)
    else:
        assert kernel == "J", (c, dtype)
        # Where lvd_tpu's streaming form raises, kernel J refuses the width too.
        assert (route == "raises") == (inner % t_gf.STREAM_INNER != 0), (c, dtype)
    assert t_gf.dx_route(c, inner, tdt) == _lvd_dx_route(c, inner, jdt, monkeypatch), (c, dtype)
