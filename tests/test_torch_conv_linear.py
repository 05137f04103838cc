"""The port's rows 12, 13 and 14 against lvd_tpu on the CPU.

Each plain version (kernels H and I run only on the card) is held to the
lvd_tpu kernel it stands beside, run as lvd_tpu's own tests run it on the
CPU (Pallas in interpret mode), on seeded numpy inputs, forward and VJP, at
1e-4 of max|ref|: ``linear_plain`` to ``linear_fused._fused_rows``,
``norm_silu_conv2d_plain`` to ``spatial_conv_fused._fused`` (ragged H*W, a W
that is not a power of 2), ``conv3x3_plain`` to ``conv3x3._conv3x3_pallas``.
The port's autograd Functions are held to ``jax.vjp`` of lvd_tpu's custom-VJP
functions ``_linear_core`` and ``_stage`` (their forwards patched, in this
test only, to the interpreted kernels). The routing predicates are held to
lvd_tpu's at every Zeroscope shape, evaluated under a test-local patch of
``jax.default_backend`` that answers "tpu".
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu.ops import conv3x3 as j_c3
from lvd_tpu.ops import linear_fused as j_lf
from lvd_tpu.ops import spatial_conv_fused as j_scf
from lvd_tpu_torch.ops import conv3x3 as t_c3
from lvd_tpu_torch.ops import linear_fused as t_lf
from lvd_tpu_torch.ops import spatial_conv_fused as t_scf

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
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


@pytest.mark.parametrize("bias", [True, False])
def test_linear_plain_matches_interpreted_kernel(bias):
    rng = np.random.default_rng(0)
    x, w = _normal(rng, (300, 256)), _normal(rng, (256, 384), 256 ** -0.5)
    b = _normal(rng, (384,), 0.1) if bias else None
    ref = j_lf._fused_rows(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                           block_m=128, interpret=True)
    got = t_lf.linear_plain(_t(x), _t(w), None if b is None else _t(b))
    _close_rel(got.numpy(), ref)


@pytest.mark.parametrize("h,w", [(5, 9), (6, 10)])
def test_norm_silu_conv2d_plain_matches_interpreted_kernel(h, w):
    """Ragged H*W (45, 60 rows) and W that is not a power of 2."""
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, h, w, 32))
    a, b = 1.0 + _normal(rng, (2, 32), 0.2), _normal(rng, (2, 32), 0.2)
    wk, bias = _normal(rng, (9, 32, 24), (9 * 32) ** -0.5), _normal(rng, (24,), 0.1)
    ref = j_scf._fused(*map(jnp.asarray, (x, a, b, wk, bias)), interpret=True)
    got = t_scf.norm_silu_conv2d_plain(_t(x), _t(a), _t(b), _t(wk.reshape(3, 3, 32, 24)),
                                       _t(bias))
    _close_rel(got.numpy(), ref)


def test_conv3x3_plain_matches_interpreted_kernel():
    rng = np.random.default_rng(2)
    x, w = _normal(rng, (2, 8, 12, 64)), _normal(rng, (3, 3, 64, 64), (9 * 64) ** -0.5)
    ref = j_c3._conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True)
    _close_rel(t_c3.conv3x3_plain(_t(x), _t(w)).numpy(), ref)
    _close_rel(t_c3.conv3x3(_t(x), _t(w)).numpy(), ref)  # the entry point on the CPU


def test_linear_autograd_matches_linear_core_vjp(monkeypatch):
    monkeypatch.setattr(j_lf, "_fused_rows", functools.partial(j_lf._fused_rows, interpret=True))
    rng = np.random.default_rng(3)
    x, w, b = _normal(rng, (200, 128)), _normal(rng, (128, 256), 128 ** -0.5), \
        _normal(rng, (256,), 0.1)
    dy = _normal(rng, (200, 256))
    ref_y, vjp = jax.vjp(j_lf._linear_core, *map(jnp.asarray, (x, w, b)))
    ref_grads = vjp(jnp.asarray(dy))
    leaves = [_t(v, grad=True) for v in (x, w, b)]
    y = t_lf.LinearCore.apply(*leaves)
    grads = torch.autograd.grad(y, leaves, _t(dy))
    _close_rel(y.detach().numpy(), ref_y)
    for got, want in zip(grads, ref_grads):
        _close_rel(got.numpy(), want)
    # Without a bias the wrapper passes zeros, as lvd_tpu's linear() does.
    p = {"w": _t(w)}
    _close_rel(t_lf.linear(p, _t(x).reshape(2, 100, 128)).reshape(200, 256).numpy(),
               j_lf.linear({"w": jnp.asarray(w)}, jnp.asarray(x)))


def test_spatial_conv_autograd_matches_stage_vjp(monkeypatch):
    """dx, da, db, dw and dbias of the port's Function against jax.vjp of
    lvd_tpu's _stage (XLA's VJP of _unfused_shifted)."""
    monkeypatch.setattr(j_scf, "_fused", functools.partial(j_scf._fused, interpret=True))
    rng = np.random.default_rng(4)
    x = _normal(rng, (2, 5, 9, 16))
    a, b = 1.0 + _normal(rng, (2, 16), 0.2), _normal(rng, (2, 16), 0.2)
    wk, bias = _normal(rng, (9, 16, 24), (9 * 16) ** -0.5), _normal(rng, (24,), 0.1)
    dy = _normal(rng, (2, 5, 9, 24))
    ref_y, vjp = jax.vjp(j_scf._stage, *map(jnp.asarray, (x, a, b, wk, bias)))
    ref_grads = vjp(jnp.asarray(dy))
    leaves = [_t(v, grad=True) for v in (x, a, b, wk, bias)]
    y = t_scf.NormSiluConv2d.apply(*leaves)
    grads = torch.autograd.grad(y, leaves, _t(dy))
    _close_rel(y.detach().numpy(), ref_y)
    for got, want in zip(grads, ref_grads):
        _close_rel(got.numpy(), want)


def _zeroscope_resnet_convs():
    """(H, W, Cin, Cout) of the 44 resnet convs of the 576x320 Zeroscope UNet
    (block_out_channels 320, 640, 1280, 1280; two layers a down block, three
    an up block, whose inputs concatenate the skips), then conv_out."""
    levels = [(40, 72), (20, 36), (10, 18), (5, 9)]
    boc = [320, 640, 1280, 1280]
    convs, skips = [], [320]
    cin = 320
    for i, (hw, cout) in enumerate(zip(levels, boc)):
        for _ in range(2):
            convs += [(*hw, cin, cout), (*hw, cout, cout)]
            cin = cout
            skips.append(cout)
        if i < 3:
            skips.append(cout)
    convs += [(5, 9, 1280, 1280)] * 4  # mid block: resnet_in and one layer's resnet
    for i, hw in enumerate(reversed(levels)):
        cout = boc[3 - i]
        for _ in range(3):
            convs += [(*hw, cin + skips.pop(), cout), (*hw, cout, cout)]
            cin = cout
    return convs


@pytest.fixture
def on_tpu(monkeypatch):
    """lvd_tpu's predicates as its TPU routing evaluates them."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_spatial_conv_predicate_matches_lvd_tpu(on_tpu, dtype):
    convs = _zeroscope_resnet_convs()
    assert len(convs) == 44
    routed = 0
    for h, w, cin, cout in convs + [(40, 72, 320, 4)]:
        jx = jax.ShapeDtypeStruct((48, h, w, cin), jnp.dtype(dtype))
        jw = jax.ShapeDtypeStruct((3, 3, cin, cout), jnp.dtype(dtype))
        tx = torch.empty((48, h, w, cin), dtype=getattr(torch, dtype), device="meta")
        tw = torch.empty((3, 3, cin, cout), device="meta")
        want = j_scf.supported(jx, jw)
        assert t_scf.supported(tx, tw) == want, (h, w, cin, cout, dtype)
        routed += want
    assert routed == {"bfloat16": 33, "float32": 25}[dtype]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_linear_and_conv3x3_predicates_match_lvd_tpu(on_tpu, dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for rows, cin, cout in [(34560, 320, 320), (34560, 640, 640), (8640, 1280, 1280),
                            (2160, 1280, 1280), (3696, 1024, 320), (3696, 1024, 640),
                            (3696, 1024, 1280)]:
        jx, jw = jax.ShapeDtypeStruct((48, rows // 48, cin), jdt), jnp.zeros((cin, cout))
        tx = torch.empty((48, rows // 48, cin), dtype=tdt, device="meta")
        tw = torch.empty((cin, cout), device="meta")
        assert t_lf.supported(tw, tx) == j_lf.supported(jw, jx), (rows, cin, cout, dtype)
        # The backward's dx call: W^T against dy.
        tdy = torch.empty((48, rows // 48, cout), dtype=tdt, device="meta")
        assert t_lf.supported(tw.t(), tdy) == j_lf.supported(
            jw.T, jax.ShapeDtypeStruct((48, rows // 48, cout), jdt))
    for h, w, cin, cout in set(_zeroscope_resnet_convs()):
        jx = jax.ShapeDtypeStruct((48, h, w, cin), jdt)
        tx = torch.empty((48, h, w, cin), dtype=tdt, device="meta")
        jw = jax.ShapeDtypeStruct((3, 3, cin, cout), jdt)
        tw = torch.empty((3, 3, cin, cout), device="meta")
        assert t_c3.supported(tx, tw) == j_c3.supported(jx, jw), (h, w, cin, cout, dtype)
