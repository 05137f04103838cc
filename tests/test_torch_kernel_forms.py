"""Kernels H and I: which form each path shape takes, and kernel I's window
and tap arithmetic, on the CPU.

The CUDA kernels run only on the card; what a CPU run can hold is the
Python that chooses their forms and the index arithmetic the halo-window
form of kernel I uses (``ops/conv3x3.py``: ``launch_plan``,
``window_start``, ``tap_window_rows``):

- every selfcheck shape (``SCONV_SHAPES``, ``CONV3X3_SHAPES``,
  ``LINEAR_SHAPES``) that lvd_tpu's own predicate routes, in bf16 and in
  fp32, takes the new form (``wgmma`` / ``mma_sync``), and a width that is
  not a multiple of 64 (136 -> 72) takes the kept WMMA form;
- an im2col gathered through the window and tap rows, zero rows for the
  invalid taps, tiles spanning frames, times the (9 Cin, Cout) weight,
  equals lvd_tpu's conv3x3 (its Pallas kernel in interpret mode where its
  row blocks tile H, else its XLA route) and, with the GroupNorm-SiLU
  prologue applied to the window, lvd_tpu's ``spatial_conv_fused._unfused``,
  at 1e-5 of max|ref| in fp32.
"""

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
from lvd_tpu_torch.ops import selfcheck

TOL = 1e-5
NEW_FORM = {"bfloat16": "wgmma", "float32": "mma_sync"}


@pytest.fixture
def on_tpu(monkeypatch):
    """lvd_tpu's predicates as its TPU routing evaluates them."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def _conv_routed(pred, n, h, w, cin, cout, dtype):
    return pred(jax.ShapeDtypeStruct((n, h, w, cin), jnp.dtype(dtype)),
                jax.ShapeDtypeStruct((3, 3, cin, cout), jnp.dtype(dtype)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_routed_conv_shapes_take_the_new_form(on_tpu, dtype):
    tdt = getattr(torch, dtype)
    routed = 0
    for pred, shapes in ((j_scf.supported, selfcheck.SCONV_SHAPES),
                         (j_c3.supported, selfcheck.CONV3X3_SHAPES)):
        for n, h, w, cin, cout in shapes:
            if _conv_routed(pred, n, h, w, cin, cout, dtype):
                routed += 1
                assert t_c3.launch_plan(w, cin, cout, tdt)["form"] == NEW_FORM[dtype], \
                    (n, h, w, cin, cout)
    # All 13 selfcheck conv shapes are routed in bf16; fp32's budgets keep 7.
    assert routed == {"bfloat16": 13, "float32": 7}[dtype]
    # lvd_tpu's row-12 predicate takes %8 widths; those keep the WMMA form.
    assert _conv_routed(j_scf.supported, 3, 5, 9, 136, 72, dtype)
    assert t_c3.launch_plan(9, 136, 72, tdt)["form"] == "wmma"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_routed_linear_shapes_take_the_new_form(on_tpu, dtype):
    tdt = getattr(torch, dtype)
    routed = []
    for rows, c, n in selfcheck.LINEAR_SHAPES:
        jx = jax.ShapeDtypeStruct((48, rows // 48, c), jnp.dtype(dtype))
        if j_lf.supported(jnp.zeros((c, n)), jx):
            routed.append((rows, c, n))
            assert t_lf.kernel_form(tdt, c, n) == NEW_FORM[dtype]  # forward
            assert t_lf.kernel_form(tdt, n, c) == NEW_FORM[dtype]  # dx on W^T
    want = list(selfcheck.LINEAR_SHAPES)
    if dtype == "float32":  # 1280 x 1280 x 4 bytes = 6.5 MB > lvd_tpu's 6 MB
        want.remove((8640, 1280, 1280))
    assert routed == want


def _im2col_conv(x, w9, z_of=None):
    """The halo-window form's arithmetic: per 128-pixel tile, the window
    rows [window_start, window_start + window_rows) of the flattened input
    (zero outside it, the prologue applied by ``z_of`` to rows inside),
    gathered at tap_window_rows (a zero row for -1), times the weight."""
    n, h, w, cin = x.shape
    p_total = n * h * w
    plan = t_c3.launch_plan(w, cin, w9.shape[-1], x.dtype)
    assert plan["form"] == "mma_sync" and plan["box_rows"] * plan["boxes"] >= plan["window_rows"]
    flat = x.reshape(p_total, cin)
    frame = torch.arange(p_total) // (h * w)
    outs = []
    for p0 in range(0, p_total, t_c3.BLOCK_PIXELS):
        q = t_c3.window_start(p0, w) + torch.arange(plan["window_rows"])
        inside = (q >= 0) & (q < p_total)
        qc = q.clamp(0, p_total - 1)
        win = flat[qc] if z_of is None else z_of(flat[qc], frame[qc])
        win = torch.where(inside[:, None], win, torch.zeros(()))
        rows = t_c3.tap_window_rows(p0, n, h, w)
        a = torch.where((rows >= 0)[..., None], win[rows.clamp(min=0)], torch.zeros(()))
        outs.append(a.reshape(t_c3.BLOCK_PIXELS, 9 * cin) @ w9.reshape(9 * cin, -1))
    return torch.cat(outs)[:p_total].reshape(n, h, w, -1)


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= TOL, f"max|d|/max|ref| = {err:.3g} > {TOL}"


@pytest.mark.parametrize("shape", [(3, 5, 9, 64, 64), (2, 8, 8, 64, 128)])
def test_window_taps_give_lvd_tpu_conv(shape):
    """(3, 5, 9): 45-pixel frames, so every tile spans frames and the W
    edges would wrap; (2, 8, 8): lvd_tpu's Pallas kernel in interpret mode."""
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wk = (rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5).astype(np.float32)
    a = (1 + 0.2 * rng.standard_normal((n, cin))).astype(np.float32)
    b = (0.2 * rng.standard_normal((n, cin))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    w9 = torch.from_numpy(wk.reshape(9, cin, cout))

    ref = j_c3.conv3x3(jnp.asarray(x), jnp.asarray(wk), interpret=h % 8 == 0)
    _close(_im2col_conv(torch.from_numpy(x), w9).numpy(), ref)

    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    z_of = lambda v, f: torch.nn.functional.silu(v * ta[f] + tb[f])
    ref = j_scf._unfused(*map(jnp.asarray, (x, a, b, wk.reshape(9, cin, cout), bias)))
    got = _im2col_conv(torch.from_numpy(x), w9, z_of) + torch.from_numpy(bias)
    _close(got.numpy(), ref)
