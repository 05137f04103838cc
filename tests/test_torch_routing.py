"""Kernels A, B, D and F: the port's routing predicates against lvd_tpu's,
on the CPU.

lvd_tpu launches a Pallas kernel only where its predicate holds on the TPU
and runs XLA elsewhere; the port launches its CUDA kernel where the same
clauses hold and stock torch elsewhere. Each grid below evaluates lvd_tpu's
predicate under a test-local patch of ``jax.default_backend`` that answers
"tpu" and requires the port's to give the same route, in bf16, fp32 and
fp16:

- kernel A (``packed_attention.kernel_ok``) against lvd_tpu's ``pallas_ok``
  in ``attention_packed``, spied through the three routes it can take:
  head dims 8, 16, 64 and 128, key counts on both sides of the 8 MiB K/V
  clause;
- kernel D (``temp_conv_fused.lvd_tpu_routes``) against lvd_tpu's
  ``supported`` at C in {72, 320, 520, 640, 1280, 2560}, F in {16, 24, 32,
  33, 64, 100}, P in {45, 2880}; the port's ``supported`` (kernel D) is
  exactly that route, stock ops elsewhere;
- kernel B (``temporal_attention.supported`` / ``supported_frames_major``)
  against lvd_tpu's at P in {16, 144, 180, 576, 600, 720, 900, 2304, 2880,
  9216} (the last four and 144 the Zeroscope-XL levels), for both stream
  layouts, 64-wide heads at C = 320, 640 and 1280 and 80-wide ones at 320.

- kernel F (``temporal_attention.bwd_route``, which ``TemporalPair``'s
  backward follows) against lvd_tpu's ``_fused_pair_bwd``, spied through
  its three routes (its backward kernel in the layout, the pixels-major
  kernel between two transposes, the unfused VJP) at P in 1..64 and the
  path's pixel counts, C in {128, 320, 512, 640}, both layouts; and dy of
  the stock route on the CPU against lvd_tpu's ``jax.vjp`` in fp32 at
  1e-5 of max|ref|.

The chunked route that replaces kernel A where ``pallas_ok`` fails
(``attention.heads_chunked``) is held to lvd_tpu's ``_heads_chunked`` at a
16-wide head dim, in fp32, at 1e-5 of max|ref|.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu.ops import pallas_attention as j_pa
from lvd_tpu.ops import temp_conv_fused as j_tc
from lvd_tpu.ops import temporal_attention as j_ta
from lvd_tpu_torch.ops import attention as t_attn
from lvd_tpu_torch.ops import packed_attention as t_pa
from lvd_tpu_torch.ops import temp_conv_fused as t_tc
from lvd_tpu_torch.ops import temporal_attention as t_ta

DTYPES = ["bfloat16", "float32", "float16"]


@pytest.fixture
def on_tpu(monkeypatch):
    """lvd_tpu's predicates as its TPU routing evaluates them."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _lvd_attention_route(q_shape, k_shape, heads, jdt, monkeypatch):
    """Which route lvd_tpu's ``attention_packed`` takes: its short-key or
    long-key kernel, or the chunked XLA attention."""
    taken = []
    for name, route in (("_flash_heads_short", "kernel"), ("_flash_heads", "kernel"),
                        ("_heads_chunked", "chunked")):
        monkeypatch.setattr(j_pa, name, lambda q, *a, r=route: taken.append(r) or q)
    q = jax.ShapeDtypeStruct(q_shape, jdt)
    k = jax.ShapeDtypeStruct(k_shape, jdt)
    jax.eval_shape(lambda q, k: j_pa.attention_packed(q, k, k, 0.125, heads), q, k)
    return taken[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_route_matches_lvd_tpu(on_tpu, monkeypatch, dtype):
    jdt = jnp.dtype(dtype)
    heads = 5
    routes = set()
    for d in (8, 16, 64, 128):
        c = heads * d
        limit = t_pa.KV_BYTES_MAX // (2 * c * jdt.itemsize)  # the longest K/V the kernel takes
        for s_k in (77, limit, limit + 1):
            want = _lvd_attention_route((2, 96, c), (2, s_k, c), heads, jdt, monkeypatch)
            got = t_pa.kernel_ok(_meta((2, 96, c), dtype), _meta((2, s_k, c), dtype), heads)
            assert ("kernel" if got else "chunked") == want, (d, s_k, dtype)
            routes.add(want)
    assert routes == ({"chunked"} if dtype == "float16" else {"kernel", "chunked"})


def test_heads_chunked_matches_lvd_tpu():
    """The stock route at a 16-wide head dim (the tiny configs), ragged
    against lvd_tpu's 512-row query blocks."""
    rng = np.random.default_rng(5)
    heads, d = 4, 16
    q = rng.standard_normal((2, 600, heads * d)).astype(np.float32)
    k = rng.standard_normal((2, 300, heads * d)).astype(np.float32)
    v = rng.standard_normal((2, 300, heads * d)).astype(np.float32)
    ref = np.asarray(j_pa._heads_chunked(*map(jnp.asarray, (q, k, v)), 0.25, heads))
    got = t_attn.heads_chunked(*map(torch.from_numpy, (q, k, v)), 0.25, heads).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [72, 320, 520, 640, 1280, 2560])
def test_temp_conv_route_matches_lvd_tpu(on_tpu, dtype, c):
    jdt = jnp.dtype(dtype)
    for f in (16, 24, 32, 33, 64, 100):
        for p in (45, 2880):
            shape = (2, f, p, c)
            want = j_tc.supported(jax.ShapeDtypeStruct(shape, jdt))
            x = _meta(shape, dtype)
            assert t_tc.lvd_tpu_routes(x) == want, (shape, dtype)
            # Kernel D exactly where lvd_tpu runs its kernel; stock ops elsewhere.
            assert t_tc.supported(x) == want, (shape, dtype)
    if dtype == "float16":
        assert not any(t_tc.supported(_meta((2, f, 45, c), dtype)) for f in (16, 24, 32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads", [(320, 5), (640, 10), (1280, 20), (320, 4)])
def test_temporal_pair_route_matches_lvd_tpu(on_tpu, dtype, c, heads):
    jdt = jnp.dtype(dtype)
    for p in (16, 144, 180, 576, 600, 720, 900, 2304, 2880, 9216):
        fm_shape, pm_shape = (2, 24, p, c), (2, p, 24, c)
        want_fm = j_ta.supported_frames_major(jax.ShapeDtypeStruct(fm_shape, jdt), heads)
        want_pm = j_ta.supported(jax.ShapeDtypeStruct(pm_shape, jdt), heads)
        assert t_ta.supported_frames_major(_meta(fm_shape, dtype), heads) == want_fm, (p, c)
        assert t_ta.supported(_meta(pm_shape, dtype), heads) == want_pm, (p, c)
        for g_fm in (True, False):
            assert t_ta._pick_g(p, g_fm) == j_ta._pick_g(p, g_fm), (p, g_fm)
    if dtype != "float16" and c <= 640 and c // heads == 64:
        # P = 180 and 900 have no frames-major group: lvd_tpu relayouts and
        # runs its pixels-major kernel there.
        for p in (180, 900):
            assert not t_ta.supported_frames_major(_meta((2, 24, p, c), dtype), heads)
            assert t_ta.supported(_meta((2, p, 24, c), dtype), heads)


def _lvd_pair_bwd_route(pdim, c, frames_major, monkeypatch):
    """Which route lvd_tpu's ``_fused_pair_bwd`` takes on the TPU: its
    backward kernel in the stream's layout ("kernel"), its pixels-major
    kernel on the transposed stream ("pixels_major") or the unfused VJP
    alone ("stock"); the VJP and the kernel are stubbed, the stream is a
    zero-stride view."""
    taken = []
    monkeypatch.setattr(jax, "vjp", lambda fn, *args: (None, lambda ct: (None, ct)))
    monkeypatch.setattr(j_ta, "_pallas_pair_bwd",
                        lambda p, y, ct, heads, g, eps, frames_major=False: taken.append(
                            frames_major) or ct)
    shape = (1, 24, pdim, c) if frames_major else (1, pdim, 24, c)
    y = np.broadcast_to(np.zeros((), np.float32), shape)
    j_ta._fused_pair_bwd(c // 64, 0, 1e-5, frames_major, (None, y), y)
    if not taken:
        return "stock"
    return "kernel" if taken[0] == frames_major else "pixels_major"


def _port_pair_bwd_route(pdim, c, frames_major, monkeypatch):
    """Which route ``TemporalPair.backward`` takes: kernel F (its wrapper)
    or the stock VJP (``_stock_dy``), spied, on meta tensors."""
    taken = []
    monkeypatch.setattr(t_ta, "temporal_attention_pair_bwd",
                        lambda p, y, dy, *a: taken.append("F") or dy)
    monkeypatch.setattr(t_ta, "_stock_dy", lambda p, y, dy, *a: taken.append("stock") or dy)
    shape = (1, 24, pdim, c) if frames_major else (1, pdim, 24, c)
    y = _meta(shape, "bfloat16")
    ctx = types.SimpleNamespace(saved_tensors=(y,), args=(None, c // 64, 1e-5, frames_major),
                                needs_input_grad=(True, False, False, False, False))
    t_ta.TemporalPair.backward(ctx, y)
    return taken[0]


@pytest.mark.parametrize("frames_major", [True, False])
@pytest.mark.parametrize("c", [128, 320, 512, 640])
def test_temporal_pair_bwd_route_matches_lvd_tpu(on_tpu, monkeypatch, c, frames_major):
    """Kernel F where lvd_tpu launches its backward kernel, in the layout or
    through the pixels-major tile (the port reads the frames-major stream
    with strides instead of transposing it), the stock VJP where lvd_tpu
    takes its unfused VJP."""
    routes = set()
    for pdim in list(range(1, 65)) + [45, 180, 720, 900, 2880]:
        want = _lvd_pair_bwd_route(pdim, c, frames_major, monkeypatch)
        assert t_ta.bwd_route(pdim, c, frames_major) == want, (pdim, c, frames_major)
        assert t_ta._pick_g_bwd(pdim, c, frames_major) == j_ta._pick_g_bwd(pdim, c, frames_major)
        got = _port_pair_bwd_route(pdim, c, frames_major, monkeypatch)
        assert got == ("stock" if want == "stock" else "F"), (pdim, c, frames_major)
        routes.add(want)
    # Frames-major at C > 384 has no tile of its own: the pixels-major one or none.
    assert routes == ({"kernel", "stock"} if not frames_major
                      else {"kernel", "pixels_major", "stock"} if c <= 384
                      else {"pixels_major", "stock"})


def test_temporal_pair_stock_dy_matches_lvd_tpu():
    """P = 7 frames-major: lvd_tpu's forward takes its kernel (the whole of
    P as one pixel group) and its backward the unfused VJP; the port's
    TemporalPair runs the plain forward and the stock VJP on the CPU, fp32,
    against ``jax.vjp`` of lvd_tpu's ``_pair_ref_fm``."""
    rng = np.random.default_rng(31)
    c, heads, shape = 128, 2, (2, 5, 7, 128)
    assert t_ta.supported_frames_major(_meta(shape, "float32"), heads)
    assert t_ta.bwd_route(7, c, True) == "stock"
    lin = lambda bias: {"w": (rng.standard_normal((c, c)) * c ** -0.5).astype(np.float32),
                        **({"b": (0.1 * rng.standard_normal(c)).astype(np.float32)}
                           if bias else {})}
    attn = lambda: {"to_q": lin(False), "to_k": lin(False), "to_v": lin(False),
                    "to_out": lin(True)}
    norm = lambda: {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    p = {"norm1": norm(), "attn1": attn(), "norm2": norm(), "attn2": attn()}
    y = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    tree = lambda fn: jax.tree_util.tree_map(fn, p)
    _, vjp = jax.vjp(lambda yy: j_ta._pair_ref_fm(tree(jnp.asarray), yy, heads, 1e-5),
                     jnp.asarray(y))
    (ref,) = vjp(jnp.asarray(ct))
    leaf = torch.from_numpy(y).requires_grad_(True)
    out = t_ta.temporal_attention_pair(tree(torch.from_numpy), leaf, heads, 1e-5,
                                       frames_major=True)
    (got,) = torch.autograd.grad(out, leaf, torch.from_numpy(ct))
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() <= 1e-5
