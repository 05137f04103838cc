"""Kernels B-D and F-J: which form each path shape takes, and the index
arithmetic of their Hopper forms, on the CPU.

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
  at 1e-5 of max|ref| in fp32;
- every ``GEGLU_SHAPES`` / ``TCONV_SHAPES`` shape that lvd_tpu's predicates
  route takes kernel C's / D's new form (``wgmma`` in bf16, ``mma_sync`` in
  fp32), and so does every width C's route gives it but fp32 C > 384 (C =
  512 with inner 256), which keeps the WMMA form;
- kernel D's launch plan (``ops/temp_conv_fused.py``, which the kernel
  checks: one window per 8-pixel tile from frame -1, tap k of output row r
  at window row r + 8 k,
  zero rows for frames outside [0, F) and pixels past P, padded m64 tiles
  whose rows are NaN here and must never reach the output) times the
  (3C, C) weight equals lvd_tpu's ``temp_conv_fused._fused`` in interpret
  mode and ``_unfused``, at F = 5 and 24 with a ragged P, at F = 40 and 64
  (two frame groups, each window from its group's first frame - 1) and at
  C = 72 (a last 64-wide channel chunk zero past C, its output columns past
  C not stored);
- kernel C's chunk plan (``ops/geglu_fused.py``, which the kernel checks:
  64-row blocks, per 64-wide inner chunk each warpgroup's [h | g] columns
  as a 64-column block of the interleaved w1, the gated chunk rounded to
  the stream's type,
  each warpgroup's output blocks, split over two blocks at C >= 448)
  equals lvd_tpu's ``_fused_rows_resident`` in interpret mode and
  ``_unfused``;
- kernel B's wgmma form (``ops/temporal_attention.py``: ``launch_plan``,
  ``block_rows``, ``key_mask``): 64-row blocks of 64 // F whole pixels
  gathered from either stream layout, zero padding rows, each row's keys
  masked to its own pixel, heads in pairs with warpgroup 1's head past an
  odd head count computed on the weights its boxes read and never stored,
  equals lvd_tpu's ``_pallas_pair`` in interpret mode and ``_pair_ref``, at
  F = 5 and 24, ragged P, H = 2 and 3;
- kernel G's wgmma form (``ops/geglu_fused.py``: ``bwd_launch_plan``,
  ``dx_columns``, ``interleave_w1``): per 64-row block and 64-wide inner
  chunk, each warpgroup's [h | g] block of the interleaved w1, d_inner from
  its 32 rows of W2, the [dh | dg] cotangent tile in the interleaved
  column order, and its dx columns in 32-column pieces of the interleaved
  w1's rows (split over two blocks at C >= 384, a last piece reaching past
  the warpgroup's columns stored only within them), equals lvd_tpu's
  ``_fused_rows_bwd_resident`` in interpret mode and the plain dx, at
  C = 192 and 448, both GELU forms.

- kernel F's wgmma form (``ops/temporal_attention.py``:
  ``bwd_launch_plan``, ``block_rows``, ``key_mask``, ``bwd_stages``): 64-row
  tiles of whole pixels from either layout, zero padding rows, keys masked
  to each row's pixel, heads in pairs, every weight box and workspace tile
  taken from the ring in the order ``bwd_stages`` lists (the stream used up
  exactly); the forward recomputed with q/k/v kept, dO, P, dV, dP, dL, dQ,
  dK per head, dz in 64-column blocks from the [dq | dk | dv] tiles, the
  LayerNorm VJPs, equals lvd_tpu's ``_pallas_pair_bwd`` in interpret mode
  and the plain dy, at F = 5 and 24, ragged P, H = 2 and 1 (warpgroup 1's
  head past H);
- kernel J's wgmma form (``ops/geglu_fused.py``: ``stream_launch_plan``,
  ``gated_chunks``, ``interleave_w1``): 128-row tiles, each 128 columns of
  the interleaved W1 holding h and g of 64 inner columns in the chunks
  ``gated_chunks`` names, the gated tensor rounded to the stream's type,
  then gated W2 + b2 in 128-column tiles, equals lvd_tpu's ``_fused_rows``
  streaming branch in interpret mode and the plain version, at C = 72 and
  128, both GELU forms.

Every selfcheck shape of B and J (at every ``GEGLU_STREAM_SHAPES`` width)
takes its ``wgmma`` form in bf16 and the first version (``wmma``) in fp32;
F and G take their ``wgmma`` forms in both types, in fp32 on TF32 wgmma:
kernel G's fp32 chunk plan (``dx_pieces`` of 16 columns, W1 staged
transposed, operands TF32-rounded by ``tf32_round``) and kernel F's fp32
passes (``_tf32_passes``, ``_tf32_gemm_tiles``) equal lvd_tpu's interpreted
kernels unrounded and hold the fp32 gate rounded; every F shape is one
lvd_tpu's backward route gives a kernel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu.ops import conv3x3 as j_c3
from lvd_tpu.ops import geglu_fused as j_gf
from lvd_tpu.ops import linear_fused as j_lf
from lvd_tpu.ops import spatial_conv_fused as j_scf
from lvd_tpu.ops import temp_conv_fused as j_tc
from lvd_tpu.ops import temporal_attention as j_ta
from lvd_tpu_torch.ops import conv3x3 as t_c3
from lvd_tpu_torch.ops import geglu_fused as t_gf
from lvd_tpu_torch.ops import linear_fused as t_lf
from lvd_tpu_torch.ops import selfcheck
from lvd_tpu_torch.ops import temp_conv_fused as t_tc
from lvd_tpu_torch.ops import temporal_attention as t_ta

TOL = 1e-5
NEW_FORM = {"bfloat16": "wgmma", "float32": "mma_sync"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's torch emulations on one thread: the suite runs its files in
    parallel workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
# Kernel C in fp32 takes mma_sync up to C = 384 and keeps the WMMA form wider.
C_FP32_MAX = 384


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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_routed_geglu_and_temp_conv_shapes_take_their_forms(on_tpu, dtype):
    tdt = getattr(torch, dtype)
    routed = []
    for rows, c in selfcheck.GEGLU_SHAPES:
        w1, w2 = jnp.zeros((c, 8 * c)), jnp.zeros((4 * c, c))
        if j_gf.supported(w1, w2, jax.ShapeDtypeStruct((rows, c), jnp.dtype(dtype))):
            routed.append(c)
            assert t_gf.forward_kernel(c, 4 * c, tdt) == "C"
            assert t_gf.launch_plan(c, tdt)["form"] == NEW_FORM[dtype]
    # fp32 weights of C = 512 and 640 exceed lvd_tpu's 10 MiB resident budget.
    assert routed == {"bfloat16": [320, 512, 640], "float32": [320]}[dtype]
    if dtype == "bfloat16":  # the Zeroscope-XL refine's feed-forwards take kernel C
        for rows, c in selfcheck.XL_GEGLU_SHAPES:
            w1, w2 = jnp.zeros((c, 8 * c)), jnp.zeros((4 * c, c))
            assert j_gf.supported(w1, w2, jax.ShapeDtypeStruct((rows, c), jnp.bfloat16))
            assert t_gf.forward_kernel(c, 4 * c, tdt) == "C"
    # Every width kernel C's route gives it takes the new form, but fp32
    # C > 384, which the route gives C only with a small inner dimension
    # (C = 512, inner 256), keeps the WMMA form.
    for c in range(64, 641, 64):
        for inner in (256, 4 * c):
            if t_gf.forward_kernel(c, inner, tdt) == "C":
                kept = dtype == "float32" and c > C_FP32_MAX
                assert t_gf.launch_plan(c, tdt)["form"] == ("wmma" if kept else NEW_FORM[dtype])
    assert (t_gf.forward_kernel(512, 256, torch.float32), t_gf.launch_plan(512, torch.float32)["form"]) \
        == ("C", "wmma")
    for shape in selfcheck.TCONV_SHAPES:
        assert j_tc.supported(jax.ShapeDtypeStruct(shape, jnp.dtype(dtype)))
        assert t_tc.supported(torch.empty(shape, dtype=tdt, device="meta"))
        assert t_tc.launch_plan(shape[1], tdt)["form"] == NEW_FORM[dtype]
    # The upsample path's and C4's shapes, each in the types the selfcheck
    # runs it: routed by lvd_tpu, so kernel D in its new form.
    checked = selfcheck.XL_TCONV_SHAPES + selfcheck.C4_TCONV_SHAPES
    if dtype == "float32":
        checked = selfcheck.C4_TCONV_FP32_SHAPES
    for shape in checked:
        assert j_tc.supported(jax.ShapeDtypeStruct(shape, jnp.dtype(dtype))), shape
        assert t_tc.supported(torch.empty(shape, dtype=tdt, device="meta")), shape
        assert t_tc.launch_plan(shape[1], tdt)["form"] == NEW_FORM[dtype]


def _window_temp_conv(x, a, b, w, bias):
    """Kernel D's wgmma form in torch: per (batch, frame group, 8-pixel
    tile) one window of rows (frame, pixel) for frames f0 - 1 .. f0 + G of
    the group from f0 (zero outside [0, F) and past P, the prologue applied
    to the rest), padded to window_rows with NaN; channels in 64-wide
    chunks, zero past C in the window and in the weight's tap slices on both
    axes; tap k of output row r reads window row r + 8 k; rows r < 8 G of
    frames inside F and pixels inside P are stored, columns past C not."""
    bsz, f, p, c = x.shape
    plan = t_tc.launch_plan(f, torch.bfloat16)
    pt, g = plan["pixel_tile"], plan["frame_group"]
    taps = t_tc.tap_rows(f)
    assert plan["form"] == "wgmma" and taps.max() < plan["window_rows"]
    assert plan["start_frame"] == -1 and plan["loaded_rows"] == pt * (g + 2)
    assert g <= t_tc.MAX_GROUP and plan["frame_groups"] * g >= f > (plan["frame_groups"] - 1) * g
    cp = -(-c // 64) * 64
    wp = torch.zeros(3, cp, cp)
    wp[:, :c, :c] = w
    out = torch.full_like(x, float("nan"))
    for gi, frames in enumerate(t_tc.window_frames(f)):
        frames = torch.tensor(frames)
        assert len(frames) == g + 2 and frames[0] == gi * g + plan["start_frame"]
        for bi in range(bsz):
            z = torch.nn.functional.silu(x[bi] * a[bi] + b[bi])  # (F, P, C)
            for p0 in range(0, p, pt):
                pix = p0 + torch.arange(pt)
                ok = ((frames >= 0) & (frames < f))[:, None] & (pix < p)[None, :]
                loaded = z[frames.clamp(0, f - 1)][:, pix.clamp(max=p - 1)]  # (G + 2, 8, C)
                loaded = torch.where(ok[..., None], loaded, torch.zeros(()))
                win = torch.full((plan["window_rows"], cp), float("nan"))
                win[:plan["loaded_rows"]] = 0.0
                win[:plan["loaded_rows"], :c] = loaded.reshape(-1, c)
                y = sum(win[taps[k]] @ wp[k] for k in range(3))  # (64 m_tiles, C padded)
                for r in range(pt * g):
                    fr = gi * g + r // pt
                    if fr < f and p0 + r % pt < p:
                        out[bi, fr, p0 + r % pt] = y[r, :c] + bias
    return out


@pytest.mark.parametrize("f,c", [(5, 64), (24, 64), (40, 64), (64, 64), (24, 72)])
def test_temp_conv_window_plan_gives_lvd_tpu(f, c):
    """P = 13: two pixel tiles, the second ragged (and lvd_tpu's Pallas
    grid cut into 8-pixel blocks, ragged too). F = 40 and 64 take two frame
    groups (of 20 and of 32 frames); C = 72 a last channel chunk of 8."""
    bsz, p = 2, 13
    rng = np.random.default_rng(17)
    x = rng.standard_normal((bsz, f, p, c)).astype(np.float32)
    a = (1 + 0.2 * rng.standard_normal((bsz, c))).astype(np.float32)
    b = (0.2 * rng.standard_normal((bsz, c))).astype(np.float32)
    w = (rng.standard_normal((3, c, c)) * (3 * c) ** -0.5).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    got = _window_temp_conv(*map(torch.from_numpy, (x, a, b, w, bias))).numpy()
    args = tuple(map(jnp.asarray, (x, a, b, w, bias)))
    _close(got, j_tc._fused(*args, block_p=8, interpret=True))
    _close(got, j_tc._unfused(*args))


def test_temp_conv_frame_groups():
    """ceil(F / 32) groups of ceil(F / groups) frames, at most 32 each; every
    frame is one group's output, and each window holds its group's frames
    and the one frame either side."""
    for f in (1, 5, 24, 32, 33, 40, 48, 64, 100, 200, 450):
        plan = t_tc.launch_plan(f, torch.float32)
        g, n = plan["frame_group"], plan["frame_groups"]
        assert n == -(-f // 32) and g == -(-f // n) and g <= 32
        assert plan["m_tiles"] == -(-8 * g // 64) and plan["form"] == "mma_sync"
        wins = t_tc.window_frames(f)
        outputs = [fr for wf in wins for fr in wf[1:-1] if fr < f]
        assert outputs == list(range(f))
        assert all(wf[-1] - wf[0] == g + 1 for wf in wins)


def _chunk_plan_geglu(x, w1, b1, w2, b2):
    """Kernel C's wgmma form in torch: 64-row blocks (rows past R zero);
    per 64-wide inner chunk k, warpgroup j's [h | g] = x w1[:, gemm1_columns]
    + b1, its 32 gated columns h * gelu(g) rounded to the stream's type into
    the 64-wide gated chunk, and each warpgroup's output blocks accumulated
    from the whole chunk; + b2 at the end."""
    r, c = x.shape
    inner = w2.shape[0]
    plan = t_gf.launch_plan(c, torch.bfloat16)
    rb, ch = plan["row_block"], plan["inner_chunk"]
    halves = range(plan["split"])
    blocks = [sum((t_gf.output_blocks(c, j, hf) for hf in halves), []) for j in (0, 1)]
    assert sorted(blocks[0] + blocks[1]) == list(range(c // 64))
    w1i = t_gf.interleave_w1(w1, inner)
    out = torch.empty_like(x)
    for r0 in range(0, r, rb):
        xb = torch.zeros(rb, c)
        xb[:min(rb, r - r0)] = x[r0:r0 + rb]
        acc = torch.zeros(rb, c)
        for k in range(inner // ch):
            gated = torch.empty(rb, ch)
            for j in (0, 1):
                cols = t_gf.gemm1_columns(k, j, inner)
                blk = slice(64 * (2 * k + j), 64 * (2 * k + j) + 64)  # the kernel's TMA box
                assert torch.equal(w1i[:, blk], w1[:, cols])
                hg = xb @ w1i[:, blk] + b1[cols]
                gated[:, 32 * j:32 * j + 32] = (hg[:, :32] * t_gf._gelu(hg[:, 32:])).to(x.dtype)
            for j in (0, 1):
                for blk in blocks[j]:
                    cs = slice(64 * blk, 64 * blk + 64)
                    acc[:, cs] += gated @ w2[ch * k:ch * k + ch, cs]
        out[r0:r0 + rb] = (acc + b2)[:min(rb, r - r0)]
    return out


@pytest.mark.parametrize("form", ["tanh", "exact"])
@pytest.mark.parametrize("c", [192, 576])
def test_geglu_chunk_plan_gives_lvd_tpu(form, c, monkeypatch):
    """C = 192 (three output blocks: two for warpgroup 0, one for 1) and
    576 (nine, split over two blocks of five and four), inner 256 (four
    chunks), 200 rows (the last 64-row block ragged)."""
    monkeypatch.setattr(j_gf, "GELU_FORM", form)
    monkeypatch.setattr(t_gf, "GELU_FORM", form)
    r, inner = 200, 256
    rng = np.random.default_rng(19)
    x = rng.standard_normal((r, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, 2 * inner)) * c ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(2 * inner)).astype(np.float32)
    w2 = (rng.standard_normal((inner, c)) * inner ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    got = _chunk_plan_geglu(*map(torch.from_numpy, (x, w1, b1, w2, b2))).numpy()
    args = tuple(map(jnp.asarray, (x, w1, b1, w2, b2)))
    _close(got, j_gf._fused_rows_resident(*args, block_m=64, nk=2, interpret=True))
    _close(got, j_gf._unfused(*args))



@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pair_and_geglu_bwd_shapes_take_their_forms(on_tpu, dtype):
    tdt = getattr(torch, dtype)
    want = "wgmma" if dtype == "bfloat16" else "wmma"
    for b, f, p, c in (selfcheck.PAIR_SHAPES + selfcheck.PAIR_BWD_SHAPES
                       + selfcheck.TRAIN_PAIR_SHAPES):
        assert j_ta.supported_frames_major(
            jax.ShapeDtypeStruct((b, f, p, c), jnp.dtype(dtype)), c // 64)
        assert t_ta.supported_frames_major(torch.empty((b, f, p, c), dtype=tdt, device="meta"),
                                           c // 64)
        # Kernel B's wgmma form in both types (in fp32 the TF32 passes).
        plan = t_ta.launch_plan(f, c, tdt)
        assert plan["form"] == "wgmma" and plan["pixels"] * f <= plan["row_block"]
        if dtype == "float32":
            assert (plan["row_block"], plan["pixels"]) == (t_ta.TF32_ROW_BLOCK, 1)
        # lvd_tpu's backward takes a kernel there, and the port kernel F: its
        # wgmma form in both types (in fp32 the TF32 passes, one pixel and
        # head a block of its attention steps, 128-row projection tiles).
        if (b, f, p, c) in selfcheck.PAIR_BWD_SHAPES:
            assert j_ta._pick_g_bwd(p, c, True) or j_ta._pick_g_bwd(p, c, False)
            assert t_ta.bwd_route(p, c, True) != "stock"
            plan = t_ta.bwd_launch_plan(f, c, tdt)
            assert plan["form"] == "wgmma" and plan["pixels"] * f <= plan["row_block"]
            if dtype == "float32":
                assert (plan["row_block"], plan["pixels"]) == (t_ta.TF32_ROW_BLOCK, 1)
    for rows, c in selfcheck.GEGLU_STREAM_SHAPES:
        assert t_gf.stream_launch_plan(tdt)["form"] == want
        if c == 1280:  # lvd_tpu streams the C = 1280 feed-forward in either type
            assert t_gf.forward_kernel(c, 4 * c, tdt) == "J"
    routed = [c for _, c in selfcheck.GEGLU_BWD_SHAPES if t_gf.dx_route(c, 4 * c, tdt) == "G"]
    # fp32 weights of C = 512 and 640 exceed lvd_tpu's resident budget: stock dx.
    assert routed == {"bfloat16": [320, 512, 640], "float32": [320]}[dtype]
    for c in routed:  # G's wgmma form in both types (TF32 in fp32)
        plan = t_gf.bwd_launch_plan(c, 4 * c, tdt)
        assert plan["form"] == "wgmma"
        # each warpgroup's columns, in 32- (bf16) or 16-column (fp32) pieces, cover C once
        assert plan["wg_columns"] * 2 * plan["split"] == c
        assert plan["piece"] == (32 if dtype == "bfloat16" else 16)
    # Widths the resident forms do not cover take the general form.
    assert t_gf.bwd_launch_plan(72, 256, tdt)["form"] == "general"


def _pair_params_np(rng, c):
    lin = lambda bias: {"w": (rng.standard_normal((c, c)) * c ** -0.5).astype(np.float32),
                        **({"b": (0.1 * rng.standard_normal(c)).astype(np.float32)}
                           if bias else {})}
    attn = lambda: {"to_q": lin(False), "to_k": lin(False), "to_v": lin(False),
                    "to_out": lin(True)}
    norm = lambda: {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    return {"norm1": norm(), "attn1": attn(), "norm2": norm(), "attn2": attn()}


def _block_plan_pair(p, y, heads, frames_major):
    """Kernel B's wgmma form in torch: per (batch, pixel block) the 64 rows
    of ``block_rows`` (zero past the block's pixels), then per attention:
    LayerNorm (padding rows zero), heads in pairs (warpgroup j: head 2 i +
    j, its k / v / q as the 64 columns its boxes read from [Wq | Wk | Wv],
    zero past 3C), scores masked by ``key_mask``, the head's output stored
    only for heads < H; the output projection, + bias, + the residual on
    the block's valid rows, which then hold y1."""
    if frames_major:
        y = y.transpose(1, 2)
    bsz, pdim, f, c = y.shape
    plan = t_ta.launch_plan(f, c, torch.bfloat16)
    assert plan["form"] == "wgmma" and plan["row_block"] == 64
    mask = t_ta.key_mask(f)
    out = torch.full_like(y, float("nan"))
    for bi in range(bsz):
        for blk in range(-(-pdim // plan["pixels"])):
            pix, frame, ok = t_ta.block_rows(f, pdim, blk)
            rows = torch.where(ok[:, None], y[bi, pix.clamp(max=pdim - 1), frame],
                               torch.zeros(()))
            for name in ("1", "2"):
                pa, ln = p["attn" + name], p["norm" + name]
                xc = rows.clone()
                mean = xc.mean(-1, keepdim=True)
                var = (xc * xc).mean(-1, keepdim=True) - mean * mean
                z = (xc - mean) * torch.rsqrt(var.clamp(min=0) + 1e-5) * ln["scale"] + ln["bias"]
                z = torch.where(ok[:, None], z, torch.zeros(()))
                wqkv = torch.cat([pa["to_q"]["w"], pa["to_k"]["w"], pa["to_v"]["w"],
                                  torch.zeros(c, 64)], dim=1)  # boxes past 3C read zeros
                o = torch.zeros(64, c)
                for pair in range(-(-heads // 2)):
                    for wg in (0, 1):
                        head = 2 * pair + wg
                        q, k, v = (z @ wqkv[:, m * c + 64 * head:m * c + 64 * head + 64]
                                   for m in range(3))
                        s_ = (q @ k.T) * 64 ** -0.5
                        probs = torch.softmax(s_.masked_fill(~mask, float("-inf")), dim=-1)
                        if head < heads:
                            o[:, 64 * head:64 * head + 64] = probs @ v
                rows = torch.where(ok[:, None], rows + o @ pa["to_out"]["w"] + pa["to_out"]["b"],
                                   rows)
            for r in torch.nonzero(ok).flatten().tolist():
                out[bi, pix[r], frame[r]] = rows[r]
    return out.transpose(1, 2) if frames_major else out


@pytest.mark.parametrize("frames_major", [True, False])
@pytest.mark.parametrize("f,pdim,c", [(5, 15, 128), (24, 5, 192)])
def test_pair_block_plan_gives_lvd_tpu(f, pdim, c, frames_major):
    """F = 5: 12 pixels a block, 15 pixels (the second block three);
    F = 24: 2 pixels a block, 5 pixels (the last block ragged), three heads
    (warpgroup 1's second head past H)."""
    rng = np.random.default_rng(23)
    heads = c // 64
    p = _pair_params_np(rng, c)
    shape = (2, f, pdim, c) if frames_major else (2, pdim, f, c)
    y = rng.standard_normal(shape).astype(np.float32)
    tree = lambda fn: {k: {n: {m: fn(t) for m, t in w.items()} if isinstance(w, dict) else fn(w)
                           for n, w in v.items()} for k, v in p.items()}
    got = _block_plan_pair(tree(torch.from_numpy), torch.from_numpy(y), heads, frames_major)
    jp, jy = tree(jnp.asarray), jnp.asarray(y)
    g = j_ta._pick_g(pdim, frames_major)
    assert g > 0
    _close(got.numpy(), j_ta._pallas_pair(jp, jy, heads, g, 1e-5, frames_major=frames_major,
                                          interpret=True))
    ref = (j_ta._pair_ref_fm if frames_major else j_ta._pair_ref)(jp, jy, heads, 1e-5)
    _close(got.numpy(), ref)


def _chunk_plan_geglu_bwd(x, dy, w1, b1, w2):
    """Kernel G's wgmma form in torch: 64-row blocks (rows past R zero),
    ``split`` blocks on each; per 64-wide inner chunk k, warpgroup j's
    [h | g] = x w1i[:, block 2 k + j] + b1 and d_inner = dy W2[64 k + 32 j
    .., :]^T, the cotangents [dh | dg] rounded to the stream's type into
    the chunk's 128-column tile (box j: warpgroup j's [dh32 | dg32]); then
    each warpgroup's dx pieces += cot times 32 rows of w1i (zero past C),
    stored only within its ``dx_columns``."""
    r, c = x.shape
    inner = w2.shape[0]
    plan = t_gf.bwd_launch_plan(c, inner, torch.bfloat16)
    rb, ch, nw = plan["row_block"], plan["inner_chunk"], plan["wg_columns"]
    w1i = t_gf.interleave_w1(w1, inner)
    w1i_rows = torch.cat([w1i, torch.zeros(64, 2 * inner)])  # boxes past C read zeros
    cols = [sorted(sum((list(t_gf.dx_columns(c, hf, j)) for hf in range(plan["split"])), []))
            for j in (0, 1)]
    assert sorted(cols[0] + cols[1]) == list(range(c))
    dx = torch.full_like(x, float("nan"))
    for r0 in range(0, r, rb):
        n = min(rb, r - r0)
        xb, dyb = torch.zeros(rb, c), torch.zeros(rb, c)
        xb[:n], dyb[:n] = x[r0:r0 + n], dy[r0:r0 + n]
        for half in range(plan["split"]):
            acc = {j: torch.zeros(rb, -(-nw // 32) * 32) for j in (0, 1)}
            for k in range(inner // ch):
                cot = torch.empty(rb, 2 * ch)
                for j in (0, 1):
                    gcols = t_gf.gemm1_columns(k, j, inner)
                    hg = xb @ w1i[:, 64 * (2 * k + j):64 * (2 * k + j) + 64] + b1[gcols]
                    d = dyb @ w2[ch * k + 32 * j:ch * k + 32 * j + 32].T
                    u, du = t_gf.gelu_val_grad(hg[:, 32:], t_gf.GELU_FORM)
                    cot[:, 64 * j:64 * j + 32] = (d * u).to(x.dtype)
                    cot[:, 64 * j + 32:64 * j + 64] = (d * hg[:, :32] * du).to(x.dtype)
                for j in (0, 1):
                    first = (2 * half + j) * nw
                    for piece in range(-(-nw // 32)):
                        wrows = w1i_rows[first + 32 * piece:first + 32 * piece + 32,
                                         2 * ch * k:2 * ch * (k + 1)]
                        acc[j][:, 32 * piece:32 * piece + 32] += cot @ wrows.T
            for j in (0, 1):
                own = list(t_gf.dx_columns(c, half, j))
                dx[r0:r0 + n, own] = acc[j][:n, :nw]
    return dx


@pytest.mark.parametrize("form", ["tanh", "exact"])
@pytest.mark.parametrize("c", [192, 448])
def test_geglu_bwd_chunk_plan_gives_lvd_tpu(form, c, monkeypatch):
    """C = 192 (one block, 96 dx columns a warpgroup: three pieces) and 448
    (two blocks of 224 columns, 112 a warpgroup: the fourth piece half its
    own), inner 256 (four chunks), 150 rows (the last block ragged)."""
    monkeypatch.setattr(j_gf, "GELU_FORM", form)
    monkeypatch.setattr(t_gf, "GELU_FORM", form)
    r, inner = 150, 256
    rng = np.random.default_rng(29)
    x = rng.standard_normal((r, c)).astype(np.float32)
    dy = rng.standard_normal((r, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, 2 * inner)) * c ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(2 * inner)).astype(np.float32)
    w2 = (rng.standard_normal((inner, c)) * inner ** -0.5).astype(np.float32)
    got = _chunk_plan_geglu_bwd(*map(torch.from_numpy, (x, dy, w1, b1, w2))).numpy()
    args = tuple(map(jnp.asarray, (x, dy, w1, b1, w2)))
    _close(got, j_gf._fused_rows_bwd_resident(*args, block_m=64, nk=2, interpret=True))
    p = {"proj": {"w": torch.from_numpy(w1), "b": torch.from_numpy(b1)},
         "out": {"w": torch.from_numpy(w2), "b": torch.zeros(c)}}
    _close(got, t_gf.geglu_mlp_bwd_plain(p, torch.from_numpy(x), torch.from_numpy(dy)).numpy())


def _block_plan_pair_bwd(p, y, dy, heads, frames_major):
    """Kernel F's wgmma form in torch: per (batch, 64-row tile) the rows of
    ``block_rows`` (zero past the tile's pixels); every weight box and
    workspace tile is taken from ``bwd_stages`` in order (two 64 x 64 boxes
    a stage, zero past the matrices, K-major boxes read transposed). The
    forward: LN1, heads in pairs (warpgroup j: head 2 i + j, its k, v, q
    from its boxes), scores masked by ``key_mask``, outputs stored for heads
    < H, the output projection + bias + x0 = x1 on the valid rows, LN2, q/k/v
    of attention 2; q/k/v of both kept. Then attention 2's VJP with u = dy
    and attention 1's with u = dx1: per head dO, P, dV, dP, dL, dQ, dK; dz
    from the [dq | dk | dv] tiles in 64-column blocks per warpgroup; the
    LayerNorm VJP on the valid rows."""
    if frames_major:
        y, dy = y.transpose(1, 2), dy.transpose(1, 2)
    bsz, pdim, f, c = y.shape
    plan = t_ta.bwd_launch_plan(f, c, torch.bfloat16)
    assert plan["form"] == "wgmma" and plan["row_block"] == 64
    pairs = -(-heads // 2)
    mask = t_ta.key_mask(f)
    mats = {}
    for at in "12":
        pa = p["attn" + at]
        mats["wqkv" + at] = torch.cat([pa[n]["w"] for n in ("to_q", "to_k", "to_v")], dim=1)
        mats["wo" + at] = pa["to_out"]["w"]

    def box(m, col, row):
        out = torch.zeros(64, 64)
        sub = mats[m][row:row + 64, col:col + 64]
        out[:sub.shape[0], :sub.shape[1]] = sub
        return out

    def ln(x, norm, ok):
        mean = x.mean(-1, keepdim=True)
        rstd = torch.rsqrt(((x * x).mean(-1, keepdim=True) - mean * mean).clamp(min=0) + 1e-5)
        z = (x - mean) * rstd * norm["scale"] + norm["bias"]
        return torch.where(ok[:, None], z, torch.zeros(())), (x - mean) * rstd, rstd

    def probs(q, k):
        s_ = (q @ k.T) * 64 ** -0.5
        return torch.softmax(s_.masked_fill(~mask, float("-inf")), dim=-1)

    out = torch.full_like(y, float("nan"))
    for bi in range(bsz):
        for blk in range(-(-pdim // plan["pixels"])):
            pix, frame, ok = t_ta.block_rows(f, pdim, blk)
            rows = lambda t: torch.where(ok[:, None], t[bi, pix.clamp(max=pdim - 1), frame],
                                         torch.zeros(()))
            x0, u2 = rows(y), rows(dy)
            stream = iter(t_ta.bwd_stages(c))

            def gemm(a, k_major=False):  # the next C / 64 stages, each warpgroup's box
                acc = [torch.zeros(64, 64), torch.zeros(64, 64)]
                for kt in range(a.shape[1] // 64):
                    m, *boxes = next(stream)
                    for wg, (col, row) in enumerate(boxes):
                        w = box(m, col, row)
                        acc[wg] += a[:, 64 * kt:64 * kt + 64] @ (w.T if k_major else w)
                return acc

            def qkv_of(z):
                kept = {}
                for j in range(pairs):
                    k_, v_, q_ = gemm(z), gemm(z), gemm(z)
                    for wg in (0, 1):
                        kept[2 * j + wg] = (q_[wg], k_[wg], v_[wg])
                return kept

            z1, xhat1, rstd1 = ln(x0, p["norm1"], ok)
            qkv1 = qkv_of(z1)
            o = torch.zeros(64, c)
            for head in range(heads):
                q_, k_, v_ = qkv1[head]
                o[:, 64 * head:64 * head + 64] = probs(q_, k_) @ v_
            x1 = x0.clone()
            for i in range(pairs):
                acc = gemm(o)
                for wg in (0, 1):
                    cols = slice(64 * (2 * i + wg), 64 * (2 * i + wg) + 64)
                    if 2 * i + wg < heads:
                        x1[:, cols] = x0[:, cols] + acc[wg] + p["attn1"]["to_out"]["b"][cols]
            x1 = torch.where(ok[:, None], x1, torch.zeros(()))
            z2, xhat2, rstd2 = ln(x1, p["norm2"], ok)
            qkv2 = qkv_of(z2)

            def vjp(at, qkv, u):
                d = {}
                for j in range(pairs):
                    do_ = gemm(u, k_major=True)
                    for wg in (0, 1):
                        head = 2 * j + wg
                        if head >= heads:
                            continue
                        q_, k_, v_ = qkv[head]
                        pr = probs(q_, k_)
                        dp = do_[wg] @ v_.T
                        dl = (dp * pr - pr * (dp * pr).sum(-1, keepdim=True)) * 64 ** -0.5
                        d[0, head], d[1, head], d[2, head] = dl @ k_, dl.T @ q_, pr.T @ do_[wg]
                dqkv = torch.cat([d[m, head] for m in range(3) for head in range(heads)], dim=1)
                dz = torch.zeros(64, c)
                for i in range(pairs):
                    acc = [torch.zeros(64, 64), torch.zeros(64, 64)]
                    for kt in range(3 * heads):
                        assert next(stream) == ("dqkv" + at, kt)
                        m, *boxes = next(stream)
                        for wg, (col, row) in enumerate(boxes):
                            acc[wg] += dqkv[:, 64 * kt:64 * kt + 64] @ box(m, col, row).T
                    for wg in (0, 1):
                        if 2 * i + wg < heads:
                            dz[:, 64 * (2 * i + wg):64 * (2 * i + wg) + 64] = acc[wg]
                return dz

            def ln_vjp(dz, xhat, rstd, norm):
                g = dz * norm["scale"]
                return rstd * (g - g.mean(-1, keepdim=True)
                               - xhat * (g * xhat).mean(-1, keepdim=True))

            dx1 = u2 + ln_vjp(vjp("2", qkv2, u2), xhat2, rstd2, p["norm2"])
            dx1 = torch.where(ok[:, None], dx1, torch.zeros(()))
            dx0 = dx1 + ln_vjp(vjp("1", qkv1, dx1), xhat1, rstd1, p["norm1"])
            assert next(stream, None) is None  # the tile used up the stream exactly
            for r in torch.nonzero(ok).flatten().tolist():
                out[bi, pix[r], frame[r]] = dx0[r]
    return out.transpose(1, 2) if frames_major else out


@pytest.mark.parametrize("f,pdim,c,frames_major", [(5, 16, 128, True), (24, 5, 64, False)])
def test_pair_bwd_block_plan_gives_lvd_tpu(f, pdim, c, frames_major):
    """F = 5 frames-major: 12 pixels a tile, 16 pixels (the second tile
    four), two heads; F = 24 pixels-major: 2 pixels a tile, 5 pixels (the
    last tile one), one head (warpgroup 1's head past H)."""
    rng = np.random.default_rng(37)
    heads = c // 64
    p = _pair_params_np(rng, c)
    shape = (2, f, pdim, c) if frames_major else (2, pdim, f, c)
    y = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    tree = lambda fn: {k: {n: {m: fn(t) for m, t in w.items()} if isinstance(w, dict) else fn(w)
                           for n, w in v.items()} for k, v in p.items()}
    tp = tree(torch.from_numpy)
    got = _block_plan_pair_bwd(tp, torch.from_numpy(y), torch.from_numpy(dy), heads,
                               frames_major)
    g = j_ta._pick_g_bwd(pdim, c, frames_major)
    assert g > 0
    _close(got.numpy(), j_ta._pallas_pair_bwd(tree(jnp.asarray), jnp.asarray(y), jnp.asarray(dy),
                                              heads, g, 1e-5, frames_major=frames_major,
                                              interpret=True))
    _close(got.numpy(), t_ta.temporal_attention_pair_bwd_plain(
        tp, torch.from_numpy(y), torch.from_numpy(dy), heads, 1e-5, frames_major).numpy())


def _two_pass_geglu(x, w1, b1, w2, b2):
    """Kernel J's wgmma form in torch: tiles of ``row_block`` rows (rows
    past R zero); pass 1: x times each 128 columns of the interleaved W1
    (zero past C), the h and g chunks ``gated_chunks`` names for each of
    the tile's 64 gated columns, + b1, the gate, rounded to the stream's
    type into the (R, inner) gated tensor; pass 2: gated times each
    ``column_block`` columns of W2, + b2, columns past C not stored."""
    r, c = x.shape
    inner = w2.shape[0]
    plan = t_gf.stream_launch_plan(torch.bfloat16)
    rb, ch, cb = plan["row_block"], plan["inner_chunk"], plan["column_block"]
    w1i = t_gf.interleave_w1(w1, inner)
    gated = torch.empty(r, inner)
    for r0 in range(0, r, rb):
        n = min(rb, r - r0)
        xb = torch.zeros(rb, c)
        xb[:n] = x[r0:r0 + n]
        for n0 in range(0, 2 * inner, 2 * ch):
            acc = xb @ w1i[:, n0:n0 + 2 * ch]
            i0 = n0 // 2
            for q, (hc, gc) in enumerate(t_gf.gated_chunks()):
                cols = slice(i0 + 8 * q, i0 + 8 * q + 8)
                assert torch.equal(w1i[:, n0 + 8 * hc:n0 + 8 * hc + 8], w1[:, cols])
                assert torch.equal(w1i[:, n0 + 8 * gc:n0 + 8 * gc + 8],
                                   w1[:, inner + i0 + 8 * q:inner + i0 + 8 * q + 8])
                h = acc[:, 8 * hc:8 * hc + 8] + b1[cols]
                g = acc[:, 8 * gc:8 * gc + 8] + b1[inner + i0 + 8 * q:inner + i0 + 8 * q + 8]
                gated[r0:r0 + n, cols] = (h * t_gf._gelu(g)).to(x.dtype)[:n]
    out = torch.full_like(x, float("nan"))
    for r0 in range(0, r, rb):
        n = min(rb, r - r0)
        gb = torch.zeros(rb, inner)
        gb[:n] = gated[r0:r0 + n]
        for n0 in range(0, c, cb):
            out[r0:r0 + n, n0:n0 + cb] = (gb @ w2[:, n0:n0 + cb] + b2[n0:n0 + cb])[:n]
    return out


@pytest.mark.parametrize("form", ["tanh", "exact"])
@pytest.mark.parametrize("c", [72, 128])
def test_geglu_stream_two_pass_plan_gives_lvd_tpu(form, c, monkeypatch):
    """C = 72 (one 128-column output tile, 72 columns stored) and 128,
    inner 512 (eight gated tiles of 64), 300 rows (the last 128-row tile
    ragged)."""
    monkeypatch.setattr(j_gf, "GELU_FORM", form)
    monkeypatch.setattr(t_gf, "GELU_FORM", form)
    r, inner = 300, 512
    rng = np.random.default_rng(41)
    x = rng.standard_normal((r, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, 2 * inner)) * c ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(2 * inner)).astype(np.float32)
    w2 = (rng.standard_normal((inner, c)) * inner ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    got = _two_pass_geglu(*map(torch.from_numpy, (x, w1, b1, w2, b2))).numpy()
    args = tuple(map(jnp.asarray, (x, w1, b1, w2, b2)))
    _close(got, j_gf._fused_rows(*args, block_m=128, block_k=256, interpret=True))
    p = {"proj": {"w": torch.from_numpy(w1), "b": torch.from_numpy(b1)},
         "out": {"w": torch.from_numpy(w2), "b": torch.from_numpy(b2)}}
    _close(got, t_gf.geglu_stream_plain(p, torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("c", [64 * n for n in range(1, 11)])
def test_geglu_bwd_tf32_pieces_cover_dx_once(c):
    """Kernel G's fp32 wgmma form at every resident width: each of C's dx
    columns is written by exactly one (block, warpgroup, 16-column piece),
    the pieces of a warpgroup whole (no piece reaching past its columns),
    and a thread's fp32 accumulators (8 a piece) stay within the 80 that
    the bf16 form's 32-column pieces hold at C = 320."""
    plan = t_gf.bwd_launch_plan(c, 4 * c, torch.float32)
    assert plan["form"] == "wgmma" and plan["piece"] == 16 and plan["row_block"] == 64
    owner = {}
    for half in range(plan["split"]):
        for wg in (0, 1):
            pieces = t_gf.dx_pieces(c, half, wg, torch.float32)
            assert all(len(piece) == 16 for piece in pieces)
            assert len(pieces) * 8 <= 80
            for piece in pieces:
                for col in piece:
                    assert col not in owner
                    owner[col] = (half, wg)
    assert sorted(owner) == list(range(c))


def _chunk_plan_geglu_bwd_tf32(x, dy, w1, b1, w2, rounded=True):
    """Kernel G's fp32 wgmma form in torch: 64-row blocks (rows past R
    zero), ``split`` blocks on each; operands TF32-rounded (``tf32_round``)
    where ``rounded``. Per 64-wide inner chunk k: warpgroup j's [h | g] =
    x times rows 128 k + 64 j .. of W1i^T (K-major, 32-column K-tiles of
    C) + b1, d_inner = dy times rows 64 k + 32 j .. of W2 (its own K-tiles);
    the cotangent tile's four 32-column K-tiles [dh0 | dg0 | dh1 | dg1],
    rounded; then each warpgroup's ``dx_pieces`` += cot times its 16 rows
    of W1i over the chunk's 128 columns."""
    r, c = x.shape
    inner = w2.shape[0]
    plan = t_gf.bwd_launch_plan(c, inner, torch.float32)
    rb, ch = plan["row_block"], plan["inner_chunk"]
    rnd = t_gf.tf32_round if rounded else (lambda t: t)
    w1i = rnd(t_gf.interleave_w1(w1, inner))
    w1t, w2r = rnd(t_gf.interleave_w1(w1, inner).transpose(0, 1).contiguous()), rnd(w2)
    xr, dyr = rnd(x), rnd(dy)
    dx = torch.full_like(x, float("nan"))
    for r0 in range(0, r, rb):
        n = min(rb, r - r0)
        xb, dyb = torch.zeros(rb, c), torch.zeros(rb, c)
        xb[:n], dyb[:n] = xr[r0:r0 + n], dyr[r0:r0 + n]
        for half in range(plan["split"]):
            pieces = {j: t_gf.dx_pieces(c, half, j, torch.float32) for j in (0, 1)}
            acc = {j: torch.zeros(rb, 16 * len(pieces[j])) for j in (0, 1)}
            for k in range(inner // ch):
                cot = torch.empty(rb, 2 * ch)
                for j in (0, 1):
                    wt = w1t[128 * k + 64 * j:128 * k + 64 * j + 64]  # (64, C), K-major
                    wd = w2r[ch * k + 32 * j:ch * k + 32 * j + 32]    # (32, C), K-major
                    hg = sum(xb[:, kt:kt + 32] @ wt[:, kt:kt + 32].T for kt in range(0, c, 32))
                    hg = hg + b1[t_gf.gemm1_columns(k, j, inner)]
                    d = sum(dyb[:, kt:kt + 32] @ wd[:, kt:kt + 32].T for kt in range(0, c, 32))
                    u, du = t_gf.gelu_val_grad(hg[:, 32:], t_gf.GELU_FORM)
                    cot[:, 64 * j:64 * j + 32] = rnd(d * u)
                    cot[:, 64 * j + 32:64 * j + 64] = rnd(d * hg[:, :32] * du)
                for j in (0, 1):
                    for q, piece in enumerate(pieces[j]):
                        rows = w1i[piece.start:piece.stop, 2 * ch * k:2 * ch * (k + 1)]
                        acc[j][:, 16 * q:16 * q + 16] += sum(
                            cot[:, 32 * h:32 * h + 32] @ rows[:, 32 * h:32 * h + 32].T
                            for h in range(4))
            for j in (0, 1):
                for q, piece in enumerate(pieces[j]):
                    dx[r0:r0 + n, piece.start:piece.stop] = acc[j][:n, 16 * q:16 * q + 16]
    return dx


@pytest.mark.parametrize("form", ["tanh", "exact"])
@pytest.mark.parametrize("c", [192, 448])
def test_geglu_bwd_tf32_chunk_plan_gives_lvd_tpu(form, c, monkeypatch):
    """C = 192 (one block, 96 dx columns a warpgroup: six pieces) and 448
    (two blocks, 112 a warpgroup: seven pieces), inner 256 (four chunks),
    150 rows (the last block ragged): unrounded, lvd_tpu's interpreted
    resident dx kernel and the plain dx; TF32-rounded, within the fp32 gate
    (5e-3) of the plain dx."""
    monkeypatch.setattr(j_gf, "GELU_FORM", form)
    monkeypatch.setattr(t_gf, "GELU_FORM", form)
    r, inner = 150, 256
    rng = np.random.default_rng(43)
    x = rng.standard_normal((r, c)).astype(np.float32)
    dy = rng.standard_normal((r, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, 2 * inner)) * c ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(2 * inner)).astype(np.float32)
    w2 = (rng.standard_normal((inner, c)) * inner ** -0.5).astype(np.float32)
    args = tuple(map(torch.from_numpy, (x, dy, w1, b1, w2)))
    got = _chunk_plan_geglu_bwd_tf32(*args, rounded=False).numpy()
    _close(got, j_gf._fused_rows_bwd_resident(*map(jnp.asarray, (x, dy, w1, b1, w2)),
                                              block_m=64, nk=2, interpret=True))
    p = {"proj": {"w": args[2], "b": args[3]}, "out": {"w": args[4], "b": torch.zeros(c)}}
    plain = t_gf.geglu_mlp_bwd_plain(p, args[0], args[1]).numpy()
    _close(got, plain)
    tf32 = _chunk_plan_geglu_bwd_tf32(*args).numpy()
    err = np.abs(tf32 - plain).max() / np.abs(plain).max()
    assert 0 < err <= selfcheck.FP32_TOL


def test_tf32_round_is_round_to_nearest_ties_away():
    """The TF32 rounding the fp32 forms give their operands (on the CPU, the
    same bits as the kernels' cvt.rna.tf32.f32): 10 mantissa bits kept,
    round to nearest with ties away from zero, signs kept."""
    ulp = 2.0 ** -10
    t = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 4, -(1.0 + ulp / 2), 1.0 + 1.5 * ulp,
                      3.0e-3, 0.0])
    got = t_gf.tf32_round(t)
    assert got[:5].tolist() == [1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp]
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all()) and got[6].item() == 0.0
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


def _tf32_passes(c):
    """Kernel F's fp32 form's passes in launch order, as csrc/pair_bwd_tf32.cu's
    ``pair_bwd_tf32`` runs them on R rows of C (rows in the stream's order):
    ("ln", source, norm, out), ("gemm", A, B, N, K, out, epilogue) with out =
    A B^T for a B of N rows of K (the staged weights: "wqkv1t" is wqkv1^T
    (3C, C), "wo1" wo1 as stored (C, C), ...), ("attn", qkv, out), ("round",
    src, out), ("attn_vjp", qkv, dO) (dq, dk, dv over qkv) and ("ln_vjp",
    dz, x, stats, norm, resid, out, rounded copy or None)."""
    return [
        ("ln", "y", "norm1", "z", "stats1"),
        ("gemm", "z", "wqkv1t", 3 * c, c, "qkv1", None),
        ("attn", "qkv1", "o"),
        ("gemm", "o", "wo1t", c, c, "x1", ("bo1", "y")),
        ("ln", "x1", "norm2", "z", "stats2"),
        ("gemm", "z", "wqkv2t", 3 * c, c, "qkv2", None),
        ("round", "dy", "u"),
        ("gemm", "u", "wo2", c, c, "o", None),
        ("attn_vjp", "qkv2", "o"),
        ("gemm", "qkv2", "wqkv2", c, 3 * c, "dz", None),
        ("ln_vjp", "dz", "x1", "stats2", "norm2", "dy", "dx1", "u"),
        ("gemm", "u", "wo1", c, c, "o", None),
        ("attn_vjp", "qkv1", "o"),
        ("gemm", "qkv1", "wqkv1", c, 3 * c, "dz", None),
        ("ln_vjp", "dz", "y", "stats1", "norm1", "dx1", "dx", None),
    ]


def _tf32_fwd_passes(c):
    """Kernel B's fp32 form's passes in launch order, as csrc/pair_fwd_tf32.cu's
    ``pair_fwd_tf32`` runs them, in ``_tf32_passes``'s terms: per attention
    LN into z, [q | k | v] from z, the attention over z (o), and o Wo + bo +
    the residual into the output ("out"), attention 2's residual read from
    there and overwritten."""
    return [
        ("ln", "y", "norm1", "z", None),
        ("gemm", "z", "wqkv1t", 3 * c, c, "qkv", None),
        ("attn", "qkv", "z"),
        ("gemm", "z", "wo1t", c, c, "out", ("bo1", "y")),
        ("ln", "out", "norm2", "z", None),
        ("gemm", "z", "wqkv2t", 3 * c, c, "qkv", None),
        ("attn", "qkv", "z"),
        ("gemm", "z", "wo2t", c, c, "out", ("bo2", "out")),
    ]


def _gemm_width(n):
    """The shared GEMM's tile width (csrc/pair_tf32.cuh ``gemm_width``)."""
    return next(w for w in (192, 160, 128, 64) if n % w == 0)


def _tf32_gemm_tiles(m, n):
    """The output tiles of the fp32 forms' projections, (row0, col0, rows,
    cols), as their GEMM walks them: 128-row tiles (``launch_plan`` and
    ``bwd_launch_plan``'s row_block; the last ragged, rows past m never
    stored), each row tile's columns in tiles of the widest of 192, 160, 128
    and 64 that divides n."""
    rb = t_ta.bwd_launch_plan(24, 64, torch.float32)["row_block"]
    assert t_ta.launch_plan(24, 64, torch.float32)["row_block"] == rb
    bn = _gemm_width(n)
    return [(r0, c0, min(rb, m - r0), bn) for r0 in range(0, m, rb) for c0 in range(0, n, bn)]


def _pair_bwd_tf32_passes(p, y, dy, heads, frames_major, rounded=True):
    """Kernel F's fp32 wgmma form in torch: ``_tf32_passes``."""
    c = y.shape[-1]
    buf = _run_tf32_passes(_tf32_passes(c), p, y, dy, heads, frames_major, rounded)
    return buf["dx"].reshape(y.shape)


def _pair_fwd_tf32_passes(p, y, heads, frames_major, rounded=True):
    """Kernel B's fp32 wgmma form in torch: ``_tf32_fwd_passes``."""
    c = y.shape[-1]
    buf = _run_tf32_passes(_tf32_fwd_passes(c), p, y, None, heads, frames_major, rounded)
    return buf["out"].reshape(y.shape)


def _run_tf32_passes(passes, p, y, dy, heads, frames_major, rounded=True):
    """The fp32 wgmma forms in torch: ``passes`` run in order on named (R, .)
    buffers whose rows keep the stream's order; each projection tiled by
    ``_tf32_gemm_tiles`` (every output element written once) against the
    staged weights (wqkv, wo as stored or transposed); each attention step
    per (pixel, head) on the pixel's rows found through the stream's
    strides, in the kernels' 16-frame tiles (frames padded to
    ``tf32_frames``); operands TF32-rounded where ``rounded``. Returns the
    buffers by name, (R, .) each."""
    rnd = t_gf.tf32_round if rounded else (lambda t: t)
    shape = y.shape
    c = shape[-1]
    if frames_major:
        bsz, f, pdim, _ = shape
        strides = (f * pdim * c, pdim * c, c)
    else:
        bsz, pdim, f, _ = shape
        strides = (f * pdim * c, c, f * c)
    r = y.numel() // c
    buf = {"y": y.reshape(r, c)}
    if dy is not None:
        buf["dy"] = dy.reshape(r, c)
    for at in "12":
        pa = p["attn" + at]
        wqkv = torch.cat([pa[n]["w"] for n in ("to_q", "to_k", "to_v")], dim=1)
        wo = pa["to_out"]["w"]
        buf |= {f"wqkv{at}": rnd(wqkv), f"wqkv{at}t": rnd(wqkv.T.contiguous()),
                f"wo{at}": rnd(wo), f"wo{at}t": rnd(wo.T.contiguous()),
                f"bo{at}": pa["to_out"]["b"]}
    rows_of = lambda b, px: [(b * strides[0] + fr * strides[1] + px * strides[2]) // c
                             for fr in range(f)]
    scale = 64 ** -0.5
    for step in passes:
        kind = step[0]
        if kind == "ln":
            _, src, norm, out, stats = step
            x = buf[src]
            mean = x.mean(-1, keepdim=True)
            rstd = torch.rsqrt((x * x).mean(-1, keepdim=True) - mean * mean + 1e-5)
            buf[out] = rnd((x - mean) * rstd * p[norm]["scale"] + p[norm]["bias"])
            if stats is not None:
                buf[stats] = (mean, rstd)
        elif kind == "gemm":
            _, a, w, n_out, k, out, epi = step
            am, wm = buf[a], buf[w]
            assert am.shape == (r, k) and wm.shape == (n_out, k)
            res = torch.full((r, n_out), float("nan"))
            for r0, c0, nr, nc in _tf32_gemm_tiles(r, n_out):
                assert bool(res[r0:r0 + nr, c0:c0 + nc].isnan().all())
                res[r0:r0 + nr, c0:c0 + nc] = am[r0:r0 + nr] @ wm[c0:c0 + nc].T
            if epi is not None:
                res = res + buf[epi[0]] + buf[epi[1]]
            buf[out] = res
        elif kind == "round":
            buf[step[2]] = rnd(buf[step[1]])
        elif kind in ("attn", "attn_vjp"):
            # Per (pixel, head) pair, frames padded to fp = 16 k with zero rows
            # and the keys past f masked; each 16-frame tile of queries (then,
            # for dk and dv, of keys) written once, the padded rows never.
            qkv = buf[step[1]]
            fp = t_ta.tf32_frames(f)
            pad = lambda t: torch.cat([t, t.new_zeros(fp - f, t.shape[1])])
            live = torch.arange(fp) < f
            new = torch.full((r, c) if kind == "attn" else qkv.shape, float("nan"))

            def put(idx, col, g):
                for t0 in range(0, fp, 16):
                    rows = [i for i in range(t0, t0 + 16) if i < f]
                    sel = [idx[i] for i in rows]
                    assert bool(new[sel, col:col + 64].isnan().all())
                    new[sel, col:col + 64] = rnd(g[rows])

            for b in range(bsz):
                for px in range(pdim):
                    idx = rows_of(b, px)
                    for h in range(heads):
                        q, k_, v = (pad(rnd(qkv[idx, m * c + 64 * h:m * c + 64 * h + 64]))
                                    for m in range(3))
                        s_ = (q @ k_.T * scale).masked_fill(~live, float("-inf"))
                        pr = torch.softmax(s_, dim=-1)
                        if kind == "attn":
                            put(idx, 64 * h, rnd(pr) @ v)
                            continue
                        do = pad(rnd(buf[step[2]][idx, 64 * h:64 * h + 64]))
                        tmp = (do @ v.T) * pr
                        dl = rnd((tmp - pr * tmp.sum(-1, keepdim=True)) * scale)
                        pt = lambda t: t.masked_fill(~live[:, None], 0.0).T
                        for m, g in enumerate((dl @ k_, pt(dl) @ q, rnd(pt(pr)) @ do)):
                            put(idx, m * c + 64 * h, g)
            assert not bool(new.isnan().any())
            buf[step[1] if kind == "attn_vjp" else step[2]] = new
        else:
            _, dz, src, stats, norm, resid, out, out_round = step
            mean, rstd = buf[stats]
            xhat = (buf[src] - mean) * rstd
            g = buf[dz] * p[norm]["scale"]
            o = buf[resid] + rstd * (g - g.mean(-1, keepdim=True)
                                     - xhat * (g * xhat).mean(-1, keepdim=True))
            buf[out] = o
            if out_round is not None:
                buf[out_round] = rnd(o)
    return buf


@pytest.mark.parametrize("f,pdim,c,frames_major", [(5, 16, 128, True), (24, 5, 64, False)])
def test_pair_bwd_tf32_passes_give_lvd_tpu(f, pdim, c, frames_major):
    """Kernel F's fp32 passes at F = 5 and 24, 80 and 120 rows (ragged
    128-row projection tiles), H = 2 and 1, both layouts: unrounded,
    lvd_tpu's interpreted ``_pallas_pair_bwd`` and the plain dy; TF32-rounded,
    within the fp32 gate (5e-3) of the plain dy."""
    rng = np.random.default_rng(47)
    heads = c // 64
    p = _pair_params_np(rng, c)
    shape = (1, f, pdim, c) if frames_major else (1, pdim, f, c)
    y = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    tree = lambda fn: {k: {n: {m: fn(t) for m, t in w.items()} if isinstance(w, dict) else fn(w)
                           for n, w in v.items()} for k, v in p.items()}
    tp = tree(torch.from_numpy)
    ty, tdy = torch.from_numpy(y), torch.from_numpy(dy)
    got = _pair_bwd_tf32_passes(tp, ty, tdy, heads, frames_major, rounded=False).numpy()
    g = j_ta._pick_g_bwd(pdim, c, frames_major) or j_ta._pick_g_bwd(pdim, c)
    assert g > 0
    jy, jdy = jnp.asarray(y), jnp.asarray(dy)
    if frames_major and not j_ta._pick_g_bwd(pdim, c, True):
        jy, jdy = jnp.swapaxes(jy, 1, 2), jnp.swapaxes(jdy, 1, 2)
    ref = np.asarray(j_ta._pallas_pair_bwd(tree(jnp.asarray), jy, jdy, heads, g, 1e-5,
                                           frames_major=frames_major and bool(
                                               j_ta._pick_g_bwd(pdim, c, True)),
                                           interpret=True))
    if ref.shape != got.shape:
        ref = np.swapaxes(ref, 1, 2)
    _close(got, ref)
    plain = t_ta.temporal_attention_pair_bwd_plain(tp, ty, tdy, heads, 1e-5, frames_major).numpy()
    _close(got, plain)
    tf32 = _pair_bwd_tf32_passes(tp, ty, tdy, heads, frames_major).numpy()
    err = np.abs(tf32 - plain).max() / np.abs(plain).max()
    assert 0 < err <= selfcheck.FP32_TOL


def test_pair_bwd_tf32_gemm_tiles_cover_each_output_once():
    """The fp32 forms' projection tiles at the train step's L0 and L1 (69120
    and 17280 rows; N = C and 3C) and a ragged row count: 192-column tiles
    where N % 192 == 0 (N = 3C but at C = 256 and 512; 1920 at L1), else
    160 (N = 320 at L0, 640 at L1), else 128 or 64, each output element
    once."""
    assert [_gemm_width(n) for n in (960, 320, 1920, 640, 192, 512, 448)] == [
        192, 160, 192, 160, 192, 128, 64]
    for m, c in ((69120, 320), (17280, 640), (1080, 192)):
        for n in (c, 3 * c):
            tiles = _tf32_gemm_tiles(m, n)
            assert {nc for *_, nc in tiles} == {_gemm_width(n)}
            assert sum(nr * nc for _, _, nr, nc in tiles) == m * n
            assert len({(r0, c0) for r0, c0, _, _ in tiles}) == len(tiles)
            assert all(r0 % 128 == 0 and c0 % nc == 0 and r0 + nr <= m and c0 + nc <= n
                       for r0, c0, nr, nc in tiles)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pair_fwd_tf32_launch_plan(dtype):
    """Kernel B's launch plan: ``wgmma`` up to F = 64 in both types and the
    first version past it; in fp32 128-row projection tiles, one (pixel,
    head) pair a block's warp tile (``pixels`` = 1) and the attention's
    frames F rounded up to 16 (F = 1, 5, 16, 24, 64 -> 16, 16, 16, 32, 64)."""
    tdt = getattr(torch, dtype)
    for f, fp in ((1, 16), (5, 16), (16, 16), (24, 32), (64, 64)):
        plan = t_ta.launch_plan(f, 320, tdt)
        assert plan["form"] == "wgmma" and plan["code"] == t_ta.FORM_CODES["wgmma"]
        if dtype == "float32":
            assert (plan["row_block"], plan["pixels"], plan["frames"]) == (128, 1, fp)
        else:
            assert (plan["row_block"], plan["pixels"], plan["frames"]) == (64, 64 // f, f)
    for f in (65, 100):
        assert t_ta.launch_plan(f, 320, tdt)["form"] == "wmma"
        assert t_ta.launch_plan(f, 320, tdt)["frames"] == f
    assert t_ta.launch_plan(24, 320, tdt, "wmma")["form"] == "wmma"


@pytest.fixture(scope="module")
def pair_fwd_case():
    """(params, y, lvd_tpu's interpreted ``_pallas_pair`` on them) per case,
    computed once for the file's tests."""
    cache = {}

    def get(f, pdim, c, bsz, frames_major):
        key = (f, pdim, c, bsz, frames_major)
        if key not in cache:
            rng = np.random.default_rng(53)
            p = _pair_params_np(rng, c)
            shape = (bsz, f, pdim, c) if frames_major else (bsz, pdim, f, c)
            y = rng.standard_normal(shape).astype(np.float32)
            tree = lambda fn: {k: {n: {m: fn(t) for m, t in w.items()} if isinstance(w, dict)
                                   else fn(w) for n, w in v.items()} for k, v in p.items()}
            g = j_ta._pick_g(pdim, frames_major)
            assert g > 0
            ref = np.asarray(j_ta._pallas_pair(tree(jnp.asarray), jnp.asarray(y), c // 64, g,
                                               1e-5, frames_major=frames_major, interpret=True))
            cache[key] = (tree(torch.from_numpy), torch.from_numpy(y), ref)
        return cache[key]

    return get


PAIR_FWD_CASES = [(5, 16, 128, 2, True), (5, 16, 128, 2, False), (24, 5, 192, 1, True),
                  (24, 5, 192, 1, False)]


@pytest.mark.parametrize("f,pdim,c,bsz,frames_major", PAIR_FWD_CASES)
def test_pair_fwd_tf32_passes_give_lvd_tpu(pair_fwd_case, f, pdim, c, bsz, frames_major):
    """Kernel B's fp32 passes, unrounded, at F = 5 (160 rows: one whole and
    one ragged 128-row projection tile, two heads) and F = 24 (120 rows, a
    ragged tile, three heads), both layouts: lvd_tpu's interpreted
    ``_pallas_pair`` and the plain version, at 1e-5 of max|ref|."""
    tp, ty, ref = pair_fwd_case(f, pdim, c, bsz, frames_major)
    got = _pair_fwd_tf32_passes(tp, ty, c // 64, frames_major, rounded=False).numpy()
    _close(got, ref)
    _close(got, t_ta.temporal_attention_pair_plain(tp, ty, c // 64, 1e-5, frames_major).numpy())


@pytest.mark.parametrize("f,pdim,c,bsz,frames_major", PAIR_FWD_CASES[::3])
def test_pair_fwd_tf32_rounded_holds_the_fp32_gate(pair_fwd_case, f, pdim, c, bsz, frames_major):
    """Kernel B's fp32 passes with every product operand TF32-rounded: within
    the fp32 gate (5e-3) of lvd_tpu's interpreted kernel, and not equal to
    it (the rounding is there)."""
    tp, ty, ref = pair_fwd_case(f, pdim, c, bsz, frames_major)
    got = _pair_fwd_tf32_passes(tp, ty, c // 64, frames_major).numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert 0 < err <= selfcheck.FP32_TOL
