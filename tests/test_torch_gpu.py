"""The port's kernels on the card (marked ``gpu``; they skip without one).

On a machine with an NVIDIA Hopper GPU and nvcc (``--noconftest``: the
suite's conftest sets up JAX, which this file does not need):
    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu
The card is looked for inside a fixture, never at import time.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from lvd_tpu_torch.ops import _build

    _build.lib()
    return torch.device("cuda")


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("s_q,s_k,c", [(2880, 2880, 320), (720, 77, 640), (45, 45, 1280)])
def test_attention_kernel_matches_plain(cuda, s_q, s_k, c):
    from lvd_tpu_torch.ops import packed_attention as pa

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, s, c, generator=g, device=cuda).bfloat16() for s in (s_q, s_k, s_k))
    before = pa.attention_packed.launches
    out = pa.attention_packed(q, k, v, 0.125, c // 64)
    ref = pa.attention_packed_plain(q.float(), k.float(), v.float(), 0.125, c // 64)
    assert pa.attention_packed.launches == before + 1
    assert _rel(out, ref) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,c", [(2910, 320), (750, 640), (210, 1280), (75, 1280)])
def test_attention_ragged_keys_read_nothing_past_them(cuda, s, c, dtype):
    """Kernel A at the GLIGEN fuser's key counts (S visual + 30 grounding
    tokens: 2910 % 64 = 30, 750 % 64 = 46), K and V at the start of buffers
    whose next rows hold NaN: the last key tile of the last batch must not
    bring them into O."""
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, _nan_tailed, exact_fp32

    g = torch.Generator(device=cuda).manual_seed(14)
    q, k, v = (torch.randn(3, s, c, generator=g, device=cuda).to(dtype) for _ in range(3))
    k, v = _nan_tailed(k), _nan_tailed(v)
    tail = torch.as_strided(v, (64 * c,), (1,), v.storage_offset() + v.numel())
    assert torch.isnan(tail).all()
    before = pa.attention_packed.launches
    out = pa.attention_packed(q, k, v, 0.125, c // 64)
    with exact_fp32():
        ref = pa.attention_packed_plain(q.float(), k.float(), v.float(), 0.125, c // 64)
    assert pa.attention_packed.launches == before + 1
    assert torch.isfinite(out).all()
    assert _rel(out, ref) <= (2e-2 if dtype == torch.bfloat16 else FP32_TOL)


def test_kernels_take_fp32(cuda):
    """fp32 goes through the kernels (no plain path on the card), within
    the fp32 gate and closer to the fp32 plain version than bf16 gets."""
    from lvd_tpu_torch.ops import _build
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops.attention import attention
    from lvd_tpu_torch.ops.basic import feed_forward
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 300, 128, generator=g, device=cuda) for _ in range(3))
    before = pa.attention_packed.launches
    out = pa.attention_packed(q, k, v, 0.125, 2)
    low = pa.attention_packed(q.bfloat16(), k.bfloat16(), v.bfloat16(), 0.125, 2)
    with exact_fp32():
        ref = pa.attention_packed_plain(q, k, v, 0.125, 2)
    assert pa.attention_packed.launches == before + 2 and out.dtype == torch.float32
    assert _rel(out, ref) <= FP32_TOL and _rel(out, ref) < _rel(low, ref)
    # The routing takes fp32 to the kernels too.
    lin = lambda a, b: {"w": torch.randn(a, b, generator=g, device=cuda) * a ** -0.5,
                        "b": torch.zeros(b, device=cuda)}
    before = pa.attention_packed.launches
    attention({n: lin(128, 128) for n in ("to_q", "to_k", "to_v", "to_out")}, q, None, 2)
    assert pa.attention_packed.launches == before + 1
    from lvd_tpu_torch.ops import geglu_fused as gf

    before = gf.geglu_mlp.launches
    x = torch.randn(2048, 128, generator=g, device=cuda)
    feed_forward({"proj": lin(128, 1024), "out": lin(512, 128)}, x)
    assert gf.geglu_mlp.launches == before + 1
    # Any other type raises.
    with pytest.raises(TypeError):
        pa.attention_packed(q.half(), k.half(), v.half(), 0.125, 2)
    with pytest.raises(TypeError):
        _build.dtype_code(q.double(), "test")


def _form_launches(wrapper, before):
    return {k: n - before[k] for k, n in wrapper.launches_by_form.items() if n != before[k]}


@pytest.mark.parametrize("d", [64, 128, 192, 256, 320])
def test_sdpa_long_keys_launch_kernels_a_and_e(cuda, d):
    """D = 64 and 128 run their own forms, 192 and 256 the wide form of
    kernels A and E, 320 the D-sliced form."""
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops.attention import sdpa

    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(2, 3, 300, d, generator=g, device=cuda).bfloat16().requires_grad_(True)
               for _ in range(3))
    fwd, bwd = pa.attention_packed.launches, pa.attention_packed_bwd.launches
    forms = dict(pa.attention_packed.launches_by_form), dict(pa.attention_packed_bwd.launches_by_form)
    want = {64: "D64", 128: "D128", 192: "wide", 256: "wide", 320: "sliced"}[d]
    out, probs = sdpa(q, k, v)
    assert probs is None and pa.attention_packed.launches == fwd + 1
    ct = torch.randn(out.shape, generator=g, device=cuda)
    grads = torch.autograd.grad(out.float(), (q, k, v), ct)
    assert pa.attention_packed_bwd.launches == bwd + 1
    assert _form_launches(pa.attention_packed, forms[0]) == {want: 1}
    assert _form_launches(pa.attention_packed_bwd, forms[1]) == {want: 1}
    leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    flat = lambda t: t.reshape(6, 300, d)
    ref = pa.attention_packed_plain(*(flat(t) for t in leaves), d ** -0.5, 1).reshape(out.shape)
    assert _rel(out, ref) <= 2e-2
    for got, want in zip(grads, torch.autograd.grad(ref, leaves, ct)):
        assert _rel(got, want) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [300, 1024])
@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("d", [192, 256])
def test_wide_form_matches_plain(cuda, d, heads, s, dtype):
    """Kernels A and E in their wide form at D = 192 and 256, one and three
    heads (C = 576, 768), ragged (300) and whole (1024) tiles, forward and
    the gradients through autograd, against the plain versions on fp32
    copies (TF32 off): 2e-2 in bf16; in fp32 5e-3 and below the same
    shape's bf16 reading."""
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    g = torch.Generator(device=cuda).manual_seed(d + heads + s)
    c = heads * d
    q, k, v, do = (torch.randn(2, s, c, generator=g, device=cuda) for _ in range(4))
    with exact_fp32():
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = pa.attention_packed_plain(*leaves, d ** -0.5, heads)
        ref_g = torch.autograd.grad(ref, leaves, do)
    errs = {}
    for dt in (torch.bfloat16, dtype):
        forms = dict(pa.attention_packed.launches_by_form), dict(
            pa.attention_packed_bwd.launches_by_form)
        low = [t.to(dt).requires_grad_(True) for t in (q, k, v)]
        out = pa.attention_packed(*low, d ** -0.5, heads)
        grads = torch.autograd.grad(out, low, do.to(dt))
        assert _form_launches(pa.attention_packed, forms[0]) == {"wide": 1}
        assert _form_launches(pa.attention_packed_bwd, forms[1]) == {"wide": 1}
        assert torch.isfinite(out).all()
        errs[dt] = max([_rel(out, ref)] + [_rel(a, b) for a, b in zip(grads, ref_g)])
    print(f"wide form D={d} H={heads} S={s} {dtype}: {errs}")
    if dtype == torch.bfloat16:
        assert errs[dtype] <= 2e-2
    else:
        assert errs[dtype] <= FP32_TOL and errs[dtype] < errs[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s_k", [77, 300])
def test_wide_form_through_packed_attention(cuda, s_k, dtype):
    """The packed attention() at three heads of 192 (C = 576) over 77 text
    keys and 300 keys: kernel_ok holds, kernel A runs its wide form (and E
    through autograd), against the plain route on fp32 copies."""
    from lvd_tpu_torch.ops import attention as at
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    g = torch.Generator(device=cuda).manual_seed(s_k)
    lin = lambda a, b: {"w": torch.randn(a, b, generator=g, device=cuda) * a ** -0.5,
                        "b": 0.1 * torch.randn(b, generator=g, device=cuda)}
    p = {n: lin(576, 576) for n in ("to_q", "to_k", "to_v", "to_out")}
    x = torch.randn(2, 300, 576, generator=g, device=cuda)
    ctx = torch.randn(2, s_k, 576, generator=g, device=cuda)
    ct = torch.randn(2, 300, 576, generator=g, device=cuda)
    with exact_fp32():
        leaf = x.clone().requires_grad_(True)
        ref = at.attention(p, leaf, ctx, num_heads=3, return_probs=True)[0]
        (ref_dx,) = torch.autograd.grad(ref, leaf, ct)
    cast = lambda t: {n: {kk: vv.to(dtype) for kk, vv in w.items()} for n, w in t.items()}
    forms = dict(pa.attention_packed.launches_by_form), dict(pa.attention_packed_bwd.launches_by_form)
    xl = x.to(dtype).requires_grad_(True)
    out, probs = at.attention(cast(p), xl, ctx.to(dtype), num_heads=3)
    (dx,) = torch.autograd.grad(out, xl, ct.to(dtype))
    assert probs is None
    assert _form_launches(pa.attention_packed, forms[0]) == {"wide": 1}
    assert _form_launches(pa.attention_packed_bwd, forms[1]) == {"wide": 1}
    err = max(_rel(out, ref), _rel(dx, ref_dx))
    print(f"packed attention() C=576 S_k={s_k} {dtype}: {err:.3g}")
    assert err <= (2e-2 if dtype == torch.bfloat16 else FP32_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [192, 256])
def test_wide_and_sliced_forms_share_the_lse(cuda, d, dtype):
    """Both forms of kernel A write the same base-2 log-sum-exp (to
    rounding), and each form of kernel E takes the other form's: the crossed
    gradients read as the matched ones against the plain backward; the wide
    forms give bit-equal results run to run."""
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v, do = (torch.randn(2, 300, 3 * d, generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    scale = d ** -0.5
    fwd = {f: pa.attention_packed_with_lse(q, k, v, scale, 3, form=f) for f in ("wide", "sliced")}
    with exact_fp32():
        ref, ref_lse = pa.attention_packed_plain(q.float(), k.float(), v.float(), scale, 3,
                                                 return_lse=True)
        ref_g = pa.attention_packed_bwd_plain(q.float(), k.float(), v.float(),
                                              fwd["wide"][0].float(), do.float(), scale, 3)
    tol = 2e-2 if dtype == torch.bfloat16 else FP32_TOL
    for out, lse in fwd.values():
        assert _rel(out, ref) <= tol and _rel(lse, ref_lse) <= 1e-3
    assert _rel(fwd["wide"][1], fwd["sliced"][1]) <= 1e-3
    o = fwd["wide"][0]
    for bwd_form in ("wide", "sliced"):
        for lse_form in ("wide", "sliced"):
            grads = pa.attention_packed_bwd(q, k, v, o, do, scale, 3, lse=fwd[lse_form][1],
                                            form=bwd_form)
            errs = [_rel(a, b) for a, b in zip(grads, ref_g)]
            print(f"E {bwd_form} from A {lse_form}'s lse, D={d} {dtype}: {errs}")
            assert max(errs) <= tol
    again = pa.attention_packed_with_lse(q, k, v, scale, 3)
    assert torch.equal(again[0], fwd["wide"][0]) and torch.equal(again[1], fwd["wide"][1])
    first = pa.attention_packed_bwd(q, k, v, o, do, scale, 3, lse=fwd["wide"][1])
    second = pa.attention_packed_bwd(q, k, v, o, do, scale, 3, lse=fwd["wide"][1])
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _ff_params(c, inner, g, cuda):
    r = lambda *s, scale: torch.randn(*s, generator=g, device=cuda) * scale
    return {"proj": {"w": r(c, 2 * inner, scale=c ** -0.5), "b": r(2 * inner, scale=0.1)},
            "out": {"w": r(inner, c, scale=inner ** -0.5), "b": r(c, scale=0.1)}}


@pytest.mark.parametrize("form", ["tanh", "exact"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_geglu_stream_kernel_matches_plain(cuda, dtype, form, monkeypatch):
    """Kernel J at a ragged row count with a C that is not a multiple of 16
    (masked tails), and at C = 1280, against its plain version; then the
    public geglu_mlp at C = 1280, which launches J forward and takes the
    stock VJP for dx, as lvd_tpu does."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    monkeypatch.setattr(gf, "GELU_FORM", form)
    tol = 2e-2 if dtype == torch.bfloat16 else FP32_TOL
    g = torch.Generator(device=cuda).manual_seed(9)
    for rows, c, inner in [(300, 136, 512), (70, 1280, 5120)]:
        p = _ff_params(c, inner, g, cuda)
        x = torch.randn(rows, c, generator=g, device=cuda)
        before = gf.geglu_stream.launches
        out = gf.geglu_stream(cast_tree(p, dtype), x.to(dtype))
        assert gf.geglu_stream.launches == before + 1 and out.dtype == dtype
        with exact_fp32():
            assert _rel(out, gf.geglu_stream_plain(p, x)) <= tol
    x = torch.randn(2, 35, 1280, generator=g, device=cuda).to(dtype).requires_grad_(True)
    fwd, bwd = gf.geglu_stream.launches, gf.geglu_mlp_bwd.launches
    out = gf.geglu_mlp(cast_tree(p, dtype), x)
    ct = torch.randn(out.shape, generator=g, device=cuda)
    (dx,) = torch.autograd.grad(out.float(), x, ct)
    assert gf.geglu_stream.launches == fwd + 1 and gf.geglu_mlp_bwd.launches == bwd
    leaf = x.detach().float().requires_grad_(True)
    with exact_fp32():
        ref = gf.geglu_mlp_plain(p, leaf)
        (ref_dx,) = torch.autograd.grad(ref, leaf, ct)
    assert _rel(out, ref) <= tol and _rel(dx, ref_dx) <= tol


@pytest.mark.parametrize("c,inner", [(72, 256), (1280, 1024)])
def test_geglu_resident_width_launches_kernel_g(cuda, c, inner):
    """Widths lvd_tpu gives its resident dx kernel that kernel C's template
    does not cover (C = 72; C = 1280 with inner 1024 in bf16): J runs the
    forward and kernel G's general form the dx, within 2e-2 of the plain
    version on fp32 copies."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import geglu_fused as gf

    g = torch.Generator(device=cuda).manual_seed(10)
    p = _ff_params(c, inner, g, cuda)
    x = torch.randn(100, c, generator=g, device=cuda)
    dy = torch.randn(100, c, generator=g, device=cuda)
    assert gf.dx_route(c, inner, torch.bfloat16) == "G"
    leaf = x.bfloat16().requires_grad_(True)
    fwd, bwd = gf.geglu_stream.launches, gf.geglu_mlp_bwd.launches
    out = gf.geglu_mlp(cast_tree(p, torch.bfloat16), leaf)
    (dx,) = torch.autograd.grad(out, leaf, dy.bfloat16())
    assert gf.geglu_stream.launches == fwd + 1 and gf.geglu_mlp_bwd.launches == bwd + 1
    err = _rel(dx, gf.geglu_mlp_bwd_plain(p, x, dy))
    print(f"kernel G dx, C={c} inner={inner} bf16: max|d|/max|ref| {err:.3g}")  # shown under -s
    assert err <= 2e-2


@pytest.mark.parametrize("c,dtype", [(2816, torch.bfloat16), (2048, torch.float32),
                                     (2176, torch.float32)])
def test_geglu_stream_wide_widths(cuda, c, dtype):
    """Kernel J past one block's accumulator (2688 columns in bf16, 2048 in
    fp32) runs a grid over output-column slices, against its plain version
    on fp32 copies (2e-2 in bf16, the fp32 gate in fp32)."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    g = torch.Generator(device=cuda).manual_seed(11)
    p = _ff_params(c, 4 * c, g, cuda)
    x = torch.randn(40, c, generator=g, device=cuda)
    before = gf.geglu_stream.launches
    out = gf.geglu_stream(cast_tree(p, dtype), x.to(dtype))
    assert gf.geglu_stream.launches == before + 1 and out.dtype == dtype
    with exact_fp32():
        ref = gf.geglu_stream_plain(p, x)
    err = _rel(out, ref)
    print(f"kernel J, C={c} {dtype}: max|d|/max|ref| {err:.3g}")  # shown under -s
    assert err <= (2e-2 if dtype == torch.bfloat16 else FP32_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s_q,s_k", [(45, 77), (77, 77), (180, 180), (720, 720), (2880, 2880),
                                     (2880, 77)])
def test_attention_lse_and_backward_match_plain(cuda, dtype, s_q, s_k):
    """Kernel A's log-sum-exp against the plain version's (1e-3 of max|ref|)
    at ragged query counts against its 128-query tile, and kernel E from it
    against the plain backward on fp32 copies, dk/dv requested or not."""
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn(2, s, 128, generator=g, device=cuda) for s in (s_q, s_k, s_k))
    do = torch.randn(2, s_q, 128, generator=g, device=cuda)
    low = [t.to(dtype) for t in (q, k, v, do)]
    out, lse = pa.attention_packed_with_lse(*low[:3], 0.125, 2)
    with exact_fp32():
        ref, ref_lse = pa.attention_packed_plain(*(t.float() for t in low[:3]), 0.125, 2,
                                                 return_lse=True)
        ref_g = pa.attention_packed_bwd_plain(*(t.float() for t in low[:3]), out.float(),
                                              low[3].float(), 0.125, 2)
    tol = 2e-2 if dtype == torch.bfloat16 else FP32_TOL
    assert lse.shape == (4, s_q) and _rel(lse, ref_lse) <= 1e-3 and _rel(out, ref) <= tol
    before = pa.attention_packed_bwd.launches
    grads = pa.attention_packed_bwd(*low[:3], out, low[3], 0.125, 2, True, lse=lse)
    dq_only = pa.attention_packed_bwd(*low[:3], out, low[3], 0.125, 2, False, lse=lse)
    assert pa.attention_packed_bwd.launches == before + 2
    assert dq_only[1] is None and dq_only[2] is None and torch.equal(dq_only[0], grads[0])
    for got, want in zip(grads, ref_g):
        assert _rel(got, want) <= tol
    with pytest.raises(RuntimeError, match="log-sum-exp"):
        pa.attention_packed_bwd(*low[:3], out, low[3], 0.125, 2)


def test_attention_writes_lse_only_under_autograd(cuda):
    """The no-grad forward (the UNet's CFG forward) passes kernel A a null
    log-sum-exp pointer; a forward that autograd records asks for one."""
    from lvd_tpu_torch.ops import packed_attention as pa

    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = (torch.randn(2, 300, 128, generator=g, device=cuda).bfloat16().requires_grad_(True)
               for _ in range(3))
    launches, lse = pa.attention_packed.launches, pa.attention_packed.lse_launches
    with torch.no_grad():
        pa.attention_packed(q, k, v, 0.125, 2)
    pa.attention_packed(q.detach(), k.detach(), v.detach(), 0.125, 2)
    assert pa.attention_packed.launches == launches + 2
    assert pa.attention_packed.lse_launches == lse
    out = pa.attention_packed(q, k, v, 0.125, 2)
    assert pa.attention_packed.lse_launches == lse + 1
    torch.autograd.grad(out.float().sum(), (q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rows_12_13_14_match_plain(cuda, dtype):
    """Kernel I with and without its prologue (ragged H*W, a W that is not a
    power of 2) and kernel H with and without the transposed weight."""
    from lvd_tpu_torch.ops import conv3x3 as c3
    from lvd_tpu_torch.ops import linear_fused as lf
    from lvd_tpu_torch.ops import spatial_conv_fused as scf
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    tol = 2e-2 if dtype == torch.bfloat16 else FP32_TOL
    g = torch.Generator(device=cuda).manual_seed(8)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=cuda) * scale
    x, a, b = r(3, 5, 9, 136), 1 + r(3, 136, scale=0.1), r(3, 136, scale=0.1)
    w, bias = r(3, 3, 136, 72, scale=(9 * 136) ** -0.5), r(72, scale=0.1)
    before = scf.norm_silu_conv2d.launches
    out = scf.norm_silu_conv2d(x.to(dtype), a, b, w.to(dtype), bias.to(dtype))
    assert scf.norm_silu_conv2d.launches == before + 1
    with exact_fp32():
        ref = scf.norm_silu_conv2d_plain(x, a, b, w, bias)
    assert _rel(out, ref) <= tol
    x, w = r(2, 8, 12, 128), r(3, 3, 128, 64, scale=(9 * 128) ** -0.5)
    before = c3.conv3x3.launches
    out = c3.conv3x3(x.to(dtype), w.to(dtype))
    assert c3.conv3x3.launches == before + 1
    with exact_fp32():
        assert _rel(out, c3.conv3x3_plain(x, w)) <= tol
    x, w, bias = r(77 * 3, 256), r(256, 384, scale=256 ** -0.5), r(384, scale=0.1)
    before = lf.linear_rows.launches
    out = lf.linear_rows(x.to(dtype), w.to(dtype), bias.to(dtype))
    dx = lf.linear_rows(out, w.to(dtype), None, trans_w=True)
    assert lf.linear_rows.launches == before + 2
    with exact_fp32():
        ref = lf.linear_plain(x, w, bias)
        assert _rel(out, ref) <= tol
        assert _rel(dx, lf.linear_plain(out.float(), w.transpose(0, 1))) <= tol


def _by_form(counter, fn):
    """fn()'s result and the forms of kernel H or I it launched."""
    before = dict(counter.launches_by_form)
    out = fn()
    return out, {k: n - before[k] for k, n in counter.launches_by_form.items() if n != before[k]}


# Kernel H at every projection shape of the path (selfcheck.LINEAR_SHAPES),
# and the ragged 231-row case of test_rows_12_13_14_match_plain.
H_SHAPES = [(34560, 640, 640), (8640, 1280, 1280), (3696, 1024, 640), (3696, 1024, 1280),
            (231, 256, 384)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,c,n", H_SHAPES)
def test_linear_forms_match_plain(cuda, rows, c, n, dtype):
    """Kernel H's forward and its dx on W^T (read transposed) in its new
    form (wgmma in bf16, mma_sync in fp32) against linear_plain on fp32
    copies: 2e-2 in bf16, 5e-3 in fp32."""
    from lvd_tpu_torch.ops import linear_fused as lf
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    tol = 2e-2 if dtype == torch.bfloat16 else FP32_TOL
    form = "wgmma" if dtype == torch.bfloat16 else "mma_sync"
    g = torch.Generator(device=cuda).manual_seed(9)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=cuda) * scale
    x, w, bias, dy = r(rows, c), r(c, n, scale=c ** -0.5), r(n, scale=0.1), r(rows, n)
    out, forms = _by_form(lf.linear_rows, lambda: lf.linear_rows(x.to(dtype), w.to(dtype),
                                                                 bias.to(dtype)))
    assert forms == {form: 1}
    dx, forms = _by_form(lf.linear_rows, lambda: lf.linear_rows(dy.to(dtype), w.to(dtype), None,
                                                                trans_w=True))
    assert forms == {form: 1}
    with exact_fp32():
        assert _rel(out, lf.linear_plain(x, w, bias)) <= tol
        assert _rel(dx, lf.linear_plain(dy, w.transpose(0, 1))) <= tol


# Kernel I: (N, H, W, Cin, Cout).
I_SHAPES = [
    (3, 5, 9, 64, 64),        # 45-pixel frames: every 128-pixel tile spans frames
    (4, 5, 9, 128, 128),
    (2, 8, 72, 64, 128),      # W = 72: a 274-row window in two TMA boxes
    (48, 20, 36, 1280, 640),  # L1 at full width
    (3, 5, 9, 136, 72),       # Cin, Cout % 64 != 0: the WMMA form
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("shape", I_SHAPES)
def test_conv_forms_match_plain(cuda, shape, prologue, dtype):
    """Kernel I with and without its prologue in the form launch_plan
    names (the halo-window form for Cin, Cout % 64 == 0, else WMMA)
    against the plain version on fp32 copies: 2e-2 in bf16, 5e-3 in fp32."""
    from lvd_tpu_torch.ops import conv3x3 as c3
    from lvd_tpu_torch.ops import spatial_conv_fused as scf
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    n, h, wd, cin, cout = shape
    tol = 2e-2 if dtype == torch.bfloat16 else FP32_TOL
    form = c3.launch_plan(wd, cin, cout, dtype)["form"]
    assert (form == "wmma") == bool(cin % 64 or cout % 64)
    g = torch.Generator(device=cuda).manual_seed(10)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=cuda) * scale
    x, w = r(n, h, wd, cin), r(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    if prologue:
        a, b, bias = 1 + r(n, cin, scale=0.1), r(n, cin, scale=0.1), r(cout, scale=0.1)
        out, forms = _by_form(scf.norm_silu_conv2d, lambda: scf.norm_silu_conv2d(
            x.to(dtype), a, b, w.to(dtype), bias.to(dtype)))
        with exact_fp32():
            ref = scf.norm_silu_conv2d_plain(x, a, b, w, bias)
    else:
        out, forms = _by_form(c3.conv3x3, lambda: c3._launch(x.to(dtype), w.to(dtype)))
        with exact_fp32():
            ref = c3.conv3x3_plain(x, w)
    assert forms == {form: 1}
    err = _rel(out, ref)
    print(f"kernel I {shape} prologue={prologue} {dtype} {form}: {err:.3g}")
    assert err <= tol


def test_selfcheck_passes(cuda):
    from lvd_tpu_torch.ops import selfcheck

    records = selfcheck.run(emit=lambda line: None)
    assert all(r["ok"] for r in records), [r for r in records if not r["ok"]]


def _pair_params(c, g, cuda):
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    lin = lambda bias: {"w": r(c, c) * c ** -0.5, **({"b": r(c) * 0.1} if bias else {})}
    attn = lambda: {"to_q": lin(False), "to_k": lin(False), "to_v": lin(False), "to_out": lin(True)}
    norm = lambda: {"scale": 1 + 0.1 * r(c), "bias": 0.1 * r(c)}
    return {"norm1": norm(), "attn1": attn(), "norm2": norm(), "attn2": attn()}


@pytest.mark.parametrize("frames_major", [True, False])
def test_temporal_pair_kernel_ragged_pixels_both_layouts(cuda, frames_major):
    """45 pixels leave a ragged last pixel group; both stream layouts, the
    kernel launched directly (lvd_tpu's frames-major route takes no P = 45)."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import temporal_attention as ta

    g = torch.Generator(device=cuda).manual_seed(1)
    p = _pair_params(320, g, cuda)
    shape = (2, 24, 45, 320) if frames_major else (2, 45, 24, 320)
    y = torch.randn(shape, generator=g, device=cuda)
    before = ta.temporal_attention_pair.launches_by_form["wgmma"]
    with torch.no_grad():
        out = ta._launch_forward(cast_tree(p, torch.bfloat16), y.bfloat16(), 5, 1e-5,
                                 frames_major)
    assert ta.temporal_attention_pair.launches_by_form["wgmma"] == before + 1
    ref = (ta._pair_ref_fm if frames_major else ta._pair_ref)(p, y, 5, 1e-5)
    assert _rel(out, ref) <= 4.5e-2


def test_geglu_kernel_exact_gelu_form(cuda, monkeypatch):
    from lvd_tpu_torch.ops import geglu_fused as gf

    monkeypatch.setattr(gf, "GELU_FORM", "exact")
    g = torch.Generator(device=cuda).manual_seed(2)
    c, inner = 128, 512
    p = {"proj": {"w": torch.randn(c, 2 * inner, generator=g, device=cuda) * c ** -0.5,
                  "b": torch.randn(2 * inner, generator=g, device=cuda) * 0.1},
         "out": {"w": torch.randn(inner, c, generator=g, device=cuda) * inner ** -0.5,
                 "b": torch.randn(c, generator=g, device=cuda) * 0.1}}
    x = torch.randn(1000, c, generator=g, device=cuda)
    out = gf.geglu_mlp(p, x.bfloat16())
    ref = gf._unfused(x, p["proj"]["w"], p["proj"]["b"], p["out"]["w"], p["out"]["b"])
    assert _rel(out, ref) <= 2e-2


def _grads(out, inputs, ct):
    return torch.autograd.grad(out.float(), inputs, ct)


def _wrapper_case(name, g, cuda):
    """(wrapper call, plain call, inputs) for one forward kernel; the inputs
    are fp32 leaves, the wrapper gets bf16 copies (fp32 for GroupNorm's a, b)."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops import temp_conv_fused as tc
    from lvd_tpu_torch.ops import temporal_attention as ta

    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=cuda) * scale
    if name == "attention_packed":
        ins = [r(2, 300, 128) for _ in range(3)]
        return (lambda q, k, v: pa.attention_packed(q, k, v, 0.125, 2),
                lambda q, k, v: pa.attention_packed_plain(q, k, v, 0.125, 2), ins, 2e-2)
    if name == "temporal_attention_pair":
        p = _pair_params(320, g, cuda)
        pb = cast_tree(p, torch.bfloat16)
        return (lambda y: ta.temporal_attention_pair(pb, y, 5, 1e-5, frames_major=True),
                lambda y: ta._pair_ref_fm(p, y, 5, 1e-5), [r(1, 24, 48, 320)], 4.5e-2)
    if name == "geglu_mlp":
        c, inner = 128, 512
        p = {"proj": {"w": r(c, 2 * inner, scale=c ** -0.5), "b": r(2 * inner, scale=0.1)},
             "out": {"w": r(inner, c, scale=inner ** -0.5), "b": r(c, scale=0.1)}}
        pb = cast_tree(p, torch.bfloat16)
        return (lambda x: gf.geglu_mlp(pb, x), lambda x: gf.geglu_mlp_plain(p, x),
                [r(2048, c)], 2e-2)
    c = 128
    w = r(3, 1, 1, c, c, scale=(3 * c) ** -0.5)
    bias = r(c, scale=0.1)
    return (lambda x, a, b: tc.norm_silu_temporal_conv(x, a, b, w.bfloat16(), bias.bfloat16()),
            lambda x, a, b: tc.norm_silu_temporal_conv_plain(x, a, b, w, bias),
            [r(2, 24, 45, c), 1 + r(2, c, scale=0.1), r(2, c, scale=0.1)], 2e-2)


@pytest.mark.parametrize("name", ["attention_packed", "temporal_attention_pair", "geglu_mlp",
                                  "norm_silu_temporal_conv"])
def test_wrapper_gradients_match_plain_autograd(cuda, name):
    """On the card the gradient through each kernel wrapper (forward kernel,
    backward kernel or stock VJP) equals the plain version's autograd
    gradient; a wrapper whose output left the graph fails here."""
    g = torch.Generator(device=cuda).manual_seed(5)
    kernel, plain, ins, tol = _wrapper_case(name, g, cuda)
    low = [t.to(torch.float32 if t.dim() == 2 and name == "norm_silu_temporal_conv"
                else torch.bfloat16).requires_grad_(True) for t in ins]
    leaves = [t.clone().requires_grad_(True) for t in ins]
    out = kernel(*low)
    ref = plain(*leaves)
    ct = torch.randn(ref.shape, generator=g, device=cuda)
    for got, want in zip(_grads(out, low, ct), _grads(ref, leaves, ct)):
        assert _rel(got, want) <= tol


def test_backward_kernels_refuse_inputs_that_require_grad(cuda):
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops import temporal_attention as ta

    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(1, 24, 8, 128, generator=g, device=cuda).bfloat16().requires_grad_(True)
    q = x[0]
    with pytest.raises(RuntimeError, match="autograd.Function"):
        pa.attention_packed_bwd(q, q, q, q, q, 0.125, 2)
    with pytest.raises(RuntimeError, match="autograd.Function"):
        pa._launch_forward(q, q, q, 0.125, 2, False)
    p = cast_tree(_pair_params(128, g, cuda), torch.bfloat16)
    with pytest.raises(RuntimeError, match="autograd.Function"):
        ta.temporal_attention_pair_bwd(p, x, x, 2, 1e-5, frames_major=True)
    ff = {"proj": {"w": torch.zeros(128, 1024, device=cuda), "b": torch.zeros(1024, device=cuda)},
          "out": {"w": torch.zeros(512, 128, device=cuda), "b": torch.zeros(128, device=cuda)}}
    with pytest.raises(RuntimeError, match="autograd.Function"):
        gf.geglu_mlp_bwd(ff, x, x)


def _weight_grad_case(name, layout, dtype, g, cuda):
    """(wrapper on params of ``dtype`` that require grad, the plain version
    on their fp32 copies, the fp32 params, the input, the counters of the
    forward and dx kernels)."""
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops import temporal_attention as ta

    if name == "pair":
        fm = layout == "frames_major"
        p = _pair_params(320, g, cuda)
        x = torch.randn((1, 24, 48, 320) if fm else (1, 48, 24, 320), generator=g, device=cuda)
        return (lambda pp, y: ta.temporal_attention_pair(pp, y, 5, 1e-5, frames_major=fm),
                lambda pp, y: (ta._pair_ref_fm if fm else ta._pair_ref)(pp, y, 5, 1e-5), p, x,
                (ta.temporal_attention_pair, ta.temporal_attention_pair_bwd))
    p = _ff_params(128, 512, g, cuda)
    return (gf.geglu_mlp, gf.geglu_mlp_plain, p, torch.randn(2048, 128, generator=g, device=cuda),
            (gf.geglu_mlp, gf.geglu_mlp_bwd))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,layout", [("pair", "frames_major"), ("pair", "pixels_major"),
                                         ("geglu", "tanh"), ("geglu", "exact")])
def test_weight_gradients_through_b_and_c_match_plain(cuda, name, layout, dtype, monkeypatch):
    """With every param requiring grad, kernel B or C still runs the forward
    and kernel F or G dx, once each; the weight and bias gradients (the
    stock VJP of the plain formulation, recomputed, as lvd_tpu's custom
    VJPs give them) and dx match the plain version's autograd on fp32
    copies: bf16 within the forward's gate, fp32 within the fp32 gate."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32
    from lvd_tpu_torch.utils.tree import flatten, unflatten_like

    if name == "geglu":
        monkeypatch.setattr(gf, "GELU_FORM", layout)
    g = torch.Generator(device=cuda).manual_seed(8)
    kernel, plain, p, x, (fwd, bwd) = _weight_grad_case(name, layout, dtype, g, cuda)
    low = cast_tree(p, dtype)
    leaves = [t.requires_grad_(True) for t in flatten(low).values()]
    ref_flat = {path: t.clone().requires_grad_(True) for path, t in flatten(p).items()}
    ref_leaves, ref_p = list(ref_flat.values()), unflatten_like(p, ref_flat)
    x_low = x.to(dtype).requires_grad_(True)
    x_ref = x.clone().requires_grad_(True)
    before = (fwd.launches, bwd.launches)
    out = kernel(low, x_low)
    ct = torch.randn(out.shape, generator=g, device=cuda)
    got = _grads(out, [x_low, *leaves], ct)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    with exact_fp32():
        want = _grads(plain(ref_p, x_ref), [x_ref, *ref_leaves], ct)
    tol = FP32_TOL if dtype == torch.float32 else (4.5e-2 if name == "pair" else 2e-2)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert _rel(a, b) <= tol, (i, _rel(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gelu", ["tanh", "exact"])
@pytest.mark.parametrize("c", [64, 320, 512, 576, 640])
def test_geglu_forms_match_plain(cuda, c, gelu, dtype, monkeypatch):
    """The public geglu_mlp at kernel C's widths (inner = 4C, 2085 ragged
    rows) in the form launch_plan names (wgmma in bf16, mma_sync in fp32;
    fp32 C >= 512 is lvd_tpu's streaming route, kernel J), forward and dx
    through autograd, against the plain version on fp32 copies: 2e-2 in
    bf16, 5e-3 in fp32 and below the bf16 reading."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    monkeypatch.setattr(gf, "GELU_FORM", gelu)
    g = torch.Generator(device=cuda).manual_seed(11)
    p = _ff_params(c, 4 * c, g, cuda)
    x = torch.randn(2085, c, generator=g, device=cuda)
    dy = torch.randn(2085, c, generator=g, device=cuda)
    with exact_fp32():
        leaf = x.clone().requires_grad_(True)
        ref = gf.geglu_mlp_plain(p, leaf)
        (ref_dx,) = torch.autograd.grad(ref, leaf, dy)
    errs = {}
    for dt in (torch.bfloat16, dtype):
        route = gf.forward_kernel(c, 4 * c, dt)
        before = dict(gf.geglu_mlp.launches_by_form), gf.geglu_stream.launches
        xl = x.to(dt).requires_grad_(True)
        out = gf.geglu_mlp(cast_tree(p, dt), xl)
        (dx,) = torch.autograd.grad(out, xl, dy.to(dt))
        forms = {k: n - before[0][k] for k, n in gf.geglu_mlp.launches_by_form.items()
                 if n != before[0][k]}
        if route == "C":
            assert forms == {gf.launch_plan(c, dt)["form"]: 1}
        else:
            assert forms == {} and gf.geglu_stream.launches == before[1] + 1
        errs[dt] = max(_rel(out, ref), _rel(dx, ref_dx))
    print(f"geglu C={c} {gelu} {dtype}: {errs}")
    if dtype == torch.bfloat16:
        assert errs[dtype] <= 2e-2
    else:
        assert errs[dtype] <= FP32_TOL and errs[dtype] < errs[torch.bfloat16]


@pytest.mark.parametrize("kernel", ["C", "D", "B", "G", "F", "J", "A", "E", "K", "L", "M"])
def test_kernels_refuse_a_plan_they_were_not_built_for(cuda, kernel, monkeypatch):
    """Kernels B, C, D, F, G and J check the wrapper's launch plan: C's and
    G's split (1 at C = 320, 2 at 640) and rows a block, D's m64 tiles,
    window rows and first frame, B's and F's rows and pixels a block (and
    form), B's attention frames and workspace bytes, J's rows, inner chunk
    and column block (and form), B's, F's and G's in bf16 and in fp32
    (their TF32 forms); A and E their form code (a code they do not know,
    another head dim's form, the wide form past D = 256), in both types;
    each changed value is refused, and the plan as given launches. K and L
    their vector width, slabs, row lanes, chunk rows and form code, M its
    form code, in bf16, fp16 and fp32."""
    if kernel in ("K", "L", "M"):
        return _refuse_norm_plans(kernel, cuda, monkeypatch)
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops import temp_conv_fused as tc
    from lvd_tpu_torch.ops import temporal_attention as ta

    g = torch.Generator(device=cuda).manual_seed(12)
    if kernel in ("A", "E"):
        plan = pa.launch_plan
        with torch.no_grad():
            for d in (64, 192, 256, 320):
                for dt in (torch.bfloat16, torch.float32):
                    q = torch.randn(1, 300, 2 * d, generator=g, device=cuda).to(dt)
                    if kernel == "A":
                        run = lambda q=q: pa.attention_packed_with_lse(q, q, q, 0.1, 2)
                    else:
                        o, lse = pa.attention_packed_with_lse(q, q, q, 0.1, 2)
                        run = lambda q=q, o=o, lse=lse: pa.attention_packed_bwd(
                            q, q, q, o, q, 0.1, 2, lse=lse)
                    run()  # the plan as given
                    own = plan(d)["code"]
                    for code in {7, -1, 1 if d != 64 else 2, 3 if d not in (192, 256) else 1}:
                        assert code != own and code != 0
                        monkeypatch.setattr(pa, "launch_plan",
                                            lambda *a, c=code: {**plan(*a), "code": c})
                        with pytest.raises(RuntimeError, match="launch failed"):
                            run()
                        monkeypatch.setattr(pa, "launch_plan", plan)
        return
    if kernel in ("B", "G", "F", "J"):
        cases = []
        if kernel == "F":
            mod, name = ta, "bwd_launch_plan"
            changes = [("pixels", 1), ("pixels", 3), ("row_block", 48), ("code", 0)]
            for c in (320, 640):
                for dt in (torch.bfloat16, torch.float32):  # fp32: the TF32 passes
                    p = cast_tree(_pair_params(c, g, cuda), dt)
                    y = torch.randn(1, 24, 16, c, generator=g, device=cuda).to(dt)
                    cases.append((lambda p=p, y=y, c=c: ta.temporal_attention_pair_bwd(
                        p, y, y, c // 64, 1e-5, True), (24, c, dt)))
        elif kernel == "J":
            mod, name = gf, "stream_launch_plan"
            changes = [("row_block", 64), ("row_block", 16), ("inner_chunk", 128),
                       ("column_block", 64), ("code", 0)]
            p = cast_tree(_ff_params(1280, 5120, g, cuda), torch.bfloat16)
            x = torch.randn(300, 1280, generator=g, device=cuda).bfloat16()
            cases.append((lambda: gf.geglu_stream(p, x), (torch.bfloat16,)))
        elif kernel == "B":
            mod, name = ta, "launch_plan"
            changes = [("pixels", 1), ("pixels", 3), ("row_block", 48), ("code", 2),
                       ("frames", 48)]
            for c in (320, 640):
                for dt in (torch.bfloat16, torch.float32):  # fp32: the TF32 passes
                    p = cast_tree(_pair_params(c, g, cuda), dt)
                    y = torch.randn(1, 24, 16, c, generator=g, device=cuda).to(dt)
                    cases.append((lambda p=p, y=y, c=c: ta._launch_forward(p, y, c // 64, 1e-5,
                                                                           True), (24, c, dt)))
        else:
            mod, name = gf, "bwd_launch_plan"
            changes = [("split", 2), ("split", 1), ("row_block", 32), ("inner_chunk", 128)]
            for c in (320, 640):
                for dt in (torch.bfloat16, torch.float32):  # fp32: the TF32 form
                    p = cast_tree(_ff_params(c, 4 * c, g, cuda), dt)
                    x = torch.randn(300, c, generator=g, device=cuda).to(dt)
                    cases.append((lambda p=p, x=x: gf.geglu_mlp_bwd(p, x, x), (c, 4 * c, dt)))
        plan = getattr(mod, name)
        with torch.no_grad():
            for run, args in cases:
                run()  # the plan as given
                for key, value in changes:
                    if plan(*args)[key] == value:
                        continue
                    monkeypatch.setattr(mod, name,
                                        lambda *a, k=key, v=value: {**plan(*a), k: v})
                    with pytest.raises(RuntimeError, match="launch failed"):
                        run()
                    monkeypatch.setattr(mod, name, plan)
        return
    if kernel == "C":
        mod, changes = gf, [("split", 2), ("split", 1), ("row_block", 32), ("inner_chunk", 128)]
        cases = []
        for c in (320, 640):
            p = cast_tree(_ff_params(c, 4 * c, g, cuda), torch.bfloat16)
            x = torch.randn(300, c, generator=g, device=cuda).bfloat16()
            cases.append((lambda p=p, x=x: gf._launch_forward(p, x), c))
    else:
        mod, changes = tc, [("m_tiles", 4), ("window_rows", 200), ("start_frame", 0),
                            ("pixel_tile", 16), ("frame_group", 12), ("frame_groups", 2)]
        x = torch.randn(1, 24, 13, 64, generator=g, device=cuda).bfloat16()
        a, b = torch.ones(1, 64, device=cuda), torch.zeros(1, 64, device=cuda)
        w = torch.randn(3, 64, 64, generator=g, device=cuda).bfloat16()
        bias = torch.zeros(64, device=cuda).bfloat16()
        cases = [(lambda: tc._launch_forward(x, a, b, w, bias), 24)]
    plan = mod.launch_plan
    with torch.no_grad():
        for run, n in cases:
            run()  # the plan as given
            for key, value in changes:
                if plan(n, torch.bfloat16)[key] == value:
                    continue
                monkeypatch.setattr(mod, "launch_plan",
                                    lambda *args, k=key, v=value: {**plan(*args), k: v})
                with pytest.raises(RuntimeError, match="launch failed"):
                    run()
                monkeypatch.setattr(mod, "launch_plan", plan)


def _refuse_norm_plans(kernel, cuda, monkeypatch):
    from lvd_tpu_torch.ops import norms

    g = torch.Generator(device=cuda).manual_seed(35)
    forms = {"K": "STATS_FORMS", "L": "APPLY_FORMS", "M": "LN_FORMS"}[kernel]
    # M takes no plan: one warp a row, the kernel's own rows a block.
    changes = [] if kernel == "M" else [("vec", 4), ("vec", 8), ("slabs", 2),
                                        ("slab_vecs", 64), ("row_lanes", 3), ("chunk_rows", 100)]
    plan, codes = norms.launch_plan, getattr(norms, forms)
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            for c in (320, 3072):
                x = torch.randn(2, 300, c, generator=g, device=cuda).to(dt)
                s, a = torch.ones(c, device=cuda), torch.ones(2, c, device=cuda)
                run = {"K": lambda: norms.group_norm_stats(x, s, s, 32, 1e-5, 300 * c // 32),
                       "L": lambda: norms.group_norm_apply(x, a, a, True),
                       "M": lambda: norms.layer_norm_rows(x[0], s, s, 1e-5)}[kernel]
                run()  # the plan as given
                own = plan(c, dt)
                for key, value in changes:
                    if own[key] == value:
                        continue
                    monkeypatch.setattr(norms, "launch_plan", lambda *args, k=key, v=value: {
                        **plan(*args), k: v})
                    with pytest.raises(RuntimeError, match="launch failed"):
                        run()
                    monkeypatch.setattr(norms, "launch_plan", plan)
                monkeypatch.setattr(norms, forms, dict.fromkeys(codes, 3))
                with pytest.raises(RuntimeError, match="launch failed"):
                    run()
                monkeypatch.setattr(norms, forms, codes)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [64, 320, 1280])
@pytest.mark.parametrize("p", [13, 45, 2880])
@pytest.mark.parametrize("f", [5, 16, 24, 32])
def test_temp_conv_forms_match_plain(cuda, f, p, c, dtype):
    """Kernel D in the form launch_plan names (wgmma in bf16, mma_sync in
    fp32) at frame counts whose 8 F rows fill 1, 2, 3 and 4 m64 tiles,
    ragged pixel counts, and narrow to wide channels, forward and the
    gradients through autograd, against the plain version on fp32 copies:
    2e-2 in bf16, 5e-3 in fp32."""
    from lvd_tpu_torch.ops import temp_conv_fused as tc
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    tol = 2e-2 if dtype == torch.bfloat16 else FP32_TOL
    g = torch.Generator(device=cuda).manual_seed(13)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=cuda) * scale
    x, a, b = r(2, f, p, c), 1 + r(2, c, scale=0.1), r(2, c, scale=0.1)
    w, bias = r(3, 1, 1, c, c, scale=(3 * c) ** -0.5), r(c, scale=0.1)
    dy = r(2, f, p, c)
    before = dict(tc.norm_silu_temporal_conv.launches_by_form)
    xl = x.to(dtype).requires_grad_(True)
    out = tc.norm_silu_temporal_conv(xl, a, b, w.to(dtype), bias.to(dtype))
    (dx,) = torch.autograd.grad(out, xl, dy.to(dtype))
    forms = {k: n - before[k] for k, n in tc.norm_silu_temporal_conv.launches_by_form.items()
             if n != before[k]}
    assert forms == {tc.launch_plan(f, dtype)["form"]: 1}
    with exact_fp32():
        leaf = x.clone().requires_grad_(True)
        ref = tc.norm_silu_temporal_conv_plain(leaf, a, b, w, bias)
        (ref_dx,) = torch.autograd.grad(ref, leaf, dy)
    err = max(_rel(out, ref), _rel(dx, ref_dx))
    print(f"kernel D F={f} P={p} C={c} {dtype}: {err:.3g}")
    assert err <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("f,p,c", [(33, 45, 320), (48, 45, 640), (64, 45, 320), (100, 13, 320), (24, 45, 72),
                                   (200, 16, 72), (24, 13, 520), (40, 2880, 320)])
def test_temp_conv_frame_groups_and_narrow_channels_match_plain(cuda, f, p, c, dtype):
    """Kernel D where lvd_tpu routes its kernel past F = 32 (two to seven
    frame groups) and at C % 64 != 0 (C = 72, 520: a last channel chunk
    zero past C, columns past C not stored), both forms, forward and dx
    through autograd, against the plain version on fp32 copies: 2e-2 in
    bf16, 5e-3 in fp32."""
    from lvd_tpu_torch.ops import temp_conv_fused as tc
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    tol = 2e-2 if dtype == torch.bfloat16 else FP32_TOL
    g = torch.Generator(device=cuda).manual_seed(31)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=cuda) * scale
    x, a, b = r(2, f, p, c), 1 + r(2, c, scale=0.1), r(2, c, scale=0.1)
    w, bias = r(3, 1, 1, c, c, scale=(3 * c) ** -0.5), r(c, scale=0.1)
    dy = r(2, f, p, c)
    assert tc.supported(x.to(dtype))
    before = dict(tc.norm_silu_temporal_conv.launches_by_form)
    xl = x.to(dtype).requires_grad_(True)
    out = tc.norm_silu_temporal_conv(xl, a, b, w.to(dtype), bias.to(dtype))
    (dx,) = torch.autograd.grad(out, xl, dy.to(dtype))
    forms = {k: n - before[k] for k, n in tc.norm_silu_temporal_conv.launches_by_form.items()
             if n != before[k]}
    assert forms == {tc.launch_plan(f, dtype)["form"]: 1}
    with exact_fp32():
        leaf = x.clone().requires_grad_(True)
        ref = tc.norm_silu_temporal_conv_plain(leaf, a, b, w, bias)
        (ref_dx,) = torch.autograd.grad(ref, leaf, dy)
    err = max(_rel(out, ref), _rel(dx, ref_dx))
    print(f"kernel D F={f} P={p} C={c} {dtype}: {err:.3g}")
    assert torch.isfinite(out).all() and err <= tol


@pytest.mark.parametrize("c,inner", [(384, 1536), (448, 256), (640, 256)])
def test_geglu_fp32_forms_match_plain(cuda, c, inner):
    """Kernel C in fp32 at its widest mma_sync width (C = 384) and at widths
    lvd_tpu's route gives it only with a small inner dimension, which keep
    the WMMA form, against the plain version in fp32 with TF32 off (5e-3)."""
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    assert gf.forward_kernel(c, inner, torch.float32) == "C"
    g = torch.Generator(device=cuda).manual_seed(14)
    p = _ff_params(c, inner, g, cuda)
    x = torch.randn(2085, c, generator=g, device=cuda)
    before = dict(gf.geglu_mlp.launches_by_form)
    with torch.no_grad():
        out = gf.geglu_mlp(p, x)
    forms = {k: n - before[k] for k, n in gf.geglu_mlp.launches_by_form.items() if n != before[k]}
    assert forms == {gf.launch_plan(c, torch.float32)["form"]: 1}
    with exact_fp32():
        assert _rel(out, gf.geglu_mlp_plain(p, x)) <= FP32_TOL


@pytest.mark.parametrize("f,p,c,frames_major", [
    (24, 2880, 320, True), (24, 2880, 512, True), (24, 720, 640, True), (24, 45, 640, False),
    (5, 45, 128, False), (16, 33, 192, True), (64, 7, 320, False)])
def test_pair_wgmma_form_matches_plain(cuda, f, p, c, frames_major):
    """Kernel B's wgmma form at the selfcheck's shapes and at F = 5, 16 and
    64 (12, 4 and 1 pixels a block), ragged pixel counts, both layouts and
    an odd head count, launched directly, against the plain version on fp32
    copies: lvd_tpu's pair gate, 4.5e-2. The first version runs on the same
    inputs for comparison."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import temporal_attention as ta
    from lvd_tpu_torch.ops.selfcheck import exact_fp32

    g = torch.Generator(device=cuda).manual_seed(21)
    params = _pair_params(c, g, cuda)
    shape = (1, f, p, c) if frames_major else (1, p, f, c)
    y = torch.randn(shape, generator=g, device=cuda)
    pb, yb = cast_tree(params, torch.bfloat16), y.bfloat16()
    before = dict(ta.temporal_attention_pair.launches_by_form)
    with torch.no_grad():
        out = ta._launch_forward(pb, yb, c // 64, 1e-5, frames_major)
        first = ta._launch_forward(pb, yb, c // 64, 1e-5, frames_major, "wmma")
        with exact_fp32():
            ref = (ta._pair_ref_fm if frames_major else ta._pair_ref)(params, y, c // 64, 1e-5)
    after = ta.temporal_attention_pair.launches_by_form
    assert {k: after[k] - before[k] for k in after} == {"wgmma": 1, "wmma": 1}
    err, err_first = _rel(out, ref), _rel(first, ref)
    print(f"kernel B F={f} P={p} C={c} fm={frames_major}: wgmma {err:.3g}, wmma {err_first:.3g}")
    assert torch.isfinite(out).all() and err <= 4.5e-2


@pytest.mark.parametrize("f,p,c,frames_major", [
    (24, 2880, 320, True), (24, 2880, 512, True), (24, 720, 640, True), (24, 45, 640, False),
    (24, 45, 320, True), (5, 45, 128, False), (16, 33, 192, True), (64, 7, 320, False)])
def test_pair_bwd_wgmma_form_matches_plain(cuda, f, p, c, frames_major):
    """Kernel F's wgmma form at the selfcheck's shapes, at ragged pixel
    counts in both layouts, at F = 5, 16 and 64 (12, 4 and 1 pixels a
    64-row tile) and odd head counts (C = 320, 192), launched directly,
    against the plain dy on fp32 copies: lvd_tpu's pair gate, 4.5e-2. The
    first version runs on the same inputs for comparison."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import temporal_attention as ta
    from lvd_tpu_torch.ops.selfcheck import exact_fp32

    g = torch.Generator(device=cuda).manual_seed(23)
    params = _pair_params(c, g, cuda)
    shape = (1, f, p, c) if frames_major else (1, p, f, c)
    y = torch.randn(shape, generator=g, device=cuda)
    dy = torch.randn(shape, generator=g, device=cuda)
    pb, yb, dyb = cast_tree(params, torch.bfloat16), y.bfloat16(), dy.bfloat16()
    before = dict(ta.temporal_attention_pair_bwd.launches_by_form)
    with torch.no_grad():
        out = ta.temporal_attention_pair_bwd(pb, yb, dyb, c // 64, 1e-5, frames_major)
        first = ta.temporal_attention_pair_bwd(pb, yb, dyb, c // 64, 1e-5, frames_major, "wmma")
        with exact_fp32():
            ref = ta.temporal_attention_pair_bwd_plain(params, y, dy, c // 64, 1e-5,
                                                        frames_major)
    after = ta.temporal_attention_pair_bwd.launches_by_form
    assert {k: after[k] - before[k] for k in after} == {"wgmma": 1, "wmma": 1}
    err, err_first = _rel(out, ref), _rel(first, ref)
    print(f"kernel F F={f} P={p} C={c} fm={frames_major}: wgmma {err:.3g}, wmma {err_first:.3g}")
    assert torch.isfinite(out).all() and err <= 4.5e-2


@pytest.mark.parametrize("gelu", ["tanh", "exact"])
@pytest.mark.parametrize("rows,c", [(1000, 1280), (4320, 1280), (2085, 640), (70, 2816),
                                    (300, 136)])
def test_geglu_stream_wgmma_form_matches_plain(cuda, rows, c, gelu, monkeypatch):
    """Kernel J's wgmma form at every GEGLU_STREAM_SHAPES width (C = 1280
    and 640), at C2's widths past the first version's one block (2816) and
    at a C that is not a multiple of the 128-column tile (136), ragged row
    counts, inner = 4C, against the plain version on fp32 copies: 2e-2. The
    first version runs on the same inputs for comparison."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops.selfcheck import exact_fp32

    monkeypatch.setattr(gf, "GELU_FORM", gelu)
    g = torch.Generator(device=cuda).manual_seed(24)
    inner = 4 * c if c % 64 == 0 else 512
    p = _ff_params(c, inner, g, cuda)
    x = torch.randn(rows, c, generator=g, device=cuda)
    pb = cast_tree(p, torch.bfloat16)
    before = dict(gf.geglu_stream.launches_by_form)
    with torch.no_grad():
        out = gf.geglu_stream(pb, x.bfloat16())
        first = gf.geglu_stream(pb, x.bfloat16(), form="wmma")
        with exact_fp32():
            ref = gf.geglu_stream_plain(p, x)
    after = gf.geglu_stream.launches_by_form
    assert {k: after[k] - before[k] for k in after} == {"wgmma": 1, "wmma": 1}
    err, err_first = _rel(out, ref), _rel(first, ref)
    print(f"kernel J rows={rows} C={c} {gelu}: wgmma {err:.3g}, wmma {err_first:.3g}")
    assert torch.isfinite(out).all() and err <= 2e-2


@pytest.mark.parametrize("gelu", ["tanh", "exact"])
@pytest.mark.parametrize("c", [64, 192, 320, 448, 512, 576, 640])
def test_geglu_bwd_wgmma_form_matches_plain(cuda, c, gelu, monkeypatch):
    """Kernel G's wgmma form at every resident width kind (one block or two
    on a row tile, 32-column pieces that divide a warpgroup's columns or
    reach past them), inner = 4C, 2085 ragged rows, against the plain dx on
    fp32 copies: 2e-2. The first version runs on the same inputs."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops.selfcheck import exact_fp32

    monkeypatch.setattr(gf, "GELU_FORM", gelu)
    g = torch.Generator(device=cuda).manual_seed(22)
    p = _ff_params(c, 4 * c, g, cuda)
    x = torch.randn(2085, c, generator=g, device=cuda)
    dy = torch.randn(2085, c, generator=g, device=cuda)
    pb = cast_tree(p, torch.bfloat16)
    before = dict(gf.geglu_mlp_bwd.launches_by_form)
    with torch.no_grad():
        dx = gf.geglu_mlp_bwd(pb, x.bfloat16(), dy.bfloat16())
        first = gf.geglu_mlp_bwd(pb, x.bfloat16(), dy.bfloat16(), form="wmma")
        with exact_fp32():
            ref = gf.geglu_mlp_bwd_plain(p, x, dy)
    after = gf.geglu_mlp_bwd.launches_by_form
    assert {k: after[k] - before[k] for k in after} == {"wgmma": 1, "wmma": 1, "general": 0}
    err, err_first = _rel(dx, ref), _rel(first, ref)
    print(f"kernel G C={c} {gelu}: wgmma {err:.3g}, wmma {err_first:.3g}")
    assert torch.isfinite(dx).all() and err <= 2e-2


@pytest.mark.parametrize("gelu", ["tanh", "exact"])
@pytest.mark.parametrize("rows,c", [(69083, 320), (17251, 640), (2085, 64), (2085, 384),
                                    (2085, 448)])
def test_geglu_bwd_tf32_form_matches_plain(cuda, rows, c, gelu, monkeypatch):
    """Kernel G's fp32 wgmma form (TF32) at the train step's L0 and L1
    widths with a ragged last 64-row block, at one block a row tile (C = 64)
    and two (384, 448: 96 and 112 dx columns a warpgroup, six and seven
    16-column pieces), inner = 4C, against the plain dx in fp32 with TF32
    off: the fp32 gate, 5e-3. The first version runs on the same inputs."""
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    monkeypatch.setattr(gf, "GELU_FORM", gelu)
    g = torch.Generator(device=cuda).manual_seed(31)
    p = _ff_params(c, 4 * c, g, cuda)
    x = torch.randn(rows, c, generator=g, device=cuda)
    dy = torch.randn(rows, c, generator=g, device=cuda)
    before = dict(gf.geglu_mlp_bwd.launches_by_form)
    with torch.no_grad():
        dx = gf.geglu_mlp_bwd(p, x, dy)
        first = gf.geglu_mlp_bwd(p, x, dy, form="wmma")
        with exact_fp32():
            ref = gf.geglu_mlp_bwd_plain(p, x, dy)
    after = gf.geglu_mlp_bwd.launches_by_form
    assert {k: after[k] - before[k] for k in after} == {"wgmma": 1, "wmma": 1, "general": 0}
    err, err_first = _rel(dx, ref), _rel(first, ref)
    print(f"kernel G fp32 rows={rows} C={c} {gelu}: wgmma {err:.3g}, wmma {err_first:.3g}")
    assert dx.dtype == torch.float32 and torch.isfinite(dx).all() and err <= FP32_TOL


@pytest.mark.parametrize("f,p,c,frames_major", [
    (24, 2880, 320, True), (24, 720, 640, True), (24, 45, 320, False), (24, 45, 640, False),
    (5, 45, 128, True), (64, 7, 192, False), (40, 9, 192, True), (13, 7, 192, False)])
def test_pair_bwd_tf32_form_matches_plain(cuda, f, p, c, frames_major):
    """Kernel F's fp32 wgmma form (TF32 projections between its row and
    attention passes) at the train step's L0 and L1 shapes, at ragged row
    counts (1080 rows: the last 128-row tile of 56) in both layouts, at
    F = 5, 13, 40 and 64 (the attention's frames padded to 16, 16, 48 and
    64, 4, 4, 1 and 1 (pixel, head) pairs a block, the last block ragged at
    F = 13) and an odd head count, against the plain dy in fp32 with
    TF32 off: the fp32 gate, 5e-3. The first version runs on the same
    inputs where it has a tile (not at F = 64 in fp32)."""
    from lvd_tpu_torch.ops import temporal_attention as ta
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    g = torch.Generator(device=cuda).manual_seed(32)
    params = _pair_params(c, g, cuda)
    shape = (1, f, p, c) if frames_major else (1, p, f, c)
    y = torch.randn(shape, generator=g, device=cuda)
    dy = torch.randn(shape, generator=g, device=cuda)
    has_first = ta._wmma_bwd_tile(f, c, 4)[0] > 0  # fp32 F = 64 fits no first-version tile
    before = dict(ta.temporal_attention_pair_bwd.launches_by_form)
    with torch.no_grad():
        out = ta.temporal_attention_pair_bwd(params, y, dy, c // 64, 1e-5, frames_major)
        if has_first:
            first = ta.temporal_attention_pair_bwd(params, y, dy, c // 64, 1e-5, frames_major,
                                                   "wmma")
        with exact_fp32():
            ref = ta.temporal_attention_pair_bwd_plain(params, y, dy, c // 64, 1e-5,
                                                        frames_major)
    after = ta.temporal_attention_pair_bwd.launches_by_form
    assert {k: after[k] - before[k] for k in after} == {"wgmma": 1, "wmma": int(has_first)}
    err = _rel(out, ref)
    err_first = f"{_rel(first, ref):.3g}" if has_first else "no tile"
    print(f"kernel F fp32 F={f} P={p} C={c} fm={frames_major}: wgmma {err:.3g}, "
          f"wmma {err_first}")
    assert out.dtype == torch.float32 and torch.isfinite(out).all() and err <= FP32_TOL


@pytest.mark.parametrize("c", [64 * h for h in range(1, 11)])
def test_pair_tf32_form_matches_plain(cuda, c):
    """Kernel B's fp32 wgmma form (TF32 projections between its LayerNorm and
    attention passes) at H = C / 64 heads, F = 1, 5, 16, 24 and 64 (the
    attention's frames padded to 16, 16, 16, 32 and 64, the keys past F
    masked) on 45 pixels (45 F rows: every last 128-row projection tile
    ragged), both layouts, against the plain version in fp32 with TF32 off:
    the fp32 gate, 5e-3. Launched directly, once a case, bit-equal when run
    again on the same inputs. The first version runs beside it where it
    has a tile."""
    from lvd_tpu_torch.ops import temporal_attention as ta
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    g = torch.Generator(device=cuda).manual_seed(41)
    params = _pair_params(c, g, cuda)
    for f in (1, 5, 16, 24, 64):
        for frames_major in (True, False):
            shape = (1, f, 45, c) if frames_major else (1, 45, f, c)
            y = torch.randn(shape, generator=g, device=cuda)
            before = dict(ta.temporal_attention_pair.launches_by_form)
            with torch.no_grad():
                out = ta._launch_forward(params, y, c // 64, 1e-5, frames_major)
                again = ta._launch_forward(params, y, c // 64, 1e-5, frames_major)
                with exact_fp32():
                    ref = (ta._pair_ref_fm if frames_major else ta._pair_ref)(params, y, c // 64,
                                                                              1e-5)
            after = ta.temporal_attention_pair.launches_by_form
            assert {k: after[k] - before[k] for k in after} == {"wgmma": 2, "wmma": 0}
            err = _rel(out, ref)
            print(f"kernel B fp32 F={f} C={c} fm={frames_major}: wgmma {err:.3g}")
            assert out.dtype == torch.float32 and torch.isfinite(out).all()
            assert err <= FP32_TOL, (f, frames_major, err)
            assert torch.equal(out, again)


@pytest.mark.parametrize("shape,frames_major", [((2, 24, 2880, 320), True),
                                                ((1, 24, 720, 640), True),
                                                ((1, 45, 24, 320), False)])
def test_pair_tf32_form_takes_a_strided_stream(cuda, shape, frames_major):
    """Kernel B's fp32 form through the public wrapper on a stream that is a
    strided view (every other channel block of a wider tensor, made
    contiguous by the wrapper), at the selfcheck's batch-2 L0 shape (69120 x
    2 rows), the train step's L1 and a pixels-major ragged one, against the
    plain version in fp32 with TF32 off: 5e-3; the first version on the same
    inputs reads within the same gate."""
    from lvd_tpu_torch.ops import temporal_attention as ta
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    g = torch.Generator(device=cuda).manual_seed(42)
    c = shape[-1]
    params = _pair_params(c, g, cuda)
    wide = torch.randn(*shape[:-1], 2 * c, generator=g, device=cuda)
    y = wide[..., c:]
    assert not y.is_contiguous()
    before = dict(ta.temporal_attention_pair.launches_by_form)
    with torch.no_grad():
        out = ta.temporal_attention_pair(params, y, c // 64, 1e-5, frames_major)
        first = ta._launch_forward(params, y, c // 64, 1e-5, frames_major, "wmma")
        with exact_fp32():
            ref = ta.temporal_attention_pair_plain(params, y, c // 64, 1e-5, frames_major)
    after = ta.temporal_attention_pair.launches_by_form
    assert {k: after[k] - before[k] for k in after} == {"wgmma": 1, "wmma": 1}
    err, err_first = _rel(out, ref), _rel(first, ref)
    print(f"kernel B fp32 {shape} fm={frames_major}: wgmma {err:.3g}, wmma {err_first:.3g}")
    assert out.shape == y.shape and torch.isfinite(out).all() and err <= FP32_TOL


def test_pair_tf32_workspace_bytes(cuda):
    """Kernel B's workspace, as the library sizes it: in the fp32 wgmma form
    z-or-o (R x C) and q/k/v (R x 3C) fp32 and the four weights staged
    (8 C^2), each buffer a whole number of 256-byte pieces; none in bf16 or
    in the first version (nor in a form the entry refuses); -1 for a shape
    the fp32 wgmma form does not take."""
    from lvd_tpu_torch.ops import _build

    size = _build.lib().lvd_temporal_pair_workspace
    codes = _build.DTYPE_CODES
    rows = 1 * 24 * 2880  # (1, 24, 2880, 320): 354 MB of rows, 3.3 MB of weights
    assert size(1, 24, 2880, 320, 1, codes[torch.float32]) == 357171200
    assert size(1, 24, 2880, 320, 1, codes[torch.float32]) == 4 * (4 * rows * 320 + 8 * 320 ** 2)
    # five rows at C = 64: z-or-o 320 fp32, q/k/v 960, the weights 3, 3, 1 and 1 x 4096
    assert size(1, 5, 1, 64, 1, codes[torch.float32]) == 4 * (320 + 960 + 8 * 4096)
    for form, dt in ((1, torch.bfloat16), (0, torch.float32), (0, torch.bfloat16)):
        assert size(1, 24, 2880, 320, form, codes[dt]) == 0
    assert size(1, 65, 10, 320, 1, codes[torch.float32]) == -1
    assert size(1, 24, 10, 704, 1, codes[torch.float32]) == -1
    assert size(1, 24, 10, 320, 2, codes[torch.float32]) == 0


@pytest.mark.parametrize("shape", [(2, 8, 2880, 320), (2, 24, 720, 640)])
def test_pair_tf32_forms_do_not_depend_on_the_batch(cuda, shape):
    """B's and F's fp32 forms give a sample the same bits alone and beside
    another (every pass works row by row or pixel by pixel): a rank of a
    data-parallel mesh computes what the unsharded step computes for its
    rows. Check (d)'s shape (8 frames) and the train step's L1."""
    from lvd_tpu_torch.ops import temporal_attention as ta

    g = torch.Generator(device=cuda).manual_seed(44)
    c = shape[-1]
    p = _pair_params(c, g, cuda)
    y, dy = (torch.randn(shape, generator=g, device=cuda) for _ in range(2))
    with torch.no_grad():
        for run in (lambda yy, dd: ta._launch_forward(p, yy, c // 64, 1e-5, True),
                    lambda yy, dd: ta.temporal_attention_pair_bwd(p, yy, dd, c // 64, 1e-5,
                                                                  True)):
            assert torch.equal(run(y, dy)[:1], run(y[:1].contiguous(), dy[:1].contiguous()))


@pytest.mark.parametrize("shape,frames_major", [((1, 24, 2880, 320), True),
                                                ((1, 45, 24, 640), False)])
def test_pair_tf32_function_gradients_match_plain(cuda, shape, frames_major):
    """The temporal pair's autograd Function in fp32 with every param
    requiring grad: B's fp32 wgmma form runs the forward and F's the dy,
    once each and no first version; the output, dy and every weight and bias
    gradient (the stock VJP of the plain pair, recomputed) against the plain
    route's autograd in fp32 with TF32 off: 1e-3."""
    from lvd_tpu_torch.ops import temporal_attention as ta
    from lvd_tpu_torch.ops.plain import plain_route
    from lvd_tpu_torch.ops.selfcheck import exact_fp32
    from lvd_tpu_torch.utils.tree import flatten, unflatten_like

    g = torch.Generator(device=cuda).manual_seed(43)
    c = shape[-1]
    p = _pair_params(c, g, cuda)
    x = torch.randn(shape, generator=g, device=cuda)
    leaves = {path: t.clone().requires_grad_(True) for path, t in flatten(p).items()}
    ref_leaves = {path: t.clone().requires_grad_(True) for path, t in flatten(p).items()}
    x_k, x_r = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    fwd, bwd = ta.temporal_attention_pair, ta.temporal_attention_pair_bwd
    before = dict(fwd.launches_by_form), dict(bwd.launches_by_form)
    out = ta.temporal_attention_pair(unflatten_like(p, leaves), x_k, c // 64, 1e-5, frames_major)
    ct = torch.randn(out.shape, generator=g, device=cuda)
    got = _grads(out, [x_k, *leaves.values()], ct)
    for fn, was in zip((fwd, bwd), before):
        assert {k: fn.launches_by_form[k] - was[k] for k in ta.FORMS} == {"wgmma": 1, "wmma": 0}
    with exact_fp32(), plain_route():
        ref = ta.temporal_attention_pair(unflatten_like(p, ref_leaves), x_r, c // 64, 1e-5,
                                         frames_major)
        want = _grads(ref, [x_r, *ref_leaves.values()], ct)
    assert _rel(out, ref) <= 1e-3
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert _rel(a, b) <= 1e-3, (i, _rel(a, b))



@pytest.mark.parametrize("name,shape", [("pair", (1, 24, 2880, 320)), ("pair", (1, 24, 720, 640)),
                                        ("geglu", (69083, 320))])
def test_tf32_forms_weight_gradients_match_plain(cuda, name, shape):
    """At the train step's shapes in fp32, every param requiring grad: B or
    C runs the forward and the new fp32 form of F or G the dx, once each
    (no WMMA launch of F or G); dx and every weight and bias gradient match
    the plain version's autograd in fp32 with TF32 off: 5e-3."""
    from lvd_tpu_torch.ops import geglu_fused as gf
    from lvd_tpu_torch.ops import temporal_attention as ta
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32
    from lvd_tpu_torch.utils.tree import flatten, unflatten_like

    g = torch.Generator(device=cuda).manual_seed(33)
    if name == "pair":
        c = shape[-1]
        p = _pair_params(c, g, cuda)
        kernel = lambda pp, y: ta.temporal_attention_pair(pp, y, c // 64, 1e-5, frames_major=True)
        plain = lambda pp, y: ta._pair_ref_fm(pp, y, c // 64, 1e-5)
        bwd = ta.temporal_attention_pair_bwd
    else:
        c = shape[-1]
        p = _ff_params(c, 4 * c, g, cuda)
        kernel, plain, bwd = gf.geglu_mlp, gf.geglu_mlp_plain, gf.geglu_mlp_bwd
    x = torch.randn(shape, generator=g, device=cuda)
    leaves = {path: t.clone().requires_grad_(True) for path, t in flatten(p).items()}
    ref_leaves = {path: t.clone().requires_grad_(True) for path, t in flatten(p).items()}
    x_k, x_r = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    before = dict(bwd.launches_by_form)
    out = kernel(unflatten_like(p, leaves), x_k)
    ct = torch.randn(out.shape, generator=g, device=cuda)
    got = _grads(out, [x_k, *leaves.values()], ct)
    after = bwd.launches_by_form
    assert after["wgmma"] - before["wgmma"] == 1 and after["wmma"] == before["wmma"]
    with exact_fp32():
        want = _grads(plain(unflatten_like(p, ref_leaves), x_r), [x_r, *ref_leaves.values()], ct)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert _rel(a, b) <= FP32_TOL, (i, _rel(a, b))


def test_tiny_unet_forward_on_card_matches_cpu(cuda, monkeypatch):
    """The tiny UNet (16-wide heads, widths 32-64) in fp32 on the card
    against its CPU run: 1e-4 of max|ref|, TF32 off. Its attentions take
    lvd_tpu's chunked route and its temporal pairs the plain one (head dim
    16), which raised before; kernel D, whose products are TF32, is switched
    off here (LVD_DISABLE_FUSED_TC, read per call) and held to its own gate
    in test_temp_conv_forms_match_plain."""
    from lvd_tpu_torch import config as cfg_mod
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.models.unet3d import apply_unet3d, init_unet3d
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops import temporal_attention as ta
    from lvd_tpu_torch.ops.selfcheck import exact_fp32
    from lvd_tpu_torch.utils import prng

    monkeypatch.setenv("LVD_DISABLE_FUSED_TC", "1")
    cfg = cfg_mod.tiny_unet_config()
    gen = torch.Generator().manual_seed(0)
    params = init_unet3d(prng.prng_key(0), cfg, device="cpu")
    sample = torch.randn((1, 4, 16, 16, 4), generator=gen)
    text = torch.randn((1, 77, cfg.cross_attention_dim), generator=gen)
    with torch.no_grad():
        ref = apply_unet3d(params, cfg, sample, 500, text)
        before = pa.attention_packed.launches, ta.temporal_attention_pair.launches
        with exact_fp32():
            out = apply_unet3d(cast_tree(params, torch.float32, cuda), cfg, sample.to(cuda), 500,
                               text.to(cuda))
    assert (pa.attention_packed.launches, ta.temporal_attention_pair.launches) == before
    err = _rel(out.cpu(), ref)
    print(f"tiny UNet on the card vs its CPU run: {err:.3g}")
    assert err <= 1e-4


def test_tiny_gated_unet_forward_on_card_matches_cpu(cuda, monkeypatch):
    """The tiny gated UNet with its fusers' gates open, its spatial
    proj_out weights not scaled down, and grounding inputs (the GLIGEN path)
    in fp32 on the card against its CPU run: 1e-4 of max|ref|, TF32 off,
    kernel D off, as in test_tiny_unet_forward_on_card_matches_cpu; the
    fuser must move the output."""
    from lvd_tpu_torch import config as cfg_mod
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.models.unet3d import apply_unet3d, init_unet3d
    from lvd_tpu_torch.ops.selfcheck import exact_fp32
    from lvd_tpu_torch.utils import prng

    monkeypatch.setenv("LVD_DISABLE_FUSED_TC", "1")
    cfg = cfg_mod.tiny_unet_config("gated")
    gen = torch.Generator().manual_seed(1)
    params = init_unet3d(prng.prng_key(1), cfg, device="cpu")

    def open_gates(node):
        if isinstance(node, list):
            return [open_gates(v) for v in node]
        if not isinstance(node, dict):
            return node
        if "fuser" in node.get("blocks", [{}])[0]:
            w = torch.randn(node["proj_out"]["w"].shape, generator=gen)
            node = {**node, "proj_out": {**node["proj_out"], "w": w / w.shape[0] ** 0.5}}
        return {k: torch.full_like(v, 0.5) if k in ("alpha_attn", "alpha_dense")
                else open_gates(v) for k, v in node.items()}

    params = open_gates(params)
    sample = torch.randn((1, 4, 16, 16, 4), generator=gen)
    text = torch.randn((1, 77, cfg.cross_attention_dim), generator=gen)
    boxes = torch.rand((4, 30, 4), generator=gen)
    g = {"boxes": boxes, "masks": (torch.rand((4, 30), generator=gen) > 0.5).float(),
         "positive_embeddings": torch.randn((4, 30, cfg.gligen_positive_len), generator=gen)}
    with torch.no_grad():
        ref = apply_unet3d(params, cfg, sample, 500, text, gligen=g)
        plain = apply_unet3d(params, cfg, sample, 500, text)
        with exact_fp32():
            out = apply_unet3d(cast_tree(params, torch.float32, cuda), cfg, sample.to(cuda), 500,
                               text.to(cuda), gligen={k: v.to(cuda) for k, v in g.items()})
    err = _rel(out.cpu(), ref)
    print(f"tiny gated UNet on the card vs its CPU run: {err:.3g}")
    assert err <= 1e-4 and _rel(plain, ref) > 1e-3


def test_fp16_takes_stock_routes_on_card(cuda):
    """fp16 streams run lvd_tpu's XLA routes on stock ops (kernels A, B and D
    take bf16 and fp32 only, as lvd_tpu's predicates): no launch, no
    TypeError, and the fp16 results within 1e-2 of the plain fp32 ones."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import attention as attn
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops import temp_conv_fused as tc
    from lvd_tpu_torch.ops import temporal_attention as ta

    g = torch.Generator(device=cuda).manual_seed(23)
    lin = lambda a, b: {"w": torch.randn(a, b, generator=g, device=cuda) * a ** -0.5,
                        "b": torch.zeros(b, device=cuda)}
    ap = {n: lin(320, 320) for n in ("to_q", "to_k", "to_v", "to_out")}
    x = torch.randn(2, 720, 320, generator=g, device=cuda)
    pair = _pair_params(320, g, cuda)
    y = torch.randn(1, 24, 48, 320, generator=g, device=cuda)
    launches = lambda: (pa.attention_packed.launches, ta.temporal_attention_pair.launches)
    before = launches()
    with torch.no_grad():
        out_a = attn.attention(cast_tree(ap, torch.float16), x.half(), None, 5)[0]
        out_b = ta.temporal_attention_pair(cast_tree(pair, torch.float16), y.half(), 5, 1e-5,
                                           frames_major=True)
        ref_a = attn.attention(ap, x, None, 5)[0]
        ref_b = ta._pair_ref_fm(pair, y, 5, 1e-5)
    assert launches() == (before[0] + 1, before[1])  # the fp32 attention reference only
    assert not tc.supported(y.half())
    assert _rel(out_a, ref_a) <= 1e-2 and _rel(out_b, ref_b) <= 1e-2


def test_key_order_draw_on_the_card_matches_the_cpu(cuda):
    """lvd_tpu's key-order draw (utils/prng.py, models/init.py) on the card:
    the random bits equal the CPU's, the normals within 1e-6 of max|cpu|
    (bfloat16 and float16 normals equal), for odd and even element counts
    and for a whole tiny CLIP tree."""
    from lvd_tpu_torch import config
    from lvd_tpu_torch.models import clip, init
    from lvd_tpu_torch.utils import prng

    key = prng.fold_in(prng.prng_key(0), 7)
    for shape in [(3, 3, 4, 320), (1024, 1024), (4099,), (3, 70001)]:
        assert torch.equal(prng.random_bits(key, shape, cuda).cpu(), prng.random_bits(key, shape))
        card, cpu = prng.normal_key(key, shape, cuda).cpu(), prng.normal_key(key, shape)
        assert ((card - cpu).abs().max() / cpu.abs().max()).item() <= 1e-6
        for dtype in (torch.bfloat16, torch.float16):
            assert torch.equal(prng.normal_key(key, shape, cuda, dtype).cpu(),
                               prng.normal_key(key, shape, dtype=dtype))
    leaves = clip.clip_text_leaves(key, config.tiny_clip_config(), with_projection=True)
    card, cpu = init.draw(leaves, cuda), init.draw(leaves, "cpu")
    for got, want in zip(torch.utils._pytree.tree_leaves(card),
                         torch.utils._pytree.tree_leaves(cpu)):
        assert got.is_cuda and got.shape == want.shape
        assert (got.cpu() - want).abs().max() <= 1e-6 * want.abs().max()


def test_tiny_cli_runs_on_the_card(cuda, tmp_path, monkeypatch):
    """``LVD_TINY=1`` without ``LVD_PLATFORM``: generate's runner pipeline is
    lvd_tpu's tiny models in fp32 on the card, and the run dir holds the GIF
    and frames file of tests/test_cli_integration.py's run."""
    import json

    import numpy as np

    from lvd_tpu_torch.cli import generate
    from lvd_tpu_torch.runners import base, lvd
    from lvd_tpu_torch.utils import vis

    bear = "\n".join(f"Frame {i + 1}: [{{'id': 0, 'name': 'bear', 'box': "
                     f"[{20 + 70 * i}, 250, 140, 160]}}]" for i in range(6))
    (tmp_path / "cache.json").write_text(json.dumps(
        {"A bear walks from the left to the right": [f"{bear}\nBackground keyword: forest"]}))
    monkeypatch.setenv("LVD_TINY", "1")
    monkeypatch.delenv("LVD_PLATFORM", raising=False)
    monkeypatch.setattr(base, "img_dir", base.img_dir)
    monkeypatch.chdir(tmp_path)
    generate.main(["--run-model", "lvd_modelscope256", "--prompt-type", "demo", "--model",
                   "gpt-4", "--template_version", "v0.1", "--cache-path", "cache.json",
                   "--num_frames", "4", "--num_inference_steps", "4", "--max_index_step", "2",
                   "--max_iter", "1", "--no-continue-on-error"])
    assert lvd._state.pipe.device.type == "cuda" and lvd._state.pipe.dtype == torch.float32
    out = tmp_path / "img_generations/imgs_demo_templatev0.1_lvd_modelscope256/run0/0"
    name = next(f for f in ("video_0.joblib", "video_0.npz") if (out / f).exists())
    frames = vis.load_video(str(out / name))
    assert (out / "video_0.gif").exists() and frames.shape == (4, 64, 96, 3)
    assert frames.dtype == np.uint8
    lvd._state = base.RunnerState()


def test_tiny_unet2d_and_sdxl_refiner_on_card_match_cpu(cuda, monkeypatch):
    """The upsample CLI's tiny SDXL refiner (UNet2D at depth 2 with
    text_time, CLIP with its projection, VAE), drawn once on the CPU, on
    the card against its CPU run in fp32, TF32 off: the UNet2D forward with
    the stock feed-forward (LVD_DISABLE_FUSED_FF, read per call; its
    16-wide heads take lvd_tpu's chunked route) within 1e-4 of max|ref|,
    and the img2img pipeline with every kernel lvd_tpu routes (kernel C's
    TF32 products) within the fp32 gate."""
    import numpy as np

    from lvd_tpu_torch import pipeline_sdxl as ps
    from lvd_tpu_torch.cli.upsample import tiny_sdxl_configs
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.models.unet2d import apply_unet2d
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    unet_cfg, clip_cfg, vae_cfg = tiny_sdxl_configs()
    models = ps.drawn_refiner_models(unet_cfg, clip_cfg, vae_cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 10, 14, 4), generator=gen)
    text = torch.randn((2, 77, unet_cfg.cross_attention_dim), generator=gen)
    added = {"text_embeds": torch.randn((2, 32), generator=gen),
             "time_ids": torch.tensor([[64.0, 96, 0, 0, 2.5], [64, 96, 0, 0, 6.0]])}
    monkeypatch.setenv("LVD_DISABLE_FUSED_FF", "1")
    with torch.no_grad():
        ref, _ = apply_unet2d(models.unet_params, unet_cfg, x, 400, text, added_cond=added)
        with exact_fp32():
            out, _ = apply_unet2d(cast_tree(models.unet_params, torch.float32, cuda), unet_cfg,
                                  x.to(cuda), 400, text.to(cuda),
                                  added_cond={k: v.to(cuda) for k, v in added.items()})
    err = _rel(out.cpu(), ref)
    print(f"tiny UNet2D on the card vs its CPU run: {err:.3g}")
    assert err <= 1e-4
    monkeypatch.delenv("LVD_DISABLE_FUSED_FF")

    image = np.random.default_rng(4).random((64, 96, 3)).astype(np.float32)
    kw = dict(strength=0.5, num_inference_steps=4, seed=2)
    on_card = ps.SDXLRefinerModels(**{**models.__dict__, **{
        k: cast_tree(getattr(models, k), torch.float32, cuda)
        for k in ("unet_params", "clip_params", "vae_params")}})
    ref = ps.SDXLRefinerPipeline(models, dtype=torch.float32, device="cpu")("a bear", image, **kw)
    with exact_fp32():
        got = ps.SDXLRefinerPipeline(on_card, dtype=torch.float32, device=cuda)(
            "a bear", image, **kw)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"tiny SDXL refiner on the card vs its CPU run: {err:.3g}")
    assert got.shape == (64, 96, 3) and err <= FP32_TOL


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_collectives_on_cuda_tensors_over_gloo(cuda, dtype, tmp_path):
    """parallel/comm.py's collectives and their VJPs on CUDA tensors of two
    gloo ranks sharing the card (the smoke's sharded phase): each result
    comes back on the card and equals its definition on the seeded
    blocks; the gradient of 0.5 |y|^2 is x for the all_to_all, x where the
    ppermute sends (zeros on the last rank), the all_reduced result for the
    psum and n x for the all_gather."""
    import _torch_parallel_ranks as ranks
    from lvd_tpu_torch.parallel.launch import RankPool

    with RankPool(2, str(tmp_path), timeout=300) as pool:
        outs = pool.run(ranks.comm_on_card, dtype)
    check_collectives(outs, dtype, "cuda")


def check_collectives(outs, dtype, device):
    import numpy as np

    full = outs[0][0]
    n = full.shape[0]
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" else dict(rtol=1e-6, atol=1e-6)
    rounded = lambda a: torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()
    blocks = [rounded(full[r]) for r in range(n)]
    for r, (_, got) in enumerate(outs):
        assert all(d == device for *_, dy, dg in got.values() for d in (dy, dg))
        x = blocks[r]
        total = sum(blocks)
        want = {
            "psum": (total, n * total),
            "all_to_all": (np.concatenate([b.reshape(n, -1, 6, 8)[r] for b in blocks], axis=1),
                           x),
            "ppermute": (blocks[r - 1] if r else np.zeros_like(x),
                         x if r < n - 1 else np.zeros_like(x)),
            "all_gather": (np.concatenate(blocks, axis=0), n * x),
        }
        for name, (y, g) in want.items():
            np.testing.assert_allclose(got[name][0], y, **tol, err_msg=f"{name} rank {r}")
            np.testing.assert_allclose(got[name][1], g, **tol, err_msg=f"{name} grad rank {r}")


# ---- kernels K, L and M (ops/norms.py, csrc/norms.cu) ----

NORM_DTYPES = [torch.bfloat16, torch.float16, torch.float32]
# (N, R, C): the spatial GroupNorms at L0-L2, the temporal one at L0 (N = 2),
# the VAE decoder's widest (24 frames at 320x576, C = 256), the refiner's
# C = 3072; (rows, C): the transformer LayerNorms at L0-L2, CLIP's, C = 3072.
NORM_GN_CASES = [(48, 2880, 320), (2, 69120, 320), (48, 720, 640), (48, 180, 1280),
                 (24, 184320, 256), (2, 144, 3072)]
NORM_LN_CASES = [(138240, 320), (34560, 640), (8640, 1280), (154, 1024), (288, 3072)]


def _norm_case(shape, g, cuda):
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=cuda) + 0.5
    p = {"scale": 1 + 0.1 * torch.randn(c, generator=g, device=cuda),
         "bias": 0.1 * torch.randn(c, generator=g, device=cuda)}
    return x, p


def _norm_tol(dtype, kernel="L"):
    """Of max|ref|: 1e-5 in fp32; in bf16 and fp16 1e-2 where the output
    rounds to x's type (L, M), 1e-4 for K's fp32 statistics."""
    if dtype == torch.float32:
        return 1e-5
    return 1e-4 if kernel == "K" else 1e-2


@pytest.mark.parametrize("dtype", NORM_DTYPES)
@pytest.mark.parametrize("kernel", ["K", "L", "L_silu"])
@pytest.mark.parametrize("shape", NORM_GN_CASES)
def test_group_norm_kernels_match_plain(cuda, shape, kernel, dtype):
    """K's (a, b) and L's y (both forms) against the plain versions on fp32
    copies: 1e-5 of max|ref| in fp32, in bf16 and fp16 1e-4 for K and 1e-2
    for L; L against its
    plain version in x's own type: bit for bit in ``affine``, within one
    unit of the last place in ``affine_silu`` (exp)."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import norms
    from lvd_tpu_torch.ops.selfcheck import exact_fp32

    g = torch.Generator(device=cuda).manual_seed(31)
    x32, p32 = _norm_case(shape, g, cuda)
    x, p = x32.to(dtype), cast_tree(p32, dtype)
    n, r, c = shape
    if kernel == "K":
        wrapper, count = norms.group_norm_stats, r * (c // 32)
        before = wrapper.launches
        out = wrapper(x, p["scale"], p["bias"], 32, 1e-5, count)
        with exact_fp32():
            ref = norms._coeffs_fn(x.float(), p["scale"].float(), p["bias"].float(), 32, 1e-5,
                                   count)
    else:
        silu = kernel == "L_silu"
        a = 1 + 0.1 * torch.randn(n, c, generator=g, device=cuda)
        b = 0.1 * torch.randn(n, c, generator=g, device=cuda)
        wrapper = norms.group_norm_apply
        before = wrapper.launches
        out = (wrapper(x, a, b, silu),)
        ref = (norms.group_norm_apply_plain(x.float(), a, b, silu),)
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        own = norms.group_norm_apply_plain(x, a, b, silu)
        ulps = (out[0].view(bits).long() - own.view(bits).long()).abs().max()
        assert ulps.item() <= (1 if silu else 0)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for got, want in zip(out, ref):
        assert got.dtype == (torch.float32 if kernel == "K" else dtype)
        assert torch.isfinite(got).all() and _rel(got, want) <= _norm_tol(dtype, kernel)


@pytest.mark.parametrize("dtype", NORM_DTYPES)
@pytest.mark.parametrize("form", ["affine", "normalize"])
@pytest.mark.parametrize("shape", NORM_LN_CASES)
def test_layer_norm_kernel_matches_plain(cuda, shape, form, dtype):
    """M against layer_norm_plain on fp32 copies (params in x's type, and
    fp32 params beside half x), 1e-5 of max|ref| in fp32, 1e-2 in bf16 and
    fp16."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import norms

    g = torch.Generator(device=cuda).manual_seed(32)
    x32, p32 = _norm_case(shape, g, cuda)
    x = x32.to(dtype)
    for p in ([cast_tree(p32, dtype), p32] if form == "affine" else [None]):
        before = norms.layer_norm_rows.launches_by_form[form]
        out = norms.layer_norm_rows(x, None if p is None else p["scale"],
                                    None if p is None else p["bias"], 1e-5)
        ref = norms.layer_norm_plain(None if p is None else cast_tree(p, torch.float32),
                                     x.float(), 1e-5)
        torch.cuda.synchronize()
        assert norms.layer_norm_rows.launches_by_form[form] == before + 1
        assert out.dtype == dtype and torch.isfinite(out).all()
        assert _rel(out, ref) <= _norm_tol(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 69120, 320), (2, 2880, 1280), (2, 144, 3072)])
def test_group_norm_stats_are_the_same_bits_alone_and_in_a_batch(cuda, shape, dtype):
    """K's statistics of a sample do not depend on the batch around it or
    on the run: each sample alone equals its row of the batch of 2 bit for
    bit, in both forms, and a second run equals the first."""
    from lvd_tpu_torch.ops import norms

    g = torch.Generator(device=cuda).manual_seed(33)
    x32, p32 = _norm_case(shape, g, cuda)
    x = x32.to(dtype)
    r, c = shape[1], shape[2]
    for form in ("coeffs", "sums"):
        run = lambda t: norms.group_norm_stats(t, p32["scale"], p32["bias"], 32, 1e-5,
                                               r * (c // 32), form)
        batch = run(x)
        for i in range(2):
            alone = run(x[i:i + 1].clone())
            assert all(torch.equal(u[i], v[0]) for u, v in zip(batch, alone))
        assert all(torch.equal(u, v) for u, v in zip(batch, run(x)))


def test_norm_kernels_refuse_inputs_that_require_grad(cuda):
    from lvd_tpu_torch.ops import norms

    x = torch.randn(2, 16, 64, device=cuda).requires_grad_(True)
    a = torch.ones(2, 64, device=cuda)
    s = torch.ones(64, device=cuda)
    with pytest.raises(RuntimeError, match="autograd.Function"):
        norms.group_norm_stats(x, s, s, 8, 1e-5, 128)
    with pytest.raises(RuntimeError, match="autograd.Function"):
        norms.group_norm_apply(x, a, a)
    with pytest.raises(RuntimeError, match="autograd.Function"):
        norms.layer_norm_rows(x[0], s, s, 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("fn", ["group_norm_coeffs", "group_norm", "group_norm_silu",
                                "layer_norm"])
def test_norm_functions_gradients_match_plain(cuda, fn, dtype):
    """Each public function launches its kernels once in the forward; dx,
    dscale and dbias through its Function (the plain version's VJP,
    recomputed) against the plain version's autograd on fp32 copies: 1e-5
    of max|ref| in fp32, 2e-2 in the half types."""
    from lvd_tpu_torch.ops import norms
    from lvd_tpu_torch.ops.selfcheck import exact_fp32

    g = torch.Generator(device=cuda).manual_seed(34)
    x32, p32 = _norm_case((2, 24, 180, 320), g, cuda)
    args = (32, 1e-5) if fn != "layer_norm" else (1e-5,)
    low = [x32.to(dtype), p32["scale"].to(dtype), p32["bias"].to(dtype)]
    low = [t.requires_grad_(True) for t in low]
    ref_leaves = [t.detach().float().requires_grad_(True) for t in low]
    counters = (norms.group_norm_stats, norms.group_norm_apply, norms.layer_norm_rows)
    before = [w.launches for w in counters]
    out = getattr(norms, fn)({"scale": low[1], "bias": low[2]}, low[0], *args)
    want_launches = {"group_norm_coeffs": [1, 0, 0], "layer_norm": [0, 0, 1]}.get(fn, [1, 1, 0])
    assert [w.launches - b for w, b in zip(counters, before)] == want_launches
    with exact_fp32():
        ref = getattr(norms, f"{fn}_plain")({"scale": ref_leaves[1], "bias": ref_leaves[2]},
                                            ref_leaves[0], *args)
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    cts = [torch.randn(o.shape, generator=g, device=cuda) for o in refs]
    got = torch.autograd.grad(outs, low, [ct.to(o.dtype) for ct, o in zip(cts, outs)])
    with exact_fp32():
        want = torch.autograd.grad(refs, ref_leaves, cts)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert _rel(a, b) <= tol
