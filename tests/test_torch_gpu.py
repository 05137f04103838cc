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


@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_sdpa_long_keys_launch_kernels_a_and_e(cuda, d):
    """D = 64 and 128 run their own instantiations, 192 and 256 the D-sliced
    form of kernels A and E."""
    from lvd_tpu_torch.ops import packed_attention as pa
    from lvd_tpu_torch.ops.attention import sdpa

    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(2, 3, 300, d, generator=g, device=cuda).bfloat16().requires_grad_(True)
               for _ in range(3))
    fwd, bwd = pa.attention_packed.launches, pa.attention_packed_bwd.launches
    out, probs = sdpa(q, k, v)
    assert probs is None and pa.attention_packed.launches == fwd + 1
    ct = torch.randn(out.shape, generator=g, device=cuda)
    grads = torch.autograd.grad(out.float(), (q, k, v), ct)
    assert pa.attention_packed_bwd.launches == bwd + 1
    leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    flat = lambda t: t.reshape(6, 300, d)
    ref = pa.attention_packed_plain(*(flat(t) for t in leaves), d ** -0.5, 1).reshape(out.shape)
    assert _rel(out, ref) <= 2e-2
    for got, want in zip(grads, torch.autograd.grad(ref, leaves, ct)):
        assert _rel(got, want) <= 2e-2


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


def test_geglu_resident_width_kernel_g_cannot_take_raises(cuda):
    """C = 72: lvd_tpu keeps the weights resident forward and backward;
    kernel C's template does not cover the width, so J runs the forward, and
    the dx, which lvd_tpu gives its resident kernel, raises with the reason
    rather than run a plain version."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import geglu_fused as gf

    g = torch.Generator(device=cuda).manual_seed(10)
    p = cast_tree(_ff_params(72, 256, g, cuda), torch.bfloat16)
    x = torch.randn(64, 72, generator=g, device=cuda).bfloat16().requires_grad_(True)
    before = gf.geglu_stream.launches
    out = gf.geglu_mlp(p, x)
    assert gf.geglu_stream.launches == before + 1
    with pytest.raises(ValueError, match="kernel G is built for"):
        out.float().sum().backward()


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
    """45 pixels leave a ragged last pixel group; both stream layouts."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import temporal_attention as ta

    g = torch.Generator(device=cuda).manual_seed(1)
    p = _pair_params(320, g, cuda)
    shape = (2, 24, 45, 320) if frames_major else (2, 45, 24, 320)
    y = torch.randn(shape, generator=g, device=cuda)
    out = ta.temporal_attention_pair(cast_tree(p, torch.bfloat16), y.bfloat16(), 5, 1e-5,
                                     frames_major=frames_major)
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
                lambda y: ta._pair_ref_fm(p, y, 5, 1e-5), [r(1, 24, 45, 320)], 4.5e-2)
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
        pa._launch_forward(q, q, q, 0.125, 2)
    p = cast_tree(_pair_params(128, g, cuda), torch.bfloat16)
    with pytest.raises(RuntimeError, match="autograd.Function"):
        ta.temporal_attention_pair_bwd(p, x, x, 2, 1e-5, frames_major=True)
    ff = {"proj": {"w": torch.zeros(128, 1024, device=cuda), "b": torch.zeros(1024, device=cuda)},
          "out": {"w": torch.zeros(512, 128, device=cuda), "b": torch.zeros(128, device=cuda)}}
    with pytest.raises(RuntimeError, match="autograd.Function"):
        gf.geglu_mlp_bwd(ff, x, x)
    # Weight gradients are not part of the guided slice: asking for one raises.
    p["attn1"]["to_q"]["w"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="training slice"):
        ta.temporal_attention_pair(p, x.detach(), 2, 1e-5, frames_major=True)
    ff["out"]["w"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="training slice"):
        gf.geglu_mlp(ff, x.detach())
