"""Kernel selfcheck on the card (counterpart of lvd_tpu/ops/selfcheck.py).

Every kernel of the guided Zeroscope path, with and without lvd_tpu's two
opt-in switches, runs at every shape that path gives it, in bf16, and is
held to its plain PyTorch version run on fp32 copies of the same inputs,
with lvd_tpu's selfcheck gate: max|kernel - plain| / max|plain| <= 2e-2, or
4.5e-2 for the temporal pair and its backward (lvd_tpu/ops/selfcheck.py:28,
441-445). The forwards A-D and the resnet convs (kernel I with its
prologue, row 12) run at the shapes of the 576x320, 24-frame CFG forward
(batch 2 x 24); the projections (kernel H, row 14) at the q/k/v/out and
text k/v shapes, with the dx call of their backward; kernel A also at the
GLIGEN fuser's shapes (S visual + 30 grounding tokens, ragged key counts),
its K and V at the start of NaN-tailed buffers; the backwards E-G at
the shapes of the guided energy walk (the cond-only UNet walk of batch 24
down to the last captured site). The public entry points conv3x3() (kernel
I without prologue, row 13) and sdpa() (kernel A with one head, row 1, and
E in its backward) run at L0-sized shapes, sdpa() at D = 64 to 256 and,
at D = 192 and 256, also at (2, 16, 4096, D), where the tensor cores and
not the launch set the time; kernel J (row 9), which the public geglu_mlp() runs where lvd_tpu's
``_fused_rows`` streams its weights, at the feed-forward shapes of that
branch (C = 1280 in bf16; C = 640 and 1280 in fp32). A backward is checked on
each of its outputs (dq, dk and dv for E; dq alone where the walk asks for no
dk/dv, at the text cross-attention).

The upsample path gives the forwards new shapes, checked after the
Zeroscope ones: kernel A, B, C and D at the Zeroscope-XL refine's
576x1024, 24-frame CFG forward (batch 2 x 24; A's self-attention up to
9216 keys, whose plain version still fits because it takes 512 queries at
a time), kernel A at the SDXL refiner's CFG forward (batch 2: 12 heads at
C = 768, 24 at C = 1536), kernels I and H at the refiner's resnet convs and
projections that lvd_tpu's predicates route under the opt-in switches (the
forward projection alone: the refiner runs no backward), and kernel D where
lvd_tpu routes its kernel past 32 frames (frame groups) and at
C % 64 != 0 (C = 72, 520), in bf16 and, at three of those shapes, in fp32.

Each kernel also runs in fp32 at its largest path shape, and B, C, F and G
at the train step's shapes (batch 1, 24 frames, L0 and L1), against the
plain version in fp32 with TF32 off, gated at 5e-3 and below the same shape's
bf16 reading, so a kernel that rounded fp32 to bf16 would fail. Every
reference runs with ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` off.

Kernels A-J record the form each call took (``launches_by_form``:
``wgmma`` in bf16, and for B, F and G in fp32 too (TF32), ``mma_sync`` for
C and D in fp32; C's kept ``wmma`` form for fp32 C > 384, I's for widths
% 64 != 0, J's first version, ``wmma``, in fp32; A and E by head dim,
``D64``, ``D128``, ``wide`` at 192 and 256, ``sliced`` past it). sdpa()
at D = 192 and 256 must take the ``wide`` form, and runs and times the
D-sliced form of A and E on the same inputs (``first_ms``,
``first_rel_err``; E's from the wide forward's log-sum-exp). B, F, G and J in their
``wgmma`` form also run and time their first version on the same inputs
(``first_ms``, ``first_rel_err``), held to no gate; B also in bf16 at the
train step's shapes, the reading its fp32 checks there must beat. C, D, F
and J also time the same products alone through ``torch.matmul`` on
pre-made operands (``products_ms``: x W1 and gated W2;
the three shifted products; F's seven projections, [q | k | v] and the
output of both attentions and dO and dz of both VJPs): not a library call
for the same function, and the port never calls it. C's Hopper forms and
the wgmma forms of G and J also time the interleaved copy of W1 that each
call makes (``copy_ms``, included in ``ms``).

Kernels K, L and M (ops/norms.py: GroupNorm statistics, GroupNorm apply
in its ``affine`` and ``affine_silu`` forms, LayerNorm), which replace XLA's
fusions of lvd_tpu's norms and no Pallas kernel, run in bf16 and fp32 at
the UNet's GroupNorm and LayerNorm shapes, the VAE decoder's widest
GroupNorm, the SDXL refiner's C = 3072 and CLIP's LayerNorm, against their
plain versions on fp32 copies: within 1e-2 of max|ref| in bf16 (K, whose
output is fp32 statistics, within 1e-4) and 1e-5 in fp32. Their backwards
N (``affine``, ``affine_silu``, ``coeffs``) and O run at the guided
update's shapes (L0 to L3), N's frame-sharded forms (``sums``, ``apply``,
``apply_silu``) at a rank's L0 shard, dx alone in bf16 (2e-2) and with
dscale and dbias in fp32 (1e-4), against their plain versions on fp32
copies (N's dy with a mean of 1, so its statistics' term shows); N's bf16
dx also against its plain version run in bf16 (``in_type_reading``). Their
yardsticks
are ``torch.var_mean`` over the grouped view (K's statistics),
``F.group_norm`` on a channels-first view (statistics and apply: K + L's
work, set beside L), then ``F.silu`` (L's ``affine_silu``),
``F.layer_norm`` (M), and aten's ``native_group_norm_backward`` on a
channels-first copy (N's ``affine``) and ``native_layer_norm_backward``
(O), dx alone; their
bound counts the arithmetic at the CUDA cores' fp32 rate (67 TFLOP/s), so
the bytes set it.

Each shape is also timed with CUDA events: the kernel, the plain version
on the same inputs, and where one PyTorch call computes the same function
(``scaled_dot_product_attention`` and its backward for A, E and sdpa,
``F.conv2d`` for kernel I, ``torch.addmm`` for H) that call as a yardstick
(the port never calls it). ``bound_ms`` is the least time the card could
take: the larger of the operations over the tensor-core peak of the type
(bf16, or TF32 for fp32) and the bytes (each input read once, each output
written once) over the memory rate. ``run()`` is called by chip_smoke.py
and tests/test_torch_gpu.py.
"""

from __future__ import annotations

import contextlib
import json

import torch
import torch.nn.functional as F

from . import (attention, conv3x3, geglu_fused, linear_fused, norms, packed_attention,
               spatial_conv_fused, temp_conv_fused, temporal_attention)

# NVIDIA H100 SXM data sheet, dense: tensor-core peaks and the HBM3 rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}  # fp32 products run in TF32
PEAK_BYTES_PER_S = 3.35e12
PEAK_SIMT_FLOPS = 67e12  # fp32 outside the tensor cores: the norms' arithmetic

DEFAULT_TOL = 2e-2
PAIR_TOL = 4.5e-2
FP32_TOL = 5e-3
# Kernels K-M against their plain versions on fp32 copies: L and M in bf16
# within 1e-2 of max|ref| (one rounding of the output), fp32 within 1e-5
# (the sums' order alone); K, whose output is fp32 in every type, within
# 1e-4 in bf16 and fp16. N and O in bf16 within lvd_tpu's gate, 2e-2 (dz,
# L's dx term and the cotangents of (a, b) round to bf16); in fp32 1e-5,
# 1e-4 where dscale and dbias or the cotangents of (a, b) (sums over N or
# the rows) are checked too. N's dy has a mean of 1 (NORM_BWD_DY_MEAN), so
# GroupNorm's statistics' term is a fifth to a half of max|dx| and 2e-2
# sees it (with a mean of 0 it lies below a bf16 ulp of most elements). N's
# bf16 dx against the plain version run in bf16 (in_type_reading): in at
# least half the (sample, group) blocks at most 1e-3 of the elements
# differ at all, which a term rounded elsewhere than the plain version
# rounds it (1-5% of every block) does not pass.
NORM_TOL = 1e-2
NORM_STATS_TOL = 1e-4
NORM_FP32_TOL = 1e-5
NORM_BWD_TOL = DEFAULT_TOL
NORM_PARAMS_FP32_TOL = 1e-4
NORM_BWD_BITS_DIFFER = 1e-3
NORM_BWD_DY_MEAN = 1.0

# The shapes the 576x320, 24-frame CFG forward gives each kernel.
ATTN_SHAPES = [  # (batch, S_q, S_k, C): self-attention at L0/L1, cross at every level
    (48, 2880, 2880, 320), (48, 720, 720, 640),
    (48, 2880, 77, 320), (48, 720, 77, 640), (48, 180, 77, 1280), (48, 45, 77, 1280),
    (48, 180, 180, 1280), (48, 45, 45, 1280),
]
# The GLIGEN fuser's self-attention over the S visual tokens and the 30
# grounding tokens, at L0, L1, L2 and mid: ragged key counts (2910 % 64 = 30,
# 750 % 64 = 46), the first two in the long-key form.
FUSER_ATTN_SHAPES = [(48, 2910, 2910, 320), (48, 750, 750, 640), (48, 210, 210, 1280),
                     (48, 75, 75, 1280)]
PAIR_SHAPES = [(2, 24, 2880, 320), (2, 24, 2880, 512), (2, 24, 720, 640)]  # (B, F, P, C)
GEGLU_SHAPES = [(138240, 320), (138240, 512), (34560, 640)]  # (rows, C), inner = 4C
TCONV_SHAPES = [(2, 24, 2880, 320), (2, 24, 720, 640), (2, 24, 180, 1280), (2, 24, 45, 1280)]
# Resnet convs spatial_conv_fused.supported routes in bf16: (N, H, W, Cin, Cout).
SCONV_SHAPES = (
    [(48, 20, 36, cin, 640) for cin in (320, 640, 960, 1280)]
    + [(48, 10, 18, cin, 1280) for cin in (640, 1280, 1920, 2560)]
    + [(48, 5, 9, cin, 1280) for cin in (1280, 2560)])
# Projections linear_fused.supported routes: (rows, C, N); q/k/v/out at L1
# and L2, the text k/v (48 x 77 rows, 1024 -> 640 or 1280).
LINEAR_SHAPES = [(34560, 640, 640), (8640, 1280, 1280), (3696, 1024, 640),
                 (3696, 1024, 1280)]
# The public entry points: conv3x3() at the L0 resnet widths, sdpa() (B, H, S, D).
CONV3X3_SHAPES = [(48, 40, 72, cin, 320) for cin in (320, 640, 960)]
SDPA_SHAPES = [(48, 5, 2880, 64), (8, 4, 1024, 128), (8, 4, 1024, 192), (8, 4, 1024, 256),
               (2, 16, 4096, 192), (2, 16, 4096, 256)]
# Kernel J (rows, C), inner = 4C, where lvd_tpu's _fused_rows streams: in bf16
# the L2 feed-forward of the CFG forward (2 x 24 x 180 rows), L3, and the L2
# of the cond-only guided walk; in fp32 (the pipeline's default) L1 and L2.
# (34560, 640) runs in bf16 too, as the reading its fp32 check must beat.
GEGLU_STREAM_SHAPES = [(8640, 1280), (2160, 1280), (4320, 1280), (34560, 640)]
GEGLU_STREAM_FP32_SHAPES = [(34560, 640), (8640, 1280)]
# The upsample path: the Zeroscope-XL refine's CFG forward (576x1024, 24
# frames: 9216, 2304, 576 and 144 pixels a frame) and the SDXL refiner's
# (576x1024, batch 2: 2304 tokens at C = 768, 576 and 144 at C = 1536). The
# first, XL's L0 self-attention, is checked beyond the route: lvd_tpu's
# pallas_ok counts K and V (2 x 9216 x 320 x 2 B > 8 MiB), so the path runs
# the chunked stock route there.
XL_ATTN_SHAPES = [
    (48, 9216, 9216, 320), (48, 2304, 2304, 640), (48, 576, 576, 1280), (48, 144, 144, 1280),
    (48, 9216, 77, 320), (48, 2304, 77, 640), (48, 576, 77, 1280), (48, 144, 77, 1280),
]
SDXL_ATTN_SHAPES = [(2, 2304, 2304, 768), (2, 576, 576, 1536), (2, 144, 144, 1536),
                    (2, 2304, 77, 768), (2, 576, 77, 1536), (2, 144, 77, 1536)]
# The refiner's CFG forward under the opt-in switches: the resnet convs
# spatial_conv_fused.supported routes (N, H, W, Cin, Cout) and the
# projections linear_fused.supported routes (rows, C, N): q/k/v/out at 2304
# tokens (C = 768), 576 and 144 (C = 1536), the text k/v (2 x 77 rows, 1280
# -> 768 or 1536). chip_smoke.py's knob child fails if the path routes any
# other shape.
SDXL_SCONV_SHAPES = [(2, 36, 64, 384, 768), (2, 18, 32, 768, 1536), (2, 18, 32, 1536, 1536),
                     (2, 9, 16, 1536, 1536), (2, 9, 16, 3072, 1536)]
SDXL_LINEAR_SHAPES = [(4608, 768, 768), (1152, 1536, 1536), (288, 1536, 1536),
                      (154, 1280, 768), (154, 1280, 1536)]
XL_PAIR_SHAPES = [(2, 24, 9216, 320), (2, 24, 2304, 640)]
XL_GEGLU_SHAPES = [(442368, 320), (110592, 640)]
XL_TCONV_SHAPES = [(2, 24, 9216, 320), (2, 24, 2304, 640), (2, 24, 576, 1280),
                   (2, 24, 144, 1280)]
# Kernel D where lvd_tpu routes its kernel past 32 frames (two to seven
# frame groups) and at C % 64 != 0; the last three also in fp32.
C4_TCONV_SHAPES = [(2, 48, 2880, 320), (2, 64, 720, 640), (2, 100, 45, 1280),
                   (2, 200, 64, 72), (2, 40, 2880, 320), (2, 24, 2880, 72), (2, 24, 180, 520)]
C4_TCONV_FP32_SHAPES = C4_TCONV_SHAPES[-3:]
# The shapes the guided energy walk's backward gives each backward kernel.
ATTN_BWD_SHAPES = [  # (batch, S_q, S_k, C): self-attention at every level, uncaptured cross
    (24, 2880, 2880, 320), (24, 720, 720, 640), (24, 180, 180, 1280), (24, 45, 45, 1280),
    (24, 2880, 77, 320), (24, 720, 77, 640), (24, 180, 77, 1280), (24, 45, 77, 1280),
]
PAIR_BWD_SHAPES = [(1, 24, 2880, 320), (1, 24, 2880, 512), (1, 24, 720, 640)]
GEGLU_BWD_SHAPES = [(69120, 320), (69120, 512), (17280, 640)]
# The train step's shapes in its type, fp32 (batch 1, 24 frames at 40x72
# latents: L0 69120 rows at C = 320, L1 17280 at C = 640), beyond the fp32
# checks at the first shapes above: B at both levels, F and G at L1, C at L0
# (its mma_sync form) and at L1 (its WMMA form, which the path routes to
# stock ops in fp32).
TRAIN_PAIR_SHAPES = [(1, 24, 2880, 320), (1, 24, 720, 640)]
TRAIN_GEGLU_SHAPES = [(69120, 320), (17280, 640)]

# Kernels K and L (N, R, C): the spatial GroupNorms at L0 (48 frames of 2880
# pixels), the temporal ones at L0 (2 x 24 frames of 2880 pixels: N = 2),
# the spatial ones at L1 and L2, the VAE decoder's widest (24 frames at
# 320x576, 256 channels, 2.26 GB in bf16) and the SDXL refiner's C = 3072
# (2 x 9 x 16 pixels); 32 groups each. Kernel M (rows, C): the transformer
# blocks' LayerNorms at L0, L1 and L2 (48 x 2880, 720, 180 rows) and CLIP's
# (2 x 77 tokens, C = 1024).
NORM_GN_SHAPES = [(48, 2880, 320), (2, 69120, 320), (48, 720, 640), (48, 180, 1280),
                  (24, 184320, 256), (2, 144, 3072)]
NORM_LN_SHAPES = [(138240, 320), (34560, 640), (8640, 1280), (154, 1024)]
# Kernels N and O at the guided update's shapes (the cond-only walk, batch
# 1 x 24 frames), L0 to L3: N's ``affine`` / ``affine_silu`` at the spatial
# GroupNorms (24 frames of 2880 ... 45 pixels), ``coeffs`` at the temporal
# convs' statistics (1 x 24 x pixels rows), O at the LayerNorms; in fp32
# (the train step's type) with the parameters' gradients too.
NORM_BWD_GN_SHAPES = [(24, 2880, 320), (24, 720, 640), (24, 180, 1280), (24, 45, 1280)]
NORM_BWD_COEFFS_SHAPES = [(1, 69120, 320), (1, 17280, 640), (1, 4320, 1280), (1, 1080, 1280)]
NORM_BWD_LN_SHAPES = [(69120, 320), (17280, 640), (4320, 1280), (1080, 1280)]
# N's frame-sharded forms (``sums``, ``apply``, ``apply_silu``) at a rank's
# share of the temporal convs' statistics at L0 when the sharded phase's two
# ranks split the 24 frames: 1 x 12 x 2880 rows.
NORM_BWD_SHARD_SHAPE = (1, 34560, 320)

_A = "lvd_tpu/ops/pallas_attention.py"
SOURCES = {  # kernel wrapper -> (CUDA source, the TPU kernels it replaces)
    "attention_packed": ("lvd_tpu_torch/csrc/packed_attention.cu",
                         f"{_A}:135 _pallas_attention_heads; {_A}:540 _pallas_attention_shortkey"),
    "temporal_attention_pair": ("lvd_tpu_torch/csrc/temporal_attention.cu",
                                "lvd_tpu/ops/temporal_attention.py:282 _pallas_pair"),
    "geglu_mlp": ("lvd_tpu_torch/csrc/geglu.cu",
                  "lvd_tpu/ops/geglu_fused.py:159 _fused_rows_resident"),
    "norm_silu_temporal_conv": ("lvd_tpu_torch/csrc/temp_conv.cu",
                                "lvd_tpu/ops/temp_conv_fused.py:153 _fused"),
    "attention_packed_bwd": ("lvd_tpu_torch/csrc/packed_attention_bwd.cu",
                             f"{_A}:235 _pallas_attention_bwd; {_A}:348 _pallas_attention_bwd_heads"),
    "temporal_attention_pair_bwd": ("lvd_tpu_torch/csrc/temporal_attention_bwd.cu",
                                    "lvd_tpu/ops/temporal_attention.py:348 _pallas_pair_bwd"),
    "geglu_mlp_bwd": ("lvd_tpu_torch/csrc/geglu_bwd.cu",
                      "lvd_tpu/ops/geglu_fused.py:299 _fused_rows_bwd_resident"),
    "linear": ("lvd_tpu_torch/csrc/linear.cu", "lvd_tpu/ops/linear_fused.py:69 _fused_rows"),
    "norm_silu_conv2d": ("lvd_tpu_torch/csrc/conv3x3.cu",
                         "lvd_tpu/ops/spatial_conv_fused.py:110 _fused"),
    "conv3x3": ("lvd_tpu_torch/csrc/conv3x3.cu", "lvd_tpu/ops/conv3x3.py:64 _conv3x3_pallas"),
    "sdpa": ("lvd_tpu_torch/csrc/packed_attention.cu", f"{_A}:109 _pallas_attention"),
    "geglu_stream": ("lvd_tpu_torch/csrc/geglu_stream.cu",
                     "lvd_tpu/ops/geglu_fused.py:194 _fused_rows"),
    # K-O replace no Pallas kernel: XLA's fusions of these functions and,
    # under jax.grad, of their VJPs.
    "group_norm_stats": ("lvd_tpu_torch/csrc/norms.cu",
                         "lvd_tpu/ops/basic.py:59 group_norm_coeffs (XLA's fusion)"),
    "group_norm_apply": ("lvd_tpu_torch/csrc/norms.cu",
                         "lvd_tpu/ops/basic.py:113 group_norm (XLA's fusion)"),
    "layer_norm_rows": ("lvd_tpu_torch/csrc/norms.cu",
                        "lvd_tpu/ops/basic.py:144 layer_norm (XLA's fusion)"),
    "group_norm_bwd": ("lvd_tpu_torch/csrc/norms_bwd.cu",
                       "lvd_tpu/ops/basic.py:59 group_norm_coeffs, :113 group_norm "
                       "(XLA's fusion of their VJP)"),
    "layer_norm_bwd": ("lvd_tpu_torch/csrc/norms_bwd.cu",
                       "lvd_tpu/ops/basic.py:144 layer_norm (XLA's fusion of its VJP)"),
}


def time_ms(fn, warmup: int = 2, iters: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def exact_fp32():
    """fp32 products and convolutions in full fp32 (cuDNN runs fp32 convs in
    TF32 by default), for the references."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def bound(flops: float, nbytes: float, dtype=torch.bfloat16, peak=None):
    """(ms, "operations" or "bytes"): ``peak`` is the operations' rate where
    they do not run on the tensor cores (else the type's tensor-core peak)."""
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _rel_err(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def _randn(gen, shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32) * scale


def _linear_p(gen, din, dout, bias=True):
    p = {"w": _randn(gen, (din, dout), din ** -0.5)}
    if bias:
        p["b"] = _randn(gen, (dout,), 0.1)
    return p


def _norm_p(gen, c):
    return {"scale": 1.0 + _randn(gen, (c,), 0.1), "bias": _randn(gen, (c,), 0.1)}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _ref(fn, *args):
    """The plain version on fp32 copies of the inputs, TF32 off."""
    with exact_fp32():
        return fn(*(_cast(a, torch.float32) if isinstance(a, (dict, torch.Tensor)) else a
                    for a in args))


def _record(name, shape, dtype, out, ref, tol, ms, plain_ms, flops, nbytes, library_ms=None,
            peak=None, fp32_tol=FP32_TOL):
    """One check's record; ``out`` and ``ref`` may be tuples (a backward's
    outputs), each held to the gate on its own."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    errs = [_rel_err(o, r) for o, r in zip(outs, refs)]
    err = max(e for e, _ in errs)
    rel = max(r for _, r in errs)
    finite = all(torch.isfinite(o).all().item() for o in outs)
    if dtype == torch.float32:
        tol = fp32_tol
    b_ms, b_by = bound(flops, nbytes, dtype, peak)
    return {"name": name, "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "rel_err": rel, "tol": tol, "ok": bool(rel <= tol and finite),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}


def _nan_tailed(t):
    """A copy of ``t`` at the start of a buffer whose next 64 rows hold NaN, so
    a kernel that read past the last row of the last batch would show it."""
    b, s, c = t.shape
    buf = torch.full((b * s + 64, c), float("nan"), dtype=t.dtype, device=t.device)
    buf[:b * s] = t.reshape(b * s, c)
    return buf[:b * s].view(b, s, c)


def check_attention(gen, shape, dtype=torch.bfloat16):
    """Kernel A at one (batch, S_q, S_k, C) shape; K and V lie at the start of
    NaN-tailed buffers."""
    b, s_q, s_k, c = shape
    heads = c // 64
    q, k, v = (_randn(gen, (b, s, c)).to(dtype) for s in (s_q, s_k, s_k))
    k, v = _nan_tailed(k), _nan_tailed(v)
    scale = 64 ** -0.5
    out, form = _launched_form(packed_attention.attention_packed,
                               lambda: packed_attention.attention_packed(q, k, v, scale, heads))
    ref = _ref(packed_attention.attention_packed_plain, q, k, v, scale, heads)
    ms = time_ms(lambda: packed_attention.attention_packed(q, k, v, scale, heads))
    plain_ms = time_ms(lambda: packed_attention.attention_packed_plain(q, k, v, scale, heads),
                       1, 2)
    split = lambda t: t.view(b, t.shape[1], heads, 64).transpose(1, 2)
    qh, kh, vh = split(q), split(k), split(v)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
    flops = 4.0 * b * heads * s_q * s_k * 64
    nbytes = q.element_size() * (2 * b * s_q * c + 2 * b * s_k * c)
    rec = _record("attention_packed", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms, flops,
                  nbytes, lib_ms) | {"form": form}
    if not packed_attention.kernel_ok(q, k, heads):  # the path takes lvd_tpu's chunked route
        rec["chunked_ms"] = time_ms(lambda: attention.heads_chunked(q, k, v, scale, heads), 1, 2)
    return rec


def _pair_params(gen, c):
    attn = lambda: {n: _linear_p(gen, c, c, bias=False) for n in ("to_q", "to_k", "to_v")} | {
        "to_out": _linear_p(gen, c, c)}
    return {"norm1": _norm_p(gen, c), "attn1": attn(), "norm2": _norm_p(gen, c), "attn2": attn()}


def check_pair(gen, shape, dtype=torch.bfloat16):
    b, f, pdim, c = shape
    heads = c // 64
    p = _cast(_pair_params(gen, c), dtype)
    y = _randn(gen, shape).to(dtype)
    fn = lambda: temporal_attention.temporal_attention_pair(p, y, heads, 1e-5, frames_major=True)
    out, form = _launched_form(temporal_attention.temporal_attention_pair, fn)
    ref = _ref(temporal_attention._pair_ref_fm, p, y, heads, 1e-5)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: temporal_attention._pair_ref_fm(p, y, heads, 1e-5), 1, 2)
    rows = b * f * pdim
    flops = 2 * (2.0 * rows * c * 4 * c + 4.0 * rows * f * c)
    nbytes = y.element_size() * (2 * rows * c + 2 * 4 * c * c) + 4.0 * 2 * 3 * c
    rec = _record("temporal_attention_pair", shape, dtype, out, ref, PAIR_TOL, ms, plain_ms,
                  flops, nbytes) | {"form": form}
    if form != "wmma":  # the first version beside the new form, on the same inputs
        first = lambda: temporal_attention._launch_forward(p, y, heads, 1e-5, True, "wmma")
        rec |= _first_version(first(), ref, time_ms(first))
    return rec


def _first_version(out, ref, ms):
    """The first version's reading and time beside a redesigned form's
    (``out`` and ``ref`` may be tuples, a backward's outputs)."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    errs = [_rel_err(o, r) for o, r in zip(outs, refs)]
    return {"first_ms": ms, "first_rel_err": max(r for _, r in errs),
            "first_max_abs_err": max(e for e, _ in errs)}


def _geglu_args(pp, xx):
    return xx, pp["proj"]["w"], pp["proj"]["b"], pp["out"]["w"], pp["out"]["b"]


def check_geglu(gen, shape, dtype=torch.bfloat16):
    rows, c = shape
    inner = 4 * c
    p = _cast({"proj": _linear_p(gen, c, 2 * inner), "out": _linear_p(gen, inner, c)}, dtype)
    x = _randn(gen, (rows, c)).to(dtype)
    fn = lambda: geglu_fused.geglu_mlp(p, x)
    if geglu_fused.forward_kernel(c, inner, dtype) != "C":  # the route streams: launch C itself
        fn = lambda: geglu_fused._launch_forward(p, x)
    out, form = _launched_form(geglu_fused.geglu_mlp, fn)
    ref = _ref(lambda pp, xx: geglu_fused._unfused(*_geglu_args(pp, xx)), p, x)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: geglu_fused._unfused(*_geglu_args(p, x)), 1, 2)
    # The same two products alone on pre-made operands (x W1, gated W2).
    gated = _randn(gen, (rows, inner)).to(dtype)
    w1, w2 = p["proj"]["w"], p["out"]["w"]
    products_ms = time_ms(lambda: (torch.matmul(x, w1), torch.matmul(gated, w2)))
    del gated
    extra = {"form": form, "products_ms": products_ms}
    if form != "wmma":  # the per-call interleaved copy of w1, part of ms
        extra["copy_ms"] = time_ms(lambda: geglu_fused.interleave_w1(w1, inner))
    flops = 6.0 * rows * c * inner
    nbytes = x.element_size() * (2 * rows * c + 3 * c * inner + 2 * inner + c)
    return _record("geglu_mlp", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms, flops,
                   nbytes) | extra


def check_geglu_stream(gen, shape, dtype=torch.bfloat16):
    """Kernel J, launched directly (the public geglu_mlp() routes to it
    wherever lvd_tpu's _fused_rows streams)."""
    rows, c = shape
    inner = 4 * c
    p = _cast({"proj": _linear_p(gen, c, 2 * inner), "out": _linear_p(gen, inner, c)}, dtype)
    x = _randn(gen, (rows, c)).to(dtype)
    fn = lambda: geglu_fused.geglu_stream(p, x)
    out, form = _launched_form(geglu_fused.geglu_stream, fn)
    ref = _ref(geglu_fused.geglu_stream_plain, p, x)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: geglu_fused.geglu_stream_plain(p, x), 1, 2)
    gated = _randn(gen, (rows, inner)).to(dtype)
    w1, w2 = p["proj"]["w"], p["out"]["w"]
    products_ms = time_ms(lambda: (torch.matmul(x, w1), torch.matmul(gated, w2)))
    del gated
    flops = 6.0 * rows * c * inner
    nbytes = x.element_size() * (2 * rows * c + 3 * c * inner + 2 * inner + c)
    rec = _record("geglu_stream", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms, flops,
                  nbytes) | {"form": form, "products_ms": products_ms}
    if form == "wgmma":  # the first version beside the new form, on the same inputs
        first = lambda: geglu_fused.geglu_stream(p, x, form="wmma")
        rec |= _first_version(first(), ref, time_ms(first))
        rec["copy_ms"] = time_ms(lambda: geglu_fused.interleave_w1(w1, inner))
    return rec


def check_temp_conv(gen, shape, dtype=torch.bfloat16):
    b, f, pdim, c = shape
    x = _randn(gen, shape).to(dtype)
    a = 1.0 + _randn(gen, (b, c), 0.1)
    sh = _randn(gen, (b, c), 0.1)
    w = _randn(gen, (3, 1, 1, c, c), (3 * c) ** -0.5).to(dtype)
    bias = _randn(gen, (c,), 0.1).to(dtype)
    if not temp_conv_fused.supported(x):
        raise RuntimeError(f"norm_silu_temporal_conv: {shape} {dtype} is not a routed shape")
    fn = lambda: temp_conv_fused.norm_silu_temporal_conv(x, a, sh, w, bias)
    out, form = _launched_form(temp_conv_fused.norm_silu_temporal_conv, fn)
    ref = _ref(temp_conv_fused.norm_silu_temporal_conv_plain, x, a, sh, w, bias)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: temp_conv_fused.norm_silu_temporal_conv_plain(x, a, sh, w, bias),
                       1, 2)
    # The three frame-shifted products alone on pre-made operands.
    w3 = w.reshape(3, c, c)
    z_prev, z_next = x[:, :-1].contiguous(), x[:, 1:].contiguous()
    products_ms = time_ms(lambda: (torch.matmul(x, w3[1]), torch.matmul(z_prev, w3[0]),
                                   torch.matmul(z_next, w3[2])))
    del z_prev, z_next
    n = b * f * pdim
    flops = 6.0 * n * c * c
    nbytes = x.element_size() * (2 * n * c + 3 * c * c + c) + 4.0 * 2 * b * c
    rec = _record("norm_silu_temporal_conv", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms,
                  flops, nbytes) | {"form": form, "products_ms": products_ms}
    plan = temp_conv_fused.launch_plan(f, dtype)
    rec["frame_groups"] = plan["frame_groups"]
    rec["ok"] = rec["ok"] and form == plan["form"]  # wgmma in bf16, mma_sync in fp32
    return rec


def check_attention_bwd(gen, shape, dtype=torch.bfloat16):
    b, s_q, s_k, c = shape
    heads = c // 64
    q, k, v = (_randn(gen, (b, s, c)).to(dtype) for s in (s_q, s_k, s_k))
    do = _randn(gen, (b, s_q, c)).to(dtype)
    scale = 64 ** -0.5
    # Kernel E reads the log-sum-exp kernel A writes for it.
    o, lse = packed_attention.attention_packed_with_lse(q, k, v, scale, heads)
    # The energy walk needs dk/dv at self-attention only (cross-attention
    # keys come from the text); check and time the call the walk makes.
    need_kv = s_q == s_k
    fn = lambda: packed_attention.attention_packed_bwd(q, k, v, o, do, scale, heads, need_kv,
                                                       lse=lse)
    out, form = _launched_form(packed_attention.attention_packed_bwd, fn)
    ref = _ref(packed_attention.attention_packed_bwd_plain, q, k, v, o, do, scale, heads)
    if not need_kv:
        out, ref = out[:1], ref[:1]
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: packed_attention.attention_packed_bwd_plain(
        q, k, v, o, do, scale, heads), 1, 2)
    split = lambda t: t.view(b, t.shape[1], heads, 64).transpose(1, 2).detach()
    qh, kh, vh = (split(t).requires_grad_(need) for t, need in
                  ((q, True), (k, need_kv), (v, need_kv)))
    with torch.enable_grad():
        sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    wanted = [t for t in (qh, kh, vh) if t.requires_grad]
    lib_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, wanted, split(do),
                                                 retain_graph=True))
    products = 5 if need_kv else 3  # QK^T, dO V^T, dS K (+ P^T dO, dS^T Q)
    flops = 2.0 * products * b * s_q * s_k * c
    nbytes = q.element_size() * (3 * b * s_q * c + (2 * b * s_k * c) * (2 if need_kv else 1)
                                 + b * s_q * c)
    return _record("attention_packed_bwd", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms,
                   flops, nbytes, lib_ms) | {"form": form}


def check_pair_bwd(gen, shape, dtype=torch.bfloat16):
    b, f, pdim, c = shape
    heads = c // 64
    p = _cast(_pair_params(gen, c), dtype)
    y = _randn(gen, shape).to(dtype)
    dy = _randn(gen, shape).to(dtype)
    plain = lambda pp, yy, dd: temporal_attention.temporal_attention_pair_bwd_plain(
        pp, yy, dd, heads, 1e-5, frames_major=True)
    fn = lambda: temporal_attention.temporal_attention_pair_bwd(p, y, dy, heads, 1e-5,
                                                                frames_major=True)
    out, form = _launched_form(temporal_attention.temporal_attention_pair_bwd, fn)
    ref = _ref(plain, p, y, dy)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: plain(p, y, dy), 1, 2)
    rows = b * f * pdim
    # The seven projections alone on pre-made operands: [q | k | v] and the
    # output projection of attention 1, [q | k | v] of attention 2, and dO
    # and dz of both VJPs.
    a, a3 = _randn(gen, (rows, c)).to(dtype), _randn(gen, (rows, 3 * c)).to(dtype)
    wq = [torch.cat([p[n][m]["w"] for m in ("to_q", "to_k", "to_v")], 1)
          for n in ("attn1", "attn2")]
    wo = [p[n]["to_out"]["w"] for n in ("attn1", "attn2")]
    products_ms = time_ms(lambda: (
        torch.matmul(a, wq[0]), torch.matmul(a, wo[0]), torch.matmul(a, wq[1]),
        torch.matmul(a, wo[1].t()), torch.matmul(a3, wq[1].t()), torch.matmul(a, wo[0].t()),
        torch.matmul(a3, wq[0].t())))
    del a, a3
    # Forward recompute (qkv1, attn1, out1, qkv2) and two attention VJPs
    # (dO, scores, dV, dP, dQ, dK, dz): 30 C^2 + 24 F C operations a row.
    flops = rows * (30.0 * c * c + 24.0 * f * c)
    nbytes = y.element_size() * (3 * rows * c + 2 * 4 * c * c) + 4.0 * 2 * 3 * c
    rec = _record("temporal_attention_pair_bwd", shape, dtype, out, ref, PAIR_TOL, ms, plain_ms,
                  flops, nbytes) | {"form": form, "products_ms": products_ms}
    if form == "wgmma":  # the first version beside the new form, on the same inputs
        first = lambda: temporal_attention.temporal_attention_pair_bwd(
            p, y, dy, heads, 1e-5, frames_major=True, form="wmma")
        rec |= _first_version(first(), ref, time_ms(first))
    return rec


def check_geglu_bwd(gen, shape, dtype=torch.bfloat16):
    rows, c = shape
    inner = 4 * c
    p = _cast({"proj": _linear_p(gen, c, 2 * inner), "out": _linear_p(gen, inner, c)}, dtype)
    x = _randn(gen, (rows, c)).to(dtype)
    dy = _randn(gen, (rows, c)).to(dtype)
    fn = lambda: geglu_fused.geglu_mlp_bwd(p, x, dy)
    out, form = _launched_form(geglu_fused.geglu_mlp_bwd, fn)
    ref = _ref(geglu_fused.geglu_mlp_bwd_plain, p, x, dy)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: geglu_fused.geglu_mlp_bwd_plain(p, x, dy), 1, 2)
    flops = 10.0 * rows * c * inner  # h, g, d_inner and the two halves of dx
    nbytes = x.element_size() * (3 * rows * c + 3 * c * inner + 2 * inner)
    rec = _record("geglu_mlp_bwd", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms, flops,
                  nbytes) | {"form": form}
    if form == "wgmma":  # the first version beside the new form, on the same inputs
        first = lambda: geglu_fused.geglu_mlp_bwd(p, x, dy, form="wmma")
        rec |= _first_version(first(), ref, time_ms(first))
        rec["copy_ms"] = time_ms(lambda: geglu_fused.interleave_w1(p["proj"]["w"], inner))
    return rec


def _launched(wrapper, fn):
    """Runs fn and raises unless it launched ``wrapper``'s kernel once."""
    before = wrapper.launches
    out = fn()
    if wrapper.launches != before + 1:
        raise RuntimeError(f"{wrapper.__name__}: the call did not launch its kernel")
    return out


def _launched_form(wrapper, fn):
    """``_launched`` for kernels B-D and F-J: (fn's result, the form it
    took)."""
    before = dict(wrapper.launches_by_form)
    out = _launched(wrapper, fn)
    (form,) = [k for k, n in wrapper.launches_by_form.items() if n != before[k]]
    return out, form


def _nchw_conv(x, w, bias=None):
    """F.conv2d on a channels-last view (cuDNN), the yardstick of kernel I."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias, padding=1)


def check_spatial_conv(gen, shape, dtype=torch.bfloat16):
    n, h, w_, cin, cout = shape
    x = _randn(gen, (n, h, w_, cin)).to(dtype)
    a = 1.0 + _randn(gen, (n, cin), 0.1)
    sh = _randn(gen, (n, cin), 0.1)
    w = _randn(gen, (3, 3, cin, cout), (9 * cin) ** -0.5).to(dtype)
    bias = _randn(gen, (cout,), 0.1).to(dtype)
    if not spatial_conv_fused.supported(x, w):
        raise RuntimeError(f"norm_silu_conv2d: {shape} {dtype} is not a routed shape")
    fn = lambda: spatial_conv_fused.norm_silu_conv2d(x, a, sh, w, bias)
    out, form = _launched_form(spatial_conv_fused.norm_silu_conv2d, fn)
    ref = _ref(spatial_conv_fused.norm_silu_conv2d_plain, x, a, sh, w, bias)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: spatial_conv_fused.norm_silu_conv2d_plain(x, a, sh, w, bias),
                       1, 2)
    lib_ms = time_ms(lambda: _nchw_conv(x, w, bias))
    pix = n * h * w_
    flops = 18.0 * pix * cin * cout
    nbytes = x.element_size() * (pix * (cin + cout) + 9 * cin * cout + cout) + 4.0 * 2 * n * cin
    return _record("norm_silu_conv2d", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms, flops,
                   nbytes, lib_ms) | {"form": form}


def check_conv3x3(gen, shape, dtype=torch.bfloat16):
    n, h, w_, cin, cout = shape
    x = _randn(gen, (n, h, w_, cin)).to(dtype)
    w = _randn(gen, (3, 3, cin, cout), (9 * cin) ** -0.5).to(dtype)
    if not conv3x3.supported(x, w):
        raise RuntimeError(f"conv3x3: {shape} {dtype} is not a routed shape")
    fn = lambda: conv3x3.conv3x3(x, w)
    out, form = _launched_form(conv3x3.conv3x3, fn)
    ref = _ref(conv3x3.conv3x3_plain, x, w)
    ms = time_ms(fn)
    plain_ms = time_ms(lambda: conv3x3.conv3x3_plain(x, w), 1, 2)
    lib_ms = time_ms(lambda: _nchw_conv(x, w))
    pix = n * h * w_
    flops = 18.0 * pix * cin * cout
    nbytes = x.element_size() * (pix * (cin + cout) + 9 * cin * cout)
    return _record("conv3x3", shape, dtype, out, ref, DEFAULT_TOL, ms, plain_ms, flops, nbytes,
                   lib_ms) | {"form": form}


def check_linear(gen, shape, dtype=torch.bfloat16, dx=True):
    """The forward projection and, with ``dx``, the dx call of its backward
    (W read transposed), each a record of kernel H."""
    rows, c, n = shape
    x = _randn(gen, (rows, c)).to(dtype)
    w = _randn(gen, (c, n), c ** -0.5).to(dtype)
    b = _randn(gen, (n,), 0.1).to(dtype)
    dy = _randn(gen, (rows, n)).to(dtype)
    item = x.element_size()
    fwd = lambda: linear_fused.linear_rows(x, w, b)
    out, form = _launched_form(linear_fused.linear_rows, fwd)
    ref = _ref(linear_fused.linear_plain, x, w, b)
    records = [_record(
        "linear", shape, dtype, out, ref, DEFAULT_TOL, time_ms(fwd),
        time_ms(lambda: linear_fused.linear_plain(x, w, b), 1, 2), 2.0 * rows * c * n,
        item * (rows * c + c * n + n + rows * n), time_ms(lambda: torch.addmm(b, x, w)))
        | {"form": form}]
    if not dx:
        return records
    bwd = lambda: linear_fused.linear_rows(dy, w, None, trans_w=True)
    out, form = _launched_form(linear_fused.linear_rows, bwd)
    ref = _ref(lambda dd, ww: linear_fused.linear_plain(dd, ww.transpose(0, 1)), dy, w)
    records.append(_record(
        "linear", [rows, n, c, "dx"], dtype, out, ref, DEFAULT_TOL, time_ms(bwd),
        time_ms(lambda: linear_fused.linear_plain(dy, w.transpose(0, 1)), 1, 2),
        2.0 * rows * c * n, item * (rows * n + c * n + rows * c),
        time_ms(lambda: torch.matmul(dy, w.transpose(0, 1)))) | {"form": form})
    return records


def check_linear_forward(gen, shape, dtype=torch.bfloat16):
    """Kernel H's forward projection alone (a path with no backward)."""
    return check_linear(gen, shape, dtype, dx=False)


def check_sdpa(gen, shape, dtype=torch.bfloat16):
    """The public sdpa() with long keys, forward (kernel A, one head) and
    backward (kernel E), through autograd, each in the form ``launch_plan``
    gives (the record fails otherwise); at D = 192 and 256 also A's and E's
    D-sliced form on the same inputs (``first_ms``, ``first_rel_err``), E's
    from the wide forward's log-sum-exp."""
    b, h, s, d = shape
    q, k, v = (_randn(gen, shape).to(dtype).requires_grad_(True) for _ in range(3))
    do = _randn(gen, shape).to(dtype)
    scale = d ** -0.5
    flat = lambda t: t.detach().reshape(b * h, s, d)
    with torch.no_grad():
        out, form = _launched_form(packed_attention.attention_packed,
                                   lambda: attention.sdpa(q, k, v)[0])
    with torch.enable_grad():
        o_graph = attention.sdpa(q, k, v)[0]
    grads, bwd_form = _launched_form(
        packed_attention.attention_packed_bwd,
        lambda: torch.autograd.grad(o_graph, (q, k, v), do, retain_graph=True))
    ref_o = _ref(packed_attention.attention_packed_plain, flat(q), flat(k), flat(v), scale, 1)
    ref_g = _ref(packed_attention.attention_packed_bwd_plain, flat(q), flat(k), flat(v),
                 flat(o_graph), flat(do), scale, 1)
    item = q.element_size()
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: attention.sdpa(qd, kd, vd))
        plain_ms = time_ms(lambda: packed_attention.attention_packed_plain(
            flat(q), flat(k), flat(v), scale, 1), 1, 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, scale=scale))
    fwd = _record("sdpa", shape, dtype, out.reshape(b * h, s, d), ref_o, DEFAULT_TOL, fwd_ms,
                  plain_ms, 4.0 * b * h * s * s * d, item * 4 * b * h * s * d,
                  lib_ms) | {"form": form}
    bwd_ms = time_ms(lambda: torch.autograd.grad(o_graph, (q, k, v), do, retain_graph=True))
    plain_bwd_ms = time_ms(lambda: packed_attention.attention_packed_bwd_plain(
        flat(q), flat(k), flat(v), flat(o_graph), flat(do), scale, 1), 1, 2)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                     retain_graph=True))
    bwd = _record(
        "sdpa_bwd", shape, dtype, tuple(g.reshape(b * h, s, d) for g in grads), ref_g,
        DEFAULT_TOL, bwd_ms, plain_bwd_ms, 10.0 * b * h * s * s * d, item * 8 * b * h * s * d,
        lib_bwd_ms) | {"form": bwd_form}
    want = packed_attention.launch_plan(d)["form"]
    for rec in (fwd, bwd):
        rec["ok"] = rec["ok"] and rec["form"] == want
    if want == "wide":  # the D-sliced form on the same inputs
        args = (flat(q), flat(k), flat(v))
        first = lambda: packed_attention._launch_forward(*args, scale, 1, False, "sliced")[0]
        fwd |= _first_version(first(), ref_o, time_ms(first))
        o, lse = packed_attention.attention_packed_with_lse(*args, scale, 1)
        first_bwd = lambda: packed_attention.attention_packed_bwd(
            *args, o, flat(do), scale, 1, lse=lse, form="sliced")
        bwd |= _first_version(first_bwd(), ref_g, time_ms(first_bwd))
    return [fwd, bwd]


def _norm_record(name, shape, dtype, out, ref, ms, plain_ms, ops, nbytes, library_ms, form,
                 tol=NORM_TOL):
    """A record of kernels K-M: their gates (``tol`` in the half types,
    NORM_FP32_TOL), their operations on the CUDA cores."""
    return _record(name, shape, dtype, out, ref, tol, ms, plain_ms, ops, nbytes,
                   library_ms, peak=PEAK_SIMT_FLOPS, fp32_tol=NORM_FP32_TOL) | {"form": form}


def _gn_inputs(gen, shape, dtype):
    """x (N, R, C) with a non-zero mean, as activations carry, and norm params."""
    return (_randn(gen, shape) + 0.5).to(dtype), _cast(_norm_p(gen, shape[-1]), dtype)


def _group_norm_library(x, p, groups, silu=False):
    """F.group_norm on a channels-first view of x (N, R, C) (then F.silu):
    statistics and apply, K + L's work, set beside L; the port never calls
    it."""
    n, r, c = x.shape
    y = F.group_norm(x.view(n, r, 1, c).permute(0, 3, 1, 2), groups, p["scale"], p["bias"], 1e-5)
    return F.silu(y) if silu else y


def check_gn_stats(gen, shape, dtype=torch.bfloat16):
    """Kernel K's ``coeffs`` form at (N, R, C), 32 groups."""
    n, r, c = shape
    groups, item = 32, torch.finfo(dtype).bits // 8
    x, p = _gn_inputs(gen, shape, dtype)
    count = r * (c // groups)
    fn = lambda: norms.group_norm_stats(x, p["scale"], p["bias"], groups, 1e-5, count)
    out, form = _launched_form(norms.group_norm_stats, fn)
    plain = lambda xx, pp: norms.group_norm_coeffs_plain(pp, xx, groups, 1e-5,
                                                         count_override=count)
    rec = _norm_record(
        "group_norm_stats", shape, dtype, out, _ref(plain, x, p), time_ms(fn),
        time_ms(lambda: plain(x, p), 1, 2), 3.0 * x.numel(),
        x.numel() * item + 2 * c * item + 8.0 * n * c,
        time_ms(lambda: torch.var_mean(x.view(n, r, groups, c // groups), dim=(1, 3),
                                       correction=0)),
        form, tol=NORM_STATS_TOL)
    # K's output is fp32 from the same values in either type: its fp32
    # reading is held to its own gate, not below the bf16 one.
    rec["below_bf16"] = False
    return rec


def check_gn_apply(gen, shape, dtype=torch.bfloat16, silu=False):
    """Kernel L at (N, R, C), form ``affine`` or (``silu``) ``affine_silu``."""
    n, r, c = shape
    x, p = _gn_inputs(gen, shape, dtype)
    a, b = 1.0 + _randn(gen, (n, c), 0.1), _randn(gen, (n, c), 0.1)
    fn = lambda: norms.group_norm_apply(x, a, b, silu)
    out, form = _launched_form(norms.group_norm_apply, fn)
    plain = lambda xx, aa, bb: norms.group_norm_apply_plain(xx, aa, bb, silu)
    return _norm_record(
        "group_norm_apply", [*shape, form], dtype, out, _ref(plain, x, a, b), time_ms(fn),
        time_ms(lambda: plain(x, a, b), 1, 2), (6.0 if silu else 2.0) * x.numel(),
        2.0 * x.numel() * x.element_size() + 8.0 * n * c,
        time_ms(lambda: _group_norm_library(x, p, 32, silu)), form)


def check_gn_apply_silu(gen, shape, dtype=torch.bfloat16):
    return check_gn_apply(gen, shape, dtype, silu=True)


def check_layer_norm(gen, shape, dtype=torch.bfloat16):
    """Kernel M's ``affine`` form at (rows, C)."""
    rows, c = shape
    x, p = _gn_inputs(gen, shape, dtype)
    fn = lambda: norms.layer_norm_rows(x, p["scale"], p["bias"], 1e-5)
    out, form = _launched_form(norms.layer_norm_rows, fn)
    return _norm_record(
        "layer_norm_rows", shape, dtype, out, _ref(norms.layer_norm_plain, p, x, 1e-5),
        time_ms(fn), time_ms(lambda: norms.layer_norm_plain(p, x, 1e-5), 1, 2),
        8.0 * x.numel(), (2.0 * x.numel() + 2 * c) * x.element_size(),
        time_ms(lambda: F.layer_norm(x, (c,), p["scale"], p["bias"], 1e-5)), form)


def _gn_bwd_library(x, dy, p, groups):
    """aten's GroupNorm backward (dx alone) on channels-first contiguous
    copies of x and dy (N, R, C), with its forward's mean and rstd, all made
    here, outside the timed call; the port never calls it."""
    n, r, c = x.shape
    xc, dyc = (t.permute(0, 2, 1).contiguous() for t in (x, dy))
    _, mean, rstd = torch.ops.aten.native_group_norm(xc, p["scale"], p["bias"], n, c, r,
                                                     groups, 1e-5)
    return lambda: torch.ops.aten.native_group_norm_backward(
        dyc, xc, mean, rstd, p["scale"], n, c, r, groups, [True, False, False])


def _kept(outs):
    return tuple(o for o in outs if o is not None)


def _norm_bwd_gates(rec, out, ref):
    """In fp32, N's and O's dx within NORM_FP32_TOL and their other outputs
    (dscale and dbias, or the cotangents of (a, b): sums over N or the
    rows) within NORM_PARAMS_FP32_TOL (``rel_errs``, one an output)."""
    if rec["dtype"] != "float32" or len(out) == 1:
        return rec
    rels = [_rel_err(o, r)[1] for o, r in zip(out, ref)]
    finite = all(torch.isfinite(o).all().item() for o in out)
    return rec | {"rel_errs": rels, "tol": NORM_PARAMS_FP32_TOL,
                  "ok": bool(finite and rels[0] <= NORM_FP32_TOL
                             and max(rels[1:]) <= NORM_PARAMS_FP32_TOL)}


def in_type_reading(got, want, addends, groups=32):
    """``got`` (N, R, C) against ``want``, the plain version run in the same
    half type on the same inputs, where it rounds where the kernel rounds:
    the largest difference in ulps of the type at the largest of the
    ``addends`` (the rounded terms ``want`` adds at each element), and
    ``bits_differ``, the median over (sample, group of C / groups channels)
    of the share of elements whose bits differ. Where the two differ only in
    the order of an fp32 sum, a flipped rounding moves the elements of a few
    channels or groups by a few ulps (more where a group's sum cancels), and
    in most groups no bit differs; a term rounded elsewhere moves a share of
    every group (tests/test_torch_norms.py)."""
    big = torch.stack(torch.broadcast_tensors(*(t.float().abs() for t in addends))).amax(0)
    # |v| in [2^(e-1), 2^e) has the ulp eps 2^(e-1)
    eps = torch.full_like(big, torch.finfo(got.dtype).eps)
    ulp = torch.ldexp(eps, torch.frexp(big).exponent - 1)
    ulps = ((got.float() - want.float()).abs() / ulp).max().item()
    n, r, c = got.shape
    differ = (got != want).view(n, r, groups, c // groups).float().mean(dim=(1, 3))
    return ulps, differ.median().item()


def gn_bwd_in_type(form, x, *, dy=None, a=None, b=None, da=None, db=None, scale=None,
                   stats=None, count=1, ds=None):
    """Kernel N's dx in ``form`` (its arguments) by the plain pieces in x's
    type, and the rounded terms it adds (``in_type_reading``'s addends)."""
    terms = ()
    if form == "sums":
        ds1, ds2 = ds
    elif form == "coeffs":
        ds1, ds2 = norms.group_coeffs_sums_bwd_plain(da, db, scale, stats, count)
    else:
        dx_l, da, db = norms.group_norm_apply_bwd_plain(x, dy, a, b, form.endswith("silu"))
        terms = (dx_l,)
        if form in ("apply", "apply_silu"):
            return dx_l, terms
        ds1, ds2 = norms.group_coeffs_sums_bwd_plain(da, db, scale, stats, count)
    t1, t2 = norms.group_sums_bwd_terms(x, ds1, ds2)
    dx = t1 + t2
    return (terms[0] + dx if terms else dx), terms + (t1, t2)


def check_gn_bwd(gen, shape, dtype=torch.bfloat16, form="affine"):
    """Kernel N at (N, R, C), 32 groups, in ``form``, on K's saved
    statistics: against the plain backward on fp32 copies, dx alone in bf16
    (the guided update), with dscale and dbias in fp32 in the ``affine`` and
    ``coeffs`` forms (the train step), the cotangents of (a, b) in the
    ``apply`` forms (the frame-sharded path). In bf16 dx is also held to
    the plain version run in bf16 (``in_type_reading``: ``ulps`` and
    ``bits_differ``, the second gated)."""
    n, r, c = shape
    groups, item = 32, torch.finfo(dtype).bits // 8
    apply_only = form in ("apply", "apply_silu")
    params = dtype == torch.float32 and form in ("affine", "affine_silu", "coeffs")
    x, p = _gn_inputs(gen, shape, dtype)
    count = r * (c // groups)
    a, b, stats = norms.group_norm_stats(x, p["scale"], p["bias"], groups, 1e-5, count,
                                         stats=True)
    dy = da = db = ds = library_ms = None
    kw = {"scale": p["scale"], "stats": stats, "count": count}
    if form == "coeffs":
        da, db = _randn(gen, (n, c)), _randn(gen, (n, c))
        kw |= {"da": da, "db": db}
        plain = lambda xx, dd, pp, st: norms.group_norm_coeffs_bwd_plain(
            xx, da, db, pp["scale"], st, count, params)
        ops, nbytes = 4.0, 2.0 * x.numel() * item
    elif form == "sums":
        ds = _randn(gen, (2, n, groups), 1e-3)
        kw = {"ds": ds}
        plain = lambda xx, dd, pp, st: (norms.group_sums_bwd_plain(xx, ds[0], ds[1]),)
        ops, nbytes = 3.0, 2.0 * x.numel() * item
    else:
        dy = (_randn(gen, shape) + NORM_BWD_DY_MEAN).to(dtype)
        kw = {"dy": dy, "a": a, "b": b} | ({} if apply_only else kw)
        silu = form.endswith("silu")
        if apply_only:
            plain = lambda xx, dd, pp, st: norms.group_norm_apply_bwd_plain(xx, dd, a, b, silu)
        else:
            plain = lambda xx, dd, pp, st: norms.group_norm_bwd_plain(
                xx, dd, a, b, pp["scale"], st, count, silu, params)
        ops, nbytes = (30.0 if silu else 10.0), 3.0 * x.numel() * item
        if form == "affine":
            library_ms = time_ms(_gn_bwd_library(x, dy, p, groups))
    fn = lambda: norms.group_norm_bwd(form, x, params=params, **kw)
    out, launched = _launched_form(norms.group_norm_bwd, fn)
    out, ref = _kept(out), _kept(_ref(plain, x, dy, p, stats))
    rec = _norm_bwd_gates(_norm_record(
        "group_norm_bwd", [*shape, launched], dtype, out, ref, time_ms(fn),
        time_ms(lambda: plain(x, dy, p, stats), 1, 2), ops * x.numel(),
        nbytes + 16.0 * n * c, library_ms, launched, tol=NORM_BWD_TOL), out, ref)
    if dtype != torch.float32:
        want, addends = gn_bwd_in_type(form, x, **kw)
        rec["ulps"], rec["bits_differ"] = in_type_reading(out[0], want, addends)
        rec["ok"] = bool(rec["ok"] and rec["bits_differ"] <= NORM_BWD_BITS_DIFFER)
    return rec | {"params": params}


def check_gn_bwd_silu(gen, shape, dtype=torch.bfloat16):
    return check_gn_bwd(gen, shape, dtype, "affine_silu")


def check_gn_bwd_coeffs(gen, shape, dtype=torch.bfloat16):
    return check_gn_bwd(gen, shape, dtype, "coeffs")


def check_gn_bwd_sums(gen, shape, dtype=torch.bfloat16):
    return check_gn_bwd(gen, shape, dtype, "sums")


def check_gn_bwd_apply(gen, shape, dtype=torch.bfloat16):
    return check_gn_bwd(gen, shape, dtype, "apply")


def check_gn_bwd_apply_silu(gen, shape, dtype=torch.bfloat16):
    return check_gn_bwd(gen, shape, dtype, "apply_silu")


def check_ln_bwd(gen, shape, dtype=torch.bfloat16):
    """Kernel O at (rows, C) on M's saved statistics: ``dx`` in bf16,
    ``dx_params`` in fp32, against the plain backward on fp32 copies, and
    aten's LayerNorm backward (dx alone) as the library call."""
    rows, c = shape
    params = dtype == torch.float32
    x, p = _gn_inputs(gen, shape, dtype)
    dy = _randn(gen, shape).to(dtype)
    _, stats = norms.layer_norm_rows(x, p["scale"], p["bias"], 1e-5, stats=True)
    fn = lambda: norms.layer_norm_bwd(x, dy, p["scale"], stats, params)
    out, launched = _launched_form(norms.layer_norm_bwd, fn)
    plain = lambda xx, dd, pp, st: norms.layer_norm_bwd_plain(xx, dd, pp["scale"], st, params)
    out, ref = _kept(out), _kept(_ref(plain, x, dy, p, stats))
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, (c,), p["scale"], p["bias"], 1e-5)
    library = lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, (c,), mean, rstd, p["scale"], p["bias"], [True, False, False])
    rec = _norm_bwd_gates(_norm_record(
        "layer_norm_bwd", [*shape, launched], dtype, out, ref, time_ms(fn),
        time_ms(lambda: plain(x, dy, p, stats), 1, 2), 12.0 * x.numel(),
        3.0 * x.numel() * x.element_size() + 12.0 * rows, time_ms(library), launched,
        tol=NORM_BWD_TOL), out, ref)
    return rec | {"params": params}


NORM_PLAN = ([(check_gn_stats, s) for s in NORM_GN_SHAPES]
             + [(check_gn_apply, s) for s in NORM_GN_SHAPES]
             + [(check_gn_apply_silu, s) for s in NORM_GN_SHAPES]
             + [(check_layer_norm, s) for s in NORM_LN_SHAPES]
             + [(check_gn_bwd, NORM_BWD_GN_SHAPES[0])]
             + [(check_gn_bwd_silu, s) for s in NORM_BWD_GN_SHAPES]
             + [(check_gn_bwd_coeffs, s) for s in NORM_BWD_COEFFS_SHAPES]
             + [(fn, NORM_BWD_SHARD_SHAPE) for fn in (check_gn_bwd_sums, check_gn_bwd_apply,
                                                      check_gn_bwd_apply_silu)]
             + [(check_ln_bwd, s) for s in NORM_BWD_LN_SHAPES])


BF16_PLAN = ([(check_attention, s) for s in ATTN_SHAPES + FUSER_ATTN_SHAPES]
             + [(check_pair, s) for s in PAIR_SHAPES]
             + [(check_geglu, s) for s in GEGLU_SHAPES]
             + [(check_temp_conv, s) for s in TCONV_SHAPES]
             + [(check_attention_bwd, s) for s in ATTN_BWD_SHAPES]
             + [(check_pair_bwd, s) for s in PAIR_BWD_SHAPES]
             + [(check_geglu_bwd, s) for s in GEGLU_BWD_SHAPES]
             + [(check_linear, s) for s in LINEAR_SHAPES]
             + [(check_spatial_conv, s) for s in SCONV_SHAPES]
             + [(check_conv3x3, s) for s in CONV3X3_SHAPES]
             + [(check_sdpa, s) for s in SDPA_SHAPES]
             + [(check_geglu_stream, s) for s in GEGLU_STREAM_SHAPES]
             + [(check_attention, s) for s in XL_ATTN_SHAPES + SDXL_ATTN_SHAPES]
             + [(check_spatial_conv, s) for s in SDXL_SCONV_SHAPES]
             + [(check_linear_forward, s) for s in SDXL_LINEAR_SHAPES]
             + [(check_pair, s) for s in XL_PAIR_SHAPES + TRAIN_PAIR_SHAPES]
             + [(check_geglu, s) for s in XL_GEGLU_SHAPES]
             + [(check_temp_conv, s) for s in XL_TCONV_SHAPES + C4_TCONV_SHAPES]
             + NORM_PLAN)
# Each kernel in fp32 at its first (largest) path shape, kernel A also at the
# fuser's L0 shape, sdpa() at every head dim, and kernel J at its fp32 shapes.
FP32_PLAN = [(fn, shapes[0]) for fn, shapes in (
    (check_attention, ATTN_SHAPES), (check_pair, PAIR_SHAPES), (check_geglu, GEGLU_SHAPES),
    (check_temp_conv, TCONV_SHAPES), (check_attention_bwd, ATTN_BWD_SHAPES),
    (check_pair_bwd, PAIR_BWD_SHAPES), (check_geglu_bwd, GEGLU_BWD_SHAPES),
    (check_linear, LINEAR_SHAPES), (check_spatial_conv, SCONV_SHAPES),
    (check_conv3x3, CONV3X3_SHAPES), (check_attention, FUSER_ATTN_SHAPES))] + [
    (check_sdpa, s) for s in SDPA_SHAPES] + [
    (check_geglu_stream, s) for s in GEGLU_STREAM_FP32_SHAPES] + [
    (check_temp_conv, s) for s in C4_TCONV_FP32_SHAPES] + [
    (check_pair, s) for s in TRAIN_PAIR_SHAPES] + [
    (check_pair_bwd, TRAIN_PAIR_SHAPES[1]), (check_geglu_bwd, TRAIN_GEGLU_SHAPES[1])] + [
    (check_geglu, s) for s in TRAIN_GEGLU_SHAPES] + NORM_PLAN
PLAN = ([(fn, s, torch.bfloat16) for fn, s in BF16_PLAN]
        + [(fn, s, torch.float32) for fn, s in FP32_PLAN])


def main(argv=None) -> int:
    """``python -m lvd_tpu_torch.ops.selfcheck [--only check_temp_conv ...]``:
    the checks of PLAN whose function is named in --only (every check
    without it), one JSON line each. Exit 0 iff every check passed."""
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--only", nargs="*", default=None)
    args = parser.parse_args(argv)
    plan = [c for c in PLAN if args.only is None or c[0].__name__ in args.only]
    records = run(plan=plan)
    return 0 if all(r["ok"] for r in records) else 1


def run(seed: int = 0, emit=print, plan=None):
    """Runs every check of ``plan`` (default PLAN, every bf16 check before
    the fp32 ones); returns the list of records (one per shape, type and
    call), each emitted as a JSON line. An fp32 record also carries the same
    check's bf16 reading and fails unless it lies below it (unless the
    record says ``below_bf16`` False: kernel K, whose output is fp32 in
    either type)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    records = []
    bf16 = {}
    for fn, shape, dtype in (PLAN if plan is None else plan):
        recs = fn(gen, shape, dtype)
        torch.cuda.synchronize()
        for rec in recs if isinstance(recs, list) else [recs]:
            key = (rec["name"], str(rec["shape"]))
            if dtype == torch.bfloat16:
                bf16[key] = rec["rel_err"]
            elif key in bf16:
                rec["bf16_rel_err"] = bf16[key]
                if rec.get("below_bf16", True):
                    rec["ok"] = bool(rec["ok"] and rec["rel_err"] < bf16[key])
            records.append(rec)
            emit(json.dumps(rec))
        torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    raise SystemExit(main())
