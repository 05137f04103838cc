#!/usr/bin/env python3
"""Chip smoke for lvd_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device  - the card's name and power limit;
  2. build   - nvcc builds lvd_tpu_torch/csrc/*.cu, one process per source,
               all started together, then one link (seconds and the -Xptxas
               -v register / shared-memory / spill lines, one record of
               registers and spills per kernel A and E instantiation, and
               their dynamic shared memory per block);
  3. kernels - every kernel at every shape the Zeroscope path gives it, in
               bf16, against its plain PyTorch version on fp32 copies, and
               each kernel in fp32 at its largest shape against the plain
               version in fp32 with TF32 off (gate 5e-3 and below the bf16
               reading) (lvd_tpu_torch.ops.selfcheck), timed with CUDA
               events: the forwards A-D and I (resnet convs, row 12) at the
               CFG forward's shapes, H (projections, row 14) at the q/k/v/out
               and text k/v shapes, the backwards E-G at the guided energy
               walk's, and the public entry points sdpa() (A and E with one
               head, row 1, D = 64 to 256), conv3x3() (I without prologue,
               row 13) and geglu_mlp() where it streams (J, row 9);
  4. reference - one full-width CFG UNet forward through the kernels (bf16)
               against the plain path (fp32) on the same inputs, with weights
               whose attention/FF/temporal-conv branches are not zero-init,
               so every kernel's output reaches the noise prediction; the
               plain path in bf16 is printed beside it as the yardstick of
               what bf16 rounding alone costs;
  5. gradient - one full-width guided energy gradient d(energy)/d(latents)
               through the kernels (bf16) against the plain path (fp32), on
               the same inputs and weights, gated on the max-element and the
               L2 ratio, with the plain path in bf16 printed beside it; a
               walk whose kernel branches are cut out of the gradient must
               fail both gates;
  6. generation - unguided Zeroscope text-to-video at full width (all UNet,
               CLIP and VAE widths, 24 frames, 576x320, CFG 9.0) from seeded
               random bf16 weights, 4 DPM-Solver++ steps, through the entry
               points a user calls; launch counts are zeroed just before and
               read just after, and every forward kernel A-D must have run;
  7. guided generation - the flagship layout (one box moving left to right)
               and GuidanceConfig through the same entry point with
               ``backward_guidance``, 4 steps with guidance on the first 2;
               every kernel A-G must have run;
  8. certification - guidance_effect at full width, 16 guided updates at
               the first timestep: the in-box attention share must rise by
               more than lvd_tpu's flagship gate (gain > 1.004) and the
               attention's CoM must move toward the box;
  9. knobs   - a child process of this script with lvd_tpu's two opt-in
               switches set (LVD_ENABLE_FUSED_SC=1 LVD_FUSED_LINEAR=1; the
               second is read at import): phases 4 and 5 again, now with the
               resnet convs on kernel I and the projections on kernel H, and
               the guided generation of phase 7, which is this slice's main
               path: every kernel A-I must have run. A non-zero exit of the
               child fails the smoke;
 10. fp32    - one full-width CFG UNet forward in TextToVideoPipeline's
               default type (fp32) through the kernels against the plain
               path in fp32, TF32 off on both;
 11. entry points - the public sdpa() (forward and backward) at D = 64
               (L0 shape), 192 and 256 (the D-sliced A and E), conv3x3() at
               L0, and geglu_mlp() with the seeded UNet's feed-forward
               weights where lvd_tpu streams them (C = 1280 block at
               (8640, 1280) in bf16, C = 640 block at (34560, 640) in fp32),
               forward and dx through autograd, each against its plain
               version on fp32 copies; counts zeroed just before and read
               just after: kernels A, E, I and J (twice) must have run, and
               G must not (lvd_tpu's dx there is the stock VJP);
 12. profile - one CFG UNet forward and one guided update under
               torch.profiler: device time per kernel and for the stock ops,
               and the device's idle share.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1 and
prints no result.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

NUM_STEPS = 4           # denoising steps driven here (the preset runs 40)
# max|kernels(bf16) - plain(fp32)| / max|plain(fp32)| of the UNet forward. On
# an H100 the kernel path read 1.73e-2; the limit leaves room for seeds and
# cards, and is far below a wrong kernel (readings in PERF.md, Findings).
REFERENCE_TOL = 5e-2
# max|kernels(bf16) - plain(fp32)| / max|plain(fp32)| of the guided energy's
# gradient with respect to the latents. On an H100 the kernel path read
# 0.099, the plain path in bf16 0.141 (bf16 rounding alone: the top-k
# selections of the energy flip near their thresholds) and a walk with the
# kernel branches cut out of the gradient 1.015; the gate sits between
# (readings in PERF.md, Findings).
GRADIENT_TOL = 0.3
# |kernels(bf16) - plain(fp32)| / |plain(fp32)| (L2) of the same gradient,
# which near-threshold top-k flips move far less than the max-element ratio.
# On an H100 the kernel path read 0.076, the plain path in bf16 0.086 and
# the walk with the kernel branches cut out 0.982. That walk must exceed
# both gates, so every run shows that they catch a broken gradient.
GRADIENT_L2_TOL = 0.2
# max|kernels(fp32) - plain(fp32)| / max|plain(fp32)| of the UNet forward in
# the pipeline's default type, TF32 off outside the kernels. On an H100 the
# kernel path (TF32 products inside the kernels) read 5.8e-4; the gate is the
# kernels' own fp32 gate, far below the bf16 path's 1.7e-2, so a kernel that
# rounded fp32 to bf16 would fail it (readings in PERF.md, Findings).
FP32_REFERENCE_TOL = 5e-3
# lvd_tpu's two opt-in switches, set for the knob phase's child process.
KNOBS = {"LVD_ENABLE_FUSED_SC": "1", "LVD_FUSED_LINEAR": "1"}
# lvd_tpu's flagship certification gate (bench.py, certify).
CERT_MIN_GAIN = 1.004
CERT_ITERS = 16
GUIDED_STEPS, GUIDED_INDEX_STEP = 4, 2  # guided generation: guidance on steps 0 and 1
FLAG_PROMPT = "A bear walks from the left to the right, forest background"


def log(msg):
    print(msg, flush=True)


def device_phase(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch.cuda: {name}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return name


def build_phase():
    from lvd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] nvcc {_build.build_info['seconds']} s (library ready after "
        f"{time.perf_counter() - t0:.2f} s): {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    for rec in ptxas_summary(_build.build_info["log"], ("packed_attention.cu",
                                                        "packed_attention_bwd.cu")):
        log(f"[build] ptxas A/E {json.dumps(rec)}")
    lib = _build.lib()
    smem = {}
    for dtype, code in (("bf16", 0), ("fp32", 1)):
        for d, form in ((64, "D64"), (128, "D128"), (192, "sliced")):
            smem[f"A {dtype} {form}"] = lib.lvd_attention_packed_smem(d, code)
            smem[f"E dkdv {dtype} {form}"] = lib.lvd_attention_packed_bwd_smem(d, code, 0)
            smem[f"E dq {dtype} {form}"] = lib.lvd_attention_packed_bwd_smem(d, code, 1)
    log(f"[build] A/E dynamic shared memory per block (bytes): {json.dumps(smem)}")


def ptxas_summary(build_log, sources):
    """Registers and spill bytes of every kernel that nvcc -Xptxas -v
    reported for the given sources, one record per kernel."""
    import re

    records, source, rec = [], None, None
    for line in build_log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
            continue
        if source not in sources:
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            short = re.search(r"attn_[a-z0-9_]+(I[^E]*E)?", name)  # identifier, template args
            rec = {"source": source, "kernel": name if short is None else short.group(0)}
            records.append(rec)
        elif rec is not None and "spill stores" in line:
            nums = [int(n) for n in re.findall(r"(\d+) bytes", line)]
            rec["stack_bytes"], rec["spill_store_bytes"], rec["spill_load_bytes"] = nums[:3]
        elif rec is not None and "Used" in line and "registers" in line:
            rec["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return records


def kernel_phase():
    from lvd_tpu_torch.ops import selfcheck

    records = selfcheck.run(seed=0, emit=lambda line: log(f"[kernel] {line}"))
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise SystemExit(f"[kernel] {len(bad)} kernel checks failed: "
                         f"{[(r['name'], r['shape'], r['rel_err']) for r in bad]}")
    return records


def flagship_guidance(frames=24):
    """bench.py's flagship layout and GuidanceConfig: one box moving left to
    right, token 2 ("bear"), the six instrumented sites."""
    from lvd_tpu_torch.diffusion.guidance import OVERALL_GUIDANCE_ATTN_KEYS, GuidanceConfig

    move = lambda f: 0.8 * f / max(frames - 1, 1)
    boxes = [[[0.05 + move(f), 0.45, 0.30 + move(f), 0.80] for f in range(frames)]]
    cfg = GuidanceConfig(loss_scale=2.5, loss_threshold=350.0, max_iter=1, max_index_step=10,
                         fg_top_p=0.25, bg_top_p=0.25, fg_weight=1.0, bg_weight=2.0)
    return {"boxes": boxes, "object_positions": [[2]], "config": cfg,
            "attn_keys": OVERALL_GUIDANCE_ATTN_KEYS}


def guidance_tensors(guide, latent_hw=(40, 72)):
    from lvd_tpu_torch.diffusion.sampler import pack_to_tensors
    from lvd_tpu_torch.layout.rasterize import make_guidance_pack

    cfg = guide["config"]
    pack = make_guidance_pack(guide["boxes"], guide["object_positions"], guide["attn_keys"],
                              latent_hw, fg_top_p=cfg.fg_top_p, bg_top_p=cfg.bg_top_p)
    return pack_to_tensors(pack, "cuda")


def seeded_latents(torch, seed=0):
    """The pipeline's seeded noise (jax.random.normal's) for 24 x 576x320."""
    from lvd_tpu_torch.utils import prng

    return torch.from_numpy(prng.normal(seed, (1, 24, 40, 72, 4))).cuda()


def _undegenerate(tree, gen, torch):
    """Gives every zero-init or 1e-5-scaled projection (transformer proj_out,
    the last temporal conv) a normal * fan_in^-1/2 weight, so the kernels'
    branches are not multiplied away before the output."""
    if isinstance(tree, list):
        return [_undegenerate(v, gen, torch) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("proj_out", "conv4") and isinstance(v, dict):
            v = dict(v)
            leaf = v if k == "proj_out" else dict(v["conv"])
            w = leaf["w"]
            fan_in = w[..., 0].numel()
            leaf["w"] = (torch.randn(w.shape, generator=gen, device=w.device)
                         * fan_in ** -0.5).to(w.dtype)
            if k == "conv4":
                v["conv"] = leaf
            out[k] = v
        else:
            out[k] = _undegenerate(v, gen, torch)
    return out


def _linear_rows_plain(x, w, b=None, trans_w=False):
    from lvd_tpu_torch.ops import linear_fused

    return linear_fused.linear_plain(x, w.transpose(0, 1) if trans_w else w, b)


@contextlib.contextmanager
def plain_route():
    """Points every kernel wrapper the UNet calls at its plain PyTorch
    version, for the reference forward only (the wrappers themselves run the
    plain version for CPU tensors alone)."""
    from lvd_tpu_torch.ops import geglu_fused, linear_fused, packed_attention
    from lvd_tpu_torch.ops import spatial_conv_fused, temp_conv_fused, temporal_attention

    swaps = [
        (packed_attention, "attention_packed", packed_attention.attention_packed_plain),
        (temporal_attention, "temporal_attention_pair",
         temporal_attention.temporal_attention_pair_plain),
        (geglu_fused, "geglu_mlp", geglu_fused.geglu_mlp_plain),
        (temp_conv_fused, "norm_silu_temporal_conv",
         temp_conv_fused.norm_silu_temporal_conv_plain),
        (spatial_conv_fused, "norm_silu_conv2d", spatial_conv_fused.norm_silu_conv2d_plain),
        (linear_fused, "linear_rows", _linear_rows_plain),
    ]
    with _swapped([(module, name, plain) for module, name, plain in swaps]):
        yield


@contextlib.contextmanager
def _swapped(swaps):
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    for module, name, fn in swaps:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, wrapper in saved:
            setattr(module, name, wrapper)


@contextlib.contextmanager
def detached_route():
    """Cuts each forward kernel's branch out of the gradient (its autograd
    Function passes no gradient back), as a kernel wrapper outside autograd
    would: the reading of a broken gradient, beside which the gate is set."""
    from lvd_tpu_torch.ops import geglu_fused, linear_fused, packed_attention
    from lvd_tpu_torch.ops import spatial_conv_fused, temp_conv_fused, temporal_attention

    nothing = lambda n: staticmethod(lambda ctx, *grads: (None,) * n)
    with _swapped([(packed_attention.PackedAttention, "backward", nothing(6)),
                   (temporal_attention.TemporalPair, "backward", nothing(5)),
                   (geglu_fused.Geglu, "backward", nothing(2)),
                   (temp_conv_fused.NormSiluTemporalConv, "backward", nothing(5)),
                   (spatial_conv_fused.NormSiluConv2d, "backward", nothing(5)),
                   (linear_fused.LinearCore, "backward", nothing(3))]):
        yield


def reference_phase(torch, models):
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.models.unet3d import apply_unet3d

    cfg = models.preset.unet
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = _undegenerate(models.unet_params, gen, torch)
    sample = torch.randn((2, 24, 40, 72, 4), generator=gen, device="cuda")
    text = torch.randn((2, 77, cfg.cross_attention_dim), generator=gen, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain path in full fp32
    try:
        with torch.no_grad():
            eps = apply_unet3d(params, cfg, sample.bfloat16(), 500, text.bfloat16())
            with plain_route():
                plain = apply_unet3d(params, cfg, sample.bfloat16(), 500, text.bfloat16())
                ref = apply_unet3d(cast_tree(params, torch.float32), cfg, sample, 500, text)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    scale = ref.abs().max().item()
    rel = (eps.float() - ref).abs().max().item() / scale
    rel_plain = (plain.float() - ref).abs().max().item() / scale
    log(f"[reference] full-width CFG UNet forward against the plain path (fp32), "
        f"max|d| / max|ref| (max|ref| {scale:.6g}): kernels (bf16) {rel:.6g} "
        f"(gate {REFERENCE_TOL}); plain path (bf16) {rel_plain:.6g}")
    if not (torch.isfinite(eps).all() and rel <= REFERENCE_TOL):
        raise SystemExit("[reference] the kernel path disagrees with the plain path")
    del eps, plain, ref, params
    torch.cuda.empty_cache()


def gradient_phase(torch, models):
    """d(energy)/d(latents) at full width: kernels (bf16), plain path (fp32
    reference, and bf16), and the walk with the kernel branches cut out."""
    from lvd_tpu_torch.diffusion import dpm_solver as dpm
    from lvd_tpu_torch.diffusion.sampler import energy_and_grad
    from lvd_tpu_torch.models.loader import cast_tree

    cfg = models.preset.unet
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = _undegenerate(models.unet_params, gen, torch)
    guide = flagship_guidance()
    pack = guidance_tensors(guide)
    lat = seeded_latents(torch)
    text = torch.randn((1, 77, cfg.cross_attention_dim), generator=gen, device="cuda")
    t = int(dpm.make_coeffs(models.preset.scheduler, 40).timestep[0])
    run = lambda p, dt: energy_and_grad(p, cfg, lat, t, text.to(dt), pack, guide["attn_keys"],
                                        guide["config"], dt)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain path in full fp32
    try:
        t0 = time.perf_counter()
        e_k, g_k = run(params, torch.bfloat16)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        with plain_route():
            e_p, g_p = run(params, torch.bfloat16)
            e_r, g_r = run(cast_tree(params, torch.float32), torch.float32)
        with detached_route():
            e_b, g_b = run(params, torch.bfloat16)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    scale = g_r.abs().max().item()
    rel = lambda g: (g - g_r).abs().max().item() / scale
    rel_l2 = lambda g: ((g - g_r).norm() / g_r.norm()).item()
    readings = {"kernels_bf16": rel(g_k), "plain_bf16": rel(g_p), "branches_cut": rel(g_b)}
    readings_l2 = {"kernels_bf16": rel_l2(g_k), "plain_bf16": rel_l2(g_p),
                   "branches_cut": rel_l2(g_b)}
    log(f"[gradient] guided energy at full width (loss-scaled): kernels (bf16) {e_k.item():.6g}, "
        f"plain (fp32) {e_r.item():.6g}, plain (bf16) {e_p.item():.6g}, branches cut "
        f"{e_b.item():.6g}; kernel walk + backward {kernel_s:.3f} s")
    log(f"[gradient] d(energy)/d(latents) against the plain path (fp32), max|d| / max|ref| "
        f"(max|ref| {scale:.6g}): {json.dumps(readings)} (gate {GRADIENT_TOL}); "
        f"|d| / |ref| (L2): {json.dumps(readings_l2)} (gate {GRADIENT_L2_TOL})")
    if not (torch.isfinite(g_k).all() and readings["kernels_bf16"] <= GRADIENT_TOL
            and readings_l2["kernels_bf16"] <= GRADIENT_L2_TOL):
        raise SystemExit("[gradient] the kernels' gradient disagrees with the plain path")
    if not (readings["branches_cut"] > GRADIENT_TOL
            and readings_l2["branches_cut"] > GRADIENT_L2_TOL):
        raise SystemExit("[gradient] the gates do not separate a gradient that lost its "
                         "kernel branches")
    del g_k, g_p, g_r, g_b, params
    torch.cuda.empty_cache()
    return readings


def wrappers():
    """Every kernel wrapper, A-J, by kernel name (sdpa() counts on A's)."""
    from lvd_tpu_torch.ops import conv3x3, geglu_fused, linear_fused, packed_attention
    from lvd_tpu_torch.ops import spatial_conv_fused, temp_conv_fused, temporal_attention

    return {
        "attention_packed": packed_attention.attention_packed,
        "temporal_attention_pair": temporal_attention.temporal_attention_pair,
        "geglu_mlp": geglu_fused.geglu_mlp,
        "norm_silu_temporal_conv": temp_conv_fused.norm_silu_temporal_conv,
        "attention_packed_bwd": packed_attention.attention_packed_bwd,
        "temporal_attention_pair_bwd": temporal_attention.temporal_attention_pair_bwd,
        "geglu_mlp_bwd": geglu_fused.geglu_mlp_bwd,
        "linear": linear_fused.linear_rows,
        "norm_silu_conv2d": spatial_conv_fused.norm_silu_conv2d,
        "conv3x3": conv3x3.conv3x3,
        "geglu_stream": geglu_fused.geglu_stream,
    }


def zero_launches():
    for fn in wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in wrappers().items()}


FORWARD_KERNELS = ("attention_packed", "temporal_attention_pair", "geglu_mlp",
                   "norm_silu_temporal_conv")
GUIDED_KERNELS = FORWARD_KERNELS + ("attention_packed_bwd", "temporal_attention_pair_bwd",
                                    "geglu_mlp_bwd")
# This slice's main path: the guided generation under the two opt-in switches.
KNOB_KERNELS = GUIDED_KERNELS + ("linear", "norm_silu_conv2d")


def generation_phase(torch, models):
    from lvd_tpu_torch.pipeline import TextToVideoPipeline
    from lvd_tpu_torch.text.templates import NEGATIVE_PROMPT

    pipe = TextToVideoPipeline(models, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    video = pipe("a brown bear walking in a forest", NEGATIVE_PROMPT, height=320, width=576,
                 num_frames=24, num_inference_steps=NUM_STEPS, guidance_scale=9.0, seed=0)
    total = time.perf_counter() - t0
    launches = read_launches()
    t = pipe.timings
    steps = t["steps"]
    log(f"[generation] video {tuple(video.shape)} {video.dtype}, "
        f"min {video.min():.4f} max {video.max():.4f} mean {video.mean():.4f}")
    log(f"[generation] encode_prompt {t['encode_prompt']:.4f} s; steps "
        f"{[round(s, 4) for s in steps]} s; decode {t['decode']:.4f} s; total {total:.4f} s")
    per_step = sum(steps[1:]) / max(len(steps) - 1, 1)
    log(f"[generation] seconds per step (steps 2..{len(steps)}) {per_step:.4f}; "
        f"40-step video at that rate: {t['encode_prompt'] + 40 * per_step + t['decode']:.2f} s")
    log(f"[generation] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[generation] launches in {NUM_STEPS} steps: {json.dumps(launches)}")
    if video.shape != (1, 24, 320, 576, 3) or not np.isfinite(video).all():
        raise SystemExit(f"[generation] bad output {video.shape}")
    missing = [name for name in FORWARD_KERNELS if launches[name] <= 0]
    if missing:
        raise SystemExit(f"[generation] kernels never launched on the main path: {missing}")
    return launches


def guided_generation_phase(torch, models, kernels=GUIDED_KERNELS):
    """The flagship guided generation through the pipeline's entry point;
    every kernel of ``kernels`` must launch."""
    from lvd_tpu_torch.pipeline import TextToVideoPipeline
    from lvd_tpu_torch.text.templates import NEGATIVE_PROMPT

    guide = flagship_guidance()
    guide["config"] = dataclasses.replace(guide["config"], max_index_step=GUIDED_INDEX_STEP)
    pipe = TextToVideoPipeline(models, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    video = pipe(FLAG_PROMPT, NEGATIVE_PROMPT, height=320, width=576, num_frames=24,
                 num_inference_steps=GUIDED_STEPS, guidance_scale=9.0, seed=0,
                 backward_guidance=guide)
    total = time.perf_counter() - t0
    launches = read_launches()
    t = pipe.timings
    steps, guided = t["steps"], t["guided"]
    log(f"[guided] video {tuple(video.shape)}, min {video.min():.4f} max {video.max():.4f} "
        f"mean {video.mean():.4f}")
    log(f"[guided] steps {[round(s, 4) for s in steps]} s (guidance on the first "
        f"{len(guided)}: guided updates {[round(s, 4) for s in guided]} s); encode "
        f"{t['encode_prompt']:.4f} s; decode {t['decode']:.4f} s; total {total:.4f} s")
    log(f"[guided] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[guided] launches in {GUIDED_STEPS} steps: {json.dumps(launches)}")
    if video.shape != (1, 24, 320, 576, 3) or not np.isfinite(video).all():
        raise SystemExit(f"[guided] bad output {video.shape}")
    missing = [name for name in kernels if launches[name] <= 0]
    if missing:
        raise SystemExit(f"[guided] kernels never launched on the guided path: {missing}")
    return pipe, launches


def certification_phase(torch, pipe):
    """lvd_tpu's flagship certificate at full width (bench.py's certify)."""
    from lvd_tpu_torch.diffusion.certify import guidance_effect

    guide = flagship_guidance()
    cond = pipe.encode_prompt(FLAG_PROMPT, "dull, blurry")[1:].to(torch.bfloat16)
    t0 = time.perf_counter()
    eff = guidance_effect(pipe.unet_params, pipe.preset.unet, pipe.preset.scheduler,
                          seeded_latents(torch).bfloat16(), cond, guidance_tensors(guide),
                          guide["attn_keys"], guide["config"], num_inference_steps=40,
                          n_iters=CERT_ITERS)
    log(f"[certify] {json.dumps(eff)} in {time.perf_counter() - t0:.2f} s "
        f"(gates: gain > {CERT_MIN_GAIN}, CoM distance falling)")
    if not (eff["gain"] > CERT_MIN_GAIN and eff["com_dist_after"] < eff["com_dist_before"]):
        raise SystemExit("[certify] guidance did not move attention into the box")
    return eff


KERNEL_SYMBOLS = {  # substrings of the kernels' device symbols
    "attention_packed": "attn_packed_kernel",
    "temporal_attention_pair": "temporal_pair_kernel",
    "geglu_mlp": "geglu_kernel",
    "norm_silu_temporal_conv": "temp_conv_kernel",
    "attention_packed_bwd": "attn_bwd_",
    "temporal_attention_pair_bwd": "temporal_pair_bwd_kernel",
    "geglu_mlp_bwd": "geglu_bwd_kernel",
    "linear": "linear_kernel",
    "conv3x3 (kernel I)": "conv3x3_kernel",
    "geglu_stream": "geglu_stream_kernel",
}


def profile_phase(torch, models):
    """Device time of one CFG UNet forward at the generation's shapes and of
    one guided update (the energy walk and its backward), each split into
    the kernels and the stock ops; idle share = 1 - busy / wall."""
    from lvd_tpu_torch.diffusion import dpm_solver as dpm
    from lvd_tpu_torch.diffusion.sampler import energy_and_grad
    from lvd_tpu_torch.models.unet3d import apply_unet3d

    cfg = models.preset.unet
    gen = torch.Generator(device="cuda").manual_seed(2)
    sample = torch.randn((2, 24, 40, 72, 4), generator=gen, device="cuda").bfloat16()
    text = torch.randn((2, 77, cfg.cross_attention_dim), generator=gen,
                       device="cuda").bfloat16()
    with torch.no_grad():
        _profile(torch, "one CFG UNet forward",
                 lambda: apply_unet3d(models.unet_params, cfg, sample, 500, text))
    guide = flagship_guidance()
    pack = guidance_tensors(guide)
    lat = seeded_latents(torch)
    t = int(dpm.make_coeffs(models.preset.scheduler, 40).timestep[0])
    _profile(torch, "one guided update", lambda: energy_and_grad(
        models.unet_params, cfg, lat, t, text[1:], pack, guide["attn_keys"], guide["config"],
        torch.bfloat16))


def _profile(torch, label, fn):
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    by_name = {e.key: (e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.self_device_time_total > 0}
    busy_ms = sum(ms for ms, _ in by_name.values())
    split = {}
    for kname, symbol in KERNEL_SYMBOLS.items():
        hits = [v for k, v in by_name.items() if symbol in k]
        if hits:
            split[kname] = {"ms": round(sum(ms for ms, _ in hits), 3),
                            "calls": sum(n for _, n in hits)}
    ours = {k for k in by_name if any(sym in k for sym in KERNEL_SYMBOLS.values())}
    stock = sorted(((ms, n, k) for k, (ms, n) in by_name.items() if k not in ours),
                   reverse=True)
    split["stock"] = {"ms": round(sum(ms for ms, _, _ in stock), 3),
                      "calls": sum(n for _, n, _ in stock)}
    log(f"[profile] {label}: wall {wall_ms:.3f} ms (CUDA events, profiler on), "
        f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}")
    log(f"[profile] {label}, device ms by kernel: {json.dumps(split)}")
    for ms, n, k in stock[:8]:
        log(f"[profile] {label}, stock {ms:.3f} ms in {n} calls: {k[:110]}")


def knob_child(torch) -> int:
    """The knob phase's body, in a child process whose environment holds
    KNOBS: the reference forward and the guided gradient through kernels A-I
    against the plain path, then the guided generation (this slice's main
    path). Its last line is the generation's launch counts."""
    missing = [k for k, v in KNOBS.items() if os.environ.get(k) != v]
    if missing:
        raise SystemExit(f"[knobs] switches not set: {missing}")
    from lvd_tpu_torch.models.loader import random_pipeline_models
    from lvd_tpu_torch.ops import _build

    _build.lib()
    models = random_pipeline_models(
        "zeroscope", torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    zero_launches()
    reference_phase(torch, models)
    ref_launches = read_launches()
    log(f"[reference] launches: {json.dumps(ref_launches)}")
    if ref_launches["linear"] <= 0 or ref_launches["norm_silu_conv2d"] <= 0:
        raise SystemExit("[reference] the switches did not route kernels H and I")
    gradient_phase(torch, models)
    _, launches = guided_generation_phase(torch, models, KNOB_KERNELS)
    print("KNOB_LAUNCHES " + json.dumps(launches), flush=True)
    return 0


def knob_phase(torch):
    """Runs knob_child in a child process with KNOBS set (LVD_FUSED_LINEAR is
    read at import); its output is echoed, a non-zero exit is fatal."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--knob-phase"],
                          env={**os.environ, **KNOBS}, capture_output=True, text=True,
                          timeout=900)
    launches = None
    for line in proc.stdout.splitlines():
        if line.startswith("KNOB_LAUNCHES "):
            launches = json.loads(line[len("KNOB_LAUNCHES "):])
        else:
            log(f"[knobs] {line}")
    log(f"[knobs] child exit {proc.returncode} after {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0 or launches is None:
        log(proc.stderr[-8000:])
        raise SystemExit("[knobs] the knob phase failed")
    return launches


def fp32_phase(torch, models):
    """One full-width CFG UNet forward in the pipeline's default type (fp32)
    through the kernels, against the plain path in fp32, TF32 off on both."""
    from lvd_tpu_torch.models.unet3d import apply_unet3d
    from lvd_tpu_torch.ops.selfcheck import exact_fp32
    from lvd_tpu_torch.pipeline import TextToVideoPipeline

    pipe = TextToVideoPipeline(models, device="cuda")
    if pipe.dtype != torch.float32:
        raise SystemExit(f"[fp32] the pipeline's default type is {pipe.dtype}")
    cfg = models.preset.unet
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = _undegenerate(pipe.unet_params, gen, torch)
    del pipe
    sample = torch.randn((2, 24, 40, 72, 4), generator=gen, device="cuda")
    text = torch.randn((2, 77, cfg.cross_attention_dim), generator=gen, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad(), exact_fp32():
        zero_launches()
        start.record()
        eps = apply_unet3d(params, cfg, sample, 500, text)
        end.record()
        torch.cuda.synchronize()
        launches = read_launches()
        with plain_route():
            ref = apply_unet3d(params, cfg, sample, 500, text)
    scale = ref.abs().max().item()
    rel = (eps - ref).abs().max().item() / scale
    log(f"[fp32] full-width CFG UNet forward in fp32 through the kernels against the plain "
        f"path (fp32, TF32 off), max|d| / max|ref| (max|ref| {scale:.6g}): {rel:.6g} "
        f"(gate {FP32_REFERENCE_TOL}); kernel path {start.elapsed_time(end):.3f} ms (first "
        f"fp32 call, CUDA events); launches {json.dumps(launches)}")
    missing = [name for name in FORWARD_KERNELS if launches[name] <= 0]
    if missing or eps.dtype != torch.float32:
        raise SystemExit(f"[fp32] kernels never launched in fp32: {missing}")
    if not (torch.isfinite(eps).all() and rel <= FP32_REFERENCE_TOL):
        raise SystemExit("[fp32] the fp32 kernel path disagrees with the plain path")
    del eps, ref, params
    torch.cuda.empty_cache()
    return rel


def _ff_of(params, level):
    """The feed-forward params of the first transformer block of down block
    ``level`` (1: C = 640, 2: C = 1280)."""
    return params["down_blocks"][level]["layers"][0]["attn"]["blocks"][0]["ff"]


ENTRY_SDPA = [(48, 5, 2880, 64), (8, 4, 1024, 192), (8, 4, 1024, 256)]  # (B, H, S, D)


def entry_point_phase(torch, models):
    """The public sdpa() (long keys: kernel A forward, E backward, one head)
    at D = 64, 192 and 256, conv3x3() (kernel I without prologue) at L0, and
    geglu_mlp() (kernel J forward, the stock VJP for dx) with the seeded
    UNet's feed-forward weights, each held to its plain version on fp32
    copies: 2e-2 in bf16, the fp32 gate in fp32."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops import attention, conv3x3, geglu_fused, packed_attention
    from lvd_tpu_torch.ops.selfcheck import FP32_TOL, exact_fp32

    gen = torch.Generator(device="cuda").manual_seed(4)
    randn = lambda shape, dt: torch.randn(shape, generator=gen, device="cuda").to(dt)
    sdpa_in = [tuple(randn(shape, torch.bfloat16).requires_grad_(True) for _ in range(3))
               + (randn(shape, torch.bfloat16),) for shape in ENTRY_SDPA]
    x = randn((48, 40, 72, 320), torch.bfloat16)
    w = (torch.randn((3, 3, 320, 320), generator=gen, device="cuda") * 2880 ** -0.5).bfloat16()
    ff_in = [(_ff_of(models.unet_params, 2), randn((8640, 1280), torch.bfloat16)),
             (cast_tree(_ff_of(models.unet_params, 1), torch.float32),
              randn((34560, 640), torch.float32))]
    ff_in = [(p, xx.requires_grad_(True), randn(xx.shape, xx.dtype)) for p, xx in ff_in]
    zero_launches()
    sdpa_out = []
    for q, k, v, do in sdpa_in:
        with torch.enable_grad():
            out, _ = attention.sdpa(q, k, v)
        sdpa_out.append((out, torch.autograd.grad(out, (q, k, v), do)))
    y = conv3x3.conv3x3(x, w)
    ff_out = []
    for p, xx, dy in ff_in:
        with torch.enable_grad():
            out = geglu_fused.geglu_mlp(p, xx)
        ff_out.append((out, torch.autograd.grad(out, xx, dy)[0]))
    torch.cuda.synchronize()
    launches = read_launches()
    rel = lambda a, r: ((a.float() - r).abs().max() / r.abs().max()).item()
    errs, tols = {}, {}
    with exact_fp32():
        for (q, k, v, do), (out, grads) in zip(sdpa_in, sdpa_out):
            b, h, s, d = q.shape
            flat = lambda t: t.detach().float().reshape(b * h, s, d)
            ref_o = packed_attention.attention_packed_plain(flat(q), flat(k), flat(v),
                                                            d ** -0.5, 1)
            ref_g = packed_attention.attention_packed_bwd_plain(
                flat(q), flat(k), flat(v), flat(out), flat(do), d ** -0.5, 1)
            errs[f"sdpa_d{d}"] = rel(flat(out), ref_o)
            errs[f"sdpa_bwd_d{d}"] = max(rel(flat(g), r) for g, r in zip(grads, ref_g))
        errs["conv3x3"] = rel(y, conv3x3.conv3x3_plain(x.float(), w.float()))
        for (p, xx, dy), (out, dx) in zip(ff_in, ff_out):
            leaf = xx.detach().float().requires_grad_(True)
            with torch.enable_grad():
                ref = geglu_fused.geglu_stream_plain(cast_tree(p, torch.float32), leaf)
                (ref_dx,) = torch.autograd.grad(ref, leaf, dy.float())
            name = f"geglu_mlp_{str(xx.dtype).replace('torch.', '')}"
            errs[name], errs[name + "_dx"] = rel(out, ref), rel(dx, ref_dx)
            tols[name] = tols[name + "_dx"] = 2e-2 if xx.dtype == torch.bfloat16 else FP32_TOL
    entry = {"sdpa": launches["attention_packed"], "sdpa_bwd": launches["attention_packed_bwd"],
             "conv3x3": launches["conv3x3"], "geglu_stream": launches["geglu_stream"]}
    log(f"[entry] sdpa() at {ENTRY_SDPA}, conv3x3() {tuple(x.shape)} -> {tuple(y.shape)} "
        f"(bf16) and geglu_mlp() at (8640, 1280) bf16 and (34560, 640) fp32, against the "
        f"plain versions (fp32): {json.dumps(errs)}; launches {json.dumps(entry)}, "
        f"geglu_mlp_bwd {launches['geglu_mlp_bwd']}")
    want = {"sdpa": len(ENTRY_SDPA), "sdpa_bwd": len(ENTRY_SDPA), "conv3x3": 1,
            "geglu_stream": len(ff_in)}
    if entry != want or launches["geglu_mlp_bwd"] != 0:
        raise SystemExit(f"[entry] launches {entry} and geglu_mlp_bwd "
                         f"{launches['geglu_mlp_bwd']}, expected {want} and 0")
    bad = {k: e for k, e in errs.items() if not e <= tols.get(k, 2e-2)}
    if bad:
        raise SystemExit(f"[entry] an entry point disagrees with its plain version: {bad}")
    return entry


def kernels_line(records, knob_launches, entry_launches):
    """One entry per kernel wrapper of selfcheck.SOURCES: its bf16 numbers at
    its largest path shape, its worst errors in bf16 and fp32, and its
    launches on this slice's main path (the entry points for sdpa() and
    conv3x3())."""
    from lvd_tpu_torch.ops.selfcheck import SOURCES

    kernels = []
    for kname, (source, replaces) in SOURCES.items():
        recs = [r for r in records if r["name"] == kname and r["dtype"] == "bfloat16"]
        f32 = [r for r in records if r["name"] == kname and r["dtype"] == "float32"]
        main = recs[0]  # the largest shape the path gives the kernel
        launches = entry_launches.get(kname, knob_launches.get(kname))
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "rel_err": max(r["rel_err"] for r in recs),
            "max_abs_err_fp32": max(r["max_abs_err"] for r in f32),
            "rel_err_fp32": max(r["rel_err"] for r in f32),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"],
        })
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--knob-phase"]:
        return knob_child(torch)
    t_start = time.perf_counter()
    name = device_phase(torch)
    build_phase()
    records = kernel_phase()

    from lvd_tpu_torch.models.loader import random_pipeline_models

    models = random_pipeline_models(
        "zeroscope", torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    reference_phase(torch, models)
    gradient_phase(torch, models)
    generation_phase(torch, models)
    pipe, _ = guided_generation_phase(torch, models)
    certification_phase(torch, pipe)
    del pipe
    knob_launches = knob_phase(torch)
    fp32_phase(torch, models)
    entry_launches = entry_point_phase(torch, models)
    torch.cuda.empty_cache()
    profile_phase(torch, models)

    kernels = kernels_line(records, knob_launches, entry_launches)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
