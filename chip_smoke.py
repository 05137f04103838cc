#!/usr/bin/env python3
"""Chip smoke for lvd_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device  - the card's name and power limit;
  2. build   - nvcc builds lvd_tpu_torch/csrc/*.cu, one process per source,
               all started together, then one link (seconds and the -Xptxas
               -v register / shared-memory / spill lines, one record of
               registers and spills per kernel A-M instantiation, and the
               dynamic shared memory per block of A-I; A's and E's wide
               forms at D = 192 and 256 must not spill);
  3. kernels - every kernel at every shape the Zeroscope path gives it (A
               also at the GLIGEN fuser's ragged key counts, K and V at the
               start of NaN-tailed buffers), in
               bf16, against its plain PyTorch version on fp32 copies, and
               each kernel in fp32 at its largest shape, and B, C, F and G
               at the train step's shapes, against the plain
               version in fp32 with TF32 off (gate 5e-3 and below the bf16
               reading) (lvd_tpu_torch.ops.selfcheck), timed with CUDA
               events: the forwards A-D and I (resnet convs, row 12) at the
               CFG forward's shapes, H (projections, row 14) at the q/k/v/out
               and text k/v shapes, the backwards E-G at the guided energy
               walk's, and the public entry points sdpa() (A and E with one
               head, row 1, D = 64 to 256), conv3x3() (I without prologue,
               row 13) and geglu_mlp() where it streams (J, row 9); B, F, G
               and J also time their first versions beside their wgmma
               forms (B, F and G in fp32 too); then the upsample path's
               shapes: A, B, C and D at the
               Zeroscope-XL refine's 576x1024 CFG forward (A's
               self-attention at 9216 keys), A at the SDXL refiner's 12-
               and 24-head shapes, and D where lvd_tpu routes its kernel
               past 32 frames (frame groups) and at C = 72 and 520, in bf16
               and three of those in fp32; then kernels K, L (both forms)
               and M at the UNet's GroupNorm and LayerNorm shapes, the VAE
               decoder's widest GroupNorm, the refiner's C = 3072 and CLIP's
               LayerNorm, bf16 (1e-2; K's fp32 statistics 1e-4) and
               fp32 (1e-5);
  4. reference - one full-width CFG UNet forward through the kernels (bf16)
               against the plain path (fp32) on the same inputs, with weights
               whose attention/FF/temporal-conv branches are not zero-init,
               so every kernel's output reaches the noise prediction; the
               plain path in bf16 is printed beside it as the yardstick of
               what bf16 rounding alone costs; the forward must launch K, L
               (by form) and M exactly as often as the UNet's tree gives
               (norm_launches: 166, 33 + 45, 65);
  5. gradient - one full-width guided energy gradient d(energy)/d(latents)
               through the kernels (bf16) against the plain path (fp32), on
               the same inputs and weights, gated on the max-element and the
               L2 ratio, with the plain path in bf16 printed beside it; a
               walk whose kernel branches are cut out of the gradient must
               fail both gates;
  6. generation - unguided Zeroscope text-to-video at full width (all UNet,
               CLIP and VAE widths, 24 frames, 576x320, CFG 9.0) from
               lvd_tpu's random weights (seed 0 in its JAX key order, drawn on
               the card in bf16 by load_pipeline_models under
               LVD_ALLOW_RANDOM_WEIGHTS=1, as every phase of this script
               draws them), 4 DPM-Solver++ steps, through the entry
               points a user calls; launch counts are zeroed just before and
               read just after, and every forward kernel A-D and K-M must
               have run, every B, C and D launch in its new form (wgmma); then the
               same call under output_type="uint8_device" must return uint8
               (24, 320, 576, 3) frames on the card within one uint8 level
               of the float video x 255;
  7. guided generation - the flagship layout (one box moving left to right)
               and GuidanceConfig through the same entry point with
               ``backward_guidance``, 4 steps with guidance on the first 2;
               every kernel A-G and K-M must have run, B, C, D, F and G in
               their new form;
  8. certification - guidance_effect at full width, 16 guided updates at
               the first timestep, lvd_tpu's two certificates: on the
               flagship layout the in-box attention share must rise by more
               than its gate (gain > 1.004) and the attention's CoM must
               move toward the box; on bench.py's 2-object layout (a cat
               and a chair, three-token phrases) the gain must exceed
               1.0008; each printed beside lvd_tpu's reading on the same
               weights (1.00683, 1.00111);
  9. gligen  - the lvd-gligen_zeroscope preset at full width (lvd_tpu's
               key-order bf16 weights, its gated init_unet3d, the fusers'
               gates open at 0.5, the PositionNet's
               null features drawn) through runners.lvd_gligen.run: bench.py's
               flagship track as a six-frame layout, the phrase "bear", 4
               steps at beta 0.5, so the fuser runs in steps 0-1 and not in
               2-3; its GIF and frames file (.joblib, or utils/vis's .npz
               fallback where joblib is absent, as on the card's machine)
               must hold (24, 320, 576, 3) frames,
               every CFG forward with the fuser must launch exactly 16 more A
               (the 16 gated blocks) and 10 more C (their FFs at L0 and L1)
               than one without, and A must have run at the fuser's 2910 and
               750 keys; seconds of each step, with and without the fuser;
 10. gligen reference - one full-width gated CFG forward with the fuser,
               kernels (bf16) against the plain path (fp32), gate 5e-2; the
               kernels' forward without the fuser must read further from it;
 11. lvd-plus - runners.lvd_plus.run on the same pipeline: guidance on steps
               0-1 (one update each), the fuser to step 2 (beta 0.75); no
               energy walk takes grounding inputs; update seconds, launches;
 12. cli     - the system's own entry point, lvd_tpu_torch.cli.generate.main,
               in-process in a temporary directory: --run-model lvd_zeroscope,
               the demo prompt with bench.py's moving bear as a cached
               six-frame layout, 24 frames, 4 steps, guidance on 2, with
               LVD_ALLOW_RANDOM_WEIGHTS=1 and no checkpoint root, so the CLI
               draws Zeroscope's UNet, CLIP and VAE (encoder included) in
               lvd_tpu's JAX key order on the card (models/init.py); the
               draw's seconds, main()'s seconds, peak memory and launches;
               its run dir must hold video_0.gif and the frames file at
               (24, 320, 576, 3) uint8, kernels A-G must launch, B, C, D, F
               and G only in their wgmma forms, the GIF written by the
               native encoder (its seconds), and four sampled leaves
               (conv_in, a to_q, the CLIP token embedding's first and last
               1024 rows, a VAE decoder conv) drawn again on the card must
               have the CPU draw's random bits and its normals within 1e-6,
               and the pipeline's bf16 leaves the CPU draw within 2^-8; the
               run dir stays for the upsample phase;
 12b. sdxl   - the SDXL refiner at full width (UNet2D, OpenCLIP-bigG with its
               projection, VAE) drawn on the card in bf16 in lvd_tpu's key
               order; one refiner CFG UNet2D forward at 576x1024 (latents
               (2, 72, 128, 4)), kernels (bf16) against the plain path
               (fp32), gate 5e-2, the plain path in bf16 beside it; kernel
               A must launch at the 12- and 24-head shapes;
 12c. upsample - lvd_tpu_torch.cli.upsample.main in-process over the cli
               phase's run dir, --method zsxl+sdxl, 6 steps (strength 0.35:
               2 tail steps): Zeroscope-XL drawn on the card by the CLI's
               own _get_xl_pipe (LVD_ALLOW_RANDOM_WEIGHTS=1), the sdxl
               phase's refiner in the module's pipe slot; the XL refine's
               encode, step and decode seconds, the SDXL seconds per frame,
               peak memory and launches; video_0_zsxl_sdxl's GIF and frames
               file must hold (24, 576, 1024, 3) uint8, A-D must launch,
               B-D only in their wgmma forms; then one XL CFG UNet forward
               and one refiner CFG UNet2D forward under the profiler;
 12d. train  - lvd_tpu_torch.training's Trainer at the lvd-gligen_zeroscope
               widths (UNet3D (320, 640, 1280, 1280), gated), fp32, batch 1,
               24 frames at 40x72 latents, 77 text states of width 1024 and
               a grounding pack of 2 boxes in 30 slots, the weights drawn on
               the card in lvd_tpu's key order: 3 adapter-only steps on one
               fixed batch (losses finite, every frozen leaf bit-unchanged,
               every fuser and position_net leaf moved, A-G launched, B, F
               and G only in their fp32 wgmma forms, TF32, never their first
               versions), then one full-finetune gradient through the kernels
               against the plain route (plain_route(), TF32 off; loss within
               1e-3, the flattened gradient within 1e-2 L2), and one full
               Trainer step; seconds per step and peak memory; then the
               adapter-only step broken down: its launches of B, C, F, G and
               J by shape, one step's seconds and peak memory, and the device
               ms by kernel and by kernel symbol (form) of a profiled step
               (probes/train_step_forms.py times the step with B's first
               version beside its new form);
 12e. image  - the 2D image path at SD 1.x widths (UNet2DConfig()), 512x512
               (64x64 latents), bf16, weights drawn on the card in lvd_tpu's
               key order: encode_prompts on a ViT-L/14-wide CLIP, two
               per-object generate_semantic_guidance runs (4 steps, one
               guided update on each of the first 2, save_all_latents) from
               get_input_latents_list's blended noise, the histories and the
               background through compose_latents_with_alignment, and
               decode_images to (3, 512, 512, 3); each run must launch C and
               G exactly as often as the UNet2D's routing gives; one CFG
               UNet2D forward against the plain path (fp32, 5e-2) and one
               guided update's gradient against the plain route (0.3
               max-element, 0.2 L2); seconds and peak memory;
 12f. sharded - lvd_tpu's frame-sharded sampling and the trainer's mesh on
               torch.distributed: 2 ranks in processes of torch's spawn
               context, both on the one card over gloo (NCCL refuses two
               ranks on one device; gloo copies through the host), a
               FileStore in a temporary directory, every collective and the
               parent's wait limited to SHARDED_TIMEOUT; a rank that fails,
               hangs or exits non-zero fails the smoke. Each rank draws
               Zeroscope in lvd_tpu's key order (load_pipeline_models under
               LVD_ALLOW_RANDOM_WEIGHTS=1, bf16), 12 of the 24 frames a
               rank; rank 0 also runs every unsharded reference: (a) one
               CFG UNet forward against the plain path (fp32, gate 5e-2;
               A, B, C launched on each rank, D never: lvd_tpu's sharded
               temporal conv is GroupNorm + halo conv3d), its census by
               kind; (b) one guided update on the flagship layout: the
               energy (0.2 relative) and the gradient (0.3 max-element, 0.2
               L2) against the plain path, E, F, G launched; (c) a 4-step
               guided generation (guidance on 2) through
               TextToVideoPipeline(..., mesh=...): the final latents within
               5e-2 of the unsharded pipeline's, the uint8 video (1, 24,
               320, 576, 3); (d) one adapter-only fp32 step of the gated
               Zeroscope (gates open) at 8 frames, batch 2, under meshes
               (data 2, model 1) and (1, 2) against the unsharded step:
               loss 1e-3 relative, the gradient (AdamW's first moment,
               flattened) 1e-2 L2 and each trained leaf's no more than 1e-2
               (L2) further from the exact fp32 gradient (the plain route,
               TF32 off) than the unsharded step's (the per-leaf gap to the
               unsharded step printed beside it); each leaf's update 1e-2 L2 against
               the one AdamW makes from the step's own gradient, and
               against the unsharded update over the elements whose
               reference gradient exceeds the gradient gate's budget, so
               that their sign is sure (the whole update and the
               gradient's sign flips printed); (e) rank
               0 runs (a)'s forward through a one-rank NCCL group. Seconds
               and peak memory per rank beside the unsharded ones;
 13. knobs   - a child process of this script with lvd_tpu's two opt-in
               switches set (LVD_ENABLE_FUSED_SC=1 LVD_FUSED_LINEAR=1; the
               second is read at import): phases 4 and 5 again, now with the
               resnet convs on kernel I and the projections on kernel H, and
               the guided generation of phase 7, which is this slice's main
               path: every kernel A-I must have run, and every launch of B,
               C, D, F, G, H and I must have taken the new form (wgmma /
               mma_sync, never a WMMA form); then one profiled CFG forward
               under the switches; then the sdxl phase's forward again
               under the switches, printing which of the refiner's
               resnet-conv and projection shapes lvd_tpu's predicates route
               to I and H (each routed conv one launch of I, the
               projections launching H, every launch in its new form).
               A non-zero exit of the child fails the
               smoke;
 14. fp32    - one full-width CFG UNet forward in TextToVideoPipeline's
               default type (fp32) through the kernels against the plain
               path in fp32, TF32 off on both; A-D must launch, B only in
               its fp32 wgmma form (TF32) and no kernel in a WMMA form;
 15. entry points - the public sdpa() (forward and backward) at D = 64
               (L0 shape), 192 and 256 (A and E in their wide form: one
               D64 and two wide launches of each, no D-sliced one),
               conv3x3() at L0, and geglu_mlp() with the seeded UNet's
               feed-forward weights where lvd_tpu streams them (C = 1280
               block at (8640, 1280) in bf16, C = 640 block at (34560, 640)
               in fp32), forward and dx through autograd, each against its
               plain version on fp32 copies; counts zeroed just before and
               read just after: kernels A, E, I (in its wgmma form) and J
               (twice: its wgmma form in bf16, its first version in fp32)
               must have run, and G must not (lvd_tpu's dx there is the
               stock VJP);
 16. profile - one CFG UNet forward and one guided update under
               torch.profiler: device time per kernel (K-M included) and for
               the stock ops by kind, and the device's idle share.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1 and
prints no result.
"""

import contextlib
import dataclasses
import json
import math
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
# lvd_tpu's certification gates (bench.py, certify): the flagship layout,
# and the 2-object layout (no CoM gate); its bench read 1.00683 and 1.00111
# on lvd_tpu's key-order weights (BENCH_r05.json), which the smoke draws.
CERT_MIN_GAIN = 1.004
CERT_MULTI_MIN_GAIN = 1.0008
LVD_TPU_GAIN, LVD_TPU_GAIN_MULTI = 1.00683, 1.00111
CERT_ITERS = 16
GUIDED_STEPS, GUIDED_INDEX_STEP = 4, 2  # guided generation: guidance on steps 0 and 1
FLAG_PROMPT = "A bear walks from the left to the right, forest background"
MULTI_PROMPT = "A white fluffy cat walks toward a brown wooden chair, living room background"


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


def build_phase(torch):
    from lvd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] nvcc {_build.build_info['seconds']} s (library ready after "
        f"{time.perf_counter() - t0:.2f} s): {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    ptxas = ptxas_summary(_build.build_info["log"], PTXAS_SOURCES)
    for rec in ptxas:
        log(f"[build] ptxas A-M {json.dumps(rec)}")
    spills = [rec for rec in ptxas if rec["source"].startswith("packed_attention")
              and ("Li192E" in rec["kernel"] or "Li256E" in rec["kernel"])
              and (rec.get("spill_store_bytes") or rec.get("spill_load_bytes"))]
    if spills:
        raise SystemExit(f"[build] A's and E's wide forms spill: {spills}")
    lib = _build.lib()
    from lvd_tpu_torch.ops.packed_attention import launch_plan as attention_plan

    smem = {}
    for dtype, code in (("bf16", 0), ("fp32", 1)):
        for d, form in ((64, None), (128, None), (192, None), (256, None), (192, "sliced")):
            plan = attention_plan(d, form)
            name = f"{plan['form']} D={d}"
            smem[f"A {dtype} {name}"] = lib.lvd_attention_packed_smem(d, plan["code"], code)
            for kind, part in ((0, "dkdv"), (1, "dq")):
                smem[f"E {part} {dtype} {name}"] = lib.lvd_attention_packed_bwd_smem(
                    d, plan["code"], code, kind)
        smem[f"H {dtype}"] = lib.lvd_linear_smem(code)
    from lvd_tpu_torch.ops.conv3x3 import launch_plan

    for w in (72, 36, 18, 9):  # the planes' widths: conv3x3() at L0, the resnet convs L1-L3
        for cout in (320, 640):
            for dtype, code in (("bf16", 0), ("fp32", 1)):
                plan = launch_plan(w, 640, cout, (torch.bfloat16, torch.float32)[code])
                smem[f"I {dtype} W={w} Cout={cout} {plan['form']}"] = lib.lvd_conv3x3_smem(
                    plan["code"], plan["box_rows"], plan["boxes"], plan["block_cout"], code)
    smem["I wmma bf16 / fp32"] = [lib.lvd_conv3x3_smem(0, 0, 0, 64, c) for c in (0, 1)]
    for c in (320, 512, 640):  # kernel C at the path's widths
        smem[f"C wgmma bf16 C={c}"] = lib.lvd_geglu_smem(1, c, 0)
        f32 = ("mma_sync", 2) if c <= 384 else ("wmma", 0)
        smem[f"C {f32[0]} fp32 C={c}"] = lib.lvd_geglu_smem(f32[1], c, 1)
    smem["D wgmma bf16 F=24"] = lib.lvd_temp_conv_smem(24, 0)
    smem["D mma_sync fp32 F=24"] = lib.lvd_temp_conv_smem(24, 1)
    for c in (320, 512, 640):  # kernels B, F and G at the path's widths
        smem[f"B wgmma bf16 C={c}"] = lib.lvd_temporal_pair_smem(c // 64)
        smem[f"F wgmma bf16 C={c}"] = lib.lvd_temporal_pair_bwd_smem(c // 64)
        smem[f"G wgmma bf16 C={c}"] = lib.lvd_geglu_bwd_smem(c, 0)
        smem[f"G wgmma fp32 C={c}"] = lib.lvd_geglu_bwd_smem(c, 1)
    log(f"[build] A-I dynamic shared memory per block (bytes): {json.dumps(smem)}")


# Sources whose kernels get one ptxas record each (registers, spills).
PTXAS_SOURCES = ("packed_attention.cu", "packed_attention_bwd.cu", "linear.cu", "conv3x3.cu",
                 "geglu.cu", "temp_conv.cu", "temporal_attention.cu", "geglu_bwd.cu",
                 "temporal_attention_bwd.cu", "geglu_stream.cu", "pair_bwd_tf32.cu",
                 "pair_fwd_tf32.cu", "norms.cu")


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
            # the kernel's length-prefixed identifier and its template arguments
            short = re.search(r"\d((?:attn|linear|conv3x3|geglu|temp_conv|temporal_pair|gn|ln)_"
                              r"\w*?kernel"
                              r"(?:\w*?I\w*?EE)?)", name)
            rec = {"source": source, "kernel": name if short is None else short.group(1)}
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


def lvd_tpu_models(torch, preset):
    """lvd_tpu's random weights for ``preset``, seed 0 in its JAX key order
    (models/init.py), drawn on the card in bf16: load_pipeline_models under
    LVD_ALLOW_RANDOM_WEIGHTS=1 with no checkpoint root, as the cli phase's
    CLI draws them."""
    from lvd_tpu_torch.models.loader import load_pipeline_models

    keys = ("LVD_ALLOW_RANDOM_WEIGHTS", "LVD_CHECKPOINT_ROOT")
    saved = {k: os.environ.pop(k, None) for k in keys}
    os.environ["LVD_ALLOW_RANDOM_WEIGHTS"] = "1"
    try:
        t0 = time.perf_counter()
        models = load_pipeline_models(preset, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"[weights] {preset}: lvd_tpu's key-order draw on the card in "
            f"{time.perf_counter() - t0:.2f} s")
        return models
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _undegenerate(tree, gen, torch):
    """Gives every zero-init or 1e-5-scaled projection (transformer proj_out,
    the last temporal conv) a normal * fan_in^-1/2 weight, so the kernels'
    branches are not multiplied away before the output; opens each GLIGEN
    fuser's gates (alpha_attn and alpha_dense 0.5, as lvd_tpu's
    tests/test_runners.py opens them) and draws the PositionNet's null
    features, which lvd_tpu's init leaves at zero."""
    if isinstance(tree, list):
        return [_undegenerate(v, gen, torch) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("alpha_attn", "alpha_dense"):
            out[k] = torch.full_like(v, 0.5)
        elif k in ("null_positive_feature", "null_position_feature"):
            out[k] = torch.randn(v.shape, generator=gen, device=v.device).to(v.dtype)
        elif k in ("proj_out", "conv4") and isinstance(v, dict):
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


@contextlib.contextmanager
def detached_route():
    """Cuts each forward kernel's branch out of the gradient (its autograd
    Function passes no gradient back), as a kernel wrapper outside autograd
    would: the reading of a broken gradient, beside which the gate is set.
    Kernels K-M keep their gradients: the captured maps reach the latents
    only through the norms."""
    from lvd_tpu_torch.ops import geglu_fused, linear_fused, packed_attention
    from lvd_tpu_torch.ops import spatial_conv_fused, temp_conv_fused, temporal_attention
    from lvd_tpu_torch.ops.plain import swapped

    nothing = staticmethod(lambda ctx, *grads: (None,) * len(ctx.needs_input_grad))
    with swapped([(fn, "backward", nothing) for fn in (
            packed_attention.PackedAttention, temporal_attention.TemporalPair, geglu_fused.Geglu,
            temp_conv_fused.NormSiluTemporalConv, spatial_conv_fused.NormSiluConv2d,
            linear_fused.LinearCore)]):
        yield


def reference_phase(torch, models):
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.models.unet3d import apply_unet3d
    from lvd_tpu_torch.ops.plain import plain_route

    cfg = models.preset.unet
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = _undegenerate(models.unet_params, gen, torch)
    sample = torch.randn((2, 24, 40, 72, 4), generator=gen, device="cuda")
    text = torch.randn((2, 77, cfg.cross_attention_dim), generator=gen, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain path in full fp32
    try:
        with torch.no_grad():
            zero_launches()
            eps = apply_unet3d(params, cfg, sample.bfloat16(), 500, text.bfloat16())
            check_norm_launches("reference", params, read_launches(), read_forms())
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


def check_norm_launches(phase, params, launches, forms):
    """Fails unless one CFG forward launched K, L (by form) and M exactly as
    often as norm_launches derives from the UNet's tree (166, 33 + 45, 65
    at Zeroscope's widths); each launch of kernel I (the opt-in resnet conv
    route) takes a GroupNorm's statistics from K and its apply + SiLU from
    I's prologue in place of L."""
    want = norm_launches(params)
    want["group_norm_apply"]["affine_silu"] -= launches["norm_silu_conv2d"]
    got = {"group_norm_stats": launches["group_norm_stats"],
           "group_norm_apply": {f: forms["group_norm_apply"][f] for f in ("affine", "affine_silu")},
           "layer_norm_rows": launches["layer_norm_rows"]}
    log(f"[{phase}] kernels K-M in one CFG forward: {json.dumps(got)} (from the UNet's tree: "
        f"{json.dumps(want)})")
    if got != want:
        raise SystemExit(f"[{phase}] kernels K-M launched {got} times in one CFG forward, "
                         f"the code gives {want}")


def gradient_phase(torch, models):
    """d(energy)/d(latents) at full width: kernels (bf16), plain path (fp32
    reference, and bf16), and the walk with the kernel branches cut out."""
    from lvd_tpu_torch.diffusion import dpm_solver as dpm
    from lvd_tpu_torch.diffusion.sampler import energy_and_grad
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops.plain import plain_route

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
    """Every kernel wrapper, A-M, by kernel name (sdpa() counts on A's)."""
    from lvd_tpu_torch.ops import conv3x3, geglu_fused, linear_fused, norms, packed_attention
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
        "group_norm_stats": norms.group_norm_stats,
        "group_norm_apply": norms.group_norm_apply,
        "layer_norm_rows": norms.layer_norm_rows,
    }


def zero_launches():
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_form"):
            fn.launches_by_form = dict.fromkeys(fn.launches_by_form, 0)


def read_launches():
    return {name: fn.launches for name, fn in wrappers().items()}


def read_forms():
    """Launches per form of kernels A-M (attention_packed,
    temporal_attention_pair, geglu_mlp, norm_silu_temporal_conv,
    attention_packed_bwd, temporal_attention_pair_bwd, geglu_mlp_bwd,
    linear_rows, norm_silu_conv2d, conv3x3, geglu_stream, group_norm_stats,
    group_norm_apply, layer_norm_rows)."""
    return {name: dict(fn.launches_by_form) for name, fn in wrappers().items()
            if hasattr(fn, "launches_by_form")}


def check_new_forms(phase, forms, redesigned=()):
    """Fails unless every launch of A-J took its new form (wgmma in bf16,
    and in fp32 wgmma for B, F and G, TF32, mma_sync for C and D; A and E
    never D-sliced): every UNet and conv3x3() shape has Cin and Cout % 64 ==
    0, and only other widths take I's WMMA form; the WMMA forms kept are
    B's and F's past 64 frames, C's for fp32 C > 384, J's first version for
    fp32 and A's and E's D-sliced form past D = 256, which no path this is
    called on reaches. Each wrapper of ``redesigned`` must have launched
    its wgmma form."""
    old = {name: f.get("wmma", 0) + f.get("sliced", 0) for name, f in forms.items()
           if f.get("wmma") or f.get("sliced")}
    if old:
        raise SystemExit(f"[{phase}] launches of the WMMA form on the path: {old}")
    idle = [name for name in redesigned if forms[name]["wgmma"] <= 0]
    if idle:
        raise SystemExit(f"[{phase}] the wgmma form never launched on the path: {idle}")


def norm_launches(params):
    """Launches of kernels K, L (by form) and M in one apply_unet3d call
    without GLIGEN inputs, derived from the UNet's param tree: every resnet
    runs two GroupNorm + SiLU (K, L ``affine_silu``) and ``conv_norm_out``
    one; every temporal conv block four GroupNorms, each K and kernel D's
    prologue; every spatial and
    temporal transformer one GroupNorm (K, L ``affine``); every spatial
    block three LayerNorms (M), every temporal block one (norm3; B holds
    the other two)."""
    sites = {"resnet": 0, "temp_conv": 0, "spatial": 0, "temporal": 0}

    def walk(node):
        if isinstance(node, list):
            for v in node:
                walk(v)
        elif isinstance(node, dict):
            for k, v in node.items():
                if k in ("resnet", "resnet_in", "resnets"):
                    sites["resnet"] += len(v) if isinstance(v, list) else 1
                elif k in ("temp_conv", "temp_conv_in"):
                    sites["temp_conv"] += 1
                elif k == "attn" and isinstance(v, dict) and "blocks" in v:
                    sites["spatial"] += len(v["blocks"])
                elif k in ("temp_attn", "transformer_in"):
                    sites["temporal"] += 1
                else:
                    walk(v)

    walk(params)
    transformers = sites["spatial"] + sites["temporal"]
    silu = 2 * sites["resnet"] + 1
    return {"group_norm_stats": 2 * sites["resnet"] + 1 + 4 * sites["temp_conv"] + transformers,
            "group_norm_apply": {"affine": transformers, "affine_silu": silu},
            "layer_norm_rows": 3 * sites["spatial"] + sites["temporal"]}


# Kernels K-M: GroupNorm statistics, GroupNorm apply (+ SiLU), LayerNorm.
NORM_KERNELS = ("group_norm_stats", "group_norm_apply", "layer_norm_rows")
FORWARD_KERNELS = ("attention_packed", "temporal_attention_pair", "geglu_mlp",
                   "norm_silu_temporal_conv") + NORM_KERNELS
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
    forms = read_forms()
    log(f"[generation] launches of B-D and F-J by form: {json.dumps(forms)}")
    check_new_forms("generation", forms, ("temporal_attention_pair",))
    uint8_device_check(torch, pipe, video)
    return launches


def uint8_device_check(torch, pipe, video):
    """The same call under output_type="uint8_device": uint8 (24, 320, 576,
    3) frames on the card, within one uint8 level of the float video x 255
    of the same seed; the call returns before the card is done (its
    seconds beside the seconds until the frames are ready)."""
    from lvd_tpu_torch.text.templates import NEGATIVE_PROMPT

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = pipe("a brown bear walking in a forest", NEGATIVE_PROMPT, height=320, width=576,
                  num_frames=24, num_inference_steps=NUM_STEPS, guidance_scale=9.0, seed=0,
                  output_type="uint8_device")
    returned = time.perf_counter() - t0
    torch.cuda.synchronize()
    ready = time.perf_counter() - t0
    diff = (frames.cpu().float() - torch.from_numpy(video[0]) * 255.0).abs().max().item()
    log(f"[uint8_device] {tuple(frames.shape)} {frames.dtype} on {frames.device}: returned after "
        f"{returned:.4f} s, ready after {ready:.4f} s; max|frames - video * 255| {diff:.4f} "
        f"(gate 1 level)")
    if (frames.dtype != torch.uint8 or not frames.is_cuda
            or tuple(frames.shape) != (24, 320, 576, 3) or diff > 1.0):
        raise SystemExit("[uint8_device] the uint8 frames on the card are not the video's")


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
    forms = read_forms()
    log(f"[guided] launches of B-D and F-J by form: {json.dumps(forms)}")
    check_new_forms("guided", forms, ("temporal_attention_pair", "temporal_attention_pair_bwd",
                                      "geglu_mlp_bwd"))
    return pipe, launches


def multi_guidance(frames=24):
    """bench.py's 2-object layout (its benchmark-protocol shape): a cat
    moving right toward a fixed chair, multi-token phrases, the flagship's
    GuidanceConfig."""
    guide = flagship_guidance(frames)
    move = lambda f: 0.55 * f / max(frames - 1, 1)
    guide["boxes"] = [[[0.05 + move(f), 0.45, 0.30 + move(f), 0.80] for f in range(frames)],
                      [[0.65, 0.40, 0.95, 0.85] for _ in range(frames)]]
    guide["object_positions"] = [[2, 3, 4], [9, 10, 11]]
    return guide


def _certify(torch, pipe, label, prompt, guide, min_gain, check_com, lvd_tpu_gain):
    from lvd_tpu_torch.diffusion.certify import guidance_effect

    cond = pipe.encode_prompt(prompt, "dull, blurry")[1:].to(torch.bfloat16)
    t0 = time.perf_counter()
    eff = guidance_effect(pipe.unet_params, pipe.preset.unet, pipe.preset.scheduler,
                          seeded_latents(torch).bfloat16(), cond, guidance_tensors(guide),
                          guide["attn_keys"], guide["config"], num_inference_steps=40,
                          n_iters=CERT_ITERS)
    log(f"[certify] {label}: {json.dumps(eff)} in {time.perf_counter() - t0:.2f} s (gates: "
        f"gain > {min_gain}{', CoM distance falling' if check_com else ''}; lvd_tpu's bench "
        f"read gain {lvd_tpu_gain} on these weights, BENCH_r05.json)")
    if not (eff["gain"] > min_gain
            and (not check_com or eff["com_dist_after"] < eff["com_dist_before"])):
        raise SystemExit(f"[certify] {label}: guidance did not move attention into the boxes")
    return eff


def certification_phase(torch, pipe):
    """lvd_tpu's two certificates at full width (bench.py's certify): the
    flagship layout (gain > 1.004, CoM distance falling) and the 2-object
    layout (gain > 1.0008)."""
    return {"flagship": _certify(torch, pipe, "flagship", FLAG_PROMPT, flagship_guidance(),
                                 CERT_MIN_GAIN, True, LVD_TPU_GAIN),
            "multi": _certify(torch, pipe, "2-object", MULTI_PROMPT, multi_guidance(),
                              CERT_MULTI_MIN_GAIN, False, LVD_TPU_GAIN_MULTI)}


# GLIGEN: bench.py's flagship track (one box moving left to right) as the
# six-frame layout an LLM would give, the phrase "bear"; the runners
# interpolate it to the flagship box of each of the 24 frames.
FLAG_LAYOUT = {
    "Prompt": "A bear walks from the left to the right",
    **{f"Frame {i + 1}": [{"id": 0, "name": "bear",
                           "box": [(0.05 + 0.16 * i) * 512, 0.45 * 512, 0.25 * 512, 0.35 * 512]}]
       for i in range(6)},
    "Background keyword": "forest",
}
GLIGEN_BETA = 0.5       # of 4 steps: the fuser runs in steps 0-1, not in 2-3
PLUS_BETA = 0.75        # lvd-plus: the fuser to step 2, guidance on steps 0-1
FUSER_SITES = 16        # gated spatial transformer blocks of a Zeroscope UNet
FUSER_FF_SITES = 10     # of them at L0 and L1, where the FF takes kernel C
FUSER_LONG_KEYS = (2910, 750)  # S + 30 grounding tokens at L0 and L1


def gligen_models(torch):
    """The lvd-gligen_zeroscope preset at full width, lvd_tpu's key-order
    bf16 weights (its gated ``init_unet3d``), the fusers' gates open
    (``_undegenerate``)."""
    models = lvd_tpu_models(torch, "lvd-gligen_zeroscope")
    gen = torch.Generator(device="cuda").manual_seed(5)
    models.unet_params = _undegenerate(models.unet_params, gen, torch)
    return models


@contextlib.contextmanager
def unet_census(torch, records):
    """Appends one record per UNet call of the sampler (a CFG forward, or the
    energy walk of a guided update): whether it took grounding inputs or
    captured maps, its launches of every kernel, and the key counts of
    kernel A's launches through attention() (the calls on which
    packed_attention.kernel_ok held)."""
    from lvd_tpu_torch.diffusion import sampler
    from lvd_tpu_torch.ops import packed_attention
    from lvd_tpu_torch.ops.plain import swapped

    real_unet, real_ok = sampler.apply_unet3d, packed_attention.kernel_ok
    keys = []

    def kernel_ok(q, k, num_heads):
        ok = real_ok(q, k, num_heads)
        if ok:
            keys.append(k.shape[1])
        return ok

    def apply_unet3d(*args, **kwargs):
        before, n_keys = read_launches(), len(keys)
        out = real_unet(*args, **kwargs)
        after = read_launches()
        records.append({"gligen": kwargs.get("gligen") is not None,
                        "walk": bool(kwargs.get("capture_keys")),
                        "launches": {n: after[n] - before[n] for n in after},
                        "a_keys": sorted(set(keys[n_keys:]))})
        return out

    with swapped([(sampler, "apply_unet3d", apply_unet3d),
                   (packed_attention, "kernel_ok", kernel_ok)]):
        yield


def check_fuser_launches(phase, census):
    """Every CFG forward with grounding inputs launches exactly FUSER_SITES
    more A and FUSER_FF_SITES more C than one without, A at the long keys
    FUSER_LONG_KEYS; no energy walk takes grounding inputs."""
    fwd = [r for r in census if not r["walk"]]
    on = [r for r in fwd if r["gligen"]]
    off = [r for r in fwd if not r["gligen"]]
    if not on or not off or any(r["gligen"] for r in census if r["walk"]):
        raise SystemExit(f"[{phase}] grounding in {len(on)} of {len(fwd)} CFG forwards and "
                         f"{sum(r['gligen'] for r in census if r['walk'])} energy walks")
    extra = {(r["launches"]["attention_packed"] - off[0]["launches"]["attention_packed"],
              r["launches"]["geglu_mlp"] - off[0]["launches"]["geglu_mlp"]) for r in on}
    same = {(r["launches"]["attention_packed"], r["launches"]["geglu_mlp"]) for r in off}
    log(f"[{phase}] per CFG forward with the fuser, launches of A and C beyond one without: "
        f"{sorted(extra)}; without: {sorted(same)}; A's key counts with the fuser: "
        f"{on[0]['a_keys']}")
    if extra != {(FUSER_SITES, FUSER_FF_SITES)} or len(same) != 1:
        raise SystemExit(f"[{phase}] the fuser's launches differ from +{FUSER_SITES} A and "
                         f"+{FUSER_FF_SITES} C per CFG forward")
    missing = [s for s in FUSER_LONG_KEYS if s not in on[0]["a_keys"]]
    if missing:
        raise SystemExit(f"[{phase}] kernel A never ran at the fuser's key counts {missing}")


def _runner_state(pipe):
    from lvd_tpu_torch.runners import base

    state = base.RunnerState()
    state.pipe, state.H, state.W = pipe, pipe.preset.height, pipe.preset.width
    state.box_h, state.box_w = pipe.preset.box_h, pipe.preset.box_w
    return state


def _read_outputs(phase, out_dir, stem="video_seed0", want=(24, 320, 576, 3)):
    """{stem}.gif and the frames file of a runner: both must hold ``want``
    frames, the frames file in uint8. The frames file is .joblib, or .npz
    where joblib is not installed (utils/vis.save_joblib's fallback, as
    lvd_tpu's)."""
    from PIL import Image, ImageSequence

    from lvd_tpu_torch.utils import vis

    gif = Image.open(os.path.join(out_dir, f"{stem}.gif"))
    gif_frames = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(gif)]
    name = next(f"{stem}.{ext}" for ext in ("joblib", "npz")
                if os.path.exists(os.path.join(out_dir, f"{stem}.{ext}")))
    frames = vis.load_video(os.path.join(out_dir, name))
    shapes = {"gif": (len(gif_frames), *gif_frames[0].shape), name: frames.shape}
    log(f"[{phase}] {sorted(os.listdir(out_dir))}: {json.dumps(shapes)}, frames {frames.dtype} "
        f"min {frames.min()} max {frames.max()} mean {frames.mean():.3f}")
    if set(shapes.values()) != {tuple(want)} or frames.dtype != np.uint8:
        raise SystemExit(f"[{phase}] the runner's outputs hold {shapes} {frames.dtype}")


def _drive_runner(torch, phase, runner, pipe, **run_kw):
    """``runner.run`` on FLAG_LAYOUT, seed 0, NUM_STEPS steps, 24 frames,
    with its state holding ``pipe`` for the call only and its outputs in a
    temporary directory (read by _read_outputs); logs its peak memory and
    launches. Returns run()'s seconds, the launches and the census of its
    UNet calls."""
    import tempfile

    from lvd_tpu_torch.runners import base

    census = []
    with tempfile.TemporaryDirectory() as out_dir, unet_census(torch, census):
        runner._state = _runner_state(pipe)
        base.img_dir = out_dir
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        runner.run(FLAG_LAYOUT, seed=0, num_inference_steps=NUM_STEPS, num_frames=24, **run_kw)
        total = time.perf_counter() - t0
        launches = read_launches()
        runner._state = base.RunnerState()  # the module holds no weights past the phase
        _read_outputs(phase, out_dir)
    log(f"[{phase}] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[{phase}] launches in {NUM_STEPS} steps: {json.dumps(launches)}")
    return total, launches, census


def gligen_phase(torch, models):
    """lvd-gligen through its runner (runners.lvd_gligen.run) at full width:
    4 steps, beta 0.5; per-step seconds and launches with and without the
    fuser; the GIF and joblib it writes."""
    from lvd_tpu_torch.pipeline import TextToVideoPipeline
    from lvd_tpu_torch.runners import lvd_gligen

    pipe = TextToVideoPipeline(models, dtype=torch.bfloat16, device="cuda")
    total, _, census = _drive_runner(torch, "gligen", lvd_gligen, pipe,
                                     gligen_scheduled_sampling_beta=GLIGEN_BETA)
    t = pipe.timings
    n_ground = int(GLIGEN_BETA * NUM_STEPS)
    steps = t["steps"]
    log(f"[gligen] lvd-gligen_zeroscope through runners.lvd_gligen.run, {NUM_STEPS} steps, beta "
        f"{GLIGEN_BETA}: steps with the fuser {[round(x, 4) for x in steps[:n_ground]]} s, "
        f"without {[round(x, 4) for x in steps[n_ground:]]} s; encode {t['encode_prompt']:.4f} s; "
        f"decode {t['decode']:.4f} s; run() {total:.4f} s")
    log(f"[gligen] launches per CFG forward: "
        f"{json.dumps([{k: v for k, v in r['launches'].items() if v} for r in census])}")
    check_fuser_launches("gligen", census)
    check_new_forms("gligen", read_forms(), ("temporal_attention_pair",))
    return pipe


def gligen_reference_phase(torch, pipe):
    """One full-width gated CFG forward with the fuser on: kernels (bf16)
    against the plain path (fp32); the kernels' forward without the fuser
    must differ from that reference by more than the kernels' reading. Both
    kernel forwards are timed with CUDA events, and the one with the fuser
    is profiled."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.models.unet3d import apply_unet3d
    from lvd_tpu_torch.ops.plain import plain_route

    cfg = pipe.preset.unet
    gen = torch.Generator(device="cuda").manual_seed(6)
    sample = torch.randn((2, 24, 40, 72, 4), generator=gen, device="cuda")
    text = torch.randn((2, 77, cfg.cross_attention_dim), generator=gen, device="cuda")
    boxes = flagship_guidance()["boxes"][0]
    g = pipe.prepare_gligen_inputs([[b] for b in boxes], [["bear"]] * 24, 24)
    g32 = {k: v.float() for k, v in g.items()}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain path in full fp32
    fwd = lambda gl: apply_unet3d(pipe.unet_params, cfg, sample.bfloat16(), 500,
                                  text.bfloat16(), gligen=gl)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    try:
        with torch.no_grad():
            events[0].record()
            eps = fwd(g)
            events[1].record()
            off = fwd(None)
            events[2].record()
            torch.cuda.synchronize()
            with plain_route():
                ref = apply_unet3d(cast_tree(pipe.unet_params, torch.float32), cfg, sample, 500,
                                   text, gligen=g32)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    scale = ref.abs().max().item()
    rel = (eps.float() - ref).abs().max().item() / scale
    rel_off = (off.float() - ref).abs().max().item() / scale
    log(f"[gligen reference] full-width gated CFG UNet forward with the fuser, against the plain "
        f"path (fp32), max|d| / max|ref| (max|ref| {scale:.6g}): kernels (bf16) {rel:.6g} (gate "
        f"{REFERENCE_TOL}); kernels without the fuser {rel_off:.6g}; kernel forward with the "
        f"fuser {events[0].elapsed_time(events[1]):.3f} ms, without "
        f"{events[1].elapsed_time(events[2]):.3f} ms (CUDA events)")
    if not (torch.isfinite(eps).all() and rel <= REFERENCE_TOL):
        raise SystemExit("[gligen reference] the kernel path disagrees with the plain path")
    if not rel_off > rel:
        raise SystemExit("[gligen reference] the fuser does not move the forward: gates shut?")
    del eps, off, ref
    torch.cuda.empty_cache()
    with torch.no_grad():
        _profile(torch, "one CFG UNet forward with the GLIGEN fuser", lambda: fwd(g))
    return rel, rel_off


def lvd_plus_phase(torch, pipe):
    """lvd-plus through runners.lvd_plus.run on the same pipeline: 4 steps,
    guidance (bench.py's flagship GuidanceConfig, its loss threshold at 0 so
    that each guided step makes its one update) on steps 0-1, the fuser to
    step 2 (beta 0.75); the energy walks take no grounding inputs."""
    from lvd_tpu_torch.runners import lvd_plus

    g = flagship_guidance()["config"]
    total, launches, census = _drive_runner(
        torch, "lvd-plus", lvd_plus, pipe, gligen_scheduled_sampling_beta=PLUS_BETA,
        loss_scale=g.loss_scale, loss_threshold=0.0, max_iter=1,
        max_index_step=GUIDED_INDEX_STEP, fg_top_p=g.fg_top_p, bg_top_p=g.bg_top_p,
        fg_weight=g.fg_weight, bg_weight=g.bg_weight)
    t = pipe.timings
    log(f"[lvd-plus] runners.lvd_plus.run, {NUM_STEPS} steps, guidance on the first "
        f"{len(t['guided'])}, beta {PLUS_BETA}: steps {[round(x, 4) for x in t['steps']]} s "
        f"(guided updates {[round(x, 4) for x in t['guided']]} s); run() {total:.4f} s")
    walks = [r for r in census if r["walk"]]
    log(f"[lvd-plus] launches per energy walk: "
        f"{json.dumps([{k: v for k, v in r['launches'].items() if v} for r in walks])}")
    if len(t["guided"]) != GUIDED_INDEX_STEP or len(walks) != GUIDED_INDEX_STEP:
        raise SystemExit(f"[lvd-plus] {len(walks)} guided updates, expected {GUIDED_INDEX_STEP}")
    fwd = [r["gligen"] for r in census if not r["walk"]]
    if fwd != [i < int(PLUS_BETA * NUM_STEPS) for i in range(NUM_STEPS)]:
        raise SystemExit(f"[lvd-plus] the fuser ran in CFG forwards {fwd}")
    check_fuser_launches("lvd-plus", census)
    missing = [name for name in GUIDED_KERNELS if launches[name] <= 0]
    if missing:
        raise SystemExit(f"[lvd-plus] kernels never launched: {missing}")
    check_new_forms("lvd-plus", read_forms(), ("temporal_attention_pair",
                                               "temporal_attention_pair_bwd", "geglu_mlp_bwd"))
    return launches


CLI_WGMMA = ("temporal_attention_pair", "geglu_mlp", "norm_silu_temporal_conv",
             "temporal_attention_pair_bwd", "geglu_mlp_bwd")  # B, C, D, F, G
# Rows of the CLIP token embedding held against the CPU draw (first and last).
CLI_EMBED_ROWS = 1024


def _cli_cache(path):
    """A layout cache holding the first demo prompt with FLAG_LAYOUT (bench.py's
    moving bear) as the six frame lines of an LLM response."""
    from lvd_tpu_torch.text.templates import PROMPTS_DEMO, canonical_prompt

    frames = "\n".join(f"Frame {i + 1}: {FLAG_LAYOUT[f'Frame {i + 1}']}" for i in range(6))
    response = f"Reasoning: the bear walks right.\n{frames}\nBackground keyword: forest"
    with open(path, "w") as f:
        json.dump({canonical_prompt(PROMPTS_DEMO[0]): [response]}, f)


def _check_cli_draw(torch, pipe):
    """Sampled leaves of the CLI's weights: lvd_tpu's key order drawn again
    on the card and on the CPU (the key walk of models/init.py) must give
    equal random bits and normals within 1e-6 of max|cpu|; the pipeline's
    bf16 leaf must be the CPU draw within bf16 rounding (2^-8)."""
    from lvd_tpu_torch.models import clip, init, unet3d, vae
    from lvd_tpu_torch.utils import prng

    preset = pipe.preset
    k = prng.split(prng.prng_key(0), 3)
    unet = unet3d.unet3d_leaves(k[0], preset.unet)
    text = clip.clip_text_leaves(k[1], preset.clip)
    auto = vae.vae_leaves(k[2], preset.vae)
    to_q = lambda t: t["down_blocks"][0]["layers"][0]["attn"]["blocks"][0]["attn1"]["to_q"]["w"]
    conv1 = lambda t: t["decoder"]["up_blocks"][0]["resnets"][0]["conv1"]["w"]
    leaves = {"unet conv_in": (unet["conv_in"]["w"], pipe.unet_params["conv_in"]["w"]),
              "unet down 0 attn1 to_q": (to_q(unet), to_q(pipe.unet_params)),
              "clip token_embedding": (text["token_embedding"], pipe.clip_params["token_embedding"]),
              "vae decoder up 0 conv1": (conv1(auto), conv1(pipe.vae_params))}
    readings = {}
    for name, (leaf, param) in leaves.items():
        n = param.numel()
        idx = torch.arange(n)
        if name.startswith("clip"):
            rows = CLI_EMBED_ROWS * leaf.shape[1]
            idx = torch.cat([idx[:rows], idx[-rows:]])
        t0 = time.perf_counter()
        bits_cpu = prng.random_bits_at(leaf.key, idx)
        cpu = prng.normal_from_bits(bits_cpu) * leaf.scale
        cpu_s = time.perf_counter() - t0
        bits_card = prng.random_bits_at(leaf.key, idx.cuda()).cpu()
        card = init.draw(leaf, "cuda").reshape(-1)[idx.cuda()].cpu()
        scale = cpu.abs().max().item()
        rel = (card - cpu).abs().max().item() / scale
        rel_bf16 = (param.float().reshape(-1)[idx.cuda()].cpu() - cpu).abs().max().item() / scale
        readings[name] = {"shape": list(leaf.shape), "compared": len(idx),
                          "bits_equal": bool(torch.equal(bits_card, bits_cpu)),
                          "rel": rel, "rel_bf16": rel_bf16, "cpu_s": round(cpu_s, 3)}
    log(f"[cli] card draw against the CPU draw: {json.dumps(readings)}")
    bad = [n for n, r in readings.items()
           if not (r["bits_equal"] and r["rel"] <= 1e-6 and r["rel_bf16"] <= 2 ** -8)]
    if bad:
        raise SystemExit(f"[cli] the card's draw differs from the CPU's at {bad}")


def cli_phase(torch, cwd):
    """The system's entry point: lvd_tpu_torch.cli.generate.main in-process
    in the directory ``cwd``,
    lvd_zeroscope, LVD_ALLOW_RANDOM_WEIGHTS=1 without a checkpoint root, so
    the CLI draws Zeroscope's UNet, CLIP and VAE in lvd_tpu's key order on
    the card; the demo prompt's cached flagship layout, 24 frames, 4 steps,
    guidance on 2. Its run dir must hold video_0.gif and the frames file at
    (24, 320, 576, 3); kernels A-G must launch, B, C, D, F and G only in
    their wgmma forms; the sampled leaves must match the CPU draw. Returns
    the run dir, which the upsample phase reads."""
    from lvd_tpu_torch.cli import generate
    from lvd_tpu_torch.ops.plain import swapped
    from lvd_tpu_torch.runners import base, lvd

    from lvd_tpu_torch.utils import native, vis

    seconds = {"draw": [], "save": [], "gif": []}

    def timed(key, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[key].append(time.perf_counter() - t0)
            return out
        return call

    env = {"LVD_ALLOW_RANDOM_WEIGHTS": "1"}
    saved_env = {k: os.environ.get(k) for k in
                 ("LVD_ALLOW_RANDOM_WEIGHTS", "LVD_CHECKPOINT_ROOT", "LVD_TINY", "LVD_PLATFORM")}
    home = os.getcwd()
    t_phase = time.perf_counter()
    swaps = [(base, "load_pipeline_models", timed("draw", base.load_pipeline_models)),
             (base, "save_video", timed("save", base.save_video)),
             (vis, "save_gif", timed("gif", vis.save_gif))]
    with swapped(swaps):
        for k in saved_env:
            os.environ.pop(k, None)
        os.environ.update(env)
        try:
            os.chdir(cwd)
            _cli_cache("cache_demo.json")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            t0 = time.perf_counter()
            generate.main(["--run-model", "lvd_zeroscope", "--prompt-type", "demo",
                           "--model", "gpt-4", "--template_version", "v0.1",
                           "--cache-path", "cache_demo.json", "--num_frames", "24",
                           "--num_inference_steps", str(NUM_STEPS),
                           "--max_index_step", str(GUIDED_INDEX_STEP), "--max_iter", "1",
                           "--num_prompts", "1", "--no-continue-on-error"])
            total = time.perf_counter() - t0
            launches, forms = read_launches(), read_forms()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            out_dir = os.path.join(cwd, "img_generations/imgs_demo_templatev0.1_lvd_zeroscope/run0/0")
            _read_outputs("cli", out_dir, "video_0")
        finally:
            os.chdir(home)
            for k, v in saved_env.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
    pipe = lvd._state.pipe
    log(f"[cli] generate.main: draw of Zeroscope's UNet, CLIP and VAE on the card "
        f"{seconds['draw'][0]:.3f} s; main() {total:.3f} s (pipeline timer: "
        f"{json.dumps({k: round(v, 4) for k, v in pipe.timer.summary().items()})}; steps "
        f"{[round(x, 4) for x in pipe.timings['steps']]} s, guided updates "
        f"{[round(x, 4) for x in pipe.timings['guided']]} s; GIF and frames file written in "
        f"{seconds['save'][0]:.3f} s, the GIF by the native encoder in "
        f"{seconds['gif'][0]:.3f} s); max_memory_allocated {peak:.3f} GiB")
    if native._STATE.get("lib") is None:
        raise SystemExit("[cli] the GIF was not written by the native encoder")
    log(f"[cli] launches in {NUM_STEPS} steps: {json.dumps(launches)}; by form: {json.dumps(forms)}")
    missing = [name for name in GUIDED_KERNELS if launches[name] <= 0]
    other = {name: {f: n for f, n in forms[name].items() if f != "wgmma" and n}
             for name in CLI_WGMMA}
    if missing or any(other.values()) or any(forms[n]["wgmma"] <= 0 for n in CLI_WGMMA):
        raise SystemExit(f"[cli] kernels never launched {missing}; B-D, F, G outside their "
                         f"wgmma forms {other}")
    _check_cli_draw(torch, pipe)
    lvd._state = base.RunnerState()
    del pipe
    torch.cuda.empty_cache()
    log(f"[cli] the cli phase took {time.perf_counter() - t_phase:.1f} s")
    return out_dir


# The SDXL refiner's CFG forward at 576x1024: latents (2, 72, 128, 4).
SDXL_LATENTS = (2, 72, 128, 4)
SDXL_HEADS = (12, 24)  # kernel A's head counts there (C = 768, 1536)
UPSAMPLE_STEPS = 6  # strength 0.35: int(6 * 0.35) = 2 tail steps, XL and SDXL
XL_FRAMES = (24, 576, 1024, 3)


def sdxl_models(torch):
    """The SDXL refiner at full width (UNet2D, OpenCLIP-bigG with its
    projection, the VAE at scale 0.13025), drawn on the card in bf16 in
    lvd_tpu's key order (split(PRNGKey(0), 3))."""
    from lvd_tpu_torch import pipeline_sdxl as ps
    from lvd_tpu_torch.models.unet2d import sdxl_refiner_config

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    models = ps.drawn_refiner_models(sdxl_refiner_config(), ps.refiner_clip_config(),
                                     ps.refiner_vae_config(), seed=0, device="cuda",
                                     dtype=torch.bfloat16)
    torch.cuda.synchronize()
    count = lambda t: sum(count(v) for v in (t.values() if isinstance(t, dict) else t)) \
        if isinstance(t, (dict, list)) else t.numel()
    log(f"[sdxl] drew the refiner on the card in {time.perf_counter() - t0:.3f} s: UNet2D "
        f"{count(models.unet_params) / 1e6:.1f} M, CLIP {count(models.clip_params) / 1e6:.1f} M, "
        f"VAE {count(models.vae_params) / 1e6:.1f} M parameters")
    return models


@contextlib.contextmanager
def attention_census(torch, records):
    """Appends (heads, S_q, S_k) of every attention() call on which
    packed_attention.kernel_ok held (kernel A's launches)."""
    from lvd_tpu_torch.ops import packed_attention
    from lvd_tpu_torch.ops.plain import swapped

    real_ok = packed_attention.kernel_ok

    def kernel_ok(q, k, num_heads):
        ok = real_ok(q, k, num_heads)
        if ok:
            records.append((num_heads, q.shape[1], k.shape[1]))
        return ok

    with swapped([(packed_attention, "kernel_ok", kernel_ok)]):
        yield


@contextlib.contextmanager
def route_census(torch, records):
    """Appends ("I" or "H", shapes, routed) for every call of lvd_tpu's
    predicates for kernels I (spatial_conv_fused.supported) and H
    (linear_fused.supported) on the path."""
    from lvd_tpu_torch.ops import linear_fused, spatial_conv_fused
    from lvd_tpu_torch.ops.plain import swapped

    real_i, real_h = spatial_conv_fused.supported, linear_fused.supported

    def sup_i(x, w):
        ok = real_i(x, w)
        records.append(("I", (tuple(x.shape), tuple(w.shape)), ok))
        return ok

    def sup_h(w, x):
        ok = real_h(w, x)
        records.append(("H", (tuple(x.shape), tuple(w.shape)), ok))
        return ok

    with swapped([(spatial_conv_fused, "supported", sup_i), (linear_fused, "supported", sup_h)]):
        yield


def sdxl_reference_phase(torch, models, phase="sdxl"):
    """One full-width refiner CFG UNet2D forward at 576x1024 through the
    kernels (bf16) against the plain path (fp32), the plain path in bf16
    beside it, gate REFERENCE_TOL, with every spatial transformer's
    proj_out drawn (``_undegenerate``) so the kernels' branches reach the
    output. Kernel A must launch at the refiner's 12- and 24-head shapes.
    Returns the launches of the kernel forward and the route census."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.models.unet2d import apply_unet2d
    from lvd_tpu_torch.ops.plain import plain_route

    cfg = models.unet_cfg
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = _undegenerate(models.unet_params, gen, torch)
    sample = torch.randn(SDXL_LATENTS, generator=gen, device="cuda")
    hidden = torch.randn((2, 77, cfg.cross_attention_dim), generator=gen, device="cuda")
    added = {"text_embeds": torch.randn((2, 1280), generator=gen, device="cuda"),
             "time_ids": torch.tensor([[576, 1024, 0, 0, 2.5], [576, 1024, 0, 0, 6.0]],
                                      device="cuda")}
    bf = {"text_embeds": added["text_embeds"].bfloat16(), "time_ids": added["time_ids"]}
    run = lambda p, x, c, a: apply_unet2d(p, cfg, x, 500, c, added_cond=a)[0]
    heads, routes = [], []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain path in full fp32
    try:
        with torch.no_grad():
            run(params, sample.bfloat16(), hidden.bfloat16(), bf)  # first call: warm
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            with attention_census(torch, heads), route_census(torch, routes):
                eps = run(params, sample.bfloat16(), hidden.bfloat16(), bf)
            torch.cuda.synchronize()
            kernel_s = time.perf_counter() - t0
            launches, forms = read_launches(), read_forms()
            with plain_route():
                plain = run(params, sample.bfloat16(), hidden.bfloat16(), bf)
                ref = run(cast_tree(params, torch.float32), sample, hidden, added)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    scale = ref.abs().max().item()
    rel = (eps.float() - ref).abs().max().item() / scale
    rel_plain = (plain.float() - ref).abs().max().item() / scale
    a_shapes = sorted(set(heads))
    log(f"[{phase}] refiner CFG UNet2D forward at {SDXL_LATENTS} against the plain path (fp32), "
        f"max|d| / max|ref| (max|ref| {scale:.6g}): kernels (bf16) {rel:.6g} (gate "
        f"{REFERENCE_TOL}); plain path (bf16) {rel_plain:.6g}; kernel forward {kernel_s:.4f} s")
    log(f"[{phase}] launches {json.dumps(launches)}; kernel A at (heads, S_q, S_k) "
        f"{json.dumps(a_shapes)}")
    if not (torch.isfinite(eps).all() and rel <= REFERENCE_TOL):
        raise SystemExit(f"[{phase}] the kernel path disagrees with the plain path")
    missing = [h for h in SDXL_HEADS if h not in {s[0] for s in a_shapes}]
    if missing:
        raise SystemExit(f"[{phase}] kernel A never ran at {missing} heads")
    del eps, plain, ref, params
    torch.cuda.empty_cache()
    return launches, forms, routes


class _TimedPipe:
    """Calls the refiner's pipeline, keeping each call's seconds and phase
    timings."""

    def __init__(self, pipe):
        self.pipe, self.calls = pipe, []

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.pipe(*args, **kwargs)
        self.calls.append({"s": time.perf_counter() - t0, **self.pipe.timings})
        return out


def profile_upsample(torch, xl, sdxl):
    """One Zeroscope-XL CFG UNet forward (2 x 24 frames at 576x1024) and one
    SDXL refiner CFG UNet2D forward (batch 2 at 576x1024) under the
    profiler, on the upsample phase's pipelines."""
    from lvd_tpu_torch.models.unet2d import apply_unet2d
    from lvd_tpu_torch.models.unet3d import apply_unet3d

    gen = torch.Generator(device="cuda").manual_seed(8)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda").bfloat16()
    sample, text = randn(2, 24, 72, 128, 4), randn(2, 77, xl.preset.unet.cross_attention_dim)
    lat, hidden = randn(*SDXL_LATENTS), randn(2, 77, sdxl.m.unet_cfg.cross_attention_dim)
    added = {"text_embeds": randn(2, 1280),
             "time_ids": torch.tensor([[576, 1024, 0, 0, 2.5], [576, 1024, 0, 0, 6.0]],
                                      device="cuda")}
    with torch.no_grad():
        _profile(torch, "one Zeroscope-XL CFG UNet forward",
                 lambda: apply_unet3d(xl.unet_params, xl.preset.unet, sample, 500, text))
        _profile(torch, "one SDXL refiner CFG UNet2D forward",
                 lambda: apply_unet2d(sdxl.unet_params, sdxl.m.unet_cfg, lat, 500, hidden,
                                      added_cond=added))


def upsample_phase(torch, run_dir, refiner):
    """lvd_tpu_torch.cli.upsample.main in-process over the cli phase's run
    dir, --method zsxl+sdxl, UPSAMPLE_STEPS steps (2 tail steps of each):
    the XL pipe by the CLI's own _get_xl_pipe under LVD_ALLOW_RANDOM_WEIGHTS=1
    (Zeroscope-XL drawn on the card), the SDXL pipe the sdxl phase's drawn
    refiner in the module's pipe slot. video_0_zsxl_sdxl's GIF and frames
    file must hold XL_FRAMES uint8; A-D must launch, B-D only in their
    wgmma forms."""
    from lvd_tpu_torch.cli import upsample
    from lvd_tpu_torch.ops.plain import swapped
    from lvd_tpu_torch.pipeline_sdxl import SDXLRefinerPipeline

    t_phase = time.perf_counter()
    draw_s = []
    real_get = upsample._get_xl_pipe

    def get_xl():
        if upsample._xl_pipe is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_get()
            torch.cuda.synchronize()
            draw_s.append(time.perf_counter() - t0)
        return real_get()

    sdxl = _TimedPipe(SDXLRefinerPipeline(refiner, dtype=torch.bfloat16, device="cuda"))
    saved_env = {k: os.environ.get(k) for k in
                 ("LVD_ALLOW_RANDOM_WEIGHTS", "LVD_CHECKPOINT_ROOT", "LVD_TINY", "LVD_PLATFORM")}
    for k in saved_env:
        os.environ.pop(k, None)
    os.environ["LVD_ALLOW_RANDOM_WEIGHTS"] = "1"
    upsample._xl_pipe, upsample._sdxl_pipe = None, sdxl
    try:
        with swapped([(upsample, "_get_xl_pipe", get_xl)]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            t0 = time.perf_counter()
            upsample.main(["--run-dir", os.path.dirname(run_dir), "--method", "zsxl+sdxl",
                           "--num_inference_steps", str(UPSAMPLE_STEPS), "--prompt-type", "demo"])
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        launches, forms = read_launches(), read_forms()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        xl = upsample._xl_pipe.timings
        profile_upsample(torch, upsample._xl_pipe, sdxl.pipe)
    finally:
        upsample._xl_pipe = upsample._sdxl_pipe = None
        for k, v in saved_env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    frame_s = [c["s"] for c in sdxl.calls]
    sdxl_steps = [s for c in sdxl.calls for s in c["steps"]]
    log(f"[upsample] main() {total:.3f} s: Zeroscope-XL drawn on the card in {draw_s[0]:.3f} s; "
        f"XL refine encode {xl['encode']:.4f} s, encode_prompt {xl['encode_prompt']:.4f} s, steps "
        f"{[round(x, 4) for x in xl['steps']]} s, decode {xl['decode']:.4f} s; SDXL "
        f"{len(frame_s)} frames, seconds per frame {[round(x, 3) for x in frame_s]} (mean "
        f"{sum(frame_s) / len(frame_s):.4f}: encode {sdxl.calls[-1]['encode']:.4f}, steps "
        f"{[round(x, 4) for x in sdxl.calls[-1]['steps']]}, decode "
        f"{sdxl.calls[-1]['decode']:.4f} s in the last); SDXL step mean "
        f"{sum(sdxl_steps) / len(sdxl_steps):.4f} s; max_memory_allocated {peak:.3f} GiB")
    log(f"[upsample] launches: {json.dumps(launches)}; by form: {json.dumps(forms)}")
    _read_outputs("upsample", run_dir, "video_0_zsxl_sdxl", XL_FRAMES)
    missing = [name for name in FORWARD_KERNELS if launches[name] <= 0]
    wg = ("temporal_attention_pair", "geglu_mlp", "norm_silu_temporal_conv")
    other = {name: {f: n for f, n in forms[name].items() if f != "wgmma" and n} for name in wg}
    if missing or any(other.values()) or any(forms[n]["wgmma"] <= 0 for n in wg):
        raise SystemExit(f"[upsample] kernels never launched {missing}; B-D outside their "
                         f"wgmma forms {other}")
    torch.cuda.empty_cache()
    log(f"[upsample] the upsample phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# Substrings of the kernels' device symbols (B-D's and F-J's: every form; K's
# two passes).
KERNEL_SYMBOLS = {
    "attention_packed": "attn_packed_kernel",
    "temporal_attention_pair": ("::temporal_pair_kernel", "::temporal_pair_wgmma_kernel",
                                "::temporal_pair_fwd_tf32::"),
    "geglu_mlp": "::geglu_w",
    "norm_silu_temporal_conv": "::temp_conv_w",
    "attention_packed_bwd": "attn_bwd_",
    "temporal_attention_pair_bwd": "::temporal_pair_bwd_",
    "geglu_mlp_bwd": "::geglu_bwd_",
    "linear": "::linear_",
    "conv3x3 (kernel I)": "::conv3x3_",
    "geglu_stream": "::geglu_stream_",
    "group_norm_stats": ("::gn_partial_kernel", "::gn_finish_kernel"),
    "group_norm_apply": "::gn_apply_kernel",
    "layer_norm_rows": "::ln_rows_kernel",
}


# Kinds of stock kernels by substrings of their device symbols, first match
# wins (the census of PERF.md section 5).
STOCK_KINDS = (
    ("conv (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "splitK")),
    ("copy, cast, layout", ("copy", "transpose", "CatArray", "cat_", "index")),
    ("reduction (norm statistics)", ("reduce_kernel", "Reduce")),
    ("softmax", ("oftMax", "softmax")),
    ("add", ("add", "Add")),
    ("mul", ("Mul", "mul")),
    ("silu, gelu, sigmoid", ("silu", "gelu", "Gelu", "sigmoid")),
)


# The train phase: lvd_tpu's training step at the lvd-gligen_zeroscope widths.
TRAIN_FRAMES = 24
TRAIN_STEPS = 3
TRAIN_LR = 1e-4
# |grad(kernels) - grad(plain)| / |grad(plain)| (L2, the flattened gradient of
# every leaf) of one fp32 full-finetune step, and the relative difference of
# its loss. Both routes run fp32; the kernels' products are TF32 inside the
# kernels, the plain route's full fp32 (TF32 off).
TRAIN_GRAD_L2_TOL = 1e-2
TRAIN_LOSS_TOL = 1e-3
TRAIN_UPDATE_L2_TOL = 1e-2  # (d): each adapter leaf's update, where its gradient's sign is sure


def train_batch(torch, cfg, frames, seed=11):
    """A fixed batch on the card: clean latents (1, F, 40, 72, 4), 77 text
    states, and a grounding pack of 2 boxes (bench.py's moving bear and a
    fixed box) in lvd_tpu's 30 slots per frame, the other slots masked."""
    from lvd_tpu_torch.pipeline import MAX_GLIGEN_OBJS

    gen = torch.Generator(device="cuda").manual_seed(seed)
    boxes = torch.zeros((frames, MAX_GLIGEN_OBJS, 4), device="cuda")
    masks = torch.zeros((frames, MAX_GLIGEN_OBJS), device="cuda")
    embs = torch.zeros((frames, MAX_GLIGEN_OBJS, cfg.gligen_positive_len), device="cuda")
    for f in range(frames):
        move = 0.8 * f / max(frames - 1, 1)
        boxes[f, 0] = torch.tensor([0.05 + move, 0.45, 0.30 + move, 0.80])
        boxes[f, 1] = torch.tensor([0.60, 0.05, 0.90, 0.35])
        masks[f, :2] = 1.0
    embs[:, :2] = torch.randn((2, cfg.gligen_positive_len), generator=gen, device="cuda")
    return {"latents": torch.randn((1, frames, 40, 72, 4), generator=gen, device="cuda"),
            "text": torch.randn((1, 77, cfg.cross_attention_dim), generator=gen, device="cuda"),
            "gligen": {"boxes": boxes, "masks": masks, "positive_embeddings": embs}}


def _loss_and_grads(torch, cfg, params, batch, key, trains=None):
    """diffusion_loss at the params and its gradient for every leaf (or for
    each leaf ``trains`` names), fp32."""
    from lvd_tpu_torch.config import SchedulerConfig
    from lvd_tpu_torch.diffusion import schedule
    from lvd_tpu_torch.training import train as tr
    from lvd_tpu_torch.utils.tree import flatten, unflatten_like

    abar = schedule.make_alphas_cumprod(SchedulerConfig())
    tables = [torch.tensor(np.asarray(v, np.float32), device="cuda")
              for v in (abar ** 0.5, (1.0 - abar) ** 0.5)]
    leaves = {p: t.detach().requires_grad_(trains is None or trains(p))
              for p, t in flatten(params).items()}
    loss = tr.diffusion_loss(unflatten_like(params, leaves), cfg, *tables, batch, key)
    wanted = [p for p, t in leaves.items() if t.requires_grad]
    grads = torch.autograd.grad(loss, [leaves[p] for p in wanted])
    return loss.detach(), dict(zip(wanted, grads))


def _timed_steps(torch, step, state, batch, keys):
    losses, seconds = [], []
    for key in keys:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch, key)
        losses.append(loss.item())
        seconds.append(time.perf_counter() - t0)
    return state, losses, seconds


# Kernels whose fp32 forms were redesigned for Hopper: the train phase's
# adapter-only steps must launch their wgmma forms and never their first
# (WMMA) versions (probes/train_step_forms.py times the step with both).
TRAIN_REDESIGNED = ("temporal_attention_pair", "temporal_attention_pair_bwd", "geglu_mlp_bwd")


@contextlib.contextmanager
def kernel_shape_census(counts):
    """Counts the launches of kernels B, C, F, G and J by (kernel, shape,
    type) into ``counts``, through their wrappers; the launches made while
    it is on reach no launch counter that read_launches() reads."""
    from lvd_tpu_torch.ops import geglu_fused, temporal_attention
    from lvd_tpu_torch.ops.plain import swapped

    def counted(kernel, fn, arg):
        def call(*args, **kwargs):
            t = args[arg]
            key = f"{kernel} {list(t.shape)} {str(t.dtype).replace('torch.', '')}"
            counts[key] = counts.get(key, 0) + 1
            return fn(*args, **kwargs)
        # A wrapper counts its launches on itself, by its module-level name.
        call.launches = 0
        if hasattr(fn, "launches_by_form"):
            call.launches_by_form = dict.fromkeys(fn.launches_by_form, 0)
        return call

    with swapped([
            (temporal_attention, "_launch_forward",
             counted("B", temporal_attention._launch_forward, 1)),
            (temporal_attention, "temporal_attention_pair_bwd",
             counted("F", temporal_attention.temporal_attention_pair_bwd, 1)),
            (geglu_fused, "_launch_forward", counted("C", geglu_fused._launch_forward, 1)),
            (geglu_fused, "geglu_mlp_bwd", counted("G", geglu_fused.geglu_mlp_bwd, 1)),
            (geglu_fused, "geglu_stream", counted("J", geglu_fused.geglu_stream, 1))]):
        yield


def train_breakdown(torch, label, step, state, batch, key):
    """One train step's breakdown: its launches of B, C, F, G and J by shape,
    then the step's seconds and peak memory (one step) and its device ms by
    kernel and by kernel symbol (the form) under the profiler (two more
    steps)."""
    counts = {}
    with kernel_shape_census(counts):
        state, _ = step(state, batch, key)
    log(f"[train] {label}: launches a step by kernel, shape and type: {json.dumps(counts)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, loss = step(state, batch, key)
    loss = loss.item()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] {label}: one step {seconds:.3f} s, loss {loss:.6g}, max_memory_allocated "
        f"{peak:.3f} GiB")
    prof = _profile(torch, f"{label} step", lambda: step(state, batch, key))
    return state, {"launches": counts, "seconds": seconds, "peak_gib": peak, **prof}


def train_phase(torch):
    """lvd_tpu's Trainer on the port at the lvd-gligen_zeroscope widths, fp32,
    batch 1, weights drawn on the card in lvd_tpu's key order: 3
    adapter-only steps on one fixed batch (loss finite, every frozen leaf
    bit-unchanged, every fuser and position_net leaf moved, A-G launched),
    then one full-finetune step's gradient through the kernels against the
    plain route, and one full Trainer step timed. Returns the adapter-only
    steps' launches."""
    from lvd_tpu_torch.config import PRESETS
    from lvd_tpu_torch.models.unet3d import init_unet3d
    from lvd_tpu_torch.training import train as tr
    from lvd_tpu_torch.utils import prng
    from lvd_tpu_torch.utils.tree import flatten

    cfg = PRESETS["lvd-gligen_zeroscope"].unet
    t_phase = time.perf_counter()
    params = init_unet3d(prng.prng_key(0), cfg, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    flat = flatten(params)
    n_params = sum(t.numel() for t in flat.values())
    log(f"[train] drew the gated Zeroscope UNet (fp32, {n_params / 1e6:.1f} M parameters) on the "
        f"card in {time.perf_counter() - t_phase:.3f} s")

    batch = train_batch(torch, cfg, TRAIN_FRAMES)
    trainer = tr.Trainer(cfg, learning_rate=TRAIN_LR, adapter_only=True)
    state = trainer.init(params)
    frozen = {p: t.cpu() for p, t in flat.items() if not trainer.tx.trains(p)}
    trained = {p: t.clone() for p, t in flat.items() if trainer.tx.trains(p)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    state, losses, seconds = _timed_steps(torch, trainer.make_step(), state, batch,
                                          [prng.prng_key(i) for i in range(TRAIN_STEPS)])
    launches, forms = read_launches(), read_forms()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = flatten(state.params)
    changed = [p for p, t in frozen.items() if not torch.equal(after[p].cpu(), t)]
    still = [p for p, t in trained.items() if torch.equal(after[p], t)]
    log(f"[train] adapter-only, {len(trained)} trained leaves "
        f"({sum(t.numel() for t in trained.values()) / 1e6:.1f} M) of {len(flat)}, "
        f"{TRAIN_FRAMES} frames: losses {losses}; seconds per step {seconds}; "
        f"max_memory_allocated {peak:.3f} GiB")
    log(f"[train] adapter-only launches in {TRAIN_STEPS} steps: {json.dumps(launches)}; by form: "
        f"{json.dumps(forms)}")
    missing = [name for name in GUIDED_KERNELS if launches[name] <= 0]
    if not all(math.isfinite(x) for x in losses) or changed or still or missing:
        raise SystemExit(f"[train] adapter-only: losses {losses}, frozen leaves changed "
                         f"{changed[:5]}, trained leaves that never moved {still[:5]}, kernels "
                         f"never launched {missing}")
    check_new_forms("train", forms, TRAIN_REDESIGNED)
    state, _ = train_breakdown(torch, "adapter-only", trainer.make_step(), state, batch,
                               prng.prng_key(TRAIN_STEPS))
    del state, trainer, frozen, trained, after
    torch.cuda.empty_cache()

    full_step_check(torch, cfg, params)
    del params, flat
    torch.cuda.empty_cache()
    log(f"[train] the train phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def full_step_check(torch, cfg, params):
    """One full-finetune step's gradient (every leaf) through the kernels
    against the plain route on the same params, batch and key, then one
    Trainer step (AdamW over every leaf), timed."""
    from lvd_tpu_torch.ops.plain import plain_route
    from lvd_tpu_torch.training import train as tr
    from lvd_tpu_torch.utils import prng
    from lvd_tpu_torch.utils.tree import flatten, unflatten_like

    batch = train_batch(torch, cfg, TRAIN_FRAMES)
    key = prng.prng_key(7)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain route in full fp32
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss_k, grads_k = _loss_and_grads(torch, cfg, params, batch, key)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        peak_grad = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        with plain_route():
            loss_p, grads_p = _loss_and_grads(torch, cfg, params, batch, key)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    num = sum(((grads_k[p] - g).double() ** 2).sum() for p, g in grads_p.items()).item()
    den = sum((g.double() ** 2).sum() for g in grads_p.values()).item()
    rel = math.sqrt(num / den)
    worst = sorted(((((grads_k[p] - g).norm() / g.norm()).item() if g.norm() > 0 else 0.0, p)
                    for p, g in grads_p.items()), reverse=True)[:3]
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"[train] full-finetune gradient at {TRAIN_FRAMES} frames, kernels against the plain "
        f"route (fp32): loss {loss_k.item():.6g} / {loss_p.item():.6g} (rel {rel_loss:.3g}, gate "
        f"{TRAIN_LOSS_TOL}); |d| / |ref| (L2, all {len(grads_p)} leaves) {rel:.6g} (gate "
        f"{TRAIN_GRAD_L2_TOL}); worst leaves {worst}; loss and gradient {kernel_s:.3f} s "
        f"(plain route {plain_s:.3f} s), max_memory_allocated {peak_grad:.3f} GiB")
    del grads_k, grads_p
    torch.cuda.empty_cache()
    if not (rel <= TRAIN_GRAD_L2_TOL and rel_loss <= TRAIN_LOSS_TOL):
        raise SystemExit("[train] the kernels' full-finetune gradient disagrees with the plain "
                         "route")
    trainer = tr.Trainer(cfg, learning_rate=TRAIN_LR)
    own = unflatten_like(params, {p: t.clone() for p, t in flatten(params).items()})
    state = trainer.init(own)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    state, losses, seconds = _timed_steps(torch, trainer.make_step(), state, batch, [key])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] full-finetune Trainer step at {TRAIN_FRAMES} frames: loss {losses[0]:.6g}; "
        f"{seconds[0]:.3f} s; max_memory_allocated {peak:.3f} GiB (params, grads and AdamW "
        f"moments included); launches {json.dumps(read_launches())}")
    if not math.isfinite(losses[0]):
        raise SystemExit("[train] the full-finetune step's loss is not finite")
    state, _ = train_breakdown(torch, "full-finetune", trainer.make_step(), state, batch, key)
    del state, own, trainer


# The image phase: the 2D path at SD 1.x widths, 512x512.
IMAGE_HW = (64, 64)  # latents of a 512x512 image
IMAGE_STEPS, IMAGE_GUIDED = 4, 2  # guidance (one update) on the first 2 of 4 steps
IMAGE_OBJECTS = (("bear", [0.05, 0.40, 0.50, 0.95]), ("bird", [0.55, 0.05, 0.90, 0.40]))
# Kernel C (forward) and G (dx) launches at 64x64 latents, by lvd_tpu's
# feed-forward predicate: resident weights and at least 2048 rows
# (lvd_tpu/ops/geglu_fused.py). A CFG forward (batch 2) fuses the 10 sites at
# C = 320 and 640 (L0's 2 x 4096 rows, L1's 2 x 1024). The guided update runs
# on the cond batch alone, where L1's 1024 rows take the stock route: its
# walk takes C at L0's 5 sites and again at the 2 down-block ones it
# recomputes (remat), and G takes dx at those 2, which lie before the last
# captured block.
IMAGE_C_PER_FORWARD = 10
IMAGE_C_PER_UPDATE, IMAGE_G_PER_UPDATE = 7, 2


def image_models(torch):
    """UNet2DConfig() (SD 1.x: (320, 640, 1280, 1280), 8 heads,
    cross-attention 768), a CLIP text tower at ViT-L/14's widths (768 wide,
    12 layers, 12 heads, 3072 inner, lvd_tpu's "gelu") and the Zeroscope
    preset's VAE (SD's), drawn on the card in bf16 in lvd_tpu's key order
    from split(PRNGKey(1), 3)."""
    from lvd_tpu_torch.config import PRESETS, CLIPTextConfig
    from lvd_tpu_torch.models.clip import init_clip_text
    from lvd_tpu_torch.models.unet2d import UNet2DConfig, init_unet2d
    from lvd_tpu_torch.models.vae import init_vae
    from lvd_tpu_torch.utils import prng

    keys = prng.split(prng.prng_key(1), 3)
    clip_cfg = CLIPTextConfig(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                              num_attention_heads=12, projection_dim=768)
    vae_cfg = PRESETS["zeroscope"].vae
    cfg = UNet2DConfig()
    t0 = time.perf_counter()
    models = {"unet": init_unet2d(keys[0], cfg, device="cuda", dtype=torch.bfloat16),
              "clip": init_clip_text(keys[1], clip_cfg, device="cuda", dtype=torch.bfloat16),
              "vae": init_vae(keys[2], vae_cfg, device="cuda", dtype=torch.bfloat16),
              "unet_cfg": cfg, "clip_cfg": clip_cfg, "vae_cfg": vae_cfg}
    torch.cuda.synchronize()
    log(f"[image] drew SD 1.x's UNet2D, a ViT-L/14-wide CLIP and the VAE on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    return models


def image_reference_phase(torch, models, text_pair, guidance, g_cfg, latents):
    """One CFG UNet2D forward at 512x512 through the kernels (bf16) against
    the plain path (fp32), gate REFERENCE_TOL, with every proj_out drawn
    (``_undegenerate``); then one guided update's latent gradient against
    the plain route (fp32) at the video gates (GRADIENT_TOL max-element,
    GRADIENT_L2_TOL L2)."""
    from lvd_tpu_torch import pipeline2d
    from lvd_tpu_torch.diffusion.guidance import OVERALL_GUIDANCE_ATTN_KEYS
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.models.unet2d import apply_unet2d
    from lvd_tpu_torch.ops.plain import plain_route

    cfg = models["unet_cfg"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    params = _undegenerate(models["unet"], gen, torch)
    params32 = cast_tree(params, torch.float32)
    sample = torch.randn((2, *IMAGE_HW, 4), generator=gen, device="cuda")
    text = text_pair.float()
    run = lambda p, x, c: apply_unet2d(p, cfg, x, 500, c)[0]
    keys = OVERALL_GUIDANCE_ATTN_KEYS
    walk = lambda p, lat, dt, c: pipeline2d._energy_and_grad(p, cfg, lat, 801, c, guidance, keys,
                                                             g_cfg, dt, None)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain path in full fp32
    try:
        with torch.no_grad():
            eps = run(params, sample.bfloat16(), text.bfloat16())
            with plain_route():
                ref = run(params32, sample, text)
        lat = latents.float()
        e_k, g_k = walk(params, lat, torch.bfloat16, text[1:].bfloat16())
        with plain_route():
            e_r, g_r = walk(params32, lat, torch.float32, text[1:])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    scale = ref.abs().max().item()
    rel = (eps.float() - ref).abs().max().item() / scale
    g_scale = g_r.abs().max().item()
    g_rel = (g_k - g_r).abs().max().item() / g_scale
    g_l2 = ((g_k - g_r).norm() / g_r.norm()).item()
    log(f"[image] CFG UNet2D forward at {IMAGE_HW} against the plain path (fp32), max|d| / "
        f"max|ref| (max|ref| {scale:.6g}): kernels (bf16) {rel:.6g} (gate {REFERENCE_TOL})")
    log(f"[image] guided update's d(energy)/d(latents) against the plain route (fp32): energy "
        f"{e_k.item():.6g} / {e_r.item():.6g}; max|d| / max|ref| {g_rel:.6g} (gate "
        f"{GRADIENT_TOL}); |d| / |ref| (L2) {g_l2:.6g} (gate {GRADIENT_L2_TOL})")
    if not (torch.isfinite(eps).all() and rel <= REFERENCE_TOL):
        raise SystemExit("[image] the kernel path's UNet2D forward disagrees with the plain path")
    if not (torch.isfinite(g_k).all() and g_rel <= GRADIENT_TOL and g_l2 <= GRADIENT_L2_TOL):
        raise SystemExit("[image] the kernels' guided gradient disagrees with the plain route")
    del eps, ref, params, params32, g_k, g_r
    torch.cuda.empty_cache()


def image_phase(torch):
    """The 2D image path at SD 1.x's 512x512 in bf16: encode_prompts on the
    ViT-L/14-wide CLIP, two per-object runs of generate_semantic_guidance
    (4 steps, one guided update on each of the first 2, save_all_latents)
    from get_input_latents_list's blended noise, their histories and the
    background through compose_latents_with_alignment, and decode_images
    of both objects and the composition, (3, 512, 512, 3) in [0, 1]. Each
    run must launch kernels C and G exactly as often as lvd_tpu routes them
    (``IMAGE_C_PER_FORWARD`` and the update's counts); then the reference
    and gradient gates (``image_reference_phase``). Returns the runs'
    launches."""
    from lvd_tpu_torch import pipeline2d
    from lvd_tpu_torch.config import SchedulerConfig
    from lvd_tpu_torch.diffusion.guidance import OVERALL_GUIDANCE_ATTN_KEYS, GuidanceConfig
    from lvd_tpu_torch.layout import latents as lat_mod
    from lvd_tpu_torch.models.encode import encode_prompts
    from lvd_tpu_torch.text.templates import NEGATIVE_PROMPT
    from lvd_tpu_torch.text.tokenizer import load_tokenizer

    t_phase = time.perf_counter()
    models = image_models(torch)
    cfg, keys = models["unet_cfg"], OVERALL_GUIDANCE_ATTN_KEYS
    tok = load_tokenizer(None)
    # loss_threshold 0: every guided step takes its one update
    g_cfg = GuidanceConfig(loss_scale=2.5, loss_threshold=0.0, max_iter=1,
                           max_index_step=IMAGE_GUIDED, fg_top_p=0.25, bg_top_p=0.25,
                           bg_weight=2.0)
    boxes = [box for _, box in IMAGE_OBJECTS]
    size = (8 * IMAGE_HW[0], 8 * IMAGE_HW[1])
    starts, latents_bg = lat_mod.get_input_latents_list(
        cfg.in_channels, 1, 2, 0.1, *size, boxes, dtype=torch.bfloat16, device="cuda")
    want = {"geglu_mlp": IMAGE_STEPS * IMAGE_C_PER_FORWARD + IMAGE_GUIDED * IMAGE_C_PER_UPDATE,
            "geglu_mlp_bwd": IMAGE_GUIDED * IMAGE_G_PER_UPDATE}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    finals, histories, total, guide = [], [], {}, None
    for (name, box), start in zip(IMAGE_OBJECTS, starts):
        prefix = "a realistic photo of a"
        t0 = time.perf_counter()
        text_pair, _, _ = encode_prompts(models["clip"], models["clip_cfg"], tok,
                                         [f"{prefix} {name}"], NEGATIVE_PROMPT)
        position = len(tok.encode(prefix)) - 1
        guide = pipeline2d.build_image_guidance([box], [[position]], keys, IMAGE_HW, g_cfg,
                                                device="cuda")
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        zero_launches()
        t0 = time.perf_counter()
        final, history = pipeline2d.generate_semantic_guidance(
            models["unet"], cfg, start, text_pair, SchedulerConfig(), IMAGE_STEPS,
            guidance=guide, guidance_cfg=g_cfg, guidance_attn_keys=keys, save_all_latents=True)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_launches()
        got = {k: launches[k] for k in want}
        log(f"[image] {name}: encode_prompts + guidance pack {encode_s:.3f} s; "
            f"generate_semantic_guidance {run_s:.3f} s ({IMAGE_STEPS} steps, guided "
            f"{IMAGE_GUIDED}); history {tuple(history.shape)}; launches {json.dumps(launches)}; "
            f"C and G {got} (want {want})")
        if got != want or tuple(history.shape) != (IMAGE_STEPS + 1, 1, *IMAGE_HW, 4):
            raise SystemExit(f"[image] {name}: launches {got} against {want}, "
                             f"history {tuple(history.shape)}")
        finals.append(final)
        histories.append(history)
        total = {k: total.get(k, 0) + n for k, n in launches.items()}
    masks = [lat_mod.proportion_to_mask(box, *IMAGE_HW) for box in boxes]
    t0 = time.perf_counter()
    composed, fg_idx, offsets = lat_mod.compose_latents_with_alignment(
        histories, masks, latents_bg, overall_bboxes=[[box] for box in boxes])
    imgs = pipeline2d.decode_images(models["vae"], models["vae_cfg"],
                                    torch.cat([*finals, composed[-1]]))
    torch.cuda.synchronize()
    log(f"[image] compose_latents_with_alignment + decode_images {time.perf_counter() - t0:.3f} s:"
        f" images {tuple(imgs.shape)} {imgs.dtype}, min {imgs.min().item():.4f} max "
        f"{imgs.max().item():.4f}; foreground indices {torch.bincount(fg_idx.flatten()).tolist()};"
        f" offsets {offsets}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    if tuple(imgs.shape) != (3, *size, 3) or not torch.isfinite(imgs).all():
        raise SystemExit(f"[image] bad images {tuple(imgs.shape)}")
    image_reference_phase(torch, models, text_pair, guide, g_cfg, starts[-1])
    del models, finals, histories, composed, imgs
    torch.cuda.empty_cache()
    log(f"[image] the image phase took {time.perf_counter() - t_phase:.1f} s")
    return total


def profile_phase(torch, models):
    """Device time of one CFG UNet forward at the generation's shapes and of
    one guided update (the energy walk and its backward), each split into
    the kernels and the stock ops; idle share = 1 - busy / wall."""
    from lvd_tpu_torch.diffusion import dpm_solver as dpm
    from lvd_tpu_torch.diffusion.sampler import energy_and_grad

    text = profile_cfg_forward(torch, models, "one CFG UNet forward")
    cfg = models.preset.unet
    guide = flagship_guidance()
    pack = guidance_tensors(guide)
    lat = seeded_latents(torch)
    t = int(dpm.make_coeffs(models.preset.scheduler, 40).timestep[0])
    _profile(torch, "one guided update", lambda: energy_and_grad(
        models.unet_params, cfg, lat, t, text[1:], pack, guide["attn_keys"], guide["config"],
        torch.bfloat16))


def profile_cfg_forward(torch, models, label):
    """One bf16 CFG UNet forward at the generation's shapes under the
    profiler; returns its (2, 77, C) text embedding."""
    from lvd_tpu_torch.models.unet3d import apply_unet3d

    cfg = models.preset.unet
    gen = torch.Generator(device="cuda").manual_seed(2)
    sample = torch.randn((2, 24, 40, 72, 4), generator=gen, device="cuda").bfloat16()
    text = torch.randn((2, 77, cfg.cross_attention_dim), generator=gen,
                       device="cuda").bfloat16()
    with torch.no_grad():
        _profile(torch, label, lambda: apply_unet3d(models.unet_params, cfg, sample, 500, text))
    return text


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
    symbols = {kname: (sym,) if isinstance(sym, str) else sym
               for kname, sym in KERNEL_SYMBOLS.items()}
    for kname, syms in symbols.items():
        hits = [v for k, v in by_name.items() if any(sym in k for sym in syms)]
        if hits:
            split[kname] = {"ms": round(sum(ms for ms, _ in hits), 3),
                            "calls": sum(n for _, n in hits)}
    ours = {k for k in by_name if any(sym in k for syms in symbols.values() for sym in syms)}
    stock = sorted(((ms, n, k) for k, (ms, n) in by_name.items() if k not in ours),
                   reverse=True)
    split["stock"] = {"ms": round(sum(ms for ms, _, _ in stock), 3),
                      "calls": sum(n for _, n, _ in stock)}
    log(f"[profile] {label}: wall {wall_ms:.3f} ms (CUDA events, profiler on), "
        f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}")
    log(f"[profile] {label}, device ms by kernel: {json.dumps(split)}")
    by_symbol = {k[:120]: [round(ms, 3), n] for k, (ms, n) in sorted(
        by_name.items(), key=lambda kv: -kv[1][0]) if k in ours}
    log(f"[profile] {label}, the kernels' device ms and calls by symbol (form): "
        f"{json.dumps(by_symbol)}")
    kinds = {}
    for ms, n, k in stock:
        kind = next((kind for kind, subs in STOCK_KINDS if any(sub in k for sub in subs)),
                    "other")
        kinds.setdefault(kind, [0.0, 0])
        kinds[kind][0] += ms
        kinds[kind][1] += n
    log(f"[profile] {label}, stock device ms and calls by kind: "
        f"{json.dumps({k: [round(ms, 3), n] for k, (ms, n) in kinds.items()})}")
    for ms, n, k in stock[:30]:
        log(f"[profile] {label}, stock {ms:.3f} ms in {n} calls: {k[:300]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "split": split, "by_symbol": by_symbol}


def knob_child(torch) -> int:
    """The knob phase's body, in a child process whose environment holds
    KNOBS: the reference forward and the guided gradient through kernels A-I
    against the plain path, then the guided generation (this slice's main
    path). Its last line is the generation's launch counts."""
    missing = [k for k, v in KNOBS.items() if os.environ.get(k) != v]
    if missing:
        raise SystemExit(f"[knobs] switches not set: {missing}")
    from lvd_tpu_torch.ops import _build

    _build.lib()
    models = lvd_tpu_models(torch, "zeroscope")
    zero_launches()
    reference_phase(torch, models)
    ref_launches = read_launches()
    log(f"[reference] launches: {json.dumps(ref_launches)}")
    if ref_launches["linear"] <= 0 or ref_launches["norm_silu_conv2d"] <= 0:
        raise SystemExit("[reference] the switches did not route kernels H and I")
    check_new_forms("reference", read_forms(), ("temporal_attention_pair",))
    gradient_phase(torch, models)
    _, launches = guided_generation_phase(torch, models, KNOB_KERNELS)
    forms = read_forms()
    profile_cfg_forward(torch, models, "one CFG UNet forward under the switches")
    del models
    torch.cuda.empty_cache()
    sdxl_knob(torch)
    print("KNOB_LAUNCHES " + json.dumps({"launches": launches, "forms": forms}), flush=True)
    return 0


def sdxl_knob(torch):
    """The sdxl reference forward again under KNOBS: which of the refiner's
    resnet-conv and projection shapes lvd_tpu's predicates route to kernels
    I and H; each routed conv launches I once and the projections launch H,
    every launch in its new form (wgmma in bf16); every other shape runs
    stock ops. Every routed shape must be one the kernels phase checked
    (selfcheck.SDXL_SCONV_SHAPES, SDXL_LINEAR_SHAPES)."""
    from lvd_tpu_torch.ops import selfcheck

    refiner = sdxl_models(torch)
    launches, forms, routes = sdxl_reference_phase(torch, refiner, "sdxl knobs")
    del refiner
    torch.cuda.empty_cache()
    as_checked = {  # (x, w) shapes -> the selfcheck's shape tuples
        "I": (lambda x, w: (*x, w[-1]), selfcheck.SDXL_SCONV_SHAPES),
        "H": (lambda x, w: (math.prod(x[:-1]), *w), selfcheck.SDXL_LINEAR_SHAPES)}
    for kind, name in (("I", "norm_silu_conv2d"), ("H", "linear")):
        routed = sorted({shape for k, shape, ok in routes if k == kind and ok})
        to_check, checked = as_checked[kind]
        unchecked = [r for r in routed if to_check(*r) not in checked]
        if unchecked:
            raise SystemExit(f"[sdxl knobs] kernel {kind} routed at shapes the kernels phase "
                             f"did not check: {unchecked}")
        stock = sorted({shape for k, shape, ok in routes if k == kind and not ok})
        calls = sum(1 for k, _, ok in routes if k == kind and ok)
        log(f"[sdxl knobs] kernel {kind}: routed (x, w) shapes {json.dumps(routed)}; stock "
            f"{json.dumps(stock)}; {calls} routed calls, {launches[name]} launches, by form "
            f"{json.dumps(forms[name])}")
        old = {f: n for f, n in forms[name].items() if f != "wgmma" and n}
        if old or (routed and launches[name] <= 0) or (kind == "I" and launches[name] != calls):
            raise SystemExit(f"[sdxl knobs] kernel {kind} launched {launches[name]} times for "
                             f"{calls} routed calls, outside its new form {old}")


def knob_phase(torch):
    """Runs knob_child in a child process with KNOBS set (LVD_FUSED_LINEAR is
    read at import); its output is echoed, a non-zero exit is fatal. Returns
    the guided generation's launches and C's, D's, H's and I's launches by
    form."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--knob-phase"],
                          env={**os.environ, **KNOBS}, capture_output=True, text=True,
                          timeout=900)
    knob = None
    for line in proc.stdout.splitlines():
        if line.startswith("KNOB_LAUNCHES "):
            knob = json.loads(line[len("KNOB_LAUNCHES "):])
        else:
            log(f"[knobs] {line}")
    log(f"[knobs] child exit {proc.returncode} after {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0 or knob is None:
        log(proc.stderr[-8000:])
        raise SystemExit("[knobs] the knob phase failed")
    return knob["launches"], knob["forms"]


def fp32_phase(torch, models):
    """One full-width CFG UNet forward in the pipeline's default type (fp32)
    through the kernels, against the plain path in fp32, TF32 off on both;
    B must launch its fp32 wgmma form only, and no kernel a WMMA form."""
    from lvd_tpu_torch.models.unet3d import apply_unet3d
    from lvd_tpu_torch.ops.plain import plain_route
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
        launches, forms = read_launches(), read_forms()
        check_norm_launches("fp32", params, launches, forms)
        with plain_route():
            ref = apply_unet3d(params, cfg, sample, 500, text)
    scale = ref.abs().max().item()
    rel = (eps - ref).abs().max().item() / scale
    log(f"[fp32] full-width CFG UNet forward in fp32 through the kernels against the plain "
        f"path (fp32, TF32 off), max|d| / max|ref| (max|ref| {scale:.6g}): {rel:.6g} "
        f"(gate {FP32_REFERENCE_TOL}); kernel path {start.elapsed_time(end):.3f} ms (first "
        f"fp32 call, CUDA events); launches {json.dumps(launches)}; by form {json.dumps(forms)}")
    missing = [name for name in FORWARD_KERNELS if launches[name] <= 0]
    if missing or eps.dtype != torch.float32:
        raise SystemExit(f"[fp32] kernels never launched in fp32: {missing}")
    check_new_forms("fp32", forms, ("temporal_attention_pair",))
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
    forms = read_forms()["conv3x3"]
    j_forms = read_forms()["geglu_stream"]
    a_forms = {"A": read_forms()["attention_packed"], "E": read_forms()["attention_packed_bwd"]}
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
        f"geglu_mlp_bwd {launches['geglu_mlp_bwd']}, conv3x3 by form {json.dumps(forms)}, "
        f"geglu_stream by form {json.dumps(j_forms)}, A and E by form {json.dumps(a_forms)}")
    want = {"sdpa": len(ENTRY_SDPA), "sdpa_bwd": len(ENTRY_SDPA), "conv3x3": 1,
            "geglu_stream": len(ff_in)}
    # J's wgmma form for the bf16 call; fp32 keeps the first version.
    j_want = {"wgmma": 1, "wmma": 1}
    # A and E: D = 64 in its own form, 192 and 256 in the wide form, never D-sliced.
    a_want = {"D64": 1, "D128": 0, "wide": len(ENTRY_SDPA) - 1, "sliced": 0}
    if (entry != want or launches["geglu_mlp_bwd"] != 0 or forms["wgmma"] != 1
            or j_forms != j_want or any(f != a_want for f in a_forms.values())):
        raise SystemExit(f"[entry] launches {entry}, geglu_mlp_bwd "
                         f"{launches['geglu_mlp_bwd']}, conv3x3 by form {forms}, "
                         f"geglu_stream by form {j_forms} and A and E by form {a_forms}, "
                         f"expected {want}, 0, one wgmma launch, {j_want} and {a_want}")
    bad = {k: e for k, e in errs.items() if not e <= tols.get(k, 2e-2)}
    if bad:
        raise SystemExit(f"[entry] an entry point disagrees with its plain version: {bad}")
    return entry, {"conv3x3": forms, "geglu_stream": j_forms,
                   "sdpa": {f"{k} {f}": n for k, fs in a_forms.items() for f, n in fs.items()}}


# The sharded phase: lvd_tpu's frame-sharded sampling and the trainer's
# ("data", "model") mesh on torch.distributed. Two gloo ranks share the card
# (NCCL refuses two ranks on one device; gloo copies through the host), and
# rank 0 alone then runs a one-rank NCCL group, the deployment's backend.
SHARDED_RANKS = 2
SHARDED_TIMEOUT = 900   # seconds: every collective's limit, and the parent's wait
SHARDED_TRAIN_FRAMES = 8
SHARDED_FORWARD = ("attention_packed", "temporal_attention_pair", "geglu_mlp") + NORM_KERNELS
SHARDED_BACKWARD = ("attention_packed_bwd", "temporal_attention_pair_bwd", "geglu_mlp_bwd")


def _rel_max(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def _update_err(got, ref):
    """|got - ref| / |ref| (L2), or |got| where ref is all zero."""
    scale = ref.float().norm()
    return (got.float() - ref.float()).norm().item() / scale.item() if scale > 0 else \
        got.float().norm().item()


def _masked_update_err(torch, update, ref, grad, g_ref):
    """_update_err over the elements whose reference gradient exceeds the
    gradient gate's whole budget, TRAIN_GRAD_L2_TOL * |g_ref| (L2): where
    that gate passes, no such element's gradient can change sign, so its
    first AdamW update (about lr times that sign) must agree. Also returns
    the count of elements whose gradient changed sign, and of those the
    mask kept."""
    keep = g_ref.float().abs() > TRAIN_GRAD_L2_TOL * g_ref.float().norm()
    flips = torch.sign(grad) != torch.sign(g_ref)
    return (_update_err(update[keep], ref[keep]), int(flips.sum()),
            int((flips & keep).sum()), int(keep.sum()), keep.numel())


def _exact_first_moment(torch, cfg, params, batch, key):
    """AdamW's first moment after a first adapter-only step, (1 - b1) g, from
    the exact fp32 gradient of the unsharded step: the plain route with TF32
    off (as the train phase's reference), each trained leaf."""
    from lvd_tpu_torch.ops.plain import plain_route
    from lvd_tpu_torch.ops.selfcheck import exact_fp32
    from lvd_tpu_torch.training import train as tr

    tx = tr.make_optimizer(TRAIN_LR, adapter_only=True, params=params)
    with plain_route(), exact_fp32():
        _, grads = _loss_and_grads(torch, cfg, params, batch, key, tx.trains)
    return {p: (1 - tx.b1) * g for p, g in grads.items()}


def _leaf_gate(got, ref, exact):
    """The mesh step's leaf gradient ``got`` against the unsharded step's
    ``ref``: (gap, gate, exempt), gap = _update_err(got, ref). The gate is
    TRAIN_GRAD_L2_TOL wherever the unsharded gradient lies within it of the
    exact fp32 gradient ``exact`` (the plain route, TF32 off). A leaf whose
    unsharded gradient is itself further than that from exact (a gated
    fuser's scalar alpha whose gradient is mostly rounding of cancelling
    terms, ROADMAP C9) is exempt from it and held instead to that distance,
    |got - ref| <= |ref - exact| (over |ref|): the mesh may move it no
    further than the kernels' rounding already does."""
    gap = _update_err(got, ref)
    if _update_err(ref, exact) <= TRAIN_GRAD_L2_TOL:
        return gap, TRAIN_GRAD_L2_TOL, False
    scale = ref.float().norm().item()
    off = (ref.float() - exact.float()).norm().item()
    return gap, off / scale if scale > 0 else off, True


def _applied_err(torch, tx, start, updates, grads):
    """The worst leaf's update against the one ``tx`` (the step's AdamW)
    makes from the same start on one device with the step's own gradient,
    read from its first moment (mu / (1 - b1) on a first step): the blocks
    of params and moments lined up and were written where they belong."""
    def err(p, g):
        mine = {p: start[p].clone()}
        zero = {"count": 0, "mu": {p: torch.zeros_like(g)}, "nu": {p: torch.zeros_like(g)}}
        tx.update({p: g / (1 - tx.b1)}, zero, mine)
        return _update_err(updates[p], mine[p] - start[p])

    return max((err(p, g), p) for p, g in grads.items())


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def _exact_fp32(torch):
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain path in full fp32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _report(rank, part, out, keys):
    """One rank's readings of one check, as it goes."""
    log(f"[sharded] rank {rank} {part}: {json.dumps({k: out[k] for k in keys if k in out})}")


def _sharded_launches(phase, launches, need):
    """The sharded path launched every kernel of ``need`` and never kernel
    D (lvd_tpu sends a sharded temporal conv to GroupNorm + halo conv3d)."""
    missing = [k for k in need if launches[k] <= 0]
    if missing or launches["norm_silu_temporal_conv"]:
        raise SystemExit(f"[sharded] {phase}: kernels never launched {missing}, kernel D "
                         f"launched {launches['norm_silu_temporal_conv']} times")


def _sharded_forward(torch, models, mesh, rank, nccl, out):
    """(a) one CFG UNet forward frame-sharded against the plain path (fp32),
    and (e) the same forward through a one-rank NCCL group on rank 0."""
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.models.unet3d import apply_unet3d
    from lvd_tpu_torch.ops.plain import plain_route
    from lvd_tpu_torch.parallel import comm
    from lvd_tpu_torch.parallel.mesh import block

    cfg = models.preset.unet
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = _undegenerate(models.unet_params, gen, torch)
    sample = torch.randn((2, 24, 40, 72, 4), generator=gen, device="cuda")
    text = torch.randn((2, 77, cfg.cross_attention_dim), generator=gen, device="cuda")
    axis = mesh.data
    fwd = lambda ax, s: apply_unet3d(params, cfg, s.bfloat16(), 500, text.bfloat16(),
                                     spmd_axis=ax)
    with torch.no_grad():
        zero_launches()
        comm.reset_census()
        local, first = _timed(torch, lambda: fwd(axis, block(sample, axis, 1)))
        out["census_forward"] = comm.read_census()
        out["launches_forward"] = read_launches()
        _sharded_launches("(a) sharded CFG forward", out["launches_forward"], SHARDED_FORWARD)
        _, out["forward_s"] = _timed(torch, lambda: fwd(axis, block(sample, axis, 1)))
        out["forward_first_s"] = first
        eps = comm.gather(local, axis, 1)
        _report(rank, "(a) forward", out, ("forward_first_s", "forward_s", "census_forward",
                                           "launches_forward"))
        if rank != 0:
            return
        fwd(None, sample)
        unsharded, out["forward_unsharded_s"] = _timed(torch, lambda: fwd(None, sample))
        with plain_route(), _exact_fp32(torch):
            ref = apply_unet3d(cast_tree(params, torch.float32), cfg, sample, 500, text)
        out["forward_rel"] = _rel_max(eps, ref)
        out["forward_rel_unsharded"] = _rel_max(unsharded, ref)
        out["forward_rel_to_unsharded"] = _rel_max(eps, unsharded)
        if not (torch.isfinite(eps).all() and out["forward_rel"] <= REFERENCE_TOL):
            raise SystemExit(f"[sharded] (a) the sharded forward reads {out['forward_rel']} "
                             f"from the plain path (gate {REFERENCE_TOL})")
        solo = comm.Group.of(nccl, "data")
        zero_launches()
        eps_nccl = fwd(solo, sample)
        out["launches_nccl"] = read_launches()
        _sharded_launches("(e) NCCL forward", out["launches_nccl"], SHARDED_FORWARD)
        out["nccl_backend"] = solo.backend
        out["nccl_rel"] = _rel_max(eps_nccl, ref)
        _report(rank, "(a, e) against the plain path", out, (
            "forward_unsharded_s", "forward_rel", "forward_rel_unsharded",
            "forward_rel_to_unsharded", "nccl_backend", "nccl_rel", "launches_nccl"))
        if solo.backend != "nccl" or not out["nccl_rel"] <= REFERENCE_TOL:
            raise SystemExit(f"[sharded] (e) the {solo.backend} forward reads "
                             f"{out['nccl_rel']} from the plain path (gate {REFERENCE_TOL})")


def _sharded_guided_update(torch, models, mesh, rank, out):
    """(b) one guided update on the flagship layout, frame-sharded: its
    energy and gradient against the plain path (fp32), unsharded."""
    from lvd_tpu_torch.diffusion import dpm_solver as dpm
    from lvd_tpu_torch.diffusion.sampler import GuidanceTensors, energy_and_grad
    from lvd_tpu_torch.models.loader import cast_tree
    from lvd_tpu_torch.ops.plain import plain_route
    from lvd_tpu_torch.parallel import comm
    from lvd_tpu_torch.parallel.mesh import block

    cfg = models.preset.unet
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = _undegenerate(models.unet_params, gen, torch)
    guide = flagship_guidance()
    pack = guidance_tensors(guide)
    lat = seeded_latents(torch)
    text = torch.randn((1, 77, cfg.cross_attention_dim), generator=gen, device="cuda")
    t = int(dpm.make_coeffs(models.preset.scheduler, 40).timestep[0])
    axis = mesh.data
    frames = lambda a: block(a, axis, 1)
    shard = GuidanceTensors({k: frames(v) for k, v in pack.masks.items()}, pack.token_indices,
                            pack.token_mask, {k: frames(v) for k, v in pack.k_fg.items()},
                            {k: frames(v) for k, v in pack.k_bg.items()})
    run = lambda p, x, g, dt, ax: energy_and_grad(p, cfg, x, t, text.to(dt), g, guide["attn_keys"],
                                                  guide["config"], dt, ax)
    zero_launches()
    (energy, local), out["update_s"] = _timed(
        torch, lambda: run(params, frames(lat), shard, torch.bfloat16, axis))
    out["launches_update"] = read_launches()
    _sharded_launches("(b) sharded guided update", out["launches_update"], SHARDED_BACKWARD)
    grad = comm.gather(local, axis, 1)
    out["energy"] = energy.item()
    _report(rank, "(b) guided update", out, ("update_s", "energy", "launches_update"))
    if rank != 0:
        return
    (e_k, g_k), out["update_unsharded_s"] = _timed(
        torch, lambda: run(params, lat, pack, torch.bfloat16, None))
    with plain_route(), _exact_fp32(torch):
        e_r, g_r = run(cast_tree(params, torch.float32), lat, pack, torch.float32, None)
    out["energy_ref"], out["energy_unsharded"] = e_r.item(), e_k.item()
    out["energy_rel"] = abs(out["energy"] - e_r.item()) / abs(e_r.item())
    out["grad_rel"], out["grad_rel_l2"] = _rel_max(grad, g_r), _rel_l2(grad, g_r)
    out["grad_rel_unsharded"], out["grad_rel_l2_unsharded"] = _rel_max(g_k, g_r), _rel_l2(g_k, g_r)
    _report(rank, "(b) against the plain path", out, (
        "update_unsharded_s", "energy_ref", "energy_unsharded", "energy_rel", "grad_rel",
        "grad_rel_l2", "grad_rel_unsharded", "grad_rel_l2_unsharded"))
    if not (torch.isfinite(grad).all() and out["grad_rel"] <= GRADIENT_TOL
            and out["grad_rel_l2"] <= GRADIENT_L2_TOL and out["energy_rel"] <= GRADIENT_L2_TOL):
        raise SystemExit(f"[sharded] (b) the sharded guided update disagrees with the plain "
                         f"path: energy {out['energy_rel']}, gradient {out['grad_rel']} max, "
                         f"{out['grad_rel_l2']} L2")


def _sharded_generation(torch, models, mesh, rank, out):
    """(c) a 4-step guided generation through TextToVideoPipeline(...,
    mesh=...): the final latents against the unsharded pipeline's, and the
    uint8 video's shape."""
    from lvd_tpu_torch.pipeline import TextToVideoPipeline
    from lvd_tpu_torch.text.templates import NEGATIVE_PROMPT

    guide = flagship_guidance()
    guide["config"] = dataclasses.replace(guide["config"], max_index_step=GUIDED_INDEX_STEP)
    call = lambda pipe: pipe(FLAG_PROMPT, NEGATIVE_PROMPT, height=320, width=576, num_frames=24,
                             num_inference_steps=GUIDED_STEPS, guidance_scale=9.0, seed=0,
                             backward_guidance=dict(guide), output_type="latent")
    pipe = TextToVideoPipeline(models, dtype=torch.bfloat16, device="cuda", mesh=mesh)
    zero_launches()
    final, out["generation_s"] = _timed(torch, lambda: call(pipe))
    out["launches_generation"] = read_launches()
    _sharded_launches("(c) sharded guided generation", out["launches_generation"],
                      SHARDED_FORWARD + SHARDED_BACKWARD)
    out["generation_steps_s"] = pipe.timings["steps"]
    video = pipe.decode_uint8(final.reshape(24, 40, 72, 4)).reshape(1, 24, 320, 576, 3)
    out["video"] = [list(video.shape), str(video.dtype)]
    _report(rank, "(c) guided generation", out, ("generation_s", "generation_steps_s", "video",
                                                  "launches_generation"))
    if tuple(video.shape) != (1, 24, 320, 576, 3) or video.dtype != torch.uint8:
        raise SystemExit(f"[sharded] (c) the video is {out['video']}")
    if rank != 0:
        return
    ref, out["generation_unsharded_s"] = _timed(
        torch, lambda: call(TextToVideoPipeline(models, dtype=torch.bfloat16, device="cuda")))
    out["generation_rel"] = _rel_max(final, ref)
    out["generation_rel_l2"] = _rel_l2(final, ref)
    _report(rank, "(c) against the unsharded pipeline", out, (
        "generation_unsharded_s", "generation_rel", "generation_rel_l2"))
    if not (torch.isfinite(final).all() and out["generation_rel"] <= REFERENCE_TOL):
        raise SystemExit(f"[sharded] (c) the sharded latents read {out['generation_rel']} from "
                         f"the unsharded pipeline's (gate {REFERENCE_TOL})")


def _sharded_train(torch, rank, out):
    """(d) one adapter-only fp32 step of the gated Zeroscope at 8 frames,
    batch 2, under mesh (data 2, model 1) and (1, 2), against the
    unsharded step (rank 0): the loss, and each trained leaf's gradient,
    read from its first moment after the step (AdamW's mu = (1 - b1) * g),
    the train phase's gates: each leaf's gradient (1e-2 L2) against the
    unsharded step's, bar the leaves named exempt, whose unsharded gradient
    is itself further than that from the exact fp32 one and which are held
    to that distance instead (_leaf_gate), and the flattened gradient
    (1e-2 L2); and each leaf's update (1e-2 L2) against the
    one AdamW makes from the step's own gradient (_applied_err) and against
    the unsharded update over the elements whose gradient's sign the
    gradient gate makes sure (_masked_update_err). On a first AdamW step
    the update is lr * g / (|g| + eps), about lr times g's sign, so a
    gradient element within rounding of zero flips it whole: the whole
    update is printed beside the gates, with the count of such flips."""
    from lvd_tpu_torch.config import PRESETS
    from lvd_tpu_torch.models.unet3d import init_unet3d
    from lvd_tpu_torch.parallel import mesh as mesh_mod
    from lvd_tpu_torch.training import train as tr
    from lvd_tpu_torch.utils import prng
    from lvd_tpu_torch.utils.tree import flatten, unflatten_like

    cfg = PRESETS["lvd-gligen_zeroscope"].unet
    # The fusers' gates open, so the gradient reaches the sharded fuser weights.
    params0 = _undegenerate(init_unet3d(prng.prng_key(0), cfg, device="cuda",
                                        dtype=torch.float32),
                            torch.Generator(device="cuda").manual_seed(5), torch)
    start = flatten(params0)
    halves = [train_batch(torch, cfg, SHARDED_TRAIN_FRAMES, seed) for seed in (11, 12)]
    cat = lambda *xs: torch.cat(xs)
    batch = {"latents": cat(*(h["latents"] for h in halves)),
             "text": cat(*(h["text"] for h in halves)),
             "gligen": {k: cat(*(h["gligen"][k] for h in halves)) for k in halves[0]["gligen"]}}
    key = prng.prng_key(7)

    def step(mesh):
        trainer = tr.Trainer(cfg, learning_rate=TRAIN_LR, adapter_only=True)
        own = unflatten_like(params0, {p: t.clone() for p, t in start.items()})
        state = trainer.init(own, mesh=mesh)
        rows = batch if mesh is None else tr.shard_batch(mesh, batch)
        torch.cuda.reset_peak_memory_stats()
        (state, loss), secs = _timed(torch, lambda: trainer.make_step(mesh)(state, rows, key))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        whole = lambda p, x: x if mesh is None else mesh_mod.full_leaf(mesh, p, x)
        updates, grads = {}, {}
        for p, t in flatten(state.params).items():
            if trainer.tx.trains(p):
                updates[p] = whole(p, t) - start[p]
                grads[p] = whole(p, state.opt_state["mu"][p])
        applied = _applied_err(torch, trainer.tx, start, updates, grads) \
            if mesh is not None and rank == 0 else None
        return loss.item(), updates, grads, secs, peak, applied

    ref = step(None) if rank == 0 else None
    exact = _exact_first_moment(torch, cfg, params0, batch, key) if rank == 0 else None
    torch.cuda.empty_cache()  # the two ranks and the parent share the card
    for shape in ((2, 1), (1, 2)):
        mesh = mesh_mod.make_mesh(model_parallel=shape[1])
        loss, updates, grads, secs, peak, applied = step(mesh)
        torch.cuda.empty_cache()
        name = f"train_{shape[0]}x{shape[1]}"
        out[name] = {"loss": loss, "s": secs, "peak_gib": peak}
        if rank == 0:
            gates = {p: _leaf_gate(g, ref[2][p], exact[p]) for p, g in grads.items()}
            worst = max(((gap, p) for p, (gap, _, ex) in gates.items() if not ex),
                        default=(0.0, None))
            exempt = {p: {"gap": gap, "bound": gate,
                          "unsharded_from_exact": _update_err(ref[2][p], exact[p])}
                      for p, (gap, gate, ex) in gates.items() if ex}
            misses = sorted((p, gap, gate) for p, (gap, gate, _) in gates.items() if gap > gate)
            num = sum(((g - ref[2][p]).double() ** 2).sum() for p, g in grads.items())
            den = sum((g.double() ** 2).sum() for g in ref[2].values())
            masked = {p: _masked_update_err(torch, u, ref[1][p], grads[p], ref[2][p])
                      for p, u in updates.items()}
            worst_masked = max((m[0], p) for p, m in masked.items())
            out[name].update(
                loss_ref=ref[0], loss_rel=abs(loss - ref[0]) / abs(ref[0]),
                worst_grad_l2=worst, exempt_leaves=exempt, grad_misses=misses,
                grad_l2=math.sqrt(num.item() / den.item()),
                worst_update_l2=max((_update_err(u, ref[1][p]), p) for p, u in updates.items()),
                worst_update_l2_masked=worst_masked, worst_applied_l2=applied,
                grad_sign_flips=sum(m[1] for m in masked.values()),
                grad_sign_flips_kept=sum(m[2] for m in masked.values()),
                kept=sum(m[3] for m in masked.values()),
                elements=sum(m[4] for m in masked.values()),
                leaves=len(updates), s_unsharded=ref[3], peak_gib_unsharded=ref[4])
        _report(rank, f"(d) adapter-only step, mesh {shape}", out, (name,))
        if rank == 0 and not (out[name]["loss_rel"] <= TRAIN_LOSS_TOL
                              and not misses
                              and out[name]["grad_l2"] <= TRAIN_GRAD_L2_TOL
                              and worst_masked[0] <= TRAIN_UPDATE_L2_TOL
                              and applied[0] <= TRAIN_UPDATE_L2_TOL
                              and set(grads) == set(ref[2])):
            raise SystemExit(f"[sharded] (d) the {shape} mesh step disagrees with the "
                             f"unsharded step: loss {out[name]['loss_rel']}, leaf gradients "
                             f"over their gate {misses}, gradient (flattened) "
                             f"{out[name]['grad_l2']}, worst leaf update (masked) "
                             f"{worst_masked}, worst leaf update against its own gradient's "
                             f"{applied}")


def sharded_rank():
    """One rank of the sharded phase, on the card's one device: the weights
    are lvd_tpu's key-order draw (load_pipeline_models under
    LVD_ALLOW_RANDOM_WEIGHTS=1), checks (a)-(e) fail the rank, and rank 0
    also runs every unsharded reference. Returns the rank's readings."""
    import torch
    import torch.distributed as dist

    from lvd_tpu_torch.models.loader import load_pipeline_models
    from lvd_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    rank = dist.get_rank()
    mesh = make_mesh()
    nccl = dist.new_group([0], backend="nccl")  # every rank makes it; rank 0 uses it
    out = {"rank": rank}
    models, out["draw_s"] = _timed(
        torch, lambda: load_pipeline_models("zeroscope", device="cuda", dtype=torch.bfloat16))
    _sharded_forward(torch, models, mesh, rank, nccl, out)
    torch.cuda.empty_cache()
    _sharded_guided_update(torch, models, mesh, rank, out)
    torch.cuda.empty_cache()
    _sharded_generation(torch, models, mesh, rank, out)
    out["peak_gib_sampling"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del models
    torch.cuda.empty_cache()
    _sharded_train(torch, rank, out)
    dist.barrier()
    return out


def sharded_phase(torch):
    """The sharded phase's ranks, each a process of torch's spawn context
    over gloo and a FileStore in a temporary directory; a rank that fails,
    hangs past SHARDED_TIMEOUT or exits non-zero fails the smoke. Returns
    rank 0's launches over the sharded forward, update and generation."""
    import tempfile

    from lvd_tpu_torch.parallel.launch import RankPool

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    saved = os.environ.get("LVD_ALLOW_RANDOM_WEIGHTS")
    os.environ["LVD_ALLOW_RANDOM_WEIGHTS"] = "1"
    try:
        with tempfile.TemporaryDirectory() as d, \
                RankPool(SHARDED_RANKS, d, timeout=SHARDED_TIMEOUT) as pool:
            results = pool.run(sharded_rank, timeout=SHARDED_TIMEOUT)
    finally:
        if saved is None:
            os.environ.pop("LVD_ALLOW_RANDOM_WEIGHTS", None)
        else:
            os.environ["LVD_ALLOW_RANDOM_WEIGHTS"] = saved
    for res in results:
        log(f"[sharded] rank {res['rank']} of {SHARDED_RANKS} (gloo, one card): draw "
            f"{res['draw_s']:.3f} s, peak memory sampling {res['peak_gib_sampling']:.3f} GiB")
    r0 = results[0]
    log(f"[sharded] census of one sharded CFG forward (per rank, {SHARDED_RANKS} ranks): "
        f"{json.dumps(r0['census_forward'])}")
    log(f"[sharded] the sharded phase took {time.perf_counter() - t0:.1f} s")
    names = set(r0["launches_forward"])
    return {k: r0["launches_forward"][k] + r0["launches_update"][k]
            + r0["launches_generation"][k] for k in names}


def kernels_line(records, knob_launches, entry_launches, forms, path_launches):
    """One entry per kernel wrapper of selfcheck.SOURCES: its bf16 numbers at
    its largest path shape, its worst errors in bf16 and fp32, its launches
    on this slice's main path (the entry points for sdpa() and conv3x3())
    and on the upsample, train and image paths (``path_launches``, by
    path); B-D's and F-J's with their launches by form, C's, D's, F's
    and J's with the same products' time through torch.matmul, C's, G's and
    J's with the time of the interleaved copy of W1 their ms includes, B's,
    F's, G's and J's with their first version's time and reading on the
    same inputs."""
    from lvd_tpu_torch.ops.selfcheck import SOURCES

    kernels = []
    for kname, (source, replaces) in SOURCES.items():
        recs = [r for r in records if r["name"] == kname and r["dtype"] == "bfloat16"]
        f32 = [r for r in records if r["name"] == kname and r["dtype"] == "float32"]
        main = recs[0]  # the largest shape the path gives the kernel
        launches = entry_launches.get(kname, knob_launches.get(kname))
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "shapes": [json.loads(x) for x in sorted({json.dumps(r["shape"]) for r in recs + f32})],
            "launches": launches,
            # the upsample path's run (cli.upsample.main, zsxl+sdxl), the
            # train phase's adapter-only steps, the image phase's two runs
            **{f"launches_{path}": counts.get(kname, 0) for path, counts in path_launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "rel_err": max(r["rel_err"] for r in recs),
            "max_abs_err_fp32": max(r["max_abs_err"] for r in f32),
            "rel_err_fp32": max(r["rel_err"] for r in f32),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"],
        })
        if kname in forms:
            kernels[-1]["forms"] = forms[kname]
        for key in ("form", "products_ms", "copy_ms", "first_ms", "first_rel_err"):
            if key in main:
                kernels[-1][key] = main[key]
        # Its fp32 readings: each shape's form, ms, bound and first version's ms.
        kernels[-1]["fp32"] = [{k: r[k] for k in ("shape", "form", "ms", "bound_ms", "first_ms",
                                                   "rel_err") if k in r} for r in f32]
        if kname in FP32_SOURCES:
            kernels[-1]["source_fp32"] = FP32_SOURCES[kname]
    return kernels


# The kernels whose fp32 form has a source of its own.
FP32_SOURCES = {"temporal_attention_pair": "lvd_tpu_torch/csrc/pair_fwd_tf32.cu",
                "temporal_attention_pair_bwd": "lvd_tpu_torch/csrc/pair_bwd_tf32.cu"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--knob-phase"]:
        return knob_child(torch)
    t_start = time.perf_counter()
    name = device_phase(torch)
    build_phase(torch)
    records = kernel_phase()
    models = lvd_tpu_models(torch, "zeroscope")
    reference_phase(torch, models)
    gradient_phase(torch, models)
    generation_phase(torch, models)
    pipe, _ = guided_generation_phase(torch, models)
    certification_phase(torch, pipe)
    del pipe
    t_gligen = time.perf_counter()
    pipe = gligen_phase(torch, gligen_models(torch))
    gligen_reference_phase(torch, pipe)
    lvd_plus_phase(torch, pipe)
    del pipe
    torch.cuda.empty_cache()
    log(f"[gligen] the GLIGEN phases took {time.perf_counter() - t_gligen:.1f} s")
    import tempfile

    with tempfile.TemporaryDirectory() as workdir:
        run_dir = cli_phase(torch, workdir)
        t_sdxl = time.perf_counter()
        refiner = sdxl_models(torch)
        sdxl_reference_phase(torch, refiner)
        log(f"[sdxl] the sdxl phase took {time.perf_counter() - t_sdxl:.1f} s")
        upsample_launches = upsample_phase(torch, run_dir, refiner)
        del refiner
        torch.cuda.empty_cache()
    train_launches = train_phase(torch)
    image_launches = image_phase(torch)
    sharded_launches = sharded_phase(torch)
    knob_launches, knob_forms = knob_phase(torch)
    fp32_phase(torch, models)
    entry_launches, entry_forms = entry_point_phase(torch, models)
    torch.cuda.empty_cache()
    profile_phase(torch, models)

    kernels = kernels_line(records, knob_launches, entry_launches, {**knob_forms, **entry_forms},
                           {"upsample": upsample_launches, "train": train_launches,
                            "image": image_launches, "sharded": sharded_launches})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
