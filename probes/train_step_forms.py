"""The train step with kernels' fp32 forms as their first (WMMA) versions
and as their TF32 wgmma forms, in one process on the card.

    python3 probes/train_step_forms.py [--rounds 4] [--kernels B]

``--kernels`` names the kernels whose first versions the "first" side
runs (B, F and G; default B), every other kernel in its new form on both
sides.

chip_smoke.py's train step (the gated Zeroscope in fp32, 24 frames, batch 1,
lvd_tpu's key-order weights from seed 0), adapter-only and then full
finetune. After one warm step of each form, each round times one step of
each form, the order alternating from round to round (first versions
first in even rounds), so neither side always runs first. Prints one JSON
line a mode: the seconds of each side's steps, their median, min and max,
the peak of max_memory_allocated over them, and each side's device busy ms
in one profiled step (chip_smoke.py's ``_profile``, whose log lines give the
split by kernel and symbol).
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from lvd_tpu_torch.config import PRESETS  # noqa: E402
from lvd_tpu_torch.models.unet3d import init_unet3d  # noqa: E402
from lvd_tpu_torch.ops import _build  # noqa: E402
from lvd_tpu_torch.training import train as tr  # noqa: E402
from lvd_tpu_torch.utils import prng  # noqa: E402
from lvd_tpu_torch.utils.tree import flatten, unflatten_like  # noqa: E402


@contextlib.contextmanager
def first_fp32_forms(kernels="FG"):
    """Kernels F and G (or those ``kernels`` names, of B, F and G) launch
    their first (WMMA) versions in fp32, as the train step ran them before
    their Hopper forms."""
    from lvd_tpu_torch.ops import geglu_fused, temporal_attention
    from lvd_tpu_torch.ops.plain import swapped

    g_plan, f_plan = geglu_fused.bwd_launch_plan, temporal_attention.bwd_launch_plan
    b_plan = temporal_attention.launch_plan

    def g(c, inner, dtype, form=None):
        if form is None and dtype == torch.float32 and geglu_fused._covers(c, inner):
            form = "wmma"
        return g_plan(c, inner, dtype, form)

    def f(frames, c, dtype, form=None):
        return f_plan(frames, c, dtype, "wmma" if form is None and dtype == torch.float32
                      else form)

    def b(frames, c, dtype, form=None):
        return b_plan(frames, c, dtype, "wmma" if form is None and dtype == torch.float32
                      else form)

    swaps = {"G": (geglu_fused, "bwd_launch_plan", g),
             "F": (temporal_attention, "bwd_launch_plan", f),
             "B": (temporal_attention, "launch_plan", b)}
    with swapped([swaps[k] for k in kernels]):
        yield


def compare(label, step, state, batch, key, rounds, kernels):
    """Times ``rounds`` steps of each form, alternating which runs first,
    then profiles one step of each; the "first" side runs the first
    versions of ``kernels``."""
    FORMS = {"first": lambda: first_fp32_forms(kernels), "new": contextlib.nullcontext}
    seconds = {side: [] for side in FORMS}
    peaks = {side: 0.0 for side in FORMS}
    for side, forms in FORMS.items():  # warm: each form's first call
        with forms():
            state, _ = step(state, batch, key)
    for i in range(rounds):
        for side in (("first", "new") if i % 2 == 0 else ("new", "first")):
            with FORMS[side]():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, loss = step(state, batch, key)
                loss.item()
                seconds[side].append(time.perf_counter() - t0)
                peaks[side] = max(peaks[side], torch.cuda.max_memory_allocated() / 2 ** 30)
    out = {"mode": label, "rounds": rounds, "first_versions_of": kernels}
    for side, forms in FORMS.items():
        xs = seconds[side]
        with forms():
            prof = cs._profile(torch, f"{label} step, fp32 {kernels} {side}",
                               lambda: step(state, batch, key))
        out[side] = {"seconds": xs, "median_s": statistics.median(xs), "min_s": min(xs),
                     "max_s": max(xs), "peak_gib": peaks[side], "busy_ms": prof["busy_ms"],
                     "wall_ms": prof["wall_ms"],
                     "split": prof["split"]}
    print(json.dumps(out), flush=True)
    return state


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--kernels", default="B")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_step_forms: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    _build.lib()
    cfg = PRESETS["lvd-gligen_zeroscope"].unet
    params = init_unet3d(prng.prng_key(0), cfg, device="cuda", dtype=torch.float32)
    batch = cs.train_batch(torch, cfg, cs.TRAIN_FRAMES)
    key = prng.prng_key(cs.TRAIN_STEPS)
    for label, adapter_only in (("adapter-only", True), ("full-finetune", False)):
        trainer = tr.Trainer(cfg, learning_rate=cs.TRAIN_LR, adapter_only=adapter_only)
        own = unflatten_like(params, {p: t.clone() for p, t in flatten(params).items()})
        state = compare(label, trainer.make_step(), trainer.init(own), batch, key, args.rounds,
                        args.kernels)
        del state, own, trainer
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
