"""Kernel B's fp32 forms in chip_smoke.py's fp32 phase: one full-width CFG
UNet forward in fp32 (TF32 off elsewhere) with B's first version (``wmma``)
and with its TF32 wgmma form, against the plain path, on the card.

    python3 probes/fp32_forward_forms.py [--seeds 1 2 3]

For each seed (the smoke's fp32 phase uses 1: its weights' fix-ups, sample
and text come from one generator of that seed) it prints one JSON line:
the forward's max|d| / max|ref| with each form of B, and for each of B's
calls in that forward its own reading on the inputs that call received,
with each form, against the plain pair in exact fp32 (``max_rel``: max|d| /
max|ref|; ``l2``: |d| / |ref|). The spread over seeds says how far the
forward's reading moves with the inputs alone.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from train_step_forms import first_fp32_forms  # noqa: E402


def _readings(got, ref):
    d = (got - ref).float()
    return {"max_rel": d.abs().max().item() / ref.abs().max().item(),
            "l2": d.norm().item() / ref.float().norm().item()}


def one_seed(models, seed):
    from lvd_tpu_torch.models.unet3d import apply_unet3d
    from lvd_tpu_torch.ops import temporal_attention as ta
    from lvd_tpu_torch.ops.plain import plain_route, swapped
    from lvd_tpu_torch.ops.selfcheck import exact_fp32
    from lvd_tpu_torch.pipeline import TextToVideoPipeline

    pipe = TextToVideoPipeline(models, device="cuda")
    cfg = models.preset.unet
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = cs._undegenerate(pipe.unet_params, gen, torch)
    del pipe
    sample = torch.randn((2, 24, 40, 72, 4), generator=gen, device="cuda")
    text = torch.randn((2, 77, cfg.cross_attention_dim), generator=gen, device="cuda")
    calls, launch = [], ta._launch_forward

    def record(p, y, num_heads, eps, frames_major, form=None):
        calls.append((p, y.clone(), num_heads, eps, frames_major))
        return launch(p, y, num_heads, eps, frames_major, form)

    out = {"seed": seed}
    with torch.no_grad(), exact_fp32():
        with plain_route():
            ref = apply_unet3d(params, cfg, sample, 500, text)
        with swapped([(ta, "_launch_forward", record)]):
            out["forward_new"] = _readings(apply_unet3d(params, cfg, sample, 500, text), ref)
        with first_fp32_forms("B"):
            out["forward_first"] = _readings(apply_unet3d(params, cfg, sample, 500, text), ref)
        del ref
        out["calls"] = []
        for p, y, heads, eps, fm in calls:
            plain = ta.temporal_attention_pair_plain(p, y, heads, eps, fm)
            out["calls"].append({
                "shape": list(y.shape), "frames_major": fm,
                "new": _readings(launch(p, y, heads, eps, fm), plain),
                "first": _readings(launch(p, y, heads, eps, fm, "wmma"), plain)})
    calls.clear()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fp32_forward_forms: no CUDA device", file=sys.stderr)
        return 1
    cs.device_phase(torch)
    cs.build_phase(torch)
    models = cs.lvd_tpu_models(torch, "zeroscope")
    for seed in args.seeds:
        print(json.dumps(one_seed(models, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
