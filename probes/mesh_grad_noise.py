"""How far a data-parallel step's per-leaf gradient lies from the unsharded
step's, for the fp32 forms of kernels B, F and G: chip_smoke.py's sharded
check (d) emulated in one process on the card.

    python3 probes/mesh_grad_noise.py [--keys 7 8 9 10] [--forms first new ...]
        [--conv-tf32 on|off]

The gated Zeroscope (fp32, its fusers' gates open) takes one adapter-only
gradient at 8 frames, batch 2 (chip_smoke.py's (d) batch and weights), once
on the whole batch and once as the mean of the two rows' gradients, each
taken as ``diffusion_loss(rows=(i, 2))`` takes it on a rank of a (data 2,
model 1) mesh. For each key and for F and G's fp32 forms as their first
versions (``first``), their TF32 wgmma forms (``new``) and, at the first
key, one of each (or the forms ``--forms`` names; ``first_B``: B's first
version, F and G new), it prints one JSON line: whether the whole-batch
gradient repeats bit for bit, the leaf ``down_blocks/0/layers/1/.../
alpha_dense`` (the gate of a fuser, a scalar) on both, their relative gap,
the worst leaf's gap, and check (d)'s rule (``_leaf_gate``) against the
exact gradient (the plain route, TF32 off): the leaf's distance from exact,
whether it passes, and every leaf the rule fails. ``--conv-tf32 off`` takes
the steps with cuDNN's TF32 off.

The whole-batch gradient is one backward over both samples, as
``Trainer``'s step took a batch before it took it one sample at a time:
what the probe reads is the gap that change removed (cuBLAS's fp32
products depend on the rows around a sample).
"""

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from lvd_tpu_torch.config import PRESETS, SchedulerConfig  # noqa: E402
from lvd_tpu_torch.diffusion import schedule  # noqa: E402
from lvd_tpu_torch.models.unet3d import init_unet3d  # noqa: E402
from lvd_tpu_torch.ops import _build  # noqa: E402
from lvd_tpu_torch.ops.plain import plain_route  # noqa: E402
from lvd_tpu_torch.ops.selfcheck import exact_fp32  # noqa: E402
from lvd_tpu_torch.training import train as tr  # noqa: E402
from lvd_tpu_torch.utils import prng  # noqa: E402
from lvd_tpu_torch.utils.tree import flatten, unflatten_like  # noqa: E402
from train_step_forms import first_fp32_forms  # noqa: E402

LEAF = "down_blocks/0/layers/1/attn/blocks/0/fuser/alpha_dense"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--keys", type=int, nargs="*", default=[7, 8, 9, 10])
    parser.add_argument("--forms", nargs="*", default=None)
    parser.add_argument("--conv-tf32", choices=("on", "off"), default="on")
    args = parser.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = args.conv_tf32 == "on"
    if not torch.cuda.is_available():
        print("mesh_grad_noise: no CUDA device", file=sys.stderr)
        return 1
    _build.lib()
    cfg = PRESETS["lvd-gligen_zeroscope"].unet
    params = cs._undegenerate(init_unet3d(prng.prng_key(0), cfg, device="cuda",
                                          dtype=torch.float32),
                              torch.Generator(device="cuda").manual_seed(5), torch)
    halves = [cs.train_batch(torch, cfg, cs.SHARDED_TRAIN_FRAMES, seed) for seed in (11, 12)]
    cat = lambda *xs: torch.cat(xs)
    batch = {"latents": cat(*(h["latents"] for h in halves)),
             "text": cat(*(h["text"] for h in halves)),
             "gligen": {k: cat(*(h["gligen"][k] for h in halves)) for k in halves[0]["gligen"]}}
    trains = tr.make_optimizer(adapter_only=True, params=params).trains
    abar = schedule.make_alphas_cumprod(SchedulerConfig())
    tables = [torch.tensor(np.asarray(v, np.float32), device="cuda")
              for v in (abar ** 0.5, (1.0 - abar) ** 0.5)]
    flat = flatten(params)
    trained = [p for p in flat if trains(p)]

    def grads(b, key, rows=None):
        leaves = {p: t.detach().requires_grad_(trains(p)) for p, t in flat.items()}
        loss = tr.diffusion_loss(unflatten_like(params, leaves), cfg, *tables, b, key, rows=rows)
        return dict(zip(trained, torch.autograd.grad(loss, [leaves[p] for p in trained])))

    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    forms = {"first": first_fp32_forms, "new": contextlib.nullcontext,
             "first_G_new_F": lambda: first_fp32_forms("G"),
             "new_G_first_F": lambda: first_fp32_forms("F"),
             "first_B": lambda: first_fp32_forms("B")}
    for n, k in enumerate(args.keys):
        key = prng.prng_key(k)
        with plain_route(), exact_fp32():
            exact = grads(batch, key)
        for label, ctx in forms.items():
            if (label not in args.forms) if args.forms else (n and label not in ("first", "new")):
                continue
            with ctx():
                whole, again = grads(batch, key), grads(batch, key)
                parts = [grads(halves[i], key, rows=(i, 2)) for i in range(2)]
            mesh = {p: (parts[0][p] + parts[1][p]) / 2 for p in trained}
            gates = {p: cs._leaf_gate(mesh[p], whole[p], exact[p]) for p in trained}
            print(json.dumps({
                "key": k, "forms": label, "conv_tf32": args.conv_tf32,
                "repeatable": all(torch.equal(whole[p], again[p]) for p in trained),
                "leaf_whole": whole[LEAF].item(), "leaf_mesh": mesh[LEAF].item(),
                "leaf_exact": exact[LEAF].item(),
                "leaf_gap": rel(mesh[LEAF], whole[LEAF]),
                "leaf_from_exact": rel(whole[LEAF], exact[LEAF]),
                "leaf_rule": list(gates[LEAF]),
                "rule_fails": sorted((p, g, b) for p, (g, b, _) in gates.items() if g > b),
                "exempt": sorted(p for p, (_, _, ex) in gates.items() if ex),
                "worst_gap": max((rel(mesh[p], whole[p]), p) for p in trained)}), flush=True)
            del whole, again, parts, mesh
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
