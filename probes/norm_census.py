"""One CFG UNet forward and one guided update under the profiler, for the
tree at --root: device busy and wall ms, ms by kernel, the stock ops by kind,
and the peak of the memory allocated over both (the weights included);
with --train, then one adapter-only and one full-finetune train step (the
smoke's train phase: gated Zeroscope, fp32, 24 frames) broken down by the
smoke's own ``train_breakdown``.

    python3 probes/norm_census.py [--root DIR] [--train]

Imports ``chip_smoke`` and ``lvd_tpu_torch`` from DIR (default: this
checkout), so that a tree and its parent, unpacked side by side, give their
census on one card in one call (run parent, tree, tree, parent). It draws
Zeroscope's bf16 weights in lvd_tpu's key order on the card, as the smoke
does, and runs the smoke's own ``profile_phase`` with that tree's kernel
symbols and stock kinds; every line it prints starts with ``[profile]``.
"""

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--train", action="store_true")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("norm_census: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from lvd_tpu_torch.ops import _build

    _build.lib()
    print(f"[profile] tree {root}", flush=True)
    models = chip_smoke.lvd_tpu_models(torch, "zeroscope")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chip_smoke.profile_phase(torch, models)
    torch.cuda.synchronize()
    print(f"[profile] peak allocated over the forward and the update: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    if args.train:
        del models
        torch.cuda.empty_cache()
        train_steps(torch, chip_smoke)
    return 0


def train_steps(torch, chip_smoke):
    """One warm and one broken-down step of each train mode, each on its own
    copy of the gated Zeroscope's fp32 weights."""
    from lvd_tpu_torch.config import PRESETS
    from lvd_tpu_torch.models.unet3d import init_unet3d
    from lvd_tpu_torch.training import train as tr
    from lvd_tpu_torch.utils import prng

    cfg = PRESETS["lvd-gligen_zeroscope"].unet
    params = init_unet3d(prng.prng_key(0), cfg, device="cuda", dtype=torch.float32)
    batch = chip_smoke.train_batch(torch, cfg, chip_smoke.TRAIN_FRAMES)
    for label, adapter_only in (("adapter-only", True), ("full-finetune", False)):
        trainer = tr.Trainer(cfg, learning_rate=chip_smoke.TRAIN_LR, adapter_only=adapter_only)
        state = trainer.init(torch.utils._pytree.tree_map(torch.clone, params))
        step = trainer.make_step()
        state, _ = step(state, batch, prng.prng_key(0))
        state, _ = chip_smoke.train_breakdown(torch, label, step, state, batch, prng.prng_key(1))
        del state, trainer
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
