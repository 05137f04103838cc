"""One CFG UNet forward and one guided update under the profiler, for the
tree at --root: device busy and wall ms, ms by kernel, the stock ops by kind,
and the peak of the memory allocated over both (the weights included).

    python3 probes/norm_census.py [--root DIR]

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
