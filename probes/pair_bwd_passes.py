"""Kernels B's and F's fp32 forms at the train step's shapes, timed call by
call and pass by pass on the card.

    python3 probes/pair_bwd_passes.py [--root DIR] [--reps 10] [--kernels BF]

Imports ``lvd_tpu_torch`` from DIR (default: this checkout), so that two
trees, unpacked side by side, can be timed in one run on one card. At
(1, 24, 2880, 320) and (1, 24, 720, 640), frames-major, seed 0, it runs
the forward (B, ``_launch_forward``) and the dy (F,
``temporal_attention_pair_bwd``) in fp32, each in the form the tree
routes, ``--reps`` times (after one warm call) and prints one JSON line a
kernel and shape: the median ms a call by CUDA events, then, from one
torch.profiler run of the same calls, the device ms a call of each kernel
symbol (the form's passes). With ``--save DIR`` it also writes each
call's output to DIR/<kernel>_<shape>.pt, so that two trees' outputs can be
compared bit for bit.
"""

import argparse
import json
import os
import statistics
import sys

SHAPES = [(1, 24, 2880, 320), (1, 24, 720, 640)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--kernels", default="BF", help="B (forward), F (dy) or both")
    parser.add_argument("--save", default=None, help="a directory for the outputs")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from lvd_tpu_torch.ops import _build, selfcheck, temporal_attention as ta

    if not torch.cuda.is_available():
        print("pair_bwd_passes: no CUDA device", file=sys.stderr)
        return 1
    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        c = shape[-1]
        p = selfcheck._pair_params(gen, c)
        y = torch.randn(shape, generator=gen, device="cuda")
        dy = torch.randn(shape, generator=gen, device="cuda")
        calls = {"B": lambda: ta._launch_forward(p, y, c // 64, 1e-5, True),
                 "F": lambda: ta.temporal_attention_pair_bwd(p, y, dy, c // 64, 1e-5, True)}
        for kernel in args.kernels:
            time_calls(args, kernel, shape, calls[kernel])
    return 0


def time_calls(args, kernel, shape, call):
    """Times ``call`` by CUDA events and by kernel symbol under the profiler;
    prints one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        out = call()
        torch.cuda.synchronize()
        if args.save:
            os.makedirs(args.save, exist_ok=True)
            name = f"{kernel}_{'x'.join(map(str, shape))}.pt"
            torch.save(out.cpu(), os.path.join(args.save, name))
        ms = []
        for _ in range(args.reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                call()
            torch.cuda.synchronize()
        passes = {e.key[:100]: round(e.self_device_time_total / 1e3 / args.reps, 4)
                  for e in prof.key_averages() if e.self_device_time_total > 0}
        print(json.dumps({"root": os.path.abspath(args.root), "kernel": kernel,
                          "shape": list(shape), "median_ms": statistics.median(ms),
                          "min_ms": min(ms), "max_ms": max(ms),
                          "device_ms_a_call_by_symbol": passes}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
