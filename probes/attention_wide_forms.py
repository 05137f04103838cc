"""Kernels A and E at head dims 192 and 256, form by form, on the card.

    python3 probes/attention_wide_forms.py [--root DIR] [--forms wide sliced]
                                           [--dtypes bf16 fp32] [--reps 10]

Imports ``lvd_tpu_torch`` from DIR (default: this checkout), so that two
trees, unpacked side by side, can be timed in one run on one card. At
sdpa()'s shapes (B * H heads of S rows, one head in the packed layout:
(8, 4, 1024, D) and (2, 16, 4096, D), seed 0) it runs kernel A
(``attention_packed_with_lse``) and kernel E (``attention_packed_bwd``
from that log-sum-exp) in each named form, ``--reps`` times after one warm
call, and prints one JSON line a kernel, form, shape and type: the median
ms a call by CUDA events, the bound (A 4 S^2 D, E 10 S^2 D operations a
head over the tensor-core peak of the type, or the bytes over 3.35 TB/s),
and from one torch.profiler run of the same calls the device ms a call of
each kernel symbol (E: delta, dk/dv, dq).
"""

import argparse
import json
import os
import statistics
import sys

SHAPES = [(8, 4, 1024), (2, 16, 4096)]  # (B, H, S); D from --dims
PEAK = {"bf16": 989e12, "fp32": 495e12}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--forms", nargs="*", default=["wide", "sliced"])
    parser.add_argument("--dtypes", nargs="*", default=["bf16", "fp32"])
    parser.add_argument("--dims", nargs="*", type=int, default=[192, 256])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from lvd_tpu_torch.ops import _build
    from lvd_tpu_torch.ops import packed_attention as pa

    if not torch.cuda.is_available():
        print("attention_wide_forms: no CUDA device", file=sys.stderr)
        return 1
    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dname in args.dtypes:
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dname]
        for b, h, s in SHAPES:
            for d in args.dims:
                q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device="cuda").to(dtype)
                               for _ in range(4))
                scale = d ** -0.5
                for form in args.forms:
                    o, lse = pa.attention_packed_with_lse(q, k, v, scale, 1, form=form)
                    calls = {
                        "A": (lambda f=form: pa.attention_packed_with_lse(q, k, v, scale, 1,
                                                                          form=f), 4),
                        "E": (lambda f=form, o=o, lse=lse: pa.attention_packed_bwd(
                            q, k, v, o, do, scale, 1, lse=lse, form=f), 10)}
                    for kernel, (call, products) in calls.items():
                        flops = 1.0 * products * b * h * s * s * d
                        nbytes = q.element_size() * b * h * s * d * (4 if kernel == "A" else 8)
                        bound = max(flops / PEAK[dname], nbytes / 3.35e12) * 1e3
                        time_calls(args, {"root": os.path.abspath(args.root), "kernel": kernel,
                                          "form": form, "shape": [b, h, s, d], "dtype": dname,
                                          "bound_ms": bound}, call)
                del q, k, v, do
                torch.cuda.empty_cache()
    return 0


def time_calls(args, rec, call):
    """Times ``call`` by CUDA events and by kernel symbol under the profiler;
    prints ``rec`` with the times as one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        call()
        torch.cuda.synchronize()
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
    by_symbol = {e.key[:90]: round(e.self_device_time_total / 1e3 / args.reps, 4)
                 for e in prof.key_averages() if e.self_device_time_total > 0}
    rec |= {"median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms),
            "device_ms_a_call_by_symbol": by_symbol}
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    sys.exit(main())
