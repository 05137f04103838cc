"""Kernels K-O on the card by kernel symbol, for the tree at --root.

    python3 probes/norm_kernel_times.py [--root DIR] [--reps 10] [--parts fwd bwd lib]

Imports ``lvd_tpu_torch`` from DIR (default: this checkout), so that a tree
and its parent, unpacked side by side, are timed on one card in one call.
``fwd``: kernels K (``coeffs``), L (``affine``, ``affine_silu``) and M
(``affine``) through their wrappers at the selfcheck's norm shapes, bf16.
``bwd``: the backward alone of the public functions, at the guided update's
shapes in bf16 with the params frozen (dx only), and at the L0 shapes in
fp32 with the params' gradients too (the train step): ``group_norm``,
``silu(group_norm)`` (N ``affine``, ``affine_silu``), ``group_norm_coeffs``
(N ``coeffs``), ``layer_norm`` (O) on this tree; on a parent, whatever its
Functions ran. ``lib``: the library calls N and O are set beside, at the
same bf16 shapes, dx alone: aten's ``native_group_norm_backward`` on a
channels-first contiguous copy of x and dy and ``native_layer_norm_backward``,
each on its own forward's statistics, all made outside the timed calls (the
port calls neither). Each call runs ``--reps`` times after one warm call; one JSON
line a call: the median ms a call by CUDA events, the bytes bound (each
input read once, each output written once, at 3.35 TB/s), and from one
torch.profiler run of the same calls the device ms and the launches a call,
in all and by kernel symbol.
"""

import argparse
import json
import os
import statistics
import sys

GN_SHAPES = [(48, 2880, 320), (2, 69120, 320), (48, 720, 640), (48, 180, 1280), (2, 144, 3072)]
LN_SHAPES = [(138240, 320), (34560, 640), (8640, 1280), (154, 1024)]
GN_BWD_SHAPES = [(24, 2880, 320), (24, 720, 640), (24, 180, 1280), (24, 45, 1280)]
COEFFS_BWD_SHAPES = [(1, 69120, 320), (1, 17280, 640), (1, 4320, 1280), (1, 1080, 1280)]
LN_BWD_SHAPES = [(69120, 320), (17280, 640), (4320, 1280), (1080, 1280)]
BYTES_PER_S = 3.35e12


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--parts", nargs="*", default=["fwd", "bwd", "lib"])
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from lvd_tpu_torch.ops import _build, norms

    if not torch.cuda.is_available():
        print("norm_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda shape, dt: torch.randn(shape, generator=gen, device="cuda").to(dt)
    root = os.path.abspath(args.root)
    if "fwd" in args.parts:
        for n, r, c in GN_SHAPES:
            x = rand((n, r, c), torch.bfloat16) + 0.5
            s, a = rand((c,), torch.bfloat16), rand((n, c), torch.float32)
            item = 2.0 * n * r * c
            calls = {"K": (lambda: norms.group_norm_stats(x, s, s, 32, 1e-5, r * c // 32), item),
                     "L affine": (lambda: norms.group_norm_apply(x, a, a, False), 2 * item),
                     "L affine_silu": (lambda: norms.group_norm_apply(x, a, a, True), 2 * item)}
            for kernel, (call, nbytes) in calls.items():
                time_calls(args, {"root": root, "kernel": kernel, "shape": [n, r, c],
                                  "dtype": "bf16", "bound_ms": nbytes / BYTES_PER_S * 1e3}, call)
        for rows, c in LN_SHAPES:
            x, s = rand((rows, c), torch.bfloat16), rand((c,), torch.bfloat16)
            time_calls(args, {"root": root, "kernel": "M", "shape": [rows, c], "dtype": "bf16",
                              "bound_ms": 4.0 * rows * c / BYTES_PER_S * 1e3},
                       lambda: norms.layer_norm_rows(x, s, s, 1e-5))
    if "bwd" in args.parts:
        for dname, dt, params, shapes in (("bf16", torch.bfloat16, False, None),
                                          ("fp32", torch.float32, True, 1)):
            item = torch.finfo(dt).bits // 8
            pick = (lambda lst: lst[:shapes]) if shapes else (lambda lst: lst)
            for fn in ("group_norm", "group_norm_silu", "group_norm_coeffs", "layer_norm"):
                lst = {"group_norm_coeffs": COEFFS_BWD_SHAPES,
                       "layer_norm": LN_BWD_SHAPES}.get(fn, GN_BWD_SHAPES)
                for shape in pick(lst):
                    call, nbytes = backward_call(torch, norms, fn, shape, dt, params, rand)
                    time_calls(args, {"root": root, "kernel": f"{fn} backward",
                                      "shape": list(shape), "dtype": dname, "params": params,
                                      "bound_ms": nbytes * item / BYTES_PER_S * 1e3}, call)
                    torch.cuda.empty_cache()
    if "lib" in args.parts:
        for shape in GN_BWD_SHAPES:
            time_calls(args, {"root": root, "kernel": "native_group_norm_backward",
                              "shape": list(shape), "dtype": "bf16",
                              "bound_ms": 6.0 * shape[0] * shape[1] * shape[2] / BYTES_PER_S * 1e3},
                       library_call(torch, shape, rand, group=True))
        for shape in LN_BWD_SHAPES:
            time_calls(args, {"root": root, "kernel": "native_layer_norm_backward",
                              "shape": list(shape), "dtype": "bf16",
                              "bound_ms": 6.0 * shape[0] * shape[1] / BYTES_PER_S * 1e3},
                       library_call(torch, shape, rand, group=False))
    return 0


def library_call(torch, shape, rand, group):
    """aten's GroupNorm (32 groups, on channels-first copies of x and dy (N,
    R, C)) or LayerNorm backward in bf16, dx alone, on its forward's mean
    and rstd."""
    c = shape[-1]
    x, dy = rand(shape, torch.bfloat16) + 0.5, rand(shape, torch.bfloat16)
    scale, bias = rand((c,), torch.bfloat16), rand((c,), torch.bfloat16)
    mask = [True, False, False]
    if not group:
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, (c,), scale, bias, 1e-5)
        return lambda: torch.ops.aten.native_layer_norm_backward(dy, x, (c,), mean, rstd, scale,
                                                                 bias, mask)
    n, r, _ = shape
    xc, dyc = (t.permute(0, 2, 1).contiguous() for t in (x, dy))
    _, mean, rstd = torch.ops.aten.native_group_norm(xc, scale, bias, n, c, r, 32, 1e-5)
    return lambda: torch.ops.aten.native_group_norm_backward(dyc, xc, mean, rstd, scale, n, c, r,
                                                             32, mask)


def backward_call(torch, norms, fn, shape, dt, params, rand):
    """The backward alone of one public norm function (autograd over a
    graph built once, kept): (call, elements moved: x and dy read, dx
    written; x read and dx written for the coefficients)."""
    c = shape[-1]
    x = (rand(shape, dt) + 0.5).requires_grad_(True)
    p = {"scale": (1 + 0.1 * rand((c,), torch.float32)).to(dt),
         "bias": (0.1 * rand((c,), torch.float32)).to(dt)}
    leaves = [x]
    if params:
        leaves += [p["scale"].requires_grad_(True), p["bias"].requires_grad_(True)]
    if fn == "layer_norm":
        outs = (norms.layer_norm(p, x),)
    elif fn == "group_norm_coeffs":
        outs = norms.group_norm_coeffs(p, x, 32)
    else:
        outs = (getattr(norms, fn)(p, x, 32),)
    cts = [rand(o.shape, o.dtype) for o in outs]
    numel = x.numel()
    nbytes = 2 * numel if fn == "group_norm_coeffs" else 3 * numel
    return (lambda: torch.autograd.grad(outs, leaves, cts, retain_graph=True)), nbytes


def time_calls(args, rec, call):
    """Times ``call`` by CUDA events and by kernel symbol under the profiler;
    prints ``rec`` with the times and launches as one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    by_symbol = {e.key[:90]: [round(e.self_device_time_total / 1e3 / args.reps, 4),
                              e.count / args.reps] for e in events}
    rec |= {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "device_ms": round(sum(v[0] for v in by_symbol.values()), 4),
            "launches": sum(v[1] for v in by_symbol.values()),
            "device_ms_and_launches_a_call_by_symbol": by_symbol}
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    sys.exit(main())
