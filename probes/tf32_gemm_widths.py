"""The TF32 wgmma GEMM that kernels B's and F's fp32 forms share, at each
tile width, on the card.

    python3 probes/tf32_gemm_widths.py [--reps 20]

Builds probes/tf32_gemm_widths.cu (the package's nvcc flags, its csrc on
the include path) in a temporary directory, then at the products of the
train step's pair (L0: 69120 rows, C = 320; L1: 17280 rows, C = 640; N =
3C and C at K = C, N = C at K = 3C; seed 0) times out = A B^T, and out =
A B^T + bias + residual (the epilogue of the pair's output projections),
at each width that divides N (64, 128, 160, 192) and ring depth
(``CONFIGS``: 2-6 stages; the occupancy gives 1 or 2 blocks an SM), the
median of
``--reps`` calls after one warm call by CUDA events. Each width's output
is held to torch.matmul of the same TF32-rounded operands in fp32 (TF32
off) at 1e-5 of max|ref|. Prints the card's name and power limit, then
one JSON line a product: ms and TFLOP/s at each width without and with
the epilogue, the width the GEMM picks (``gemm_width`` in
csrc/pair_tf32.cuh) and torch.matmul's ms in TF32 on the same operands
(``torch.mm``; ``torch.addmm`` with the bias), a yardstick the port
never calls.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (width, ring stages) the probe's build instantiates
CONFIGS = ((64, 4), (64, 6), (128, 3), (128, 4), (160, 2), (160, 4), (192, 2), (192, 4))
PRODUCTS = [(69120, 3 * 320, 320), (69120, 320, 320), (69120, 320, 960),
            (17280, 3 * 640, 640), (17280, 640, 640), (17280, 640, 1920)]  # (M, N, K)


def picked(n):
    """csrc/pair_tf32.cuh ``gemm_width``."""
    return next(w for w in (192, 160, 128, 64) if n % w == 0)


def build(tmp):
    sys.path.insert(0, ROOT)
    from lvd_tpu_torch.ops import _build

    lib = os.path.join(tmp, "libprobe_tf32.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                    "-o", lib, os.path.join(ROOT, "probes", "tf32_gemm_widths.cu")],
                   check=True)
    handle = ctypes.CDLL(lib)
    handle.probe_tf32_gemm.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    handle.probe_tf32_gemm.restype = ctypes.c_int
    return handle


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.median(ms)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tf32_gemm_widths: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    sys.path.insert(0, ROOT)
    from lvd_tpu_torch.ops.geglu_fused import tf32_round
    from lvd_tpu_torch.ops.selfcheck import exact_fp32

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        for m, n, k in PRODUCTS:
            a = tf32_round(torch.randn(m, k, generator=gen, device="cuda"))
            bt = tf32_round(torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5)
            bias = torch.randn(n, generator=gen, device="cuda")
            res = torch.randn(m, n, generator=gen, device="cuda")
            with exact_fp32():
                plain = a @ bt.T
                refs = {"plain": plain, "epilogue": plain + bias + res}
            out = torch.empty_like(plain)
            rec = {"M": m, "N": n, "K": k, "picked": picked(n), "widths": {}}
            for bn, ns in ((w, ns) for w, ns in CONFIGS if n % w == 0):
                cfg = f"{bn}x{ns}"
                rec["widths"][cfg] = {}
                for kind, ref in refs.items():
                    ep = (bias.data_ptr(), res.data_ptr()) if kind == "epilogue" else (None, None)
                    call = lambda bn=bn, ns=ns, ep=ep: lib.probe_tf32_gemm(
                        bn, ns, a.data_ptr(), bt.data_ptr(), *ep, out.data_ptr(), m, n, k, stream)
                    err = call()
                    torch.cuda.synchronize()
                    rel = ((out - ref).abs().max() / ref.abs().max()).item() if err == 0 else None
                    ms = time_ms(call, args.reps) if err == 0 else None
                    ok = ok and err == 0 and rel <= 1e-5
                    rec["widths"][cfg][kind] = {"err": err, "rel_err": rel, "ms": ms,
                                               "tflops": 2e-9 * m * n * k / ms if ms else None}
            saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            rec["torch_mm_tf32_ms"] = time_ms(lambda: torch.mm(a, bt.T), args.reps)
            rec["torch_addmm_tf32_ms"] = time_ms(lambda: torch.addmm(bias, a, bt.T), args.reps)
            torch.backends.cuda.matmul.allow_tf32 = saved
            print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
