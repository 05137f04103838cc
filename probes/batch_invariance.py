"""Where the first row's numbers first change with the batch around it, in
chip_smoke.py's sharded check (d): the gated Zeroscope's adapter-only loss
and gradient (fp32, its fusers' gates open, 8 frames at 40x72, key 7) on
the batch of 2, and on its first row alone as a rank of a (data 2, model 1)
mesh takes it (``diffusion_loss(rows=(0, 2))``), on the card.

    python3 probes/batch_invariance.py [--key 7] [--conv-tf32 on|off] [--kernels]

Every aten op of both runs (forward and backward) is logged by a digest of
each tensor it reads and writes: the whole tensor in the one-row run, its
first rows in the batch-of-2 run where its leading dim is twice as long,
else the whole tensor. Prints, in op order, the first ops whose inputs
match in both runs and whose outputs differ (an op that is not batch
invariant), the first op whose inputs differ though every earlier output
matched (a producer outside aten, such as a kernel launched through
ctypes), and the count of ops compared. ``--conv-tf32 off`` runs both with
cuDNN's TF32 off. ``--kernels`` instead runs kernels A-G and cuDNN's fp32
conv on a batch of 2 samples and on the first alone, at (d)'s shapes, and
prints whether the first sample's output is bit-equal.

The batch of 2 goes through one ``diffusion_loss``, as ``Trainer``'s step
took a batch before it took it one sample at a time (the repair these
readings led to).
"""

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from lvd_tpu_torch.config import PRESETS, SchedulerConfig  # noqa: E402
from lvd_tpu_torch.diffusion import schedule  # noqa: E402
from lvd_tpu_torch.models.unet3d import init_unet3d  # noqa: E402
from lvd_tpu_torch.ops import _build  # noqa: E402
from lvd_tpu_torch.training import train as tr  # noqa: E402
from lvd_tpu_torch.utils import prng  # noqa: E402
from lvd_tpu_torch.utils.tree import flatten, unflatten_like  # noqa: E402

WEIGHTS = 1 << 24  # digest weights, applied a piece of this many elements at a time


class Digests(TorchDispatchMode):
    """Logs (op, input digests, output digests) of every aten op that reads or
    writes a floating-point tensor. ``half``: the one-row run's log, whose
    shapes say which tensors of this run hold that run's share in their
    first rows (first dim twice as long); None in the one-row run. A digest
    is (shape, weighted sum, sum of |x|, sliced)."""

    def __init__(self, weights, half=None):
        super().__init__()
        self.weights, self.half, self.log = weights, half, []

    def digest(self, t, ref=None):
        if not isinstance(t, torch.Tensor) or not t.is_floating_point() or t.numel() == 0:
            return None
        sliced = (ref is not None and t.dim() > 0 and len(ref[0]) == t.dim()
                  and t.shape[0] == 2 * ref[0][0] and tuple(t.shape[1:]) == tuple(ref[0][1:]))
        if sliced:
            t = t[:ref[0][0]]
        flat, s, a = t.detach().reshape(-1), 0.0, 0.0
        for i in range(0, flat.numel(), WEIGHTS):  # in pieces: no double copy of a whole tensor
            x = flat[i:i + WEIGHTS].double()
            s += (x * self.weights[:x.numel()]).sum().item()
            a += x.abs().sum().item()
        return (tuple(t.shape), s, a, sliced)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        i = len(self.log)
        ref = self.half[i] if self.half is not None and i < len(self.half) else (None, [], [])
        pad = lambda ds, n: list(ds) + [None] * (n - len(ds))
        fresh = "empty" in str(func)  # uninitialized memory: nothing to compare
        self.log.append((str(func),
                         [self.digest(a, r) for a, r in zip(ins, pad(ref[1], len(ins)))],
                         [None if fresh else self.digest(o, r)
                          for o, r in zip(outs, pad(ref[2], len(outs)))]))
        return out


def kernel_cases(g):
    """(name, fn of a batch-of-2 tensor, that tensor, rows of the first
    sample) for kernels A-G and cuDNN's fp32 conv at check (d)'s shapes
    (batch 2 of 8 frames at 40x72: 2880 pixels at C = 320)."""
    import torch.nn.functional as F

    from lvd_tpu_torch.ops import geglu_fused, packed_attention, selfcheck
    from lvd_tpu_torch.ops import temp_conv_fused, temporal_attention as ta

    r = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device="cuda") * scale
    pair = selfcheck._pair_params(g, 320)
    ff = {"proj": selfcheck._linear_p(g, 320, 2560), "out": selfcheck._linear_p(g, 1280, 320)}
    q, k, v, do = (r(16, 2880, 320) for _ in range(4))
    x, dy = r(2, 8, 2880, 320), r(2, 8, 2880, 320)
    a, sh = 1 + r(2, 320, scale=0.1), r(2, 320, scale=0.1)
    w3, b3 = r(3, 1, 1, 320, 320, scale=960 ** -0.5), r(320, scale=0.1)
    wc = r(320, 320, 3, 3, scale=2880 ** -0.5)
    img = r(16, 320, 40, 72)
    attn_bwd = lambda qq, kk, vv, oo, dd: packed_attention.attention_packed_bwd(
        qq, kk, vv, oo, dd, 0.125, 5, True,
        lse=packed_attention.attention_packed_with_lse(qq, kk, vv, 0.125, 5)[1])
    o = packed_attention.attention_packed(q, k, v, 0.125, 5)
    return [
        ("A", lambda n: packed_attention.attention_packed(q[:n], k[:n], v[:n], 0.125, 5), 16, 8),
        ("E", lambda n: torch.cat(attn_bwd(q[:n], k[:n], v[:n], o[:n], do[:n]), 1), 16, 8),
        ("B", lambda n: ta._launch_forward(pair, x[:n // 8].contiguous(), 5, 1e-5, True), 16, 8),
        ("F", lambda n: ta.temporal_attention_pair_bwd(pair, x[:n // 8].contiguous(),
                                                       dy[:n // 8].contiguous(), 5, 1e-5, True),
         16, 8),
        ("C", lambda n: geglu_fused.geglu_mlp(ff, x.reshape(-1, 320)[:n * 2880]), 16, 8),
        ("G", lambda n: geglu_fused.geglu_mlp_bwd(ff, x.reshape(-1, 320)[:n * 2880],
                                                  dy.reshape(-1, 320)[:n * 2880]), 16, 8),
        ("D", lambda n: temp_conv_fused.norm_silu_temporal_conv(
            x[:n // 8].contiguous(), a[:n // 8], sh[:n // 8], w3, b3), 16, 8),
        ("conv2d (cuDNN)", lambda n: F.conv2d(img[:n], wc, padding=1), 16, 8),
    ]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--key", type=int, default=7)
    parser.add_argument("--conv-tf32", choices=("on", "off"), default="on")
    parser.add_argument("--kernels", action="store_true",
                        help="each kernel's first sample, alone and in the batch of 2")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("batch_invariance: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = args.conv_tf32 == "on"
    _build.lib()
    if args.kernels:
        with torch.no_grad():
            for name, fn, two, one in kernel_cases(torch.Generator(device="cuda").manual_seed(3)):
                whole, alone = fn(two), fn(one)
                head = whole[:alone.shape[0]]
                print(json.dumps({"kernel": name, "conv_tf32": args.conv_tf32,
                                  "first_sample_bit_equal": bool(torch.equal(head, alone)),
                                  "max_abs_diff": (head - alone).abs().max().item()}), flush=True)
        return 0
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
    key = prng.prng_key(args.key)
    weights = torch.randn(WEIGHTS, generator=torch.Generator(device="cuda").manual_seed(9),
                          device="cuda", dtype=torch.float64)

    def run(b, rows, mode):
        leaves = {p: t.detach().requires_grad_(trains(p)) for p, t in flat.items()}
        with mode:
            loss = tr.diffusion_loss(unflatten_like(params, leaves), cfg, *tables, b, key,
                                     rows=rows)
            torch.autograd.grad(loss, [t for t in leaves.values() if t.requires_grad])
        torch.cuda.synchronize()
        return mode.log

    one = run(halves[0], (0, 2), Digests(weights))
    two = run(batch, None, Digests(weights, half=one))
    same = lambda a, b: a is None or b is None or a[:3] == b[:3]
    rel = lambda a, b: abs(a[1] - b[1]) / max(a[2], 1e-30) if a and b else None
    variant, reductions, foreign, clean = [], 0, None, True
    for i, ((op, i1, o1), (op2, i2, o2)) in enumerate(zip(one, two)):
        if op != op2:
            print(json.dumps({"op_sequences_part_at": i, "one_row": op, "two_rows": op2}))
            break
        same_in = all(same(a, b) for a, b in zip(i1, i2))
        same_out = all(same(a, b) for a, b in zip(o1, o2))
        # an output with no batch rows from inputs with them: a sum over the batch
        reduced = any(b and not b[3] for b in o2) and any(b and b[3] for b in i2)
        if not same_in and clean and foreign is None:
            foreign = {"index": i, "op": op, "inputs_rel": [rel(a, b) for a, b in zip(i1, i2)]}
        if same_in and not same_out:
            if reduced:
                reductions += 1
            else:
                variant.append({"index": i, "op": op,
                                "out_shapes": [d[0] if d else None for d in o1],
                                "out_rel": [rel(a, b) for a, b in zip(o1, o2)]})
        clean = clean and (same_out or reduced)
    kinds = {}
    for v in variant:
        kinds[v["op"]] = kinds.get(v["op"], 0) + 1
    print(json.dumps({"conv_tf32": args.conv_tf32, "key": args.key, "ops": [len(one), len(two)],
                      "first_foreign_producer": foreign, "batch_variant_ops": len(variant),
                      "batch_reductions": reductions, "batch_variant_by_op": kinds,
                      "first_variant": variant[:12]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
