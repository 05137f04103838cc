"""The collective census of the port (counterpart of
lvd_tpu/parallel/audit.py).

lvd_tpu lowers a shard_map'd function and sums the collectives of its
StableHLO text. Here ``audit_collectives(fn, *args, n_devices=n)`` calls
``fn(axis, *args)`` as rank 0 of ``n`` with a recording stand-in for the
axis (comm.Group.recording): the collectives exchange nothing, only count
their kind and per-rank result bytes, so ``fn`` runs on ``device="meta"``
tensors, with every kernel wrapper pointed at its plain version (a meta
tensor holds no data to launch a kernel on): nothing is launched and no
process group is needed. The count becomes lvd_tpu's rows with its
``wire_bytes`` rules (per-rank traffic):
    all_to_all:         size * (n-1)/n
    all_reduce (ring):  2 * size * (n-1)/n
    all_gather:         size * (n-1)/n
    reduce_scatter:     size * (n-1)/n
    collective_permute: size
A census covers one call of ``fn``: audit one UNet forward, not a sampling
loop, and multiply by the step count.

    python -m lvd_tpu_torch.parallel.audit --preset zeroscope --n 8

prints lvd_tpu's JSON line for one frame-sharded CFG UNet forward at the
preset's shapes.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.plain import plain_route
from . import comm


def wire_bytes(kind: str, size: int, n: int) -> int:
    frac = (n - 1) / n
    if kind == "all_reduce":
        return int(2 * size * frac)
    if kind == "collective_permute":
        return size
    return int(size * frac)


def audit_collectives(fn, *args, n_devices: int, **kwargs) -> Dict[str, dict]:
    """{kind: {count, resident_bytes, wire_bytes}} and a "total" row of
    ``fn(axis, *args, **kwargs)`` as rank 0 of ``n_devices``."""
    comm.reset_census()
    with plain_route(), torch.no_grad():
        fn(comm.Group.recording("data", n_devices), *args, **kwargs)
    out = {}
    for kind, row in comm.read_census().items():
        out[kind] = {**row, "wire_bytes": wire_bytes(kind, row["resident_bytes"], n_devices)}
    comm.reset_census()
    out["total"] = {k: sum(r[k] for r in out.values())
                    for k in ("count", "resident_bytes", "wire_bytes")}
    return out


def meta_params(cfg, dtype=torch.bfloat16):
    """The UNet's param tree (lvd_tpu's keys and shapes) as meta tensors."""
    from ..models import init
    from ..models.unet3d import unet3d_leaves
    from ..utils import prng

    def make(node):
        if isinstance(node, (init.Normal, init.Const)):
            return torch.empty(node.shape, dtype=dtype, device="meta")
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return [make(v) for v in node]

    return make(unet3d_leaves(prng.prng_key(0), cfg))


def cfg_forward(axis, params, cfg, latents, text):
    """One frame-sharded CFG UNet forward (bench.py's unit)."""
    from ..models.unet3d import apply_unet3d

    return apply_unet3d(params, cfg, torch.cat([latents, latents]), 500, text, spmd_axis=axis)


def _main(argv=None):
    """Census of one frame-sharded CFG UNet forward at a preset's shapes,
    as rank 0 of --n (meta tensors: no card, no process group)."""
    import argparse
    import json

    from ..config import PRESETS

    p = argparse.ArgumentParser(description=_main.__doc__)
    p.add_argument("--preset", default="zeroscope")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--frames", type=int, default=None)
    args = p.parse_args(argv)

    preset = PRESETS[args.preset]
    cfg = preset.unet
    f = args.frames or preset.default_num_frames
    h, w = preset.height // 8, preset.width // 8
    if f % args.n:
        raise SystemExit(f"{f} frames do not divide over {args.n} ranks")
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    census = audit_collectives(cfg_forward, meta_params(cfg), cfg, meta(1, f // args.n, h, w, 4),
                               meta(2, cfg.max_text_len, cfg.cross_attention_dim),
                               n_devices=args.n)
    print(json.dumps({"preset": args.preset, "n_devices": args.n, "frames": f,
                      "latent_hw": [h, w], "unit": "one CFG UNet forward", "census": census}))


if __name__ == "__main__":
    _main()
