"""Every kernel wrapper the UNets call pointed at its plain PyTorch version,
for a whole walk: the reference path of chip_smoke.py, and a walk on meta
tensors, which hold no data to launch a kernel on (parallel/audit.py). The
wrappers themselves take their plain versions for CPU tensors alone."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def swapped(swaps):
    """Sets each (module, name, value) for the block, then restores it."""
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    for module, name, value in swaps:
        setattr(module, name, value)
    try:
        yield
    finally:
        for module, name, value in saved:
            setattr(module, name, value)


def _linear_rows_plain(x, w, b=None, trans_w=False):
    from . import linear_fused

    return linear_fused.linear_plain(x, w.transpose(0, 1) if trans_w else w, b)


def plain_route():
    """A context in which kernels A-D, H, I and K-M run their plain
    versions."""
    from . import geglu_fused, linear_fused, norms, packed_attention, spatial_conv_fused
    from . import temp_conv_fused, temporal_attention

    return swapped([
        (packed_attention, "attention_packed", packed_attention.attention_packed_plain),
        (temporal_attention, "temporal_attention_pair",
         temporal_attention.temporal_attention_pair_plain),
        (geglu_fused, "geglu_mlp", geglu_fused.geglu_mlp_plain),
        (temp_conv_fused, "norm_silu_temporal_conv",
         temp_conv_fused.norm_silu_temporal_conv_plain),
        (spatial_conv_fused, "norm_silu_conv2d", spatial_conv_fused.norm_silu_conv2d_plain),
        (linear_fused, "linear_rows", _linear_rows_plain),
        (norms, "group_norm_coeffs", norms.group_norm_coeffs_plain),
        (norms, "group_norm", norms.group_norm_plain),
        (norms, "group_norm_silu", norms.group_norm_silu_plain),
        (norms, "layer_norm", norms.layer_norm_plain),
    ])
