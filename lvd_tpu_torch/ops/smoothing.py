"""Depthwise Gaussian smoothing of attention maps (counterpart of
lvd_tpu/ops/smoothing.py, for GuidanceConfig.smooth_attn): a normalized
separable Gaussian, reflect padding, one depthwise convolution per map.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_2d(kernel_size: int = 3, sigma: float = 0.5) -> np.ndarray:
    """Outer product of two 1D Gaussians, normalized to sum 1."""
    coords = np.arange(kernel_size, dtype=np.float64)
    mean = (kernel_size - 1) / 2.0
    g = np.exp(-(((coords - mean) / sigma) ** 2) / 2.0)
    g = g / (sigma * math.sqrt(2 * math.pi))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def smooth_attn_maps(maps, kernel_size: int = 3, sigma: float = 0.5):
    """maps: (..., H, W) -> same shape, reflect-padded Gaussian blur in fp32,
    returned in the maps' type."""
    shape = maps.shape
    h, w = shape[-2], shape[-1]
    x = maps.reshape(-1, 1, h, w).float()
    pad = kernel_size // 2
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    k = torch.from_numpy(gaussian_kernel_2d(kernel_size, sigma)).to(x.device)
    y = F.conv2d(x, k[None, None])
    return y.reshape(shape).to(maps.dtype)
