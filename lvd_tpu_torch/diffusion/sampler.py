"""The unguided denoising loop: CFG + DPM-Solver++ (counterpart of the
unguided path of lvd_tpu/diffusion/sampler.py:160-174).

The latent carry is fp32 end to end; the UNet consumes the model dtype (the
dtype of the latents passed in). Cross-attention guidance and GLIGEN are
later slices.
"""

from __future__ import annotations

import time

import torch

from ..models.unet3d import apply_unet3d
from . import dpm_solver as dpm


def sample_video(unet_params, unet_cfg, latents, text_pair, coeffs: dpm.SolverCoeffs,
                 guidance_scale: float = 9.0, step_times=None):
    """latents (B, F, h, w, C) initial noise in the model dtype; text_pair
    (2B, L, D) = [uncond; cond]. Returns the final latents in the model
    dtype. ``step_times``, if a list, receives each step's seconds (the
    step is synchronised with the card first)."""
    model_dt = latents.dtype
    b = latents.shape[0]
    lat = latents.float()
    prev_x0 = None
    for i in range(len(coeffs.timestep)):
        t0 = time.perf_counter()
        c = coeffs.at(i)
        lat_in = torch.cat([lat, lat], dim=0).to(model_dt)
        eps = apply_unet3d(unet_params, unet_cfg, lat_in, c.timestep, text_pair)
        eps_u, eps_c = eps[:b], eps[b:]
        eps_cfg = eps_u + guidance_scale * (eps_c - eps_u)
        prev_x0, lat = dpm.step(prev_x0, c, lat, eps_cfg)
        if step_times is not None:
            if lat.is_cuda:
                torch.cuda.synchronize(lat.device)
            step_times.append(time.perf_counter() - t0)
    return lat.to(model_dt)
