"""The denoising loop: CFG + DPM-Solver++ + cross-attention guidance + GLIGEN
(counterpart of lvd_tpu/diffusion/sampler.py:58-190).

The latent carry is fp32 end to end (a guidance update is far below the bf16
step at unit scale); the UNet consumes the model dtype (the dtype of the
latents passed in). Each of the first ``min(max_index_step, T)`` steps first
runs the guidance loop: while ``loss / loss_scale > loss_threshold`` and
fewer than ``max_iter`` updates were made, the loss-scaled energy and its
gradient with respect to the latents are taken through a cond-only UNet walk
that stops at the last captured site, and ``lat -= sqrt(1 - abar_t) * grad``.
The loss starts at 1e10 and is carried across steps, so a step that enters
with a loss already at or below the threshold makes no update. The CFG
forward of each of the first ``min(num_grounding_steps, T)`` steps takes the
GLIGEN inputs; the energy walk never does. lvd_tpu compiles one scan per
segment between the steps where guidance or GLIGEN stops
(``segment_boundaries``); this loop decides step by step.

Frame-sharded (``spmd_axis``, a parallel/comm.Group): each rank runs the
loop on its frames of the latents, the UNet walks sharded, and the energy
is psummed, so the loop's condition reads the same all-reduced loss on
every rank and every rank makes the same number of updates. The energy's
backward is seeded with 1 / ranks (parallel/comm.py's psum rule); under
``energy_remat`` the checkpointed layers recompute, collectives included,
in the same order on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.unet3d import apply_unet3d
from ..parallel import comm
from . import dpm_solver as dpm
from .guidance import GuidanceConfig, compute_ca_energy


@dataclasses.dataclass
class GuidanceTensors:
    """The guidance pack (layout/rasterize.GuidancePack) as device tensors."""

    masks: Dict[Tuple, torch.Tensor]
    token_indices: torch.Tensor
    token_mask: torch.Tensor
    k_fg: Dict[Tuple, torch.Tensor]
    k_bg: Dict[Tuple, torch.Tensor]


def pack_to_tensors(pack, device) -> GuidanceTensors:
    on = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    return GuidanceTensors(
        masks={k: on(v) for k, v in pack.masks.items()},
        token_indices=on(pack.token_indices).long(),
        token_mask=on(pack.token_mask),
        k_fg={k: on(v) for k, v in pack.k_fg.items()},
        k_bg={k: on(v) for k, v in pack.k_bg.items()},
    )


def energy_and_grad(unet_params, unet_cfg, lat32, timestep, cond_text, guidance,
                    keys, g_cfg: GuidanceConfig, model_dt, spmd_axis=None):
    """The loss-scaled energy at fp32 latents and its gradient with respect
    to them (fp32), through the cond-only walk in ``model_dt``; sharded,
    the whole video's energy and the gradient of this rank's frames."""
    with torch.enable_grad():
        x = lat32.detach().requires_grad_(True)
        _, aux = apply_unet3d(unet_params, unet_cfg, x.to(model_dt), timestep, cond_text,
                              capture_keys=keys, capture_only=True,
                              remat=g_cfg.energy_remat != "none", spmd_axis=spmd_axis)
        energy = compute_ca_energy(aux, guidance, keys, g_cfg, spmd_axis) * g_cfg.loss_scale
        seed = None if spmd_axis is None else comm.replicated_seed(energy, spmd_axis)
        (grad,) = torch.autograd.grad(energy, x, grad_outputs=seed)
    return energy.detach(), grad


def sample_video(unet_params, unet_cfg, latents, text_pair, coeffs: dpm.SolverCoeffs,
                 guidance_scale: float = 9.0, guidance: Optional[GuidanceTensors] = None,
                 guidance_cfg: Optional[GuidanceConfig] = None,
                 guidance_attn_keys: Sequence[Tuple] = (), gligen_pair=None,
                 num_grounding_steps: int = 0, step_times=None, guided_times=None,
                 spmd_axis=None):
    """latents (B, F, h, w, C) initial noise in the model dtype; text_pair
    (2B, L, D) = [uncond; cond]; gligen_pair None or the (2B*F, M, ...)
    grounding inputs of apply_unet3d. Returns the final latents in the model
    dtype. With ``spmd_axis``, F is this rank's frames, and so are the
    guidance pack's masks and k values and the grounding rows.
    ``step_times`` and ``guided_times``, if lists, receive each step's
    seconds and each guided step's guidance-loop seconds (the card is
    synchronised first)."""
    model_dt = latents.dtype
    b = latents.shape[0]
    n_steps = len(coeffs.timestep)
    g_cfg = guidance_cfg or GuidanceConfig()
    g_end = min(g_cfg.max_index_step, n_steps) if guidance is not None else 0
    gl_end = min(num_grounding_steps, n_steps) if gligen_pair is not None else 0
    keys = tuple(tuple(k) for k in guidance_attn_keys)
    cond_text = text_pair[b:]
    sync = (lambda: torch.cuda.synchronize(latents.device)) if latents.is_cuda else (lambda: None)

    lat = latents.float()
    prev_x0 = None
    loss = torch.tensor(1e10, dtype=torch.float32)  # always guide on the first step
    for i in range(n_steps):
        t0 = time.perf_counter()
        c = coeffs.at(i)
        if i < g_end:
            it = 0
            while (loss / g_cfg.loss_scale > g_cfg.loss_threshold).item() and it < g_cfg.max_iter:
                loss, grad = energy_and_grad(unet_params, unet_cfg, lat, c.timestep, cond_text,
                                             guidance, keys, g_cfg, model_dt, spmd_axis)
                lat = lat - c.sqrt_one_minus_abar * grad
                it += 1
            if guided_times is not None:
                sync()
                guided_times.append(time.perf_counter() - t0)
        lat_in = torch.cat([lat, lat], dim=0).to(model_dt)
        eps = apply_unet3d(unet_params, unet_cfg, lat_in, c.timestep, text_pair,
                           gligen=gligen_pair if i < gl_end else None, spmd_axis=spmd_axis)
        eps_u, eps_c = eps[:b], eps[b:]
        eps_cfg = eps_u + guidance_scale * (eps_c - eps_u)
        prev_x0, lat = dpm.step(prev_x0, c, lat, eps_cfg)
        if step_times is not None:
            sync()
            step_times.append(time.perf_counter() - t0)
    return lat.to(model_dt)
