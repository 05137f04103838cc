"""The 2D image path: semantic guidance and latent composition (counterpart
of lvd_tpu/pipeline2d.py).

``generate_semantic_guidance`` denoises image latents with DPM-Solver++
(2M) and classifier-free guidance over the 2D UNet (models/unet2d.py), from
an fp32 latent carry. Each of the first ``min(max_index_step, T)`` steps
first runs the guidance loop: while ``loss / loss_scale > loss_threshold``
and fewer than ``max_iter`` updates were made, the loss-scaled
cross-attention energy (diffusion/guidance.py) and its gradient with
respect to the latents are taken through a remat walk of the UNet that
captures the guided sites, and ``lat -= sqrt(1 - abar_t) * grad``; the loss
starts at 1e10 and is carried across steps. The first
``min(num_grounding_steps, T)`` steps take the GLIGEN inputs, in the energy
walk and in the CFG pair (whose uncond half has its masks zeroed). lvd_tpu
compiles one scan per segment between the steps where guidance or grounding
stops; this loop decides step by step, and reads the loss on the host once
per guidance iteration, as lvd_tpu's while-loop condition does.
``save_all_latents`` also returns the (T+1, B, h, w, C) history that
``layout/latents.compose_latents`` takes; ``fast_after_steps`` subsamples
the schedule's tail.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .config import SchedulerConfig, VAEConfig
from .diffusion import dpm_solver as dpm
from .diffusion import schedule as schedule_mod
from .diffusion.guidance import GuidanceConfig, compute_ca_energy
from .diffusion.sampler import GuidanceTensors, pack_to_tensors
from .layout.rasterize import make_guidance_pack
from .models.unet2d import UNet2DConfig, apply_unet2d
from .models.vae import decode as vae_decode
from .utils.device import resolve_device


def _energy_and_grad(unet_params, unet_cfg, lat32, timestep, cond_text, guidance, keys,
                     g_cfg: GuidanceConfig, model_dt, gligen):
    """The loss-scaled energy at fp32 latents and its gradient with respect
    to them, through the remat walk in ``model_dt``."""
    with torch.enable_grad():
        x = lat32.detach().requires_grad_(True)
        _, aux = apply_unet2d(unet_params, unet_cfg, x.to(model_dt), timestep, cond_text,
                              capture_keys=keys, remat=True, gligen=gligen)
        energy = compute_ca_energy(aux, guidance, keys, g_cfg) * g_cfg.loss_scale
        (grad,) = torch.autograd.grad(energy, x)
    return energy.detach(), grad


@torch.no_grad()
def generate_semantic_guidance(unet_params, unet_cfg: UNet2DConfig, latents, text_pair,
                               sched_cfg: SchedulerConfig, num_inference_steps: int,
                               guidance_scale: float = 7.5,
                               guidance: Optional[GuidanceTensors] = None,
                               guidance_cfg: Optional[GuidanceConfig] = None,
                               guidance_attn_keys: Sequence[Tuple] = (), gligen=None,
                               num_grounding_steps: int = 0, save_all_latents: bool = False,
                               fast_after_steps: Optional[int] = None, fast_rate: int = 2):
    """latents (B, h, w, C) scaled initial latents in the model dtype;
    text_pair (2B, L, D) = [uncond; cond]; gligen None or {boxes (B, M, 4),
    masks (B, M), positive_embeddings (B, M, D)}. Returns the final latents,
    or (final, all_latents (T+1, B, h, w, C)) with ``save_all_latents``."""
    timesteps = schedule_mod.inference_timesteps(sched_cfg, num_inference_steps)
    if fast_after_steps is not None:
        timesteps = schedule_mod.get_fast_schedule(timesteps, fast_after_steps, fast_rate)
    coeffs = dpm.make_coeffs(sched_cfg, timesteps=timesteps)
    n_steps = len(timesteps)

    g_cfg = guidance_cfg or GuidanceConfig()
    g_end = min(g_cfg.max_index_step, n_steps) if guidance is not None else 0
    gl_end = min(num_grounding_steps, n_steps) if gligen is not None else 0
    keys = tuple(tuple(k) for k in guidance_attn_keys)
    b = latents.shape[0]
    cond_text = text_pair[b:]
    model_dt = latents.dtype
    g_pair = None
    if gligen is not None:
        g_pair = {k: torch.cat([v, v], dim=0) for k, v in gligen.items()}
        g_pair["masks"][:b] = 0.0

    lat = latents.float()
    prev_x0 = None
    loss = torch.tensor(1e10, dtype=torch.float32)
    history = [latents] if save_all_latents else None
    for i in range(n_steps):
        c = coeffs.at(i)
        grounded = i < gl_end
        if i < g_end:
            it = 0
            while (loss / g_cfg.loss_scale > g_cfg.loss_threshold).item() and it < g_cfg.max_iter:
                loss, grad = _energy_and_grad(unet_params, unet_cfg, lat, c.timestep, cond_text,
                                              guidance, keys, g_cfg, model_dt,
                                              gligen if grounded else None)
                lat = lat - c.sqrt_one_minus_abar * grad
                it += 1
        lat_in = torch.cat([lat, lat], dim=0).to(model_dt)
        eps, _ = apply_unet2d(unet_params, unet_cfg, lat_in, c.timestep, text_pair,
                              gligen=g_pair if grounded else None)
        eps_u, eps_c = eps[:b], eps[b:]
        prev_x0, lat = dpm.step(prev_x0, c, lat, eps_u + guidance_scale * (eps_c - eps_u))
        if save_all_latents:
            history.append(lat.to(model_dt))

    final = lat.to(model_dt)
    if save_all_latents:
        return final, torch.stack(history)
    return final


@torch.no_grad()
def decode_images(vae_params, vae_cfg: VAEConfig, latents):
    """(B, h, w, C) latents -> (B, H, W, 3) float in [0, 1]."""
    imgs = vae_decode(vae_params, vae_cfg, latents / vae_cfg.scaling_factor)
    return torch.clamp(imgs.float() / 2.0 + 0.5, 0.0, 1.0)


def build_image_guidance(boxes, object_positions, guidance_attn_keys, latent_hw,
                         g_cfg: GuidanceConfig, device=None) -> GuidanceTensors:
    """The single-frame guidance pack (each box gets a frame axis of length
    1), as tensors on ``device`` (the card unless asked)."""
    pack = make_guidance_pack([[list(b)] for b in boxes], object_positions, guidance_attn_keys,
                              latent_hw, fg_top_p=g_cfg.fg_top_p, bg_top_p=g_cfg.bg_top_p)
    return pack_to_tensors(pack, resolve_device(device))
