"""Guidance-effect certification (counterpart of
lvd_tpu/diffusion/certify.py:69-145).

With random weights there is no detector benchmark to run, so the
certificate measures what the energy optimizes: the share of each object
token's cross-attention mass inside its box, and the distance of the
attention's center of mass from the box's, averaged over the instrumented
sites, before and after ``n_iters`` guided updates at the first inference
timestep. Each update is the sampler's guided step (loss-scaled energy,
``lat -= sqrt(1 - abar_t) * grad``, fp32 latent carry). A gain above 1 and a
falling CoM distance show that capture -> energy -> gradient through the
UNet -> latent update moves attention into the boxes.
"""

from __future__ import annotations

import torch

from ..models.unet3d import apply_unet3d
from . import dpm_solver as dpm
from .guidance import GuidanceConfig, _center_of_mass, gather_token_maps
from .sampler import energy_and_grad


def _key_metrics(attn, masks, token_indices, token_mask):
    """In-box attention share and normalized CoM distance of one site,
    averaged over the valid (object, token) pairs, frames and heads."""
    n_f, n_heads, hw, _ = attn.shape
    n_obj, n_p = token_indices.shape
    hk, wk = masks.shape[2], masks.shape[3]
    a = gather_token_maps(attn.float(), token_indices)      # (O, P, F, h, HW)
    m = masks.reshape(n_obj, 1, n_f, 1, hw)
    ratio = (a * m).sum(-1) / (a.sum(-1) + 1e-12)
    com_a_h, com_a_w = _center_of_mass(a.reshape(n_obj, n_p, n_f, n_heads, hk, wk))
    com_m_h, com_m_w = _center_of_mass(masks)
    diag = float(hk * hk + wk * wk) ** 0.5
    dist = torch.sqrt((com_a_h - com_m_h[:, None, :, None]) ** 2
                      + (com_a_w - com_m_w[:, None, :, None]) ** 2) / diag
    w = token_mask[:, :, None, None]
    denom = token_mask.sum() * n_f * n_heads + 1e-12
    return (ratio * w).sum() / denom, (dist * w).sum() / denom


@torch.no_grad()
def guidance_effect(unet_params, unet_cfg, scheduler_cfg, latents, cond_text, guidance, attn_keys,
                    g_cfg: GuidanceConfig, num_inference_steps: int = 40, n_iters: int = 5):
    """In-box attention share and CoM distance before and after ``n_iters``
    guided updates at the first inference timestep. ``latents``
    (1, F, h, w, C) in the model dtype, ``cond_text`` (1, L, D),
    ``guidance`` a sampler.GuidanceTensors. Returns a dict of floats."""
    keys = tuple(tuple(k) for k in attn_keys)
    coeffs = dpm.make_coeffs(scheduler_cfg, num_inference_steps)
    c = coeffs.at(0)
    dt = latents.dtype

    def metrics(lat):
        _, aux = apply_unet3d(unet_params, unet_cfg, lat, c.timestep, cond_text,
                              capture_keys=keys, capture_only=True)
        pairs = [_key_metrics(aux[k], guidance.masks[k], guidance.token_indices,
                              guidance.token_mask) for k in keys]
        return (torch.stack([r for r, _ in pairs]).mean().item(),
                torch.stack([d for _, d in pairs]).mean().item())

    r0, d0 = metrics(latents)
    lat = latents.float()
    for _ in range(n_iters):
        _, grad = energy_and_grad(unet_params, unet_cfg, lat, c.timestep, cond_text, guidance,
                                  keys, g_cfg, dt)
        lat = lat - c.sqrt_one_minus_abar * grad
    r1, d1 = metrics(lat.to(dt))
    return {"inbox_before": r0, "inbox_after": r1, "gain": r1 / max(r0, 1e-12),
            "com_dist_before": d0, "com_dist_after": d1, "n_iters": n_iters}
