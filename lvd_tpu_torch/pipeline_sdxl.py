"""SDXL-refiner img2img, one frame at a time (counterpart of
lvd_tpu/pipeline_sdxl.py).

The refiner is a 2D UNet (``models/unet2d.sdxl_refiner_config``)
conditioned on OpenCLIP-bigG's penultimate hidden states and its projected
pooled output with the "text_time" time ids (original size, crop, aesthetic
score). A frame is encoded by the VAE, sampled and renoised to ``strength``
of the schedule with the two keys of ``split(PRNGKey(seed))``, and the tail
steps denoise it with CFG over the [negative; prompt] pair at aesthetic
scores 2.5 / 6.0; the VAE decodes it. Runs on the card unless
``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import CLIPTextConfig, SchedulerConfig, VAEConfig
from .diffusion import dpm_solver as dpm
from .diffusion import schedule as schedule_mod
from .models.clip import apply_clip_text
from .models.loader import cast_tree
from .models.unet2d import UNet2DConfig, apply_unet2d
from .models.vae import decode as vae_decode
from .models.vae import encode as vae_encode
from .utils import prng
from .utils.device import resolve_device, sync
from .utils.profiling import PhaseTimer


@dataclasses.dataclass
class SDXLRefinerModels:
    unet_cfg: UNet2DConfig
    clip_cfg: CLIPTextConfig       # OpenCLIP bigG (hidden 1280, projected)
    vae_cfg: VAEConfig
    scheduler: SchedulerConfig
    unet_params: dict
    clip_params: dict
    vae_params: dict
    tokenizer: object


class SDXLRefinerPipeline:
    """img2img refinement: encode, renoise to ``strength``, denoise the tail
    with aesthetic-score conditioning (positive 6.0 / negative 2.5)."""

    def __init__(self, models: SDXLRefinerModels, dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.m = models
        self.dtype = dtype
        self.unet_params = cast_tree(models.unet_params, dtype, self.device)
        self.clip_params = cast_tree(models.clip_params, dtype, self.device)
        self.vae_params = cast_tree(models.vae_params, dtype, self.device)
        # The models hold the cast trees only, as lvd_tpu's do.
        models.unet_params, models.clip_params = self.unet_params, self.clip_params
        models.vae_params = self.vae_params
        # Seconds of the last call: encode, encode_prompt, steps (one entry
        # per denoising step), decode. ``timer`` sums the phases encode,
        # encode_prompt, step and decode over calls (LVD_TIMINGS=1 prints each).
        self.timings: dict = {}
        self.timer = PhaseTimer()

    def _encode_text(self, prompt: str, negative_prompt: str):
        tok = self.m.tokenizer
        ids = np.stack([np.asarray(tok.encode_padded(negative_prompt), np.int64),
                        np.asarray(tok.encode_padded(prompt), np.int64)])
        out = apply_clip_text(self.clip_params, self.m.clip_cfg,
                              torch.from_numpy(ids).to(self.device), return_penultimate=True)
        pooled = out.get("text_embeds", out["pooler_output"])
        return out["penultimate_hidden_state"].to(self.dtype), pooled.to(self.dtype)

    @torch.no_grad()
    def __call__(self, prompt: str, image, negative_prompt: str = "", strength: float = 0.35,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 aesthetic_score: float = 6.0, negative_aesthetic_score: float = 2.5,
                 seed: int = 0):
        """image (H, W, 3) float in [0, 1] -> the refined (H, W, 3) float
        image in [0, 1] (numpy)."""
        image = np.asarray(image, np.float32)
        h, w = image.shape[:2]
        vae = self.m.vae_cfg
        k1, k2 = prng.split(prng.prng_key(seed))

        with self.timer.phase("encode"):
            img = torch.from_numpy(image * 2.0 - 1.0)[None].to(self.device, self.dtype)
            mean, logvar = vae_encode(self.vae_params, vae, img)
            z = mean + torch.exp(0.5 * logvar) * prng.normal_key(
                k1, tuple(mean.shape), self.device, mean.dtype)
            latents0 = (z * vae.scaling_factor).float()

            full_ts = schedule_mod.inference_timesteps(self.m.scheduler, num_inference_steps)
            start = max(num_inference_steps - int(num_inference_steps * strength), 0)
            tail_ts = full_ts[start:]
            coeffs = dpm.make_coeffs(self.m.scheduler, timesteps=tail_ts)
            abar = schedule_mod.make_alphas_cumprod(self.m.scheduler)
            t_start = int(tail_ts[0])
            noise = prng.normal_key(k2, tuple(latents0.shape), self.device)
            latents = (float(np.sqrt(abar[t_start])) * latents0
                       + float(np.sqrt(1 - abar[t_start])) * noise).to(self.dtype)
            sync(self.device)
        self.timings = {"encode": self.timer.last["encode"]}

        with self.timer.phase("encode_prompt"):
            hidden, pooled = self._encode_text(prompt, negative_prompt)
            time_ids = torch.tensor([[h, w, 0, 0, negative_aesthetic_score],
                                     [h, w, 0, 0, aesthetic_score]], dtype=torch.float32,
                                    device=self.device)
            added = {"text_embeds": pooled, "time_ids": time_ids}
            sync(self.device)
        self.timings.update(encode_prompt=self.timer.last["encode_prompt"], steps=[])

        # The carry stays in the pipeline's type, as lvd_tpu's scan carries it.
        lat, prev_x0 = latents, None
        for i in range(len(tail_ts)):
            with self.timer.phase("step"):
                c = coeffs.at(i)
                lat_in = torch.cat([lat, lat])
                eps, _ = apply_unet2d(self.unet_params, self.m.unet_cfg, lat_in, c.timestep,
                                      hidden, added_cond=added)
                eps_cfg = eps[:1] + guidance_scale * (eps[1:] - eps[:1])
                prev_x0, lat = dpm.step(prev_x0, c, lat, eps_cfg)
                sync(self.device)
            self.timings["steps"].append(self.timer.last["step"])

        with self.timer.phase("decode"):
            out = vae_decode(self.vae_params, vae, lat / vae.scaling_factor)
            image = torch.clamp(out.float() / 2.0 + 0.5, 0.0, 1.0)[0].cpu().numpy()
        self.timings["decode"] = self.timer.last["decode"]
        return image


def refiner_clip_config() -> CLIPTextConfig:
    """OpenCLIP-bigG, the refiner's text encoder (text_encoder_2)."""
    return CLIPTextConfig(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                          num_attention_heads=20, projection_dim=1280)


def refiner_vae_config() -> VAEConfig:
    return VAEConfig(scaling_factor=0.13025)


def drawn_refiner_models(unet_cfg: UNet2DConfig, clip_cfg: CLIPTextConfig, vae_cfg: VAEConfig,
                         seed: int = 0, device=None, dtype=torch.float32) -> SDXLRefinerModels:
    """Random refiner weights in lvd_tpu's key order: ``split(PRNGKey(seed),
    3)`` feeds ``init_unet2d``, ``init_clip_text`` (with its projection) and
    ``init_vae``, drawn on ``device`` (the card unless asked)."""
    from .models.clip import init_clip_text
    from .models.unet2d import init_unet2d
    from .models.vae import init_vae
    from .text.tokenizer import load_tokenizer

    k = prng.split(prng.prng_key(seed), 3)
    return SDXLRefinerModels(
        unet_cfg=unet_cfg, clip_cfg=clip_cfg, vae_cfg=vae_cfg, scheduler=SchedulerConfig(),
        unet_params=init_unet2d(k[0], unet_cfg, device, dtype),
        clip_params=init_clip_text(k[1], clip_cfg, with_projection=True, device=device,
                                   dtype=dtype),
        vae_params=init_vae(k[2], vae_cfg, device, dtype),
        tokenizer=load_tokenizer(None))
