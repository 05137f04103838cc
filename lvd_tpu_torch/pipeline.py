"""TextToVideoPipeline (counterpart of lvd_tpu/pipeline.py:84-128 and
324-427, without the frame-sharded path).

CLIP encodes the [negative; prompt] pair, DPM-Solver++ (2M) denoises with
classifier-free guidance from fp32-carried latents, optionally with
cross-attention energy guidance on the first steps (``backward_guidance``)
and GLIGEN grounding on the first ``int(beta * T)`` steps (``gligen_boxes``,
``gligen_phrases``: per-frame boxes and their phrases, a gated UNet tree),
and the VAE decodes the frames to uint8 on the device. Without ``latents``
the initial noise is ``jax.random.normal(PRNGKey(seed))``'s, drawn on the
host by a numpy copy of JAX's PRNG (utils/prng.py), so a seed gives the same
video as lvd_tpu.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .config import ModelPreset
from .diffusion import dpm_solver as dpm
from .diffusion import sampler as sampler_mod
from .diffusion.guidance import GuidanceConfig
from .layout.rasterize import make_guidance_pack
from .models.clip import apply_clip_text
from .models.loader import cast_tree
from .models.vae import decode as vae_decode
from .utils import prng
from .utils.device import resolve_device

MAX_GLIGEN_OBJS = 30  # grounding slots per frame (lvd_tpu/pipeline.py:28)


@dataclasses.dataclass
class PipelineModels:
    preset: ModelPreset
    unet_params: dict
    clip_params: dict
    vae_params: dict
    tokenizer: object


class TextToVideoPipeline:
    def __init__(self, models: PipelineModels, dtype=torch.float32, device=None):
        """Runs on the card unless ``device="cpu"`` is asked for; the params
        are cast to ``dtype`` (fp32 by default, as lvd_tpu's pipeline) and
        moved to the device once."""
        self.device = resolve_device(device)
        self.m = models
        self.preset = models.preset
        self.dtype = dtype
        self.unet_params = cast_tree(models.unet_params, dtype, self.device)
        self.clip_params = cast_tree(models.clip_params, dtype, self.device)
        self.vae_params = cast_tree(models.vae_params, dtype, self.device)
        # Phase seconds of the last call: encode_prompt, steps (one entry per
        # denoising step), guided (one entry per guided step: its guidance
        # updates), decode.
        self.timings: dict = {}

    @torch.no_grad()
    def encode_prompt(self, prompt: str, negative_prompt: str = ""):
        """The CFG pair (2, L, D): [uncond; cond] final hidden states."""
        tok = self.m.tokenizer
        ids = np.stack([np.asarray(tok.encode_padded(negative_prompt), np.int64),
                        np.asarray(tok.encode_padded(prompt), np.int64)])
        ids = torch.from_numpy(ids).to(self.device)
        return apply_clip_text(self.clip_params, self.preset.clip, ids)["last_hidden_state"]

    @torch.no_grad()
    def encode_phrases_pooled(self, phrases):
        """Pooled CLIP embeddings (N, D) of grounding phrases, the
        PositionNet's input."""
        tok = self.m.tokenizer
        ids = np.stack([np.asarray(tok.encode_padded(p), np.int64) for p in phrases])
        ids = torch.from_numpy(ids).to(self.device)
        return apply_clip_text(self.clip_params, self.preset.clip, ids)["pooler_output"]

    def prepare_gligen_inputs(self, gligen_boxes, gligen_phrases, num_frames: int):
        """Per-frame box and phrase lists -> the CFG pair {boxes (2F, M, 4),
        masks (2F, M), positive_embeddings (2F, M, positive_len)} in the
        pipeline's type on its device, [uncond; cond] with the uncond masks
        zeroed; M = MAX_GLIGEN_OBJS slots, each phrase encoded once a call."""
        d = self.preset.unet.gligen_positive_len
        boxes = np.zeros((num_frames, MAX_GLIGEN_OBJS, 4), np.float32)
        masks = np.zeros((num_frames, MAX_GLIGEN_OBJS), np.float32)
        embs = np.zeros((num_frames, MAX_GLIGEN_OBJS, d), np.float32)
        phrase_cache: dict = {}
        for f, (phrases_f, boxes_f) in enumerate(zip(gligen_phrases, gligen_boxes)):
            phrases_f = list(phrases_f)[:MAX_GLIGEN_OBJS]
            boxes_f = list(boxes_f)[:MAX_GLIGEN_OBJS]
            new = [p for p in phrases_f if p not in phrase_cache]
            if new:
                pooled = self.encode_phrases_pooled(new).float().cpu().numpy()
                phrase_cache.update(zip(new, pooled))
            n = len(boxes_f)
            if n:
                boxes[f, :n] = np.asarray(boxes_f, np.float32)
                masks[f, :n] = 1.0
                embs[f, :n] = np.stack([phrase_cache[p] for p in phrases_f])
        on = lambda a: torch.from_numpy(a).to(self.device, self.dtype)
        return {"boxes": on(np.concatenate([boxes, boxes])),
                "masks": on(np.concatenate([np.zeros_like(masks), masks])),
                "positive_embeddings": on(np.concatenate([embs, embs]))}

    @torch.no_grad()
    def decode_latents(self, latents, chunk: int = 24):
        """(B, F, h, w, C) latents -> (B, F, H, W, 3) float in [0, 1], via
        uint8 on the device (as lvd_tpu rounds it); frames in chunks."""
        b, f, h, w, c = latents.shape
        flat = latents.reshape(b * f, h, w, c)
        outs = []
        for i in range(0, b * f, chunk):
            imgs = vae_decode(self.vae_params, self.preset.vae,
                              flat[i:i + chunk] / self.preset.vae.scaling_factor)
            imgs = torch.clamp(imgs.float() / 2.0 + 0.5, 0.0, 1.0)
            outs.append(torch.round(imgs * 255.0).to(torch.uint8).cpu())
        imgs = torch.cat(outs).numpy().astype(np.float32) / 255.0
        return imgs.reshape(b, f, *imgs.shape[1:])

    @torch.no_grad()
    def __call__(self, prompt: str, negative_prompt: str = "", height: Optional[int] = None,
                 width: Optional[int] = None, num_frames: int = 16,
                 num_inference_steps: int = 50, guidance_scale: float = 9.0, seed: int = 0,
                 latents=None, backward_guidance: Optional[dict] = None,
                 gligen_boxes=None, gligen_phrases=None,
                 gligen_scheduled_sampling_beta: float = 0.3, output_type: str = "np"):
        """Returns (B, F, H, W, 3) float32 in [0, 1] (``output_type="np"``)
        or the final latents (``"latent"``). ``latents`` may be passed in
        (B, F, h, w, 4); otherwise they are drawn from ``seed`` as lvd_tpu
        draws them. ``backward_guidance``: {boxes, object_positions, config,
        attn_keys[, pack]} as lvd_tpu takes it; the guided updates enable
        autograd locally. ``gligen_boxes`` / ``gligen_phrases``: per frame, a
        list of normalized xyxy boxes and their phrases; the fuser runs in
        the first ``int(gligen_scheduled_sampling_beta * num_inference_steps)``
        steps and never in the guided updates' energy walk."""
        preset = self.preset
        height = height or preset.height
        width = width or preset.width
        if height % 8 or width % 8:
            raise ValueError(f"height/width must be multiples of 8: {height}x{width}")
        sf = preset.vae.scale_factor
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" \
            else (lambda: None)

        t0 = time.perf_counter()
        text_pair = self.encode_prompt(prompt, negative_prompt).to(self.dtype)
        sync()
        self.timings = {"encode_prompt": time.perf_counter() - t0, "steps": []}

        h_lat, w_lat = height // sf, width // sf
        if latents is None:
            noise = prng.normal(seed, (1, num_frames, h_lat, w_lat, 4)) * dpm.INIT_NOISE_SIGMA
            latents = torch.from_numpy(noise)
        latents = torch.as_tensor(latents).to(self.device, self.dtype)

        coeffs = dpm.make_coeffs(preset.scheduler, num_inference_steps)
        guidance, g_cfg, keys = None, None, ()
        if backward_guidance is not None:
            g_cfg = backward_guidance.get("config") or GuidanceConfig()
            keys = tuple(tuple(k) for k in backward_guidance["attn_keys"])
            pack = backward_guidance.get("pack")
            if pack is None:
                pack = make_guidance_pack(
                    backward_guidance["boxes"], backward_guidance["object_positions"], keys,
                    (h_lat, w_lat), fg_top_p=g_cfg.fg_top_p, bg_top_p=g_cfg.bg_top_p,
                    upsample_scale=g_cfg.upsample_scale)
            guidance = sampler_mod.pack_to_tensors(pack, self.device)
        gligen_pair, n_ground = None, 0
        if gligen_boxes:
            gligen_pair = self.prepare_gligen_inputs(gligen_boxes, gligen_phrases, num_frames)
            n_ground = int(gligen_scheduled_sampling_beta * num_inference_steps)
        self.timings["guided"] = []
        final = sampler_mod.sample_video(self.unet_params, preset.unet, latents, text_pair,
                                         coeffs, float(guidance_scale), guidance, g_cfg, keys,
                                         gligen_pair=gligen_pair, num_grounding_steps=n_ground,
                                         step_times=self.timings["steps"],
                                         guided_times=self.timings["guided"])
        if output_type == "latent":
            return final
        t0 = time.perf_counter()
        video = self.decode_latents(final)
        self.timings["decode"] = time.perf_counter() - t0
        return video
