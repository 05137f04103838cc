"""TextToVideoPipeline (counterpart of lvd_tpu/pipeline.py:84-128 and
225-427, without the frame-sharded path).

CLIP encodes the [negative; prompt] pair, DPM-Solver++ (2M) denoises with
classifier-free guidance from fp32-carried latents, optionally with
cross-attention energy guidance on the first steps (``backward_guidance``)
and GLIGEN grounding on the first ``int(beta * T)`` steps (``gligen_boxes``,
``gligen_phrases``: per-frame boxes and their phrases, a gated UNet tree),
and the VAE decodes the frames to uint8 on the device. Without ``latents``
the initial noise is ``jax.random.normal(PRNGKey(seed))``'s, drawn on the
host by a copy of JAX's PRNG (utils/prng.py), so a seed gives the same video
as lvd_tpu. Phases are timed by a PhaseTimer, and the sampling is traced
under ``LVD_PROFILE`` (utils/profiling.py), where lvd_tpu's are.

``video_to_video`` is the Zeroscope-XL refinement (SDEdit): the VAE encoder
takes the frames to latents (``encode_video``: chunks of 8 frames, each
sampled with the next key of lvd_tpu's ``split`` chain from
``PRNGKey(seed)``), they are renoised to ``strength`` of the schedule with
``PRNGKey(seed + 99991)``'s noise, and the tail steps denoise them with
unguided CFG.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import ModelPreset
from .diffusion import dpm_solver as dpm
from .diffusion import sampler as sampler_mod
from .diffusion import schedule as schedule_mod
from .diffusion.guidance import GuidanceConfig
from .layout.rasterize import make_guidance_pack
from .models.clip import apply_clip_text
from .models.loader import cast_tree
from .models.vae import decode as vae_decode
from .models.vae import encode as vae_encode
from .utils import prng
from .utils.device import resolve_device, sync
from .utils.profiling import PhaseTimer, maybe_trace

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
        # updates), decode. ``timer`` sums the phases encode_prompt, sample
        # and decode over calls, as lvd_tpu's does (LVD_TIMINGS=1 prints each).
        self.timings: dict = {}
        self.timer = PhaseTimer()

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
    def encode_video(self, video, seed: int = 0, chunk: int = 8):
        """(F, H, W, 3) float in [0, 1] -> (1, F, h, w, C) latents in the
        pipeline's type: per chunk of frames the next ``key, sub =
        split(key)`` of lvd_tpu's chain from ``PRNGKey(seed)``, and
        ``(mean + exp(logvar / 2) * normal(sub)) * scaling_factor``, the
        normal drawn in the pipeline's type, as lvd_tpu draws it."""
        vae = self.preset.vae
        video = torch.as_tensor(np.asarray(video, np.float32) * 2.0 - 1.0)
        key = prng.prng_key(seed)
        outs = []
        for i in range(0, video.shape[0], chunk):
            key, sub = prng.split(key)
            mean, logvar = vae_encode(self.vae_params, vae,
                                      video[i:i + chunk].to(self.device, self.dtype))
            noise = prng.normal_key(sub, tuple(mean.shape), self.device, mean.dtype)
            outs.append((mean + torch.exp(0.5 * logvar) * noise) * vae.scaling_factor)
        return torch.cat(outs)[None]

    @torch.no_grad()
    def video_to_video(self, prompt: str, video, strength: float = 0.6,
                       negative_prompt: str = "", num_inference_steps: int = 50,
                       guidance_scale: float = 9.0, seed: int = 0, output_type: str = "np"):
        """SDEdit vid2vid, the Zeroscope-XL refinement: encode the frames
        ((F, H, W, 3) float in [0, 1]), renoise them to the first of the last
        ``int(num_inference_steps * strength)`` timesteps with
        ``normal(PRNGKey(seed + 99991))``, and denoise those tail steps with
        unguided CFG. Returns (1, F, H, W, 3) float in [0, 1], or the final
        latents (``output_type="latent"``). Phase seconds land in
        ``timings``: encode, encode_prompt, steps, decode."""
        preset = self.preset
        with self.timer.phase("encode"):
            latents0 = self.encode_video(video, seed=seed)
            sync(self.device)
        full_ts = schedule_mod.inference_timesteps(preset.scheduler, num_inference_steps)
        start = max(num_inference_steps - int(num_inference_steps * strength), 0)
        tail_ts = full_ts[start:]
        coeffs = dpm.make_coeffs(preset.scheduler, timesteps=tail_ts)
        abar = schedule_mod.make_alphas_cumprod(preset.scheduler)
        t0 = int(tail_ts[0])
        noise = prng.normal_key(prng.prng_key(seed + 99991), tuple(latents0.shape), self.device)
        a0, s0 = float(np.float32(np.sqrt(abar[t0]))), float(np.float32(np.sqrt(1 - abar[t0])))
        latents = (a0 * latents0.float() + s0 * noise).to(self.dtype)

        with self.timer.phase("encode_prompt"):
            text_pair = self.encode_prompt(prompt, negative_prompt).to(self.dtype)
            sync(self.device)
        self.timings = {"encode": self.timer.last["encode"],
                        "encode_prompt": self.timer.last["encode_prompt"], "steps": [],
                        "guided": []}
        with self.timer.phase("sample"), maybe_trace("sample"):
            final = sampler_mod.sample_video(
                self.unet_params, preset.unet, latents, text_pair, coeffs,
                float(guidance_scale), step_times=self.timings["steps"])
        if output_type == "latent":
            return final
        with self.timer.phase("decode"):
            video = self.decode_latents(final)
        self.timings["decode"] = self.timer.last["decode"]
        return video

    @torch.no_grad()
    def decode_uint8(self, latents):
        """(N, h, w, C) latents -> (N, H, W, 3) uint8 frames on the device
        (lvd_tpu's ``_decode_jit``)."""
        imgs = vae_decode(self.vae_params, self.preset.vae,
                          latents / self.preset.vae.scaling_factor)
        imgs = torch.clamp(imgs.float() / 2.0 + 0.5, 0.0, 1.0)
        return torch.round(imgs * 255.0).to(torch.uint8)

    @torch.no_grad()
    def decode_latents(self, latents, chunk: int = 24):
        """(B, F, h, w, C) latents -> (B, F, H, W, 3) float in [0, 1], via
        uint8 on the device (as lvd_tpu rounds it); frames in chunks."""
        b, f, h, w, c = latents.shape
        flat = latents.reshape(b * f, h, w, c)
        outs = [self.decode_uint8(flat[i:i + chunk]).cpu() for i in range(0, b * f, chunk)]
        imgs = torch.cat(outs).numpy().astype(np.float32) / 255.0
        return imgs.reshape(b, f, *imgs.shape[1:])

    @torch.no_grad()
    def __call__(self, prompt: str, negative_prompt: str = "", height: Optional[int] = None,
                 width: Optional[int] = None, num_frames: int = 16,
                 num_inference_steps: int = 50, guidance_scale: float = 9.0, seed: int = 0,
                 latents=None, backward_guidance: Optional[dict] = None,
                 gligen_boxes=None, gligen_phrases=None,
                 gligen_scheduled_sampling_beta: float = 0.3, output_type: str = "np"):
        """Returns (B, F, H, W, 3) float32 in [0, 1] (``output_type="np"``),
        the final latents (``"latent"``), or the decoded frames as a uint8
        (B*F, H, W, 3) tensor on the pipeline's device (``"uint8_device"``:
        nothing in this call waits for the card there, so a caller can
        overlap one video's copy to the host with the next one's sampling;
        ``timings`` then holds no step seconds). ``latents`` may be passed in
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

        # "uint8_device" returns the frames on the card without waiting for
        # it (lvd_tpu/pipeline.py:406-424): no sync, and no timer that syncs.
        on_host = output_type != "uint8_device"
        with self.timer.phase("encode_prompt"):
            text_pair = self.encode_prompt(prompt, negative_prompt).to(self.dtype)
            if on_host:
                sync(self.device)
        self.timings = {"encode_prompt": self.timer.last["encode_prompt"], "steps": [],
                        "guided": []}

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
        with self.timer.phase("sample"), maybe_trace("sample"):
            final = sampler_mod.sample_video(
                self.unet_params, preset.unet, latents, text_pair, coeffs,
                float(guidance_scale), guidance, g_cfg, keys, gligen_pair=gligen_pair,
                num_grounding_steps=n_ground,
                step_times=self.timings["steps"] if on_host else None,
                guided_times=self.timings["guided"] if on_host else None)
        if output_type == "latent":
            return final
        if not on_host:
            b, f, h, w, c = final.shape
            return self.decode_uint8(final.reshape(b * f, h, w, c))
        with self.timer.phase("decode"):
            video = self.decode_latents(final)
        self.timings["decode"] = self.timer.last["decode"]
        return video
