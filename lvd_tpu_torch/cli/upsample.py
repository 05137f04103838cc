"""Video upsampling CLI: Zeroscope-XL vid2vid and the SDXL refiner's
per-frame img2img (counterpart of lvd_tpu/cli/upsample.py; parity target of
both: the reference's scripts/upsample.py).

Reads the ``video_*.joblib`` (or ``.npz``) frames of a generation run
directory, refines each at 576x1024, and writes gif/joblib next to them as
``video_*_{zsxl|sdxl|zsxl_sdxl}``, skipping an output whose GIF exists.

Usage:
  python -m lvd_tpu_torch.cli.upsample --run-dir <run dir> \
      [--method zsxl | sdxl | zsxl+sdxl] [--strength 0.35] [--num_inference_steps 50]

Runs on the card; ``LVD_PLATFORM=cpu`` runs it on the CPU, and ``LVD_TINY=1``
with lvd_tpu's tiny models in fp32 (the SDXL refiner at a 64x96 target).
Otherwise the weights are the converted checkpoints under
``LVD_CHECKPOINT_ROOT`` (``models/convert.py``): Zeroscope-XL (or its random
weights under ``LVD_ALLOW_RANDOM_WEIGHTS=1``) and the SDXL refiner, whose
absence raises FileNotFoundError.

One divergence from lvd_tpu: ``upsample_video_zsxl`` scales uint8 frames
(what ``vis.load_video`` returns) by 1/255, as its docstring and the
``sdxl`` branch intend; lvd_tpu's casts to float32 before its uint8 test,
so its ``zsxl`` method clips [0, 255] to [0, 1].
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from ..utils import platform, vis
from ..utils.platform import maybe_force_platform

_xl_pipe = None
_sdxl_pipe = None

TINY_SDXL_HW = (64, 96)  # the refiner's target under LVD_TINY=1


def _get_xl_pipe():
    """Zeroscope-XL's pipeline in bf16 (lvd_tpu's tiny models in fp32 under
    ``LVD_TINY=1``), built once."""
    global _xl_pipe
    if _xl_pipe is None:
        from ..models.loader import load_pipeline_models, tiny_pipeline_models
        from ..pipeline import TextToVideoPipeline

        device = platform.device()
        if os.environ.get("LVD_TINY") == "1":
            models = tiny_pipeline_models(device=device)
            _xl_pipe = TextToVideoPipeline(models, dtype=torch.float32, device=device)
        else:
            models = load_pipeline_models("zeroscope_xl", device=device, dtype=torch.bfloat16)
            _xl_pipe = TextToVideoPipeline(models, dtype=torch.bfloat16, device=device)
    return _xl_pipe


def tiny_sdxl_configs():
    """lvd_tpu's tiny refiner (its upsample CLI under ``LVD_TINY=1``): the
    UNet2D at depth 2 with text_time conditioning, CLIP and VAE."""
    from ..config import CLIPTextConfig, VAEConfig
    from ..models.unet2d import UNet2DConfig

    unet_cfg = UNet2DConfig(
        block_out_channels=(16, 32, 32, 32), cross_attention_dim=32, num_heads=(2, 2, 2, 2),
        down_block_has_attn=(False, True, True, False), transformer_depth=(0, 2, 2, 0),
        mid_transformer_depth=2, norm_num_groups=8, addition_embed_type="text_time",
        addition_time_embed_dim=8, projection_class_embeddings_input_dim=32 + 5 * 8)
    clip_cfg = CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=2, projection_dim=32)
    vae_cfg = VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4)
    return unet_cfg, clip_cfg, vae_cfg


def _get_sdxl_pipe():
    """The SDXL refiner's pipeline in bf16 from its converted checkpoint
    (lvd_tpu's tiny refiner in fp32 under ``LVD_TINY=1``), built once."""
    global _sdxl_pipe
    if _sdxl_pipe is None:
        from .. import pipeline_sdxl as ps
        from ..models.loader import load_params_npz
        from ..models.unet2d import sdxl_refiner_config
        from ..text.tokenizer import load_tokenizer

        device = platform.device()
        if os.environ.get("LVD_TINY") == "1":
            models = ps.drawn_refiner_models(*tiny_sdxl_configs(), seed=0, device=device)
            _sdxl_pipe = ps.SDXLRefinerPipeline(models, dtype=torch.float32, device=device)
        else:
            root = os.environ.get("LVD_CHECKPOINT_ROOT", "")
            ckpt = os.path.join(root, "stabilityai--stable-diffusion-xl-refiner-1.0")
            if not os.path.isdir(ckpt):
                raise FileNotFoundError(
                    "SDXL refiner checkpoint not converted; run "
                    "`python -m lvd_tpu_torch.models.convert --src <sdxl-refiner> "
                    f"--dst {ckpt or '$LVD_CHECKPOINT_ROOT/...'} --sdxl-refiner`")
            load = lambda name: load_params_npz(os.path.join(ckpt, name), device, torch.bfloat16)
            models = ps.SDXLRefinerModels(
                unet_cfg=sdxl_refiner_config(), clip_cfg=ps.refiner_clip_config(),
                vae_cfg=ps.refiner_vae_config(), scheduler=ps.SchedulerConfig(),
                unet_params=load("unet.npz"), clip_params=load("clip.npz"),
                vae_params=load("vae.npz"), tokenizer=load_tokenizer(ckpt))
            _sdxl_pipe = ps.SDXLRefinerPipeline(models, dtype=torch.bfloat16, device=device)
    return _sdxl_pipe


def _resize_video(video: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize through PIL of frames in [0, 1] (host-side prep)."""
    from PIL import Image

    out = []
    for frame in video:
        img = Image.fromarray((np.clip(frame, 0, 1) * 255).astype(np.uint8))
        img = img.resize((width, height), Image.BILINEAR)
        out.append(np.asarray(img).astype(np.float32) / 255.0)
    return np.stack(out)


def _as_unit_float(video) -> np.ndarray:
    """Frames as float32 in [0, 1]: uint8 frames scaled by 1/255."""
    video = np.asarray(video)
    if video.dtype == np.uint8:
        return video.astype(np.float32) / 255.0
    return video.astype(np.float32)


def upsample_video_sdxl(video, prompt: str, strength: float = 0.35,
                        num_inference_steps: int = 50, seed: int = 0, target_hw=(576, 1024)):
    """Per-frame SDXL-refiner img2img, frame i at seed + i (reference
    scripts/upsample.py:104-158)."""
    pipe = _get_sdxl_pipe()
    video = _as_unit_float(video)
    if os.environ.get("LVD_TINY") == "1":
        target_hw = TINY_SDXL_HW
    resized = _resize_video(video, *target_hw)
    out = [pipe(prompt, frame, strength=strength, num_inference_steps=num_inference_steps,
                seed=seed + i)
           for i, frame in enumerate(resized)]
    return np.stack(out)


def upsample_video_zsxl(video, prompt: str, strength: float = 0.35,
                        num_inference_steps: int = 50, seed: int = 0):
    """(F, H, W, 3) frames (float in [0, 1], or uint8) -> the video refined
    at Zeroscope-XL's size by vid2vid, (F, H', W', 3) float in [0, 1]."""
    pipe = _get_xl_pipe()
    resized = _resize_video(_as_unit_float(video), pipe.preset.height, pipe.preset.width)
    out = pipe.video_to_video(prompt, resized, strength=strength,
                              num_inference_steps=num_inference_steps, seed=seed)
    return np.asarray(out[0])


def main(argv=None):
    maybe_force_platform()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run-dir", required=True,
                   help="generation run directory (contains {ind}/video_*.joblib)")
    p.add_argument("--method", choices=["zsxl", "sdxl", "zsxl+sdxl"], default="zsxl")
    p.add_argument("--strength", type=float, default=0.35)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--prompt-type", type=str, default="lvd")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-formats", nargs="+", default=["gif", "joblib"])
    args = p.parse_args(argv)

    from ..text.templates import canonical_prompt, get_prompts

    prompts = [canonical_prompt(pr) for pr in get_prompts(args.prompt_type)]

    videos = sorted(glob.glob(os.path.join(args.run_dir, "*", "video_*.joblib")))
    videos += sorted(glob.glob(os.path.join(args.run_dir, "*", "video_*.npz")))
    print(f"Found {len(videos)} videos under {args.run_dir}")

    for path in videos:
        ind = int(os.path.basename(os.path.dirname(path)))
        prompt = prompts[ind] if ind < len(prompts) else ""
        suffix = args.method.replace("+", "_")
        stem = path.rsplit(".", 1)[0] + f"_{suffix}"
        if os.path.exists(stem + ".gif"):
            print(f"Skipping existing {stem}.gif")
            continue
        out = vis.load_video(path)
        if "zsxl" in args.method:
            out = upsample_video_zsxl(out, prompt, strength=args.strength,
                                      num_inference_steps=args.num_inference_steps,
                                      seed=args.seed)
        if "sdxl" in args.method:
            out = upsample_video_sdxl(out, prompt, strength=min(args.strength, 0.35),
                                      num_inference_steps=args.num_inference_steps,
                                      seed=args.seed)
        vis.save_frames(stem, out, formats=args.save_formats)
        print(f"Upsampled {path} -> {stem}.*")


if __name__ == "__main__":
    main()
