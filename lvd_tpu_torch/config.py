"""Model and pipeline configurations (the port's own copy of lvd_tpu/config.py).

The port keeps its own copy so that it imports nothing of the JAX package.
Presets mirror the reference checkpoints (SURVEY.md §2.3, generation/lvd.py:19-37):
ModelScope `damo-vilab/text-to-video-ms-1.7b` and Zeroscope
`cerspense/zeroscope_v2_576w` share one UNet architecture; they differ in
weights and generation resolution.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    """ModelScope/Zeroscope 3D UNet (reference models/unet_3d_condition.py:228-257)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64  # heads per block = channels // head_dim
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_norm_eps: float = 1e-6
    # transformer_in stem: 8 heads x attention_head_dim (inner dim 512)
    transformer_in_num_heads: int = 8
    attention_type: str = "default"  # "gated" enables GLIGEN adapters
    gligen_positive_len: int = 1024
    gligen_fourier_freqs: int = 8
    max_text_len: int = 77

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def num_heads(self, channels: int) -> int:
        return channels // self.attention_head_dim

    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """OpenCLIP ViT-H text tower used by ModelScope/Zeroscope (hidden 1024)."""

    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    # "gelu" (quick-gelu not used by these checkpoints)
    hidden_act: str = "gelu"
    # ModelScope/Zeroscope condition on the final hidden state.
    projection_dim: int = 1024


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """SD AutoencoderKL (4-level, latent scale 0.18215)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @property
    def scale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """DDIM-style training schedule shared by ModelScope/Zeroscope; sampling
    uses DPM-Solver++ 2M on top (reference generation/lvd.py:46)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    steps_offset: int = 1


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    name: str
    unet: UNet3DConfig
    clip: CLIPTextConfig
    vae: VAEConfig
    scheduler: SchedulerConfig
    height: int
    width: int
    default_num_frames: int
    # Attention-map grid of the highest-resolution instrumented layer
    # (reference generation/lvd.py:21-35 `base_attn_dim`).
    base_attn_dim: Tuple[int, int]
    # Canvas the LLM lays boxes out on.
    box_h: int = 512
    box_w: int = 512
    checkpoint: Optional[str] = None


def _preset(name, h, w, frames, base_attn, attention_type="default", checkpoint=None):
    return ModelPreset(
        name=name,
        unet=UNet3DConfig(attention_type=attention_type),
        clip=CLIPTextConfig(),
        vae=VAEConfig(),
        scheduler=SchedulerConfig(),
        height=h,
        width=w,
        default_num_frames=frames,
        base_attn_dim=base_attn,
        checkpoint=checkpoint,
    )


PRESETS = {
    "modelscope512": _preset(
        "modelscope512", 512, 512, 16, (64, 64),
        checkpoint="damo-vilab/text-to-video-ms-1.7b",
    ),
    "modelscope256": _preset(
        "modelscope256", 256, 256, 16, (32, 32),
        checkpoint="damo-vilab/text-to-video-ms-1.7b",
    ),
    "zeroscope": _preset(
        "zeroscope", 320, 576, 24, (40, 72),
        checkpoint="cerspense/zeroscope_v2_576w",
    ),
    "lvd-gligen_modelscope256": _preset(
        "lvd-gligen_modelscope256", 256, 256, 16, (32, 32),
        attention_type="gated",
        checkpoint="longlian/text-to-video-lvd-ms",
    ),
    "lvd-gligen_zeroscope": _preset(
        "lvd-gligen_zeroscope", 320, 576, 24, (40, 72),
        attention_type="gated",
        checkpoint="longlian/text-to-video-lvd-zs",
    ),
    # High-res vid2vid refiner (scripts/upsample.py, generation/zeroscope_dpm.py:90-109)
    "zeroscope_xl": _preset(
        "zeroscope_xl", 576, 1024, 24, (72, 128),
        checkpoint="cerspense/zeroscope_v2_XL",
    ),
}


def tiny_unet_config(attention_type: str = "default") -> UNet3DConfig:
    """A miniature UNet with the full topology, for CPU tests and dry runs."""
    return UNet3DConfig(
        block_out_channels=(32, 64, 64, 64),
        cross_attention_dim=64,
        attention_head_dim=16,
        norm_num_groups=8,
        transformer_in_num_heads=2,
        attention_type=attention_type,
        gligen_positive_len=64,
    )


def dryrun_unet_config(attention_type: str = "default") -> UNet3DConfig:
    """Smallest config with the full mechanism set (down/mid/up, skip wiring,
    spatial+temporal transformers, temp convs) for the driver's multi-chip
    dry run — 2 blocks x 1 layer so cold XLA-CPU compiles stay within the
    driver budget (the 4-block tiny config timed it out in round 2)."""
    return UNet3DConfig(
        block_out_channels=(16, 32),
        layers_per_block=1,
        cross_attention_dim=32,
        attention_head_dim=8,
        norm_num_groups=4,
        transformer_in_num_heads=1,
        attention_type=attention_type,
        gligen_positive_len=32,
    )


def tiny_clip_config() -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=49408,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
    )


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8)
