"""Noise schedules and timestep utilities, on the host in numpy (the port's
own copy of lvd_tpu/diffusion/schedule.py).

Parity target: the diffusers DDIM config shared by ModelScope/Zeroscope
(beta 0.00085..0.012 scaled_linear, 1000 train steps).
"""

from __future__ import annotations

import numpy as np

from ..config import SchedulerConfig


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        return (
            np.linspace(
                cfg.beta_start ** 0.5,
                cfg.beta_end ** 0.5,
                cfg.num_train_timesteps,
                dtype=np.float64,
            )
            ** 2
        )
    if cfg.beta_schedule == "linear":
        return np.linspace(
            cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps, dtype=np.float64
        )
    raise ValueError(f"Unknown beta schedule: {cfg.beta_schedule}")


def make_alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    return np.cumprod(1.0 - make_betas(cfg), axis=0)


def inference_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending integer timesteps, diffusers "linspace" spacing."""
    return (
        np.linspace(0, cfg.num_train_timesteps - 1, num_inference_steps + 1)
        .round()[::-1][:-1]
        .astype(np.int64)
    )


def get_fast_schedule(timesteps: np.ndarray, fast_after_steps: int, fast_rate: int):
    """Truncated 'fast tail' schedule (reference utils/schedule.py:5-15):
    keep the first ``fast_after_steps`` steps, then subsample the tail."""
    timesteps = np.asarray(timesteps)
    if fast_after_steps >= len(timesteps) - 1:
        return timesteps
    return np.concatenate(
        [timesteps[:fast_after_steps], timesteps[fast_after_steps + 1 :: fast_rate]]
    )
