"""DPM-Solver++ (2M) with host-side coefficients (counterpart of
lvd_tpu/diffusion/dpm_solver.py).

Per-step coefficients are computed once in numpy; one step is a function of
(state, coefficients of this step, x, eps) on tensors. Matches diffusers'
defaults: dpmsolver++, order 2, midpoint, epsilon prediction, lower order on
the final step below 15 steps.

VP parameterization: alpha_t = sqrt(abar_t), sigma_t = sqrt(1 - abar_t),
lambda_t = log(alpha_t / sigma_t); x0 = (x - sigma_t eps) / alpha_t;
  1st order: x_prev = (sig_p / sig_c) x - alpha_p (e^-h - 1) x0
  2nd order: x_prev = (sig_p / sig_c) x - alpha_p (e^-h - 1) (D0 + D1 / 2),
with h = lam_p - lam_c, r = h_prev / h, D0 = x0, D1 = (x0 - x0_prev) / r.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..config import SchedulerConfig
from . import schedule

INIT_NOISE_SIGMA = 1.0


class SolverCoeffs(NamedTuple):
    """Per-step coefficients, each a numpy array of shape (num_steps,)."""

    timestep: np.ndarray
    alpha_c: np.ndarray
    sigma_c: np.ndarray
    alpha_p: np.ndarray
    sigma_p: np.ndarray
    h: np.ndarray
    r: np.ndarray
    use_second_order: np.ndarray
    sqrt_one_minus_abar: np.ndarray  # sigma at the current t: the guidance step's scale

    def at(self, i: int) -> "SolverCoeffs":
        """The coefficients of step ``i`` as Python scalars."""
        return SolverCoeffs(*[a[i].item() for a in self])


def make_coeffs(cfg: SchedulerConfig, num_inference_steps: int = None,
                timesteps: np.ndarray = None, lower_order_final: bool = True) -> SolverCoeffs:
    if timesteps is None:
        timesteps = schedule.inference_timesteps(cfg, num_inference_steps)
    timesteps = np.asarray(timesteps, dtype=np.int64)
    n = len(timesteps)
    abar = schedule.make_alphas_cumprod(cfg)
    alpha = np.sqrt(abar)
    sigma = np.sqrt(1.0 - abar)
    lam = np.log(alpha) - np.log(sigma)
    t_prev = np.concatenate([timesteps[1:], [0]])  # final target: the t=0 grid point
    h = lam[t_prev] - lam[timesteps]
    h_prev = np.concatenate([[np.nan], h[:-1]])
    with np.errstate(invalid="ignore"):
        r = np.where(np.isnan(h_prev), 0.0, h_prev / h)
    use_second = np.ones(n, dtype=bool)
    use_second[0] = False
    if lower_order_final and n < 15:
        use_second[-1] = False
    f32 = lambda a: np.asarray(a, np.float32)
    return SolverCoeffs(
        timestep=timesteps,
        alpha_c=f32(alpha[timesteps]), sigma_c=f32(sigma[timesteps]),
        alpha_p=f32(alpha[t_prev]), sigma_p=f32(sigma[t_prev]),
        h=f32(h), r=f32(r), use_second_order=use_second,
        sqrt_one_minus_abar=f32(sigma[timesteps]),
    )


def step(prev_x0, c: SolverCoeffs, x, eps):
    """One step on fp32 tensors; ``c`` holds this step's scalars
    (``SolverCoeffs.at``) and ``prev_x0`` the previous data prediction (or
    None on the first step). Returns (x0, x_prev)."""
    x32, eps32 = x.float(), eps.float()
    x0 = (x32 - c.sigma_c * eps32) / c.alpha_c
    ratio = c.sigma_p / c.sigma_c
    phi = float(np.exp(-np.float32(c.h)) - np.float32(1.0))
    if c.use_second_order:
        d1 = (x0 - prev_x0.float()) / (c.r if c.r != 0 else 1.0)
        x_prev = ratio * x32 - c.alpha_p * phi * (x0 + 0.5 * d1)
    else:
        x_prev = ratio * x32 - c.alpha_p * phi * x0
    return x0.to(x.dtype), x_prev.to(x.dtype)
