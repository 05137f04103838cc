"""Diffusion training step (counterpart of lvd_tpu/training/train.py, one
device).

Epsilon-prediction MSE over the DDPM forward process and AdamW with optax's
semantics, for full finetuning or GLIGEN-adapter-only training (everything
frozen but the ``fuser`` and ``position_net`` leaves, the way lvd-gligen
checkpoints are made). The timesteps and the noise are lvd_tpu's draws from
the same key (utils/prng.py), and the UNet runs with lvd_tpu's remat rule,
so a step from the same params, batch and key is lvd_tpu's step. On the
card the forward launches the kernels, the input gradients take kernels
E-G where lvd_tpu routes them, and the weight gradients of the temporal
pair and the GEGLU come from their stock recompute VJPs, as lvd_tpu's
custom VJPs give them. The ("data", "model") mesh of lvd_tpu's trainer
(``Trainer.init(..., mesh)``, ``shard_batch``) comes with the frame-sharded
slice (ROADMAP A5).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import SchedulerConfig, UNet3DConfig
from ..diffusion import schedule
from ..models.unet3d import apply_unet3d
from ..utils import prng
from ..utils.tree import flatten, unflatten_like

ADAPTER_KEYS = ("fuser", "position_net")


class TrainState(NamedTuple):
    params: dict
    # {"count": int, "mu": {path: tensor}, "nu": {path: tensor}}: AdamW's
    # moments of the trained leaves only (frozen ones hold none).
    opt_state: dict
    step: int


def _adapter_only_mask(params) -> Dict[str, float]:
    """1.0 for the GLIGEN adapter leaves (a path through ``fuser`` or
    ``position_net``), else 0.0."""
    return {path: float(any(k in path.split("/") for k in ADAPTER_KEYS))
            for path in flatten(params)}


@dataclasses.dataclass
class AdamW:
    """optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    eps_root 0, bias correction, ``wd * p`` added before the ``-lr``
    scale), over the leaves that ``trainable`` names; under adapter-only
    training the others are optax's ``set_to_zero``: no moments, never
    touched."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    trainable: Optional[frozenset] = None  # None: every leaf

    def trains(self, path: str) -> bool:
        return self.trainable is None or path in self.trainable

    def init(self, params) -> dict:
        flat = {p: t for p, t in flatten(params).items() if self.trains(p)}
        return {"count": 0, "mu": {p: torch.zeros_like(t) for p, t in flat.items()},
                "nu": {p: torch.zeros_like(t) for p, t in flat.items()}}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], opt_state: dict,
               params: Dict[str, torch.Tensor]) -> dict:
        """Applies one step to the flat ``params`` and the moments, in place,
        and returns the new optimizer state."""
        count = opt_state["count"] + 1
        # optax: 1 - decay ** count in float32, the moments divided by it
        bc1 = float(1 - np.float32(self.b1) ** np.int32(count))
        bc2 = float(1 - np.float32(self.b2) ** np.int32(count))
        for path, g in grads.items():
            m, v = opt_state["mu"][path], opt_state["nu"][path]
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            params[path].add_(-self.learning_rate * (u + self.weight_decay * params[path]))
        return {"count": count, "mu": opt_state["mu"], "nu": opt_state["nu"]}


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 1e-2,
                   adapter_only: bool = False, params=None) -> AdamW:
    if not adapter_only:
        return AdamW(learning_rate, weight_decay)
    if params is None:
        raise ValueError("adapter_only needs params to build the mask")
    mask = _adapter_only_mask(params)
    return AdamW(learning_rate, weight_decay,
                 trainable=frozenset(p for p, m in mask.items() if m > 0.5))


def diffusion_loss(params, cfg: UNet3DConfig, sqrt_abar, sqrt_1m_abar, batch, key):
    """The standard epsilon-prediction loss, lvd_tpu's draws from ``key``.

    batch: {"latents": (B, F, h, w, C) clean latents, "text": (B, L, D)
    encoder states, optional "gligen": grounding inputs}; ``sqrt_abar`` and
    ``sqrt_1m_abar`` are fp32 tensors of the schedule on the latents'
    device."""
    lat = batch["latents"]
    t_key, n_key = prng.split(key)
    t = prng.randint(t_key, (lat.shape[0],), 0, sqrt_abar.shape[0], lat.device)
    eps = prng.normal_key(n_key, tuple(lat.shape), lat.device, lat.dtype)
    a = sqrt_abar[t][:, None, None, None, None].to(lat.dtype)
    s = sqrt_1m_abar[t][:, None, None, None, None].to(lat.dtype)
    noisy = a * lat + s * eps
    pred = apply_unet3d(params, cfg, noisy, t, batch["text"], gligen=batch.get("gligen"),
                        remat=True)
    return torch.mean((pred.float() - eps.float()) ** 2)


@dataclasses.dataclass
class Trainer:
    """lvd_tpu's Trainer on one device: ``init(params)`` then ``make_step()``
    gives ``step(state, batch, key) -> (state, loss)``."""

    unet_cfg: UNet3DConfig
    sched_cfg: SchedulerConfig = SchedulerConfig()
    learning_rate: float = 1e-4
    adapter_only: bool = False

    def init(self, params, mesh=None) -> TrainState:
        if mesh is not None:
            raise NotImplementedError(
                "Trainer.init(..., mesh): the sharded trainer comes with the frame-sharded "
                "slice (ROADMAP A5)")
        self.tx = make_optimizer(self.learning_rate, adapter_only=self.adapter_only,
                                 params=params)
        return TrainState(params=params, opt_state=self.tx.init(params), step=0)

    def make_step(self, mesh=None):
        """The step updates the state's params and moments in place, as
        lvd_tpu donates the state to its jitted step."""
        if mesh is not None:
            raise NotImplementedError(
                "Trainer.make_step(mesh=...): the sharded trainer comes with the frame-sharded "
                "slice (ROADMAP A5)")
        abar = schedule.make_alphas_cumprod(self.sched_cfg)
        tables = {}

        def step_fn(state: TrainState, batch, key):
            flat = flatten(state.params)
            device = next(iter(flat.values())).device
            if device not in tables:
                tables[device] = tuple(torch.tensor(np.asarray(v, np.float32), device=device)
                                       for v in (abar ** 0.5, (1.0 - abar) ** 0.5))
            leaves = {p: t.detach().requires_grad_(self.tx.trains(p)) for p, t in flat.items()}
            loss = diffusion_loss(unflatten_like(state.params, leaves), self.unet_cfg,
                                  *tables[device], batch, key)
            trained = [p for p in leaves if self.tx.trains(p)]
            grads = dict(zip(trained, torch.autograd.grad(loss, [leaves[p] for p in trained])))
            opt_state = self.tx.update(grads, state.opt_state, flat)
            return (TrainState(unflatten_like(state.params, flat), opt_state, state.step + 1),
                    loss.detach())

        return step_fn


def save_train_state(path: str, state: TrainState) -> None:
    """Params (flat), the moments and the step, with ``torch.save`` into
    ``path/train_state.pt`` (the port's own format; lvd_tpu writes flax
    msgpack)."""
    os.makedirs(path, exist_ok=True)
    torch.save({"params": flatten(state.params), "opt_state": state.opt_state,
                "step": state.step}, os.path.join(path, "train_state.pt"))


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """A TrainState saved by ``save_train_state``, on the template's device;
    ``template`` gives the param tree's structure (a fresh
    ``Trainer.init``)."""
    flat = flatten(template.params)
    device = next(iter(flat.values())).device
    saved = torch.load(os.path.join(path, "train_state.pt"), map_location=device)
    if set(saved["params"]) != set(flat):
        raise ValueError("restore_train_state: the saved params do not match the template")
    return TrainState(unflatten_like(template.params, saved["params"]), saved["opt_state"],
                      saved["step"])
