"""Diffusion training step (counterpart of lvd_tpu/training/train.py).

Epsilon-prediction MSE over the DDPM forward process and AdamW with optax's
semantics, for full finetuning or GLIGEN-adapter-only training (everything
frozen but the ``fuser`` and ``position_net`` leaves, the way lvd-gligen
checkpoints are made). The timesteps and the noise are lvd_tpu's draws from
the same key (utils/prng.py), and the UNet runs with lvd_tpu's remat rule,
so a step from the same params, batch and key is lvd_tpu's step. The batch
is taken one sample at a time (each sample's loss gradient, summed): a
sample's gradient then does not depend on the batch around it, so a
data-parallel mesh gives the one-device step's bits. On the
card the forward launches the kernels, the input gradients take kernels
E-G where lvd_tpu routes them, and the weight gradients of the temporal
pair and the GEGLU come from their stock recompute VJPs, as lvd_tpu's
custom VJPs give them.

Over lvd_tpu's ("data", "model") mesh (parallel/mesh.py:
``Trainer.init(params, mesh)``, ``make_step(mesh)``, ``shard_batch``) each
rank holds its rows of the batch (axis 0 split on "data") and its "model"
block of every column- or row-sharded leaf (``param_spec``) with that
block's AdamW moments, which is the memory the "model" axis saves. A step
gathers the full leaves over "model" (comm.all_gather, whose VJP sums each
gradient back into the blocks), so every head count and the GEGLU's
[h | g] projection meet lvd_tpu's whole weights; draws t and eps for the
global batch from the key, as lvd_tpu does, and keeps its rows; and seeds
each sample's backward with 1 / (ranks * rows) (parallel/comm.py's rule
for a replicated value): a replicated leaf's gradient is then summed over
every rank and a sharded block's over "data", which gives the gradient of
the global mean loss, and each block takes the single-device update.
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
from ..parallel import comm
from ..parallel import mesh as mesh_mod
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


def diffusion_loss(params, cfg: UNet3DConfig, sqrt_abar, sqrt_1m_abar, batch, key, rows=None):
    """The standard epsilon-prediction loss, lvd_tpu's draws from ``key``.

    batch: {"latents": (B, F, h, w, C) clean latents, "text": (B, L, D)
    encoder states, optional "gligen": grounding inputs}; ``sqrt_abar`` and
    ``sqrt_1m_abar`` are fp32 tensors of the schedule on the latents'
    device. ``rows`` (start, total): the batch is rows start.. of a global
    batch of ``total``, whose draws are made and these rows kept."""
    lat = batch["latents"]
    b = lat.shape[0]
    start, total = rows or (0, b)
    t_key, n_key = prng.split(key)
    t = prng.randint(t_key, (total,), 0, sqrt_abar.shape[0], lat.device)[start:start + b]
    eps = prng.normal_key(n_key, (total,) + tuple(lat.shape[1:]), lat.device,
                          lat.dtype)[start:start + b]
    a = sqrt_abar[t][:, None, None, None, None].to(lat.dtype)
    s = sqrt_1m_abar[t][:, None, None, None, None].to(lat.dtype)
    noisy = a * lat + s * eps
    pred = apply_unet3d(params, cfg, noisy, t, batch["text"], gligen=batch.get("gligen"),
                        remat=True)
    return torch.mean((pred.float() - eps.float()) ** 2)


def _sample(batch, i, b):
    """Sample ``i`` of ``b``: the i-th of b equal blocks of axis 0 of every
    tensor of the batch, as ``shard_batch`` cuts them over b ranks (the
    grounding inputs hold a sample's frames in their rows)."""
    if isinstance(batch, dict):
        return {k: _sample(v, i, b) for k, v in batch.items()}
    n = batch.shape[0] // b
    return batch.narrow(0, i * n, n)


def _psum_leaves(grads: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each tensor summed over ``group``, in one all_reduce of them all."""
    if group.size == 1 or not grads:
        return grads
    flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads.values()]), group)
    out, i = {}, 0
    for path, g in grads.items():
        out[path] = flat[i:i + g.numel()].view_as(g)
        i += g.numel()
    return out


@dataclasses.dataclass
class Trainer:
    """lvd_tpu's Trainer: ``init(params[, mesh])`` then ``make_step([mesh])``
    gives ``step(state, batch, key) -> (state, loss)``; under a mesh every
    rank calls both with its ``shard_batch`` rows."""

    unet_cfg: UNet3DConfig
    sched_cfg: SchedulerConfig = SchedulerConfig()
    learning_rate: float = 1e-4
    adapter_only: bool = False

    def init(self, params, mesh=None) -> TrainState:
        """Under ``mesh`` the state holds this rank's blocks of the sharded
        leaves (mesh.shard_params) and their moments."""
        self.tx = make_optimizer(self.learning_rate, adapter_only=self.adapter_only,
                                 params=params)
        if mesh is not None:
            params = mesh_mod.shard_params(mesh, params)
        return TrainState(params=params, opt_state=self.tx.init(params), step=0)

    def make_step(self, mesh=None):
        """The step updates the state's params and moments in place, as
        lvd_tpu donates the state to its jitted step; under ``mesh`` the
        returned loss is the global batch's."""
        abar = schedule.make_alphas_cumprod(self.sched_cfg)
        tables = {}

        def step_fn(state: TrainState, batch, key):
            flat = flatten(state.params)
            device = next(iter(flat.values())).device
            if device not in tables:
                tables[device] = tuple(torch.tensor(np.asarray(v, np.float32), device=device)
                                       for v in (abar ** 0.5, (1.0 - abar) ** 0.5))
            leaves = {p: t.detach().requires_grad_(self.tx.trains(p)) for p, t in flat.items()}
            trained = [p for p in leaves if self.tx.trains(p)]
            full = leaves if mesh is None else {
                p: mesh_mod.full_leaf(mesh, p, t, differentiable=True) for p, t in leaves.items()}
            params = unflatten_like(state.params, full)
            b = batch["latents"].shape[0]
            data = (0, 1) if mesh is None else (mesh.data.rank, mesh.data.size)
            ranks = 1 if mesh is None else mesh.data.size * mesh.model.size
            # One sample at a time, as a rank of a data-parallel mesh holding
            # one row takes it: a sample's gradient is then the same bits
            # whatever batch it came in, and the mesh's sum over ranks is the
            # one-device sum over samples (ROADMAP C9).
            loss, grads = 0.0, {}
            for i in range(b):
                one = diffusion_loss(params, self.unet_cfg, *tables[device], _sample(batch, i, b),
                                     key, rows=(data[0] * b + i, data[1] * b))
                seed = torch.full_like(one, 1.0 / (ranks * b))
                got = torch.autograd.grad(one, [full[p] for p in trained], grad_outputs=seed)
                for p, g in zip(trained, got):
                    grads[p] = g if i == 0 else grads[p] + g
                loss = loss + one.detach() / b
            if mesh is not None:
                gathered = [p for p in trained if full[p] is not leaves[p]]
                if gathered:  # back through the gathers: each block's sum over "model"
                    grads.update(zip(gathered, torch.autograd.grad(
                        [full[p] for p in gathered], [leaves[p] for p in gathered],
                        grad_outputs=[grads[p] for p in gathered])))
                replicated = {p: g for p, g in grads.items() if full[p] is leaves[p]}
                grads.update(_psum_leaves(replicated, mesh.model))
                grads = _psum_leaves(grads, mesh.data)
                loss = comm.all_reduce(loss, mesh.data) / mesh.data.size
            opt_state = self.tx.update(grads, state.opt_state, flat)
            return (TrainState(unflatten_like(state.params, flat), opt_state, state.step + 1),
                    loss.detach())

        return step_fn


def _map_state(params: Dict[str, torch.Tensor], opt_state: dict, fn):
    """fn(path, tensor) over the flat params and the moments."""
    return ({p: fn(p, t) for p, t in params.items()},
            {"count": opt_state["count"],
             **{m: {p: fn(p, t) for p, t in opt_state[m].items()} for m in ("mu", "nu")}})


def save_train_state(path: str, state: TrainState, mesh=None) -> None:
    """Params (flat), the moments and the step, with ``torch.save`` into
    ``path/train_state.pt`` (the port's own format; lvd_tpu writes flax
    msgpack). Under ``mesh`` every rank calls it: the blocks are gathered
    into the full leaves, as ``jax.device_get`` gives them, and the first
    rank writes the file, which a single device restores as well."""
    params, opt_state = flatten(state.params), state.opt_state
    if mesh is not None:
        params, opt_state = _map_state(params, opt_state,
                                       lambda p, t: mesh_mod.full_leaf(mesh, p, t))
    if mesh is None or mesh.data.rank == mesh.model.rank == 0:
        os.makedirs(path, exist_ok=True)
        torch.save({"params": params, "opt_state": opt_state, "step": state.step},
                   os.path.join(path, "train_state.pt"))
    if mesh is not None:
        torch.distributed.barrier()


def restore_train_state(path: str, template: TrainState, mesh=None) -> TrainState:
    """A TrainState saved by ``save_train_state``, on the template's device;
    ``template`` gives the param tree's structure (a fresh
    ``Trainer.init``, under ``mesh`` the mesh's), and under ``mesh`` each
    full leaf is cut to this rank's block."""
    flat = flatten(template.params)
    device = next(iter(flat.values())).device
    saved = torch.load(os.path.join(path, "train_state.pt"), map_location=device)
    if set(saved["params"]) != set(flat):
        raise ValueError("restore_train_state: the saved params do not match the template")
    params, opt_state = saved["params"], saved["opt_state"]
    if mesh is not None:
        params, opt_state = _map_state(params, opt_state,
                                       lambda p, t: mesh_mod.leaf_block(mesh, p, t))
    return TrainState(unflatten_like(template.params, params), opt_state, saved["step"])


def shard_batch(mesh, batch):
    """This rank's rows of every tensor of the batch: axis 0 split on
    "data" (lvd_tpu's P("data"))."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    return mesh_mod.block(torch.as_tensor(batch), mesh.data, 0)
