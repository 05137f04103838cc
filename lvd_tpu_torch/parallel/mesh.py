"""The ("data", "model") mesh and its sharding rules (counterpart of
lvd_tpu/parallel/mesh.py), over torch.distributed.

* axis "data": shards the frames of a video while it is sampled
  (pipeline.TextToVideoPipeline(..., mesh=...)), and the batch of a
  training step (training/train.py);
* axis "model": the trainer's tensor parallelism. Each rank stores its
  block of every column- or row-sharded weight (``param_spec``) and that
  block's AdamW moments; a step gathers the full weights where the model
  uses them and sums their gradients back to the blocks.

The mesh is the default process group's ranks laid out row-major as
(n // model_parallel, model_parallel): rank ``r`` sits at data index
``r // model_parallel`` and model index ``r % model_parallel``. Its "data"
group holds the ranks of its column, its "model" group those of its row,
as comm.Groups of the default group's backend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.tree import flatten, unflatten_like
from . import comm


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: comm.Group
    model: comm.Group

    @property
    def shape(self):
        return (self.data.size, self.model.size)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """The mesh over the initialised default group (``n_devices``, if given,
    must be its size). Every rank must call it, in the same order as any
    other group it makes."""
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh: {n_devices} devices asked of a group of {n} ranks")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    rows = n // model_parallel
    rank = dist.get_rank()
    data = model = None
    for j in range(model_parallel):  # every rank makes every group, in one order
        pg = dist.new_group([i * model_parallel + j for i in range(rows)])
        if rank % model_parallel == j:
            data = comm.Group.of(pg, "data")
    for i in range(rows):
        pg = dist.new_group([i * model_parallel + j for j in range(model_parallel)])
        if rank // model_parallel == i:
            model = comm.Group.of(pg, "model")
    return Mesh(data, model)


# -- parameter partition rules (lvd_tpu/parallel/mesh.py:44-76) ---------------

_COLUMN_SHARDED = ("to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj", "fc1")
_ROW_SHARDED = ("to_out", "out_proj", "fc2")


def param_spec(path, leaf) -> tuple:
    """lvd_tpu's partition spec of the leaf at ``path`` (a '/'-joined path or
    a sequence of keys): (None, "model") column-sharded for to_q/k/v,
    q/k/v_proj, fc1 and an ff's proj; ("model", None) row-sharded for
    to_out, out_proj, fc2 and an ff's out; () replicated otherwise (convs,
    norms, embeddings, biases)."""
    names = [str(k) for k in (path.split("/") if isinstance(path, str) else path)]
    if leaf.ndim < 2:
        return ()
    parent = names[-2] if len(names) >= 2 else ""
    grandparent = names[-3] if len(names) >= 3 else ""
    if names[-1] == "w":
        if parent in _COLUMN_SHARDED:
            return (None, "model")
        if parent in _ROW_SHARDED:
            return ("model", None)
        if parent == "proj" and grandparent == "ff":
            return (None, "model")
        if parent == "out" and grandparent == "ff":
            return ("model", None)
    return ()


def _model_axis(path, t) -> Optional[int]:
    """The axis ``param_spec`` splits on "model", or None."""
    spec = param_spec(path, t)
    return spec.index("model") if "model" in spec else None


def make_param_shardings(mesh: Mesh, params):
    """The tree of ``param_spec``s (the mesh fixes nothing more here)."""
    return unflatten_like(params, {p: param_spec(p, t) for p, t in flatten(params).items()})


def block(x: torch.Tensor, group: comm.Group, axis: int) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``axis``; a size that the
    group does not divide raises, as shard_map would."""
    if x.shape[axis] % group.size:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not divide over the "
                         f"{group.size} ranks of {group.name!r}")
    n = x.shape[axis] // group.size
    return x.narrow(axis, group.rank * n, n)


def leaf_block(mesh: Mesh, path: str, t: torch.Tensor) -> torch.Tensor:
    """The leaf as this rank stores it: its "model" block where
    ``param_spec`` shards it over more than one rank (a copy, so the full
    leaf can be freed), the leaf itself otherwise."""
    axis = _model_axis(path, t)
    return t if axis is None or mesh.model.size == 1 else block(t, mesh.model, axis).clone()


def full_leaf(mesh: Mesh, path: str, t: torch.Tensor, differentiable: bool = False):
    """The whole leaf from this rank's block: comm.all_gather, whose VJP sums
    the gradient back into the blocks, with ``differentiable``, else
    comm.gather; the leaf itself where replicated or where "model" has one
    rank."""
    axis = _model_axis(path, t)
    if axis is None or mesh.model.size == 1:
        return t
    return (comm.all_gather if differentiable else comm.gather)(t, mesh.model, axis)


def shard_params(mesh: Mesh, params):
    """Each leaf as this rank stores it (``leaf_block``)."""
    return unflatten_like(params, {p: leaf_block(mesh, p, t) for p, t in flatten(params).items()})


def data_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> tuple:
    spec = [None] * ndim
    spec[axis] = "data"
    return tuple(spec)


def replicated(mesh: Mesh) -> tuple:
    return ()
