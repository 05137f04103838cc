"""Collectives over one axis of a mesh, in ``jax.lax``'s terms, on
torch.distributed.

lvd_tpu shards frames with ``shard_map`` and writes its collectives as
``jax.lax.psum``, ``all_to_all(..., tiled=True)``, ``ppermute``,
``axis_index`` and ``axis_size`` over a named mesh axis; its trainer lets
GSPMD gather the model-sharded weights. Here a :class:`Group` stands for
the axis: a torch.distributed process group with this rank's index in it,
its size and its backend. Each collective is a ``torch.autograd.Function``
with the VJP that ``jax.lax`` gives it:

* ``psum``: the all_reduce sum. Its backward is an all_reduce too: the sum
  feeds every rank, so each rank's input receives the cotangents of every
  rank's copy. The rule that goes with it: a scalar that a psum made
  replicated (the guided energy, a loss that every rank of an axis
  computes alike) is counted once, by seeding its backward with
  ``1 / size`` on every rank (``replicated_seed``). Seeding 1 would make
  every gradient behind the psum ``size`` times too large; the GroupNorm
  statistics' psums, whose cotangents differ from rank to rank, need the
  all_reduce. jax's ``shard_map`` with ``check_vma`` gets the same result
  by transposing psum to a broadcast and the implicit broadcast of an
  invariant value to a psum.
* ``all_to_all(x, split_axis, concat_axis)``: the tiled all_to_all; block
  ``j`` of the split axis goes to rank ``j``, and the blocks received are
  concatenated along the concat axis in rank order. Its VJP is the inverse
  all_to_all.
* ``ppermute(x, pairs)``: rank ``dst`` receives ``src``'s ``x`` for each
  ``(src, dst)``; a rank that no pair sends to gets zeros. Its VJP is the
  reverse permutation.
* ``all_gather(x, axis)``: the tiled gather of the trainer's model-sharded
  weights. Its VJP sums the cotangent over the group (an all_reduce) and
  keeps this rank's block: the gradient lvd_tpu's reduce-scatter gives, at
  twice its traffic.

Backends: ``nccl`` (one rank per card, the deployment) hands CUDA tensors
to NCCL; ``gloo`` (the CPU tests, and ranks that share one card, which NCCL
refuses) takes host tensors, so CUDA tensors are copied through the host
explicitly for every gloo collective; half types travel as bytes, and
are summed in fp32.
The path is chosen by the backend, never by catching an error.

Census: every call adds its kind, by lvd_tpu's names (``all_reduce``,
``all_to_all``, ``collective_permute``), and the bytes of its per-rank
result to a running count (``reset_census``, ``read_census``), backward
calls included. A ``Group.recording`` group communicates nothing: it
returns empty results of the right shape (on ``meta`` tensors in
parallel/audit.py) and only counts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

_CENSUS: Dict[str, list] = {}


def reset_census() -> None:
    _CENSUS.clear()


def read_census() -> Dict[str, dict]:
    """{kind: {count, resident_bytes}} of the calls since ``reset_census``."""
    return {k: {"count": c, "resident_bytes": b} for k, (c, b) in sorted(_CENSUS.items())}


def _record(kind: str, result: torch.Tensor) -> None:
    row = _CENSUS.setdefault(kind, [0, 0])
    row[0] += 1
    row[1] += result.numel() * result.element_size()


@dataclasses.dataclass(frozen=True)
class Group:
    """One mesh axis: ``rank`` of ``size`` in process group ``pg`` over
    ``backend`` ("nccl", "gloo", or "record" for the census's stand-in)."""

    name: str
    rank: int
    size: int
    backend: str
    pg: object = None

    @classmethod
    def of(cls, pg, name: str) -> "Group":
        return cls(name, dist.get_rank(pg), dist.get_world_size(pg), str(dist.get_backend(pg)),
                   pg)

    @classmethod
    def recording(cls, name: str, size: int, rank: int = 0) -> "Group":
        return cls(name, rank, size, "record")


def axis_index(group: Group) -> int:
    return group.rank


def axis_size(group: Group) -> int:
    return group.size


def replicated_seed(value: torch.Tensor, group: Group) -> torch.Tensor:
    """The backward seed of a scalar replicated over ``group`` by a psum."""
    return torch.full_like(value, 1.0 / group.size)


# -- the collectives, without autograd ----------------------------------------

def _to_wire(x: torch.Tensor, group: Group, bits: bool) -> torch.Tensor:
    """A contiguous tensor the backend takes: on the host for gloo, half
    types as their bytes where only bytes move (``bits``), else summed in
    fp32."""
    if group.backend == "gloo":
        x = x.cpu().contiguous()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.view(torch.uint8) if bits else x.float()
    return x.contiguous()


def _from_wire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if y.dtype == torch.uint8 != like.dtype:
        y = y.view(like.dtype)
    return y.to(like.device, like.dtype)


def all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the group, as a new tensor (no autograd)."""
    if group.backend == "record":
        out = torch.empty_like(x)
    else:
        out = _to_wire(x, group, bits=False).clone()
        dist.all_reduce(out, group=group.pg)
        out = _from_wire(out, x)
    _record("all_reduce", out)
    return out


def _all_to_all(x: torch.Tensor, group: Group, split_axis: int, concat_axis: int):
    n = group.size
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} does not split "
                         f"into {n}")
    blocks = x.chunk(n, dim=split_axis)
    if group.backend == "record":
        got = list(blocks)
    else:
        wire = _to_wire(torch.stack(blocks), group, bits=True)
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=group.pg)
        got = list(_from_wire(out, x).unbind(0))
    out = torch.cat(got, dim=concat_axis)
    _record("all_to_all", out)
    return out


def _ppermute(x: torch.Tensor, group: Group, pairs: Sequence[Tuple[int, int]]):
    """One uneven all_to_all: this rank sends its whole ``x`` to its
    destination and receives from its source, nothing else."""
    dst = {s: d for s, d in pairs}.get(group.rank)
    src = {d: s for s, d in pairs}.get(group.rank)
    if group.backend == "record":
        out = torch.empty_like(x)
    elif not pairs:  # every rank of the group sees the same pairs: none sends
        out = torch.zeros_like(x)
    else:
        shaped = _to_wire(x, group, bits=True)
        wire = shaped.reshape(-1)
        recv = wire.new_empty(wire.numel() if src is not None else 0)
        sizes = lambda peer: [wire.numel() if r == peer else 0 for r in range(group.size)]
        dist.all_to_all_single(recv, wire if dst is not None else wire[:0],
                               output_split_sizes=sizes(src), input_split_sizes=sizes(dst),
                               group=group.pg)
        out = (_from_wire(recv.view(shaped.shape), x) if src is not None
               else torch.zeros_like(x))
    _record("collective_permute", out)
    return out


def _all_gather(x: torch.Tensor, group: Group, axis: int):
    if group.backend == "record":
        out = torch.cat([x] * group.size, dim=axis)
    else:
        wire = _to_wire(x, group, bits=True)
        parts = [torch.empty_like(wire) for _ in range(group.size)]
        dist.all_gather(parts, wire, group=group.pg)
        out = _from_wire(torch.cat(parts, dim=axis), x)
    _record("all_gather", out)
    return out


def gather(x: torch.Tensor, group: Group, axis: int) -> torch.Tensor:
    """The tiled all_gather without autograd (a checkpoint's full leaves)."""
    return _all_gather(x, group, axis)


# -- the collectives, with jax.lax's VJPs -------------------------------------


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(g, group, concat_axis, split_axis), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs):
        ctx.args = (group, pairs)
        return _ppermute(x, group, pairs)

    @staticmethod
    def backward(ctx, g):
        group, pairs = ctx.args
        return _ppermute(g, group, [(d, s) for s, d in pairs]), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (group, axis, x.shape[axis])
        return _all_gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        group, axis, n = ctx.args
        return all_reduce(g, group).narrow(axis, group.rank * n, n), None, None


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    return _Psum.apply(x, group)


def all_to_all(x: torch.Tensor, group: Group, split_axis: int, concat_axis: int) -> torch.Tensor:
    return _AllToAll.apply(x, group, split_axis % x.ndim, concat_axis % x.ndim)


def ppermute(x: torch.Tensor, group: Group, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    return _Ppermute.apply(x, group, tuple(tuple(p) for p in pairs))


def all_gather(x: torch.Tensor, group: Group, axis: int) -> torch.Tensor:
    return _AllGather.apply(x, group, axis % x.ndim)
