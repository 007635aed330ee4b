"""Rollout-batch sharding over a ``torch.distributed`` process group — the
counterpart of ``positionbaseddynamics_tpu/parallel/sharding.py``.

The reference's only parallelism is single-process OpenMP
(``TimeStepController.cpp:95``, ``SimulationModel.cpp:1033``). Across
cards, the port shards the rollouts (data parallel): every rank holds a
block of the ``(B, ...)`` rollout axis of a batched state and steps it
through the port's batched ``step``, with no collective in the hot loop;
the readout gathers the blocks (:func:`gather_batch`). A JAX device mesh
becomes a process group: :func:`make_group` for one axis,
:func:`make_mesh_groups` for the 2-D (rollouts × grid rows) mesh of
``parallel/intra_grid.py``.

The caller starts the processes and calls
``torch.distributed.init_process_group`` with its store or address, world
size and rank; nothing here reads a cluster's environment. NCCL needs one
card a rank (it refuses two ranks on one device); gloo moves CPU tensors
only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..mpc.planners import _expand_state
from ..solver.constraints import ConstraintSet
from ..solver.state import SimState
from ..solver.step import StepConfig, make_step_fn

Tensor = torch.Tensor


def _backend(device, backend: Optional[str]) -> str:
    if backend is not None:
        return backend
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def make_group(device=None, backend: Optional[str] = None,
               ranks: Optional[Sequence[int]] = None):
    """A process group over ``ranks`` (all when None), the counterpart of
    ``make_mesh``: NCCL for a CUDA ``device`` (None means CUDA), gloo for
    the CPU, unless ``backend`` names one. Every rank calls it, after
    ``torch.distributed.init_process_group``."""
    if not dist.is_initialized():
        raise RuntimeError("call torch.distributed.init_process_group "
                           "(its store or address, world size and rank) "
                           "before make_group")
    return dist.new_group(ranks=None if ranks is None else list(ranks),
                          backend=_backend(device, backend))


def make_mesh_groups(dp: int, device=None, backend: Optional[str] = None):
    """The 2-D mesh ``(dp, world // dp)`` as ``(dp_group, scene_group)``
    of this rank: rank ``d·S + s`` sits at rollout block ``d`` and row
    block ``s``; its scene group holds the ranks of its rollout block, its
    dp group those of its row block. Every rank calls it."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % dp:
        raise ValueError(f"world size {world} does not divide into {dp} "
                         "rollout blocks")
    scene = world // dp
    backend = _backend(device, backend)
    mine = {}
    for d in range(dp):                     # every rank creates every group
        ranks = [d * scene + s for s in range(scene)]
        g = dist.new_group(ranks=ranks, backend=backend)
        if rank in ranks:
            mine["scene"] = g
    for s in range(scene):
        ranks = [d * scene + s for d in range(dp)]
        g = dist.new_group(ranks=ranks, backend=backend)
        if rank in ranks:
            mine["dp"] = g
    return mine["dp"], mine["scene"]


def replicate_scene(state: SimState, batch: int) -> SimState:
    """A single-scene state as ``batch`` identical rollouts: the fields
    that differ between rollouts get a real ``(batch, ...)`` axis, the
    inverse masses, rest shapes and inertias stay shared (the port's
    batched-state layout, ``mpc.planners``)."""
    return _expand_state(state, batch)


def _map_rollout(state, fn: Callable[[Tensor], Tensor]):
    """``state`` with ``fn`` applied to every field that carries a leading
    rollout axis (more dimensions than one scene's: 1 for inverse masses,
    2 for the others, 0 for the time and the overflow counter); a tensor
    is mapped as it is."""
    if isinstance(state, Tensor):
        return fn(state)

    def part(p):
        if p is None:
            return None
        out = {}
        for f in dataclasses.fields(p):
            a = getattr(p, f.name)
            base = 1 if f.name == "inv_mass" else 2
            out[f.name] = fn(a) if a.dim() > base else a
        return dataclasses.replace(p, **out)

    top = {k: (fn(a) if a is not None and a.dim() > 0 else a)
           for k, a in (("time", state.time), ("overflow", state.overflow))}
    return dataclasses.replace(
        state, particles=part(state.particles),
        orientations=part(state.orientations), rigid=part(state.rigid),
        **top)


def _block(n: int, group) -> slice:
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % world:
        raise ValueError(f"{n} rows do not divide among {world} ranks")
    k = n // world
    return slice(rank * k, (rank + 1) * k)


def shard_batch(state, group):
    """This rank's block of the rollout axis of a batched state (or of a
    tensor's leading axis), the counterpart of ``shard_batch``: the
    rollouts divide evenly among the group's ranks."""
    return _map_rollout(state, lambda a: a[_block(a.shape[0], group)]
                        .contiguous())


def gather_batch(state, group):
    """The readout: every rank's block of the rollout axis, concatenated
    in rank order (one ``all_gather`` a field)."""
    world = dist.get_world_size(group)

    def gather(a):
        a = a.contiguous()
        parts = [torch.empty_like(a) for _ in range(world)]
        dist.all_gather(parts, a, group=group)
        return torch.cat(parts, 0)

    return _map_rollout(state, gather)


def make_sharded_step_fn(cset: ConstraintSet, cfg: StepConfig, group,
                         pipeline=None, device=None):
    """``local state -> local state``: one step of this rank's block of
    the rollouts (:func:`shard_batch`) through the port's batched
    ``make_step_fn`` route, with the collision ``pipeline`` when given. No
    collective runs in a step; :func:`gather_batch` reads the rollouts
    out. ``fn.path`` is the route, ``fn.group`` the group."""
    fn = make_step_fn(cset, cfg, device, pipeline=pipeline)
    fn.group = group
    return fn
