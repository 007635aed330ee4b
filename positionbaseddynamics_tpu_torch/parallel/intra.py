"""One scene's particles split over a process group — the counterpart of
``positionbaseddynamics_tpu/parallel/intra.py``, for unstructured
particle constraint families.

* The **particle axis** is block-sharded: integration and the velocity
  update of a rank's particles need no communication.
* Each family's **constraint axis** is block-sharded for the projection:
  once a substep every rank gathers the full positions (one
  ``all_gather``); then, for every family pass, it solves its block of the
  family's constraints on them, scatters the corrections into a full-size
  buffer and the buffers are summed (one ``all_reduce``, the λ-reduction
  collective), so every rank holds the same updated positions. Each
  rank's λ stays with its block. The rank keeps its own slice at the end
  of the substep.

Structured grid cloths shard with O(halo) traffic in
``parallel/intra_grid.py``; this path moves O(N) a family pass.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..ops import integration
from ..solver.constraints import ConstraintSet, scatter_add
from ..solver.state import SimState
from ..solver.step import StepConfig

Tensor = torch.Tensor


def _pad_rows(a: Tensor, mult: int) -> Tensor:
    pad = (-a.shape[0]) % mult
    if pad == 0:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))], 0)


def _block_of(a: Tensor, rank: int, world: int) -> Tensor:
    """Rank ``rank``'s block of the leading axis, padded with zero rows to
    a multiple of ``world``."""
    a = _pad_rows(a, world)
    k = a.shape[0] // world
    return a[rank * k:(rank + 1) * k]


def _slice_batch(batch, rank: int, world: int):
    """The batch's constraint rows of this rank's block; padding rows are
    zeros (index 0, rest 0, stiffness 0: no correction)."""
    c = batch.n_rows
    return dataclasses.replace(batch, **{
        k: _block_of(getattr(batch, k), rank, world)
        for k in batch._tensor_fields()
        if getattr(batch, k).dim() and getattr(batch, k).shape[0] == c})


def _map_particles(state: SimState, fn) -> SimState:
    p = state.particles
    return dataclasses.replace(state, particles=dataclasses.replace(p, **{
        f.name: fn(getattr(p, f.name)) for f in dataclasses.fields(p)}))


def pad_state_for_mesh(state: SimState, group) -> SimState:
    """Pad the particle axis to a multiple of the group's size; padding
    particles are static (zero inverse mass)."""
    world = dist.get_world_size(group)
    return _map_particles(state, lambda a: _pad_rows(a, world))


def shard_particles(state: SimState, group) -> SimState:
    """This rank's block of a padded state's particles."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    return _map_particles(state,
                          lambda a: _block_of(a, rank, world).contiguous())


def gather_particles(state: SimState, group) -> SimState:
    """The readout: every rank's block of the particles, in rank order."""
    world = dist.get_world_size(group)

    def gather(a):
        parts = [torch.empty_like(a) for _ in range(world)]
        dist.all_gather(parts, a.contiguous(), group=group)
        return torch.cat(parts, 0)

    return _map_particles(state, gather)


def make_intra_sharded_step_fn(state: SimState, cset: ConstraintSet,
                               cfg: StepConfig, group, device=None):
    """``local state -> local state``: one sim step of this rank's block of
    the particles (:func:`pad_state_for_mesh`, then
    :func:`shard_particles`). Families other than the particle batches
    (grids, rods, joints, rigid bodies) raise, and every family needs its
    build-time Jacobi counts (``ConstraintSet.with_jacobi_counts``). Every
    rank builds it, on ``device`` (None means CUDA)."""
    if (cset.grid_cloths or cset.grid_tets or cset.joints or cset.has_rods
            or cset.direct_rods or cset.rigid_generics or cset.n_rigid):
        raise NotImplementedError(
            "this generic all_gather path supports unstructured particle "
            "constraint families only; structured grid cloths shard with "
            "O(halo) traffic via parallel.intra_grid.make_grid_intra_step_fn"
            " (build with use_structured_grid=False to force this path)")
    if any(name not in cset.jacobi_inv_counts
           for name, _ in cset.particle_batches()):
        raise ValueError("build the ConstraintSet with "
                         "with_jacobi_counts() before sharding")
    dev = resolve_device(device)
    if cset.device is not None and cset.device != dev:
        cset = cset.to(dev)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    n = state.particles.n
    n = n + (-n) % world                        # the padded particle count
    h = cfg.dt / cfg.substeps
    gravity = torch.tensor(cfg.gravity, dtype=torch.float32, device=dev)
    fams = []
    for name, batch in cset.particle_batches():
        inv_cnt = cset.jacobi_inv_counts[name]
        lam0 = batch.init_lambda()
        if lam0.numel():
            lam0 = _block_of(lam0, rank, world)
        fams.append((_slice_batch(batch, rank, world), lam0,
                     cfg.jacobi_omega * _pad_rows(inv_cnt, world)))

    def all_gather(a):
        parts = [torch.empty_like(a) for _ in range(world)]
        dist.all_gather(parts, a.contiguous(), group=group)
        return torch.cat(parts, 0)

    def fn(st: SimState) -> SimState:
        p = st.particles
        x, v, w = p.x, p.v, p.inv_mass
        n_loc = x.shape[0]
        w_full = all_gather(w)
        old = last = p.old_x
        for _ in range(cfg.substeps):
            last, old = old, x
            x, v = integration.semi_implicit_euler(h, w, x, v,
                                                   gravity.expand_as(x))
            x_full = all_gather(x)
            lams = [lam0 for _, lam0, _ in fams]
            for _ in range(cfg.max_iterations):
                for k, (blk, _, scale) in enumerate(fams):
                    corr, lams[k] = blk.solve(x_full, w_full, lams[k], h)
                    total = scatter_add(n, blk.idx, corr)
                    dist.all_reduce(total, group=group)
                    x_full = x_full + scale * total
            x = x_full[rank * n_loc:(rank + 1) * n_loc]
            v = integration.velocity_update_first_order(h, w, x, old, v)
            if cfg.damping:
                v = v * (1.0 - cfg.damping)
        particles = dataclasses.replace(p, x=x, v=v, old_x=old, last_x=last)
        return dataclasses.replace(st, particles=particles,
                                   time=st.time + cfg.dt)

    return fn
