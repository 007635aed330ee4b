"""One structured-grid cloth split over a process group by row blocks,
with a one-row halo exchange — the counterpart of
``positionbaseddynamics_tpu/parallel/intra_grid.py``.

Rank ``r`` of the group owns grid rows ``[r·R, (r+1)·R)``. Integration and
the velocity update are local. A family pass reaches one row up and one
down, so before each distance and each bending pass a rank receives its
neighbours' boundary row of positions (:func:`halo_exchange`, one row each
way by ``batch_isend_irecv``, zeros at the cloth's top and bottom), and
after the pass it sends the corrections its halo rows collected back to
their owners (:func:`halo_reduce`). Each rank solves only the anchors of
the rows it owns, so every constraint is solved once, and its λ stays with
it. A pass moves 4 rows of ``W·3`` floats a rank, whatever the grid's
height: O(halo), not O(N).

The stencil is ``solver/grid_window.py``'s ``RowWindow``, the plain
PyTorch version that the cloth kernel's row-window mode is held against;
as in JAX, no kernel runs here. With a ``dp_group`` (the 2-D mesh of
``sharding.make_mesh_groups``), each rank steps its block of the rollouts
``(B/dp, R·W, 3)``, and the rollouts need no collective.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..solver.grid_cloth import GridClothBatch
from ..solver.grid_cloth_cuda import kernel_params
from ..solver.grid_window import RowWindow
from ..solver.step import StepConfig

Tensor = torch.Tensor


def _p2p(pairs, group):
    """Run the ``(op, tensor, group rank)`` pairs as one batch of
    point-to-point transfers and wait for them."""
    if not pairs:
        return
    ops = [dist.P2POp(op, t, dist.get_global_rank(group, peer), group)
           for op, t, peer in pairs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def halo_exchange(a: Tensor, group, rows: int = 1) -> Tensor:
    """``(..., R, W, k) -> (..., R + 2·rows, W, k)``: the ``rows`` rows
    above from the previous rank and the ``rows`` below from the next,
    zeros at the grid's top and bottom (``intra_grid.py:152-157``)."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    edge = a.shape[:-3] + (rows,) + a.shape[-2:]
    above = a.new_zeros(edge)
    below = a.new_zeros(edge)
    pairs = []
    if rank > 0:
        pairs += [(dist.isend, a[..., :rows, :, :].contiguous(), rank - 1),
                  (dist.irecv, above, rank - 1)]
    if rank < world - 1:
        pairs += [(dist.isend, a[..., -rows:, :, :].contiguous(), rank + 1),
                  (dist.irecv, below, rank + 1)]
    _p2p(pairs, group)
    return torch.cat([above, a, below], dim=-3)


def halo_reduce(acc_ext: Tensor, group) -> Tensor:
    """``(..., R + 2, W, k) -> (..., R, W, k)``: the corrections in my halo
    rows go to the ranks that own those rows and theirs come to mine; the
    next rank's top halo row is my last row, the previous rank's bottom
    halo row my first (``intra_grid.py:159-170``)."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    edge = acc_ext.shape[:-3] + (1,) + acc_ext.shape[-2:]
    from_next = acc_ext.new_zeros(edge)
    from_prev = acc_ext.new_zeros(edge)
    pairs = []
    if rank > 0:
        pairs += [(dist.isend, acc_ext[..., :1, :, :].contiguous(), rank - 1),
                  (dist.irecv, from_prev, rank - 1)]
    if rank < world - 1:
        pairs += [(dist.isend, acc_ext[..., -1:, :, :].contiguous(),
                   rank + 1),
                  (dist.irecv, from_next, rank + 1)]
    _p2p(pairs, group)
    acc = acc_ext[..., 1:-1, :, :].clone()
    if rank < world - 1:
        acc[..., -1:, :, :] += from_next
    if rank > 0:
        acc[..., :1, :, :] += from_prev
    return acc


def rows_of(a, height: int, width: int, group, device) -> Tensor:
    """This rank's row block ``(R, W, 1)`` of a per-particle quantity
    given for the whole grid (``height·width`` values), as float32 on
    ``device``."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    r = height // world
    g = torch.as_tensor(np.asarray(torch.as_tensor(a).cpu(), np.float32))
    return g.reshape(height, width, 1)[rank * r:(rank + 1) * r].to(device)


def make_grid_intra_step_fn(batch: GridClothBatch, inv_mass, cfg: StepConfig,
                            group, dp_group=None, device=None):
    """``(x, v) -> (x, v)``, one sim step of this rank's row block of the
    grid, ``x``, ``v`` of shape ``(R·W, 3)``, or ``(B/dp, R·W, 3)`` with a
    ``dp_group``: its block of the rollouts. The batch covers particles
    ``[0, H·W)`` with uniform XPBD distance and bending parameters, ``H``
    divisible by the group's size. Every rank of ``group`` builds it
    together (the inverse masses' halo is exchanged here, once) on
    ``device`` (None means CUDA; the group's backend must move tensors
    there)."""
    dev = resolve_device(device)
    h_grid, w_grid = batch.height, batch.width
    if batch.offset != 0:
        raise NotImplementedError("grid intra-sharding expects offset 0")
    if not (batch.has_distance and batch.has_bending
            and batch.xpbd_distance and batch.xpbd_bending):
        raise NotImplementedError("XPBD distance+bending grids only")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if h_grid % world:
        raise NotImplementedError(
            f"grid rows ({h_grid}) must divide by device count ({world})")
    br = h_grid // world
    params = kernel_params(batch, h=cfg.dt / cfg.substeps,
                           gravity=cfg.gravity, damping=cfg.damping)

    wl, icd, icb = (rows_of(a, h_grid, w_grid, group, dev)
                    for a in (inv_mass, batch.inv_cnt_dist,
                              batch.inv_cnt_bend))
    win = RowWindow(params, halo_exchange(wl, group), rank * br - 1, h_grid,
                    own=(rank * br, (rank + 1) * br),
                    omega=cfg.jacobi_omega)

    def extend(x):
        return halo_exchange(x, group)

    def reduce(acc):
        return halo_reduce(acc, group)

    def fn(x: Tensor, v: Tensor):
        want = 3 if dp_group is not None else 2
        if x.dim() != want or x.shape[-2] != br * w_grid:
            raise ValueError(f"expected this rank's rows, (..., {br * w_grid},"
                             f" 3) with {want} dimensions; got "
                             f"{tuple(x.shape)}")
        lead = x.shape[:-2]
        xg = x.reshape(*lead, br, w_grid, 3)
        vg = v.reshape(*lead, br, w_grid, 3)
        for _ in range(cfg.substeps):
            xg, vg = win.substep(xg, vg, wl, icd, icb, cfg.max_iterations,
                                 extend, reduce)
        return xg.reshape(x.shape), vg.reshape(v.shape)

    return fn
