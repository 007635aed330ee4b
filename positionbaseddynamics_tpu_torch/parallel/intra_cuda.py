"""The fused cloth kernel on row blocks of one cloth, over a process group
— the counterpart of ``positionbaseddynamics_tpu/parallel/intra_pallas.py``
(named after the port's ``*_cuda.py`` modules).

Rank ``r`` owns grid rows ``[r·R, (r+1)·R)``. Once a step it receives
``exch`` rows from each neighbour (positions and velocities; zeros beyond
the cloth's top and bottom) and runs the fused cloth kernel
(``solver/grid_cloth_cuda.py``, ``fuse_substeps`` in the row-window mode)
on its ``R + 2·exch`` rows, whose first is global row ``r·R − exch``, and
keeps its central ``R``:

* a step's influence reaches ``3·iterations·substeps`` rows, so with
  ``exch`` two rows more, rounded up to even, the kept rows never see the
  window's zero-filled edges;
* the kernel's masks and parity read the global row, so only the first
  and the last rank see the cloth's real edges;
* pinned particles and the Jacobi weights are data: their planes are cut
  for the window once, when the step function is built (they do not
  change; JAX sends them every step).

A step moves ``2·exch`` rows of positions and of velocities a rank each
way, independent of N. On the CPU the window runs the kernel's plain
version (``grid_window.window_substeps_reference``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..solver.grid_cloth import GridClothBatch
from ..solver.grid_cloth_cuda import make_cloth_step
from ..solver.step import StepConfig
from .intra_grid import halo_exchange, rows_of

Tensor = torch.Tensor


def _round_up_even(n: int) -> int:
    return n + (n & 1)


def exchange_rows(cfg: StepConfig) -> int:
    """Rows a rank receives from each neighbour a step: the step's reach
    ``3·iterations·substeps`` plus 2, rounded up to even."""
    return _round_up_even(3 * cfg.max_iterations * cfg.substeps + 2)


def make_cuda_intra_step_fn(batch: GridClothBatch, inv_mass, cfg: StepConfig,
                            group, device=None):
    """``(x, v) -> (x, v)``, one full sim step of this rank's row block
    ``(R·W, 3)`` through the fused kernel in its row-window mode. The
    refusals are JAX's: the grid's rows divide by the group's size, into
    even blocks that cover the halo. Every rank of ``group`` builds it
    together, on ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    h_grid, w_grid = batch.height, batch.width
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if h_grid % world:
        raise NotImplementedError(
            f"grid rows ({h_grid}) must divide by device count ({world})")
    r_loc = h_grid // world
    exch = exchange_rows(cfg)
    if r_loc % 2:
        raise NotImplementedError("rows per device must be even "
                                  "(parity alignment)")
    if r_loc < exch:
        raise NotImplementedError(
            f"rows per device ({r_loc}) must cover the halo ({exch}); "
            f"use fewer devices or a larger grid")
    step_local = make_cloth_step(
        batch, None, None, None, dt=cfg.dt, substeps=cfg.substeps,
        max_iterations=cfg.max_iterations, gravity=cfg.gravity,
        damping=cfg.damping, n_steps=1, fuse_substeps=True,
        height_override=r_loc + 2 * exch, global_height=h_grid,
        external_params=True, device=dev)

    we, icde, icbe = (
        halo_exchange(rows_of(a, h_grid, w_grid, group, dev), group,
                      exch).reshape(-1)
        for a in (inv_mass, batch.inv_cnt_dist, batch.inv_cnt_bend))
    off = rank * r_loc - exch

    def fn(x: Tensor, v: Tensor):
        if tuple(x.shape) != (r_loc * w_grid, 3):
            raise ValueError(f"expected this rank's rows, ({r_loc * w_grid},"
                             f" 3); got {tuple(x.shape)}")
        xe = halo_exchange(x.reshape(r_loc, w_grid, 3), group, exch)
        ve = halo_exchange(v.reshape(r_loc, w_grid, 3), group, exch)
        xo, vo = step_local(xe.reshape(-1, 3), ve.reshape(-1, 3), we, icde,
                            icbe, off)
        keep = slice(exch * w_grid, (exch + r_loc) * w_grid)
        return xo[keep], vo[keep]

    return fn
