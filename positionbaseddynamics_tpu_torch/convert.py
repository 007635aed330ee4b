"""Carry a scene of the JAX package across to the port.

The JAX package's ``SimState``, ``GridClothBatch``, ``GridTetBatch`` and
particle-batch leaves (``DistanceBatch`` … ``ShapeMatchingBatch``), taken
out as numpy arrays (``np.asarray`` of each leaf) together with the
batches' static fields, become the port's ``(SimState, ConstraintSet)``; a JAX ``FluidScene`` (with its ``CellGridSpec`` and
``BoundaryTables``) and ``FluidState`` become the port's. Both packages
then compute the same trajectory from the same scene. This module reads
numpy only; it never imports the JAX package.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .fluids.cellgrid import CellGridSpec, boundary_tables
from .fluids.model import FluidScene, FluidState
from .solver import constraints
from .solver.constraints import PARTICLE_BATCH_ORDER, ConstraintSet
from .solver.grid_cloth import GridClothBatch
from .solver.grid_tet import GridTetBatch
from .solver.state import ParticleState, SimState

_PARTICLE_FIELDS = ("x", "v", "old_x", "last_x", "x0", "inv_mass")
_META_FIELDS = ("height", "width", "offset", "xpbd_distance", "xpbd_bending",
                "has_distance", "has_bending")
_TET_FIELDS = ("inv_rest_odd", "inv_rest_even", "rest_vol_odd",
               "rest_vol_even", "youngs", "poisson", "inv_cnt")
_TET_META_FIELDS = ("width", "height", "depth", "offset",
                    "inversion_handling")


def scene_from_numpy(state_arrays: Mapping[str, np.ndarray],
                     grid_cloth_arrays: Sequence[Mapping],
                     meta: Sequence[Mapping], device=None, *,
                     grid_tet_arrays: Sequence[Mapping] = (),
                     grid_tet_meta: Sequence[Mapping] = (),
                     particle_batches: Mapping[str, Tuple] = None
                     ) -> Tuple[SimState, ConstraintSet]:
    """``state_arrays``: the particle leaves ``x, v, old_x, last_x, x0,
    inv_mass`` and ``time`` (``overflow`` optional). ``grid_cloth_arrays``:
    per grid cloth, ``rest``, ``stiff``, ``q_mat``, ``bend_stiff`` (dicts
    family → array) and ``inv_cnt_dist``, ``inv_cnt_bend``. ``meta``: per
    grid cloth, its static fields ``height, width, offset, xpbd_distance,
    xpbd_bending, has_distance, has_bending``. ``grid_tet_arrays``: per
    tet grid, ``inv_rest_odd, inv_rest_even, rest_vol_odd, rest_vol_even,
    youngs, poisson, inv_cnt``; ``grid_tet_meta``: per tet grid, ``width,
    height, depth, offset, inversion_handling``. ``particle_batches``:
    the JAX set's ``particle_batches()`` as a mapping name → ``(class
    name, arrays, statics)``, the class one of ``solver/constraints.py``'s
    particle batches, ``arrays`` its tensor fields and ``statics`` its
    static fields (``num_colors``, ``xpbd``, the strain flags); a name is
    a field of the set (``"distance"``, …) or ``"extra{i}"``. Every array
    is copied to ``device`` (None means CUDA), the index tables as int64,
    the colours as int32, the rest as float32; the Jacobi counts are
    computed again from the indices."""
    dev = resolve_device(device)
    if len(grid_cloth_arrays) != len(meta):
        raise ValueError(f"{len(grid_cloth_arrays)} grid cloths but "
                         f"{len(meta)} meta entries")
    if len(grid_tet_arrays) != len(grid_tet_meta):
        raise ValueError(f"{len(grid_tet_arrays)} tet grids but "
                         f"{len(grid_tet_meta)} meta entries")

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    missing = [k for k in _PARTICLE_FIELDS + ("time",)
               if k not in state_arrays]
    if missing:
        raise ValueError(f"state_arrays lacks {missing}")
    particles = ParticleState(
        **{k: f32(state_arrays[k]) for k in _PARTICLE_FIELDS})
    overflow = state_arrays.get("overflow")
    state = SimState(particles=particles, orientations=None, rigid=None,
                     time=f32(state_arrays["time"]),
                     overflow=None if overflow is None else f32(overflow))

    gcs = []
    for arrays, m in zip(grid_cloth_arrays, meta):
        static = {k: m[k] for k in _META_FIELDS}
        gcs.append(GridClothBatch(
            rest={f: f32(a) for f, a in arrays["rest"].items()},
            stiff={f: f32(a) for f, a in arrays["stiff"].items()},
            q_mat={f: f32(a) for f, a in arrays["q_mat"].items()},
            bend_stiff={f: f32(a) for f, a in arrays["bend_stiff"].items()},
            inv_cnt_dist=f32(arrays["inv_cnt_dist"]),
            inv_cnt_bend=f32(arrays["inv_cnt_bend"]),
            **static))
    gts = [GridTetBatch(**{k: f32(arrays[k]) for k in _TET_FIELDS},
                        **{k: m[k] for k in _TET_META_FIELDS})
           for arrays, m in zip(grid_tet_arrays, grid_tet_meta)]
    n = particles.x.shape[-2]
    cset = ConstraintSet(grid_cloths=tuple(gcs), n_particles=n,
                         grid_tets=tuple(gts),
                         **_particle_batches(particle_batches or {}, dev))
    return state, cset.with_jacobi_counts(n)


def _particle_batches(batches: Mapping[str, Tuple], dev) -> dict:
    """``ConstraintSet`` fields of the particle batches given as name →
    ``(class name, arrays, statics)``."""
    def tensor(field, a):
        dtype = {"idx": torch.int64, "color": torch.int32}.get(
            field, torch.float32)
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    kw, extras = {}, {}
    for name, (cls_name, arrays, statics) in batches.items():
        cls = getattr(constraints, cls_name, None)
        if cls is None or not issubclass(cls, constraints._ParticleBatch):
            raise ValueError(f"{name}: {cls_name} is not a particle batch "
                             "of the port")
        batch = cls(**{f: tensor(f, a) for f, a in arrays.items()},
                    **dict(statics))
        if name.startswith("extra"):
            extras[int(name[len("extra"):])] = batch
        elif name in PARTICLE_BATCH_ORDER:
            kw[name] = batch
        else:
            raise ValueError(f"unknown particle batch name {name!r}")
    if sorted(extras) != list(range(len(extras))):
        raise ValueError(f"extra batches {sorted(extras)} are not 0..n-1")
    kw["extra_batches"] = tuple(extras[i] for i in range(len(extras)))
    return kw


_FLUID_ARRAYS = ("mass", "boundary_x", "boundary_psi")
_FLUID_STATICS = ("density0", "support_radius", "viscosity", "iterations",
                  "cap_per_cell", "min_dt", "max_dt", "particle_radius",
                  "gravity", "hash_cap")
_GRID_STATICS = ("origin", "dims", "cell", "cap", "max_active")
_BOUNDARY_FIELDS = ("xt", "psit", "capb", "near", "near_frac")
_FLUID_STATE_FIELDS = ("x", "v", "old_x", "last_x", "time", "dt")


def _cellgrid_from_numpy(grid: Optional[Mapping[str, Any]], dev
                         ) -> Optional[CellGridSpec]:
    if grid is None:
        return None
    missing = [k for k in _GRID_STATICS if k not in grid]
    if missing:
        raise ValueError(f"cellgrid lacks {missing}")
    bnd = grid.get("boundary")
    if bnd is not None:
        missing = [k for k in _BOUNDARY_FIELDS if k not in bnd]
        if missing:
            raise ValueError(f"cellgrid.boundary lacks {missing}")
        bnd = boundary_tables(bnd["xt"], bnd["psit"], bnd["capb"],
                              bnd["near"], bnd["near_frac"], dev)
    return CellGridSpec(origin=tuple(float(v) for v in grid["origin"]),
                        dims=tuple(int(v) for v in grid["dims"]),
                        cell=float(grid["cell"]), cap=int(grid["cap"]),
                        max_active=int(grid["max_active"]), boundary=bnd)


def fluid_scene_from_numpy(scene: Mapping[str, Any], device=None
                           ) -> FluidScene:
    """A JAX ``FluidScene`` as the port's. ``scene`` maps each field of the
    JAX scene to its value: ``mass``, ``boundary_x`` and ``boundary_psi``
    as numpy arrays, the statics (``density0, support_radius, viscosity,
    iterations, cap_per_cell, min_dt, max_dt, particle_radius, gravity,
    hash_cap``) as Python values, and ``cellgrid`` as None or a mapping of
    the ``CellGridSpec``'s fields (``origin, dims, cell, cap, max_active,
    boundary``), whose ``boundary`` is None or a mapping of the
    ``BoundaryTables``' fields (``xt`` a sequence of three ``(n_cells,
    capb)`` planes, ``psit``, ``capb``, ``near``, ``near_frac``). Arrays
    are copied to ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    missing = [k for k in _FLUID_ARRAYS + _FLUID_STATICS + ("cellgrid",)
               if k not in scene]
    if missing:
        raise ValueError(f"scene lacks {missing}")
    arrays = {k: torch.tensor(np.asarray(scene[k], np.float32), device=dev)
              for k in _FLUID_ARRAYS}
    arrays["boundary_x"] = arrays["boundary_x"].reshape(-1, 3)
    statics = {k: scene[k] for k in _FLUID_STATICS}
    statics["gravity"] = tuple(float(g) for g in statics["gravity"])
    return FluidScene(**arrays, **statics,
                      cellgrid=_cellgrid_from_numpy(scene["cellgrid"], dev))


def fluid_state_from_numpy(state: Mapping[str, Any], device=None
                           ) -> FluidState:
    """A JAX ``FluidState`` as the port's: ``x, v, old_x, last_x`` ``(N,
    3)``, ``time`` and ``dt`` scalars and ``overflow`` (optional) as numpy
    arrays, copied to ``device`` (None means CUDA) as float32."""
    dev = resolve_device(device)
    missing = [k for k in _FLUID_STATE_FIELDS if k not in state]
    if missing:
        raise ValueError(f"state lacks {missing}")

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    overflow = state.get("overflow")
    return FluidState(**{k: f32(state[k]) for k in _FLUID_STATE_FIELDS},
                      overflow=None if overflow is None else f32(overflow))
