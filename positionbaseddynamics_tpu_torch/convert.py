"""Carry a scene of the JAX package across to the port.

The JAX package's ``SimState`` (its particles, ``OrientationState`` and
``RigidState``), ``GridClothBatch``, ``GridTetBatch``, particle-batch
leaves (``DistanceBatch`` … ``DarbouxVectorBatch``, the generic batches
with the caller's torch function), ``JointBatch``-es, the Cosserat
batches, ``RodLatticeBatch``, the stiff-rod batches and
``GenericRigidBatch``-es, taken out as numpy arrays (``np.asarray`` of
each leaf) together with the batches' static fields, become the port's
``(SimState, ConstraintSet)``;
a JAX ``FluidScene`` (with its ``CellGridSpec`` and
``BoundaryTables``) and ``FluidState`` become the port's. Both packages
then compute the same trajectory from the same scene. This module reads
numpy only; it never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .fluids.cellgrid import CellGridSpec, boundary_tables
from .fluids.model import FluidScene, FluidState
from .solver import constraints
from .solver.constraints import PARTICLE_BATCH_ORDER, ConstraintSet
from .solver.direct_rods import DirectRodBatch, DirectRodTreeBatch
from .solver.grid_cloth import GridClothBatch
from .solver.grid_rods import RodLatticeBatch
from .solver.grid_tet import GridTetBatch
from .solver.joints import JointBatch
from .solver.state import (OrientationState, ParticleState, RigidState,
                           SimState)

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
                     particle_batches: Mapping[str, Tuple] = None,
                     rigid: Optional[Mapping[str, np.ndarray]] = None,
                     joints: Sequence[Tuple[Mapping, Mapping]] = (),
                     orientations: Optional[Mapping[str, np.ndarray]] = None,
                     rods: Mapping[str, Tuple] = None,
                     rod_lattices: Sequence[Tuple[Mapping, Mapping]] = (),
                     direct_rods: Sequence[Tuple] = (),
                     rigid_generics: Sequence[Tuple[Mapping, Mapping]] = ()
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
    a field of the set (``"distance"``, …) or ``"extra{i}"``. ``rigid``:
    the JAX ``RigidState``'s fields by name (``x, v, q, omega, old_x,
    last_x, old_q, last_q, x0, q0, inv_mass, inertia0, ext_force,
    ext_torque``). ``joints``: per ``JointBatch`` of the JAX set, in its
    order, ``(arrays, statics)``: its array fields that are not None
    (``bodies``, ``color``, ``local0``, …, ``seq_repeat``) and its static
    fields ``kind`` and ``num_colors``. ``orientations``: the JAX
    ``OrientationState``'s fields by name (``q, omega, old_q, last_q, q0,
    inv_mass``). ``rods``: ``"stretch_shear"`` and ``"bend_twist"`` as
    ``(class name, arrays, statics)``. ``rod_lattices``: per
    ``RodLatticeBatch``, ``(arrays, statics)``. ``direct_rods``: per
    stiff-rod batch, ``(class name, arrays, statics)``; a tree's
    ``arrays`` hold its ``schedule`` (a dict of arrays) and its
    ``statics`` ``n_slots``, ``dmax``, ``pmax`` and ``solver``.
    ``rigid_generics``: per ``GenericRigidBatch``, ``(arrays, statics)``,
    its statics ``fn`` (the constraint written as a torch function) and
    ``num_colors``; a ``GenericConstraintBatch`` comes among
    ``particle_batches`` as ``"generic{i}"``, its ``fn`` in its statics.
    Every array is copied to ``device`` (None means CUDA), the index tables
    as int64, the colours as int32, ``seq_repeat`` as bool, the rest as
    float32; the Jacobi counts are computed again from the indices."""
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
    rigid_state = None
    if rigid is not None:
        names = [f.name for f in dataclasses.fields(RigidState)]
        missing = [k for k in names if k not in rigid]
        if missing:
            raise ValueError(f"rigid lacks {missing}")
        rigid_state = RigidState(**{k: f32(rigid[k]) for k in names})
    ori = None
    if orientations is not None:
        ori = OrientationState(**{
            f.name: f32(orientations[f.name])
            for f in dataclasses.fields(OrientationState)})
    state = SimState(particles=particles, orientations=ori,
                     rigid=rigid_state, time=f32(state_arrays["time"]),
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
    kw = _particle_batches(particle_batches or {}, dev)
    for name, (cls_name, arrays, statics) in (rods or {}).items():
        if name not in ("stretch_shear", "bend_twist"):
            raise ValueError(f"unknown rod batch name {name!r}")
        kw[name] = _batch(getattr(constraints, cls_name), arrays, statics,
                          dev)
    lattices = tuple(RodLatticeBatch(
        **{f: torch.tensor(np.asarray(a, np.float32), device=dev)
           for f, a in arrays.items()}, **dict(statics))
        for arrays, statics in rod_lattices)
    cset = ConstraintSet(grid_cloths=tuple(gcs), n_particles=n,
                         grid_tets=tuple(gts),
                         n_rigid=None if rigid_state is None
                         else rigid_state.n,
                         joints=tuple(_joint_batch(a, st, dev)
                                      for a, st in joints),
                         rod_lattices=lattices,
                         direct_rods=tuple(_direct_rod(*d, dev)
                                           for d in direct_rods),
                         rigid_generics=tuple(
                             _batch(constraints.GenericRigidBatch, arrays,
                                    statics, dev)
                             for arrays, statics in rigid_generics), **kw)
    n_q = 0 if ori is None else ori.n
    return state, cset.with_jacobi_counts(n, n_q)


def _direct_rod(cls_name: str, arrays: Mapping, statics: Mapping, dev):
    """A JAX stiff-rod batch's arrays and statics as the port's."""
    if cls_name == "DirectRodBatch":
        return _batch(DirectRodBatch, arrays, {}, dev)
    if cls_name != "DirectRodTreeBatch":
        raise ValueError(f"{cls_name} is not a stiff-rod batch")
    arrays = dict(arrays)
    sched = arrays.pop("schedule", None)
    statics = dict(statics)
    solver = statics.pop("solver", "auto")
    if sched is not None:
        sched = dict(sched, **{k: statics[k] for k in ("n_slots", "dmax",
                                                       "pmax")})
    return DirectRodTreeBatch.from_arrays(arrays, sched, solver=solver,
                                          device=dev)


def _joint_batch(arrays: Mapping, statics: Mapping, dev) -> JointBatch:
    """A JAX ``JointBatch``'s arrays and statics as the port's."""
    def tensor(name, a):
        dtype = {"bodies": torch.int64, "color": torch.int32,
                 "seq_repeat": torch.bool}.get(name, torch.float32)
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    return JointBatch(**{k: tensor(k, a) for k, a in arrays.items()},
                      kind=str(statics["kind"]),
                      num_colors=int(statics["num_colors"]))


def _particle_batches(batches: Mapping[str, Tuple], dev) -> dict:
    """``ConstraintSet`` fields of the particle batches given as name →
    ``(class name, arrays, statics)``."""
    kw, extras, gens = {}, {}, {}
    for name, (cls_name, arrays, statics) in batches.items():
        cls = getattr(constraints, cls_name, None)
        if cls is None or not issubclass(cls, constraints._ParticleBatch):
            raise ValueError(f"{name}: {cls_name} is not a particle batch "
                             "of the port")
        batch = _batch(cls, arrays, statics, dev)
        if name.startswith("extra"):
            extras[int(name[len("extra"):])] = batch
        elif name.startswith("generic"):
            gens[int(name[len("generic"):])] = batch
        elif name in PARTICLE_BATCH_ORDER:
            kw[name] = batch
        else:
            raise ValueError(f"unknown particle batch name {name!r}")
    for what, d in (("extra", extras), ("generic", gens)):
        if sorted(d) != list(range(len(d))):
            raise ValueError(f"{what} batches {sorted(d)} are not 0..n-1")
    kw["extra_batches"] = tuple(extras[i] for i in range(len(extras)))
    kw["generics"] = tuple(gens[i] for i in range(len(gens)))
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


#: Index fields of the collision structures, carried as int64.
_INDEX_FIELDS = ("pair_i", "pair_jj", "pair_bi", "pair_bj", "bodies",
                 "morton_perm", "tets", "grid_tet", "tet_blocks",
                 "surf_blocks", "idx", "idx_p", "idx_q", "edges")


def _batch(cls, arrays: Mapping, statics: Mapping, dev):
    """``cls`` from its numpy ``arrays`` (as tensors on ``dev``) and its
    ``statics``."""
    return cls(**{f: _tensor_field(f, a, dev) for f, a in arrays.items()},
               **dict(statics))


def _tensor_field(name: str, a, dev):
    dtype = (torch.int64 if name in _INDEX_FIELDS
             else torch.int32 if name == "color" else torch.float32)
    return torch.tensor(np.asarray(a), dtype=dtype, device=dev)


def _fields(d: Mapping[str, Any], cls, dev, **extra) -> Any:
    """``cls`` from ``d``: its numpy arrays as tensors on ``dev``, its
    other entries as they are, keys that ``cls`` lacks left out."""
    names = {f.name for f in dataclasses.fields(cls)}
    out = {}
    for k, v in d.items():
        if k not in names or k in extra:
            continue
        out[k] = (_tensor_field(k, v, dev)
                  if isinstance(v, np.ndarray) else v)
    return cls(**out, **extra)


def _sdf_shape(d: Mapping[str, Any], dev):
    """An ``SDFShape`` from its kind and arrays; a stack of grids (values
    with a leading axis) reads its grids through ``grid_row``."""
    from .collision.sdf import CSDF, SDFShape

    shape = _fields(d, SDFShape, dev)
    gv = shape.grid_values
    if gv is not None and gv.dim() > (4 if shape.kind == CSDF else 3):
        shape = dataclasses.replace(
            shape, grid_row=torch.arange(gv.shape[0], device=dev))
    return shape


def collision_pipeline_from_numpy(pipe: Mapping[str, Any], device=None):
    """A JAX ``CollisionPipeline`` flattened to numpy as the port's
    ``CollisionPipeline`` on ``device`` (None means CUDA). ``pipe`` holds
    the pipeline's fields by name: ``tolerance``, ``broad_phase``,
    ``rb_pairs``; ``rigid_colliders`` (per collider its ``body``,
    ``shape`` — a mapping of ``kind``, ``params``, ``invert``,
    ``grid_values``, ``grid_origin``, ``grid_inv_cell`` — ``verts``,
    ``restitution``, ``friction``, ``frame_rot``, ``frame_t``,
    ``verts_radius``, ``shape_radius``, ``block_centers``,
    ``block_radii``); ``particle_groups`` (``offset``, ``count``,
    ``restitution``, ``friction``, ``morton_perm``, ``block_size``);
    ``solid_pairs`` as ``((offset, count, friction), tet collider
    fields)``; ``rb_batched`` (``BatchedRigidColliders``' fields with
    ``groups`` a list of ``RigidPairGroup`` fields, each ``shapes`` a
    stacked shape mapping) and ``pg_batched`` (``ParticlePairGroup``
    fields), or None and empty on the unrolled path. Arrays are numpy,
    absent ones None; indices become int64, the rest float32."""
    from .collision.batched import (BatchedRigidColliders,
                                    ParticlePairGroup, RigidPairGroup)
    from .collision.detection import (CollisionPipeline,
                                      ParticleGroupCollider, RigidCollider)
    from .collision.solid import TetCollider

    dev = resolve_device(device)
    rcs = tuple(_fields(c, RigidCollider, dev,
                        shape=_sdf_shape(c["shape"], dev))
                for c in pipe.get("rigid_colliders", ()))
    pgs = tuple(_fields(g, ParticleGroupCollider, dev)
                for g in pipe.get("particle_groups", ()))
    solid = tuple(((int(o), int(n), np.float32(f)),
                   _fields(tc, TetCollider, dev))
                  for (o, n, f), tc in pipe.get("solid_pairs", ()))
    rb = pipe.get("rb_batched")
    if rb is not None:
        groups = tuple(_fields(g, RigidPairGroup, dev,
                               shapes=_sdf_shape(g["shapes"], dev))
                       for g in rb["groups"])
        rb = _fields(rb, BatchedRigidColliders, dev, groups=groups)
    pg = tuple(_fields(g, ParticlePairGroup, dev,
                       shapes=_sdf_shape(g["shapes"], dev))
               for g in pipe.get("pg_batched", ()))
    return CollisionPipeline(
        rigid_colliders=rcs, particle_groups=pgs,
        tolerance=float(pipe["tolerance"]),
        rb_pairs=tuple(tuple(int(i) for i in p) for p in pipe["rb_pairs"]),
        solid_pairs=solid, broad_phase=str(pipe["broad_phase"]),
        rb_batched=rb, pg_batched=pg)
