"""Carry a scene of the JAX package across to the port.

The JAX package's ``SimState``, ``GridClothBatch`` and ``GridTetBatch``
leaves, taken out as numpy arrays (``np.asarray`` of each leaf) together
with the batches' static fields, become the port's ``(SimState,
ConstraintSet)``. Both
packages then compute the same trajectory from the same scene. This
module reads numpy only; it never imports the JAX package.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .solver.constraints import ConstraintSet
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
                     grid_tet_meta: Sequence[Mapping] = ()
                     ) -> Tuple[SimState, ConstraintSet]:
    """``state_arrays``: the particle leaves ``x, v, old_x, last_x, x0,
    inv_mass`` and ``time`` (``overflow`` optional). ``grid_cloth_arrays``:
    per grid cloth, ``rest``, ``stiff``, ``q_mat``, ``bend_stiff`` (dicts
    family → array) and ``inv_cnt_dist``, ``inv_cnt_bend``. ``meta``: per
    grid cloth, its static fields ``height, width, offset, xpbd_distance,
    xpbd_bending, has_distance, has_bending``. ``grid_tet_arrays``: per
    tet grid, ``inv_rest_odd, inv_rest_even, rest_vol_odd, rest_vol_even,
    youngs, poisson, inv_cnt``; ``grid_tet_meta``: per tet grid, ``width,
    height, depth, offset, inversion_handling``. Every array is copied to
    ``device`` (None means CUDA) as float32."""
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
    cset = ConstraintSet(grid_cloths=tuple(gcs),
                         n_particles=particles.x.shape[-2],
                         grid_tets=tuple(gts))
    return state, cset
