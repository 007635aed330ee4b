"""Carry a scene of the JAX package across to the port.

The JAX package's ``SimState`` and ``GridClothBatch`` leaves, taken out as
numpy arrays (``np.asarray`` of each leaf) together with the batches'
static fields, become the port's ``(SimState, ConstraintSet)``. Both
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
from .solver.state import ParticleState, SimState

_PARTICLE_FIELDS = ("x", "v", "old_x", "last_x", "x0", "inv_mass")
_META_FIELDS = ("height", "width", "offset", "xpbd_distance", "xpbd_bending",
                "has_distance", "has_bending")


def scene_from_numpy(state_arrays: Mapping[str, np.ndarray],
                     grid_cloth_arrays: Sequence[Mapping],
                     meta: Sequence[Mapping], device=None
                     ) -> Tuple[SimState, ConstraintSet]:
    """``state_arrays``: the particle leaves ``x, v, old_x, last_x, x0,
    inv_mass`` and ``time`` (``overflow`` optional). ``grid_cloth_arrays``:
    per grid cloth, ``rest``, ``stiff``, ``q_mat``, ``bend_stiff`` (dicts
    family → array) and ``inv_cnt_dist``, ``inv_cnt_bend``. ``meta``: per
    grid cloth, its static fields ``height, width, offset, xpbd_distance,
    xpbd_bending, has_distance, has_bending``. Every array is copied to
    ``device`` (None means CUDA) as float32."""
    dev = resolve_device(device)
    if len(grid_cloth_arrays) != len(meta):
        raise ValueError(f"{len(grid_cloth_arrays)} grid cloths but "
                         f"{len(meta)} meta entries")

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
    cset = ConstraintSet(grid_cloths=tuple(gcs),
                         n_particles=particles.x.shape[-2])
    return state, cset
