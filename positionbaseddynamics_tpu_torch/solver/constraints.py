"""Constraint containers and host-side constraint initialisation.

Port of the parts of ``positionbaseddynamics_tpu/solver/constraints.py``
that the grid slices need: the numpy rank-1 isometric-bending factor
(``:173-197``) and a ``ConstraintSet`` that holds structured grid cloths
and tet grids (``:1144-1223``, the ``grid_cloth{i}`` and ``grid_tet{i}``
keys). The unstructured batches come with slice 4.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


def _init_isometric_bending_s_np(p: np.ndarray) -> np.ndarray:
    """Rank-1 factor of the isometric-bending Hessian: the reference's
    ``Q(j,k) = coef·K[j]·K[k]`` (``XPBD.cpp:136-148``) is exactly
    ``Q = −S Sᵀ`` with ``S = K·√(−coef)``. ``p (C, 4, 3)`` in stencil
    order (p0, p1, p2, p3); returns ``S (C, 4)`` in the solver's internal
    (p2, p3, p0, p1) index order."""
    p = np.asarray(p, np.float64)
    x0, x1, x2, x3 = p[:, 2], p[:, 3], p[:, 0], p[:, 1]
    e0, e1, e2 = x1 - x0, x2 - x0, x3 - x0
    e3, e4 = x2 - x1, x3 - x1

    def cot(v, w):
        cos_t = np.einsum("cd,cd->c", v, w)
        sin_t = np.linalg.norm(np.cross(v, w), axis=-1)
        return cos_t / np.maximum(sin_t, 1e-12)

    c01, c02 = cot(e0, e1), cot(e0, e2)
    c03, c04 = cot(-e0, e3), cot(-e0, e4)
    a0 = 0.5 * np.linalg.norm(np.cross(e0, e1), axis=-1)
    a1 = 0.5 * np.linalg.norm(np.cross(e0, e2), axis=-1)
    coef = 3.0 / (2.0 * (a0 + a1))
    k = np.stack([c03 + c04, c01 + c02, -c01 - c03, -c02 - c04], axis=1)
    return (np.sqrt(coef)[:, None] * k).astype(np.float32)


@dataclass(frozen=True)
class ConstraintSet:
    """All constraint batches of a scene. So far the port has the
    structured grid cloths (``solver/grid_cloth.py``) and the structured
    tet grids (``solver/grid_tet.py``). ``n_particles`` is the scene's
    particle count (set by the builder); the stepper uses it to tell
    whether one grid covers the whole scene."""

    grid_cloths: Tuple = ()
    n_particles: Optional[int] = None
    grid_tets: Tuple = ()

    def init_lambdas(self):
        lams = {f"grid_cloth{i}": gc.init_lambda()
                for i, gc in enumerate(self.grid_cloths)}
        for i, gt in enumerate(self.grid_tets):
            lams[f"grid_tet{i}"] = gt.init_lambda()
        return lams

    @property
    def device(self) -> Optional[torch.device]:
        batches = self.grid_cloths + self.grid_tets
        return batches[0].device if batches else None

    def to(self, device) -> "ConstraintSet":
        """The same set with every tensor on ``device``."""
        return dataclasses.replace(
            self, grid_cloths=tuple(gc.to(device) for gc in self.grid_cloths),
            grid_tets=tuple(gt.to(device) for gt in self.grid_tets))
