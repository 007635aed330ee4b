"""High-resolution visualization-mesh skinning for tet models (port of
``positionbaseddynamics_tpu/models/skinning.py``).

Equivalent of ``TetModel::attachVisMesh`` / ``updateVisMesh``
(``Simulation/TetModel.h:21-28,74-84``, impl ``TetModel.cpp``): each
vis-mesh vertex is bound at rest to its best tet (minimum barycentric
error — the same metric as ``findRefTetAt``,
``DistanceFieldCollisionDetection.cpp:793-806``) and follows it by
barycentric interpolation of the deformed tet corners.

Binding is host-side numpy (once at build), with JAX's chunked search,
error metric and tie order; skinning is one gather and one ``einsum`` a
frame.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device

Tensor = torch.Tensor


@dataclass(frozen=True)
class VisMeshAttachment:
    """Frozen binding of a vis mesh to a tet model."""

    tet_verts: Tensor  # (V, 4) int64 global particle indices of the tet
    bary: Tensor       # (V, 4) float32 barycentric weights (may extrapolate
    #                    slightly outside, like the reference's bestIndex
    #                    binding of exterior vis vertices)
    faces: np.ndarray  # (F, 3) int32

    @staticmethod
    def create(vis_vertices, tet_handle, rest_positions, faces=None,
               device=None) -> "VisMeshAttachment":
        """Bind ``vis_vertices (V, 3)`` to the tets of ``tet_handle`` using
        the model's build-time ``rest_positions`` (full scene array, numpy
        or a tensor), on ``device`` (None means CUDA)."""
        dev = resolve_device(device)
        if isinstance(rest_positions, torch.Tensor):
            rest_positions = rest_positions.detach().cpu().numpy()
        rest = np.asarray(rest_positions, np.float64)
        tets = np.asarray(tet_handle.mesh.tets, np.int64) + tet_handle.offset
        vis = np.asarray(vis_vertices, np.float64)
        a = np.stack([rest[tets[:, 1]] - rest[tets[:, 0]],
                      rest[tets[:, 2]] - rest[tets[:, 0]],
                      rest[tets[:, 3]] - rest[tets[:, 0]]], axis=-1)
        inv_a = np.linalg.inv(a)                     # (T, 3, 3)
        x0 = rest[tets[:, 0]]

        best = np.zeros(len(vis), np.int64)
        best_err = np.full(len(vis), np.inf)
        best_bary = np.zeros((len(vis), 3))
        chunk = 512
        for s in range(0, len(tets), chunk):
            bary = np.einsum("tij,vtj->vti", inv_a[s:s + chunk],
                             vis[:, None, :] - x0[None, s:s + chunk])
            err = (np.maximum(0.0, -bary).sum(-1)
                   + np.maximum(0.0, bary.sum(-1) - 1.0))
            am = err.argmin(1)
            e = err[np.arange(len(vis)), am]
            upd = e < best_err
            best[upd] = s + am[upd]
            best_err[upd] = e[upd]
            best_bary[upd] = bary[np.arange(len(vis)), am][upd]
        b_full = np.concatenate(
            [1.0 - best_bary.sum(-1, keepdims=True), best_bary], axis=-1)
        return VisMeshAttachment(
            tet_verts=torch.as_tensor(tets[best], device=dev),
            bary=torch.as_tensor(b_full.astype(np.float32), device=dev),
            faces=(np.zeros((0, 3), np.int32) if faces is None
                   else np.asarray(faces, np.int32)))

    def skin(self, x: Tensor) -> Tensor:
        """Deformed vis-mesh vertex positions ``(..., V, 3)`` from the
        current particle array ``x (..., N, 3)``
        (``TetModel::updateVisMesh``)."""
        return torch.einsum("vk,...vki->...vi", self.bary,
                            x[..., self.tet_verts, :])
