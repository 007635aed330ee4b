"""Host-side mesh topology (numpy) — a copy of the topology classes of
``positionbaseddynamics_tpu/models/mesh.py`` (``IndexedFaceMesh``,
``IndexedTetMesh``): edge, adjacency and surface extraction, run once at
scene-build time, and the deformed meshes' face and vertex normals in
torch. Edge order is face-major first-occurrence, as in the
reference's per-face enumeration.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def _unique_edges(halfedges: np.ndarray):
    """Deduplicate (a, b) pairs keeping first-occurrence order and original
    orientation. Returns ``(edges (E,2), edge_id (H,), first_he (E,))``."""
    key = np.sort(halfedges, axis=1)
    _, first_idx, inv = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    edge_id = rank[inv.reshape(-1)]          # halfedge → edge (appearance order)
    first_he = np.sort(first_idx)
    return halfedges[first_he].astype(np.int32), edge_id, first_he


@dataclass
class TriangleMesh:
    """Indexed triangle mesh with edge topology: ``edges (E, 2)`` vertex
    pairs, ``edge_faces (E, 2)`` adjacent face ids (−1 on the boundary),
    as ``IndexedFaceMesh::buildNeighbors``; optional ``uvs (T, 2)`` and
    ``uv_indices (F, 3)`` texture coordinates."""

    n_vertices: int
    faces: np.ndarray              # (F, 3) int32
    uvs: np.ndarray = None         # (T, 2) float32 or None
    uv_indices: np.ndarray = None  # (F, 3) int32 or None
    edges: np.ndarray = field(init=False)
    edge_faces: np.ndarray = field(init=False)

    def __post_init__(self):
        self.faces = np.asarray(self.faces, np.int32).reshape(-1, 3)
        if self.uvs is not None and len(np.asarray(self.uvs)):
            self.uvs = np.asarray(self.uvs, np.float32).reshape(-1, 2)
            if self.uv_indices is not None and len(
                    np.asarray(self.uv_indices)):
                self.uv_indices = np.asarray(
                    self.uv_indices, np.int32).reshape(-1, 3)
            else:
                self.uv_indices = None
        else:
            self.uvs = None
            self.uv_indices = None
        f = self.faces
        n_f = len(f)
        # face-major halfedge order: (v0,v1), (v1,v2), (v2,v0) per face
        he = np.stack([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]],
                      axis=1).reshape(-1, 2)
        self.edges, edge_id, first_he = _unique_edges(he)
        hf = np.repeat(np.arange(n_f, dtype=np.int32), 3)
        n_e = len(self.edges)
        ef = np.full((n_e, 2), -1, np.int32)
        ef[:, 0] = hf[first_he]
        is_first = np.zeros(len(he), bool)
        is_first[first_he] = True
        rest = ~is_first
        ef[edge_id[rest], 1] = hf[rest]
        self.edge_faces = ef

    def bending_stencils(self) -> np.ndarray:
        """Interior-edge stencils ``(p0, p1, p2, p3)`` — p0/p1 the flap
        vertices opposite the shared edge (p2, p3) — in the order
        ``SimulationModel::addBendingConstraints`` emits them."""
        interior = (self.edge_faces[:, 0] >= 0) & (self.edge_faces[:, 1] >= 0)
        e = self.edges[interior]
        f0 = self.faces[self.edge_faces[interior, 0]]
        f1 = self.faces[self.edge_faces[interior, 1]]
        # the flap vertex is the face's third vertex: sum(face) − a − b
        a, b = e[:, 0].astype(np.int64), e[:, 1].astype(np.int64)
        p0 = f0.astype(np.int64).sum(1) - a - b
        p1 = f1.astype(np.int64).sum(1) - a - b
        return np.stack([p0, p1, a, b], axis=1).astype(np.int32)


@dataclass
class TetMesh:
    """Indexed tetrahedral mesh with edges and surface faces
    (``Utils/IndexedTetMesh``)."""

    n_vertices: int
    tets: np.ndarray               # (T, 4) int32
    edges: np.ndarray = field(init=False)
    surface_faces: np.ndarray = field(init=False)

    _TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
    # face i is opposite vertex i, wound so that its normal points out of a
    # positively oriented tet
    _TET_FACES = ((1, 3, 2), (0, 2, 3), (0, 3, 1), (0, 1, 2))

    def __post_init__(self):
        self.tets = np.asarray(self.tets, np.int32).reshape(-1, 4)
        t = self.tets
        he = np.stack([t[:, list(e)] for e in self._TET_EDGES],
                      axis=1).reshape(-1, 2)
        self.edges, _, _ = _unique_edges(he)

        tris = np.stack([t[:, list(fa)] for fa in self._TET_FACES],
                        axis=1).reshape(-1, 3)
        key = np.sort(tris, axis=1)
        _, first_idx, inv, counts = np.unique(
            key, axis=0, return_index=True, return_inverse=True,
            return_counts=True)
        surface = counts[inv.reshape(-1)[first_idx]] == 1
        self.surface_faces = tris[first_idx[surface]].astype(np.int32)


def _faces(faces, device):
    if isinstance(faces, torch.Tensor):
        return faces.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(faces, np.int64), device=device)


def face_normals(x, faces):
    """Per-face unit normals of deformed vertex positions ``x (..., N, 3)``
    (``mesh.py:128-145``; ``IndexedFaceMesh::updateNormals``,
    ``Utils/IndexedFaceMesh.h:96-121``): ``(..., F, 3)``. As in the
    reference, degenerate faces (normalized cross product with squared norm
    < 1e-6) get the UnitX fallback normal."""
    f = _faces(faces, x.device)
    a = x[..., f[:, 0], :]
    n = torch.linalg.cross(x[..., f[:, 1], :] - a, x[..., f[:, 2], :] - a,
                           dim=-1)
    l2 = torch.sum(n * n, dim=-1, keepdim=True)
    n = torch.where(l2 < 1e-24, torch.zeros_like(n),
                    n / torch.sqrt(torch.clamp_min(l2, 1e-30)))
    degenerate = torch.sum(n * n, dim=-1, keepdim=True) < 1e-6
    unit_x = torch.zeros_like(n)
    unit_x[..., 0] = 1.0
    return torch.where(degenerate, unit_x, n)


def vertex_normals(x, faces, n_vertices=None):
    """Per-vertex unit normals ``(..., n_vertices, 3)`` (``mesh.py:
    148-161``; ``IndexedFaceMesh::updateVertexNormals``,
    ``Utils/IndexedFaceMesh.h:123-146``): each incident face adds its unit
    normal regardless of area, then the sum is normalized."""
    if n_vertices is None:
        n_vertices = x.shape[-2]
    f = _faces(faces, x.device)
    fn = face_normals(x, f)
    vn = torch.zeros(x.shape[:-2] + (n_vertices, 3), dtype=x.dtype,
                     device=x.device)
    for k in range(3):
        vn = vn.index_add(-2, f[:, k], fn)
    l2 = torch.sum(vn * vn, dim=-1, keepdim=True)
    return torch.where(l2 < 1e-24, torch.zeros_like(vn),
                       vn / torch.sqrt(torch.clamp_min(l2, 1e-30)))
