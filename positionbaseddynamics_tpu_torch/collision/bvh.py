"""Bounding-sphere hierarchy over narrow-phase point clouds.

The port's own copy of ``positionbaseddynamics_tpu/collision/bvh.py``
(numpy only; its orders and spheres equal the JAX package's exactly).
It is the fixed-depth form of the reference's ``PointCloudBSH`` kd-tree
(``Simulation/BoundingSphereHierarchy.h:10-56``, ``kdTree.inl``).

The reference prunes per-vertex SDF tests by walking a kd-tree of
bounding spheres with the predicate *"SDF distance at the sphere center
< sphere radius"* (``DistanceFieldCollisionDetection.cpp:226-247``).
This module builds a fixed-depth hierarchy instead — Morton-ordered
vertex blocks, each with a build-time local bounding sphere — so the
predicate is evaluated for all block spheres of a pair at once, and a
pair whose block spheres all miss gives no contact rows.

Construction mirrors the reference's median-split intent: vertices are
sorted along the Morton curve of their positions so blocks are spatially
compact, then each block of ``block_size`` consecutive vertices gets the
smallest enclosing sphere of its points (centroid + max distance, the
``BoundingSphere`` constructor's semantics).
"""
from __future__ import annotations

import numpy as np


def morton_order(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """Vertex permutation along the 3-D Morton (Z-order) curve."""
    p = np.asarray(points, np.float64)
    lo = p.min(0)
    ext = np.maximum(p.max(0) - lo, 1e-12)
    q = np.clip(((p - lo) / ext * ((1 << bits) - 1)), 0,
                (1 << bits) - 1).astype(np.uint64)

    def _spread(v):
        v &= np.uint64(0x3FF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x30000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x9249249)
        return v

    code = (_spread(q[:, 0]) | (_spread(q[:, 1]) << np.uint64(1))
            | (_spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def build_block_spheres(verts: np.ndarray, block_size: int = 32):
    """Morton-sort ``verts (V, 3)`` and compute per-block bounding
    spheres. Returns ``(verts_sorted (V, 3), centers (B, 3),
    radii (B,))`` with the last block padded by repeating the final
    vertex (its sphere stays tight)."""
    v = np.asarray(verts, np.float32)
    if len(v) == 0:
        return v, np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)
    order = morton_order(v)
    vs = v[order]
    n_blocks = -(-len(vs) // block_size)
    pad = n_blocks * block_size - len(vs)
    vp = np.concatenate([vs, np.repeat(vs[-1:], pad, 0)], 0) if pad else vs
    blocks = vp.reshape(n_blocks, block_size, 3)
    centers = blocks.mean(axis=1)
    radii = np.linalg.norm(blocks - centers[:, None, :],
                           axis=-1).max(axis=1)
    return vs, centers.astype(np.float32), radii.astype(np.float32)
