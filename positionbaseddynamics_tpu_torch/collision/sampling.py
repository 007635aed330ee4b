"""Surface point-cloud sampling for rb–rb narrow-phase sources.

The port's own copy of ``positionbaseddynamics_tpu/collision/sampling.py``
(numpy only; its samples equal the JAX package's exactly).


The reference tests body A's *mesh vertices* against body B's SDF
(``DistanceFieldCollisionDetection.cpp:100-175``). When rigid bodies are
created from analytic shapes rather than meshes, we generate a uniform
surface sample as the vertex set. Counts are static → fixed contact
capacity."""
from __future__ import annotations

import numpy as np


def sample_sphere(radius: float, n: int = 64) -> np.ndarray:
    """Fibonacci-sphere surface samples ``(n, 3)``."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return (radius * np.stack([
        np.sin(phi) * np.cos(theta),
        np.sin(phi) * np.sin(theta),
        np.cos(phi)], -1)).astype(np.float32)


def sample_box(half_extents, n_per_edge: int = 3) -> np.ndarray:
    """Box surface lattice: corners + edge/face subdivisions ``(V, 3)``."""
    h = np.asarray(half_extents, np.float64)
    t = np.linspace(-1.0, 1.0, max(n_per_edge, 2))
    g = np.stack(np.meshgrid(t, t, t, indexing="ij"), -1).reshape(-1, 3)
    on_surf = (np.abs(np.abs(g).max(axis=1) - 1.0) < 1e-9)
    return (g[on_surf] * h).astype(np.float32)


def sample_cylinder(radius: float, height: float, n_theta: int = 12,
                    n_h: int = 3) -> np.ndarray:
    """Lateral rings + cap rims/centers ``(V, 3)`` (y-axis cylinder)."""
    theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    ys = np.linspace(-height / 2, height / 2, max(n_h, 2))
    pts = [np.stack([radius * np.cos(theta), np.full_like(theta, y),
                     radius * np.sin(theta)], -1) for y in ys]
    pts.append(np.array([[0.0, -height / 2, 0.0], [0.0, height / 2, 0.0]]))
    return np.concatenate(pts, 0).astype(np.float32)


def sample_torus(major_r: float, minor_r: float, n_major: int = 16,
                 n_minor: int = 8) -> np.ndarray:
    """Parametric torus lattice ``(n_major*n_minor, 3)`` (y-axis torus)."""
    u = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    r = major_r + minor_r * np.cos(vv)
    return np.stack([r * np.cos(uu), minor_r * np.sin(vv),
                     r * np.sin(uu)], -1).reshape(-1, 3).astype(np.float32)
