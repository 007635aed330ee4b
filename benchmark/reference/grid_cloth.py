"""Plain XPBD cloth of a regular triangle grid (``Demos/ClothDemo``):
distance constraints on every mesh edge (method 4, ``XPBD.cpp:14-60``)
and isometric bending on every interior edge (method 3,
``XPBD.cpp:112-213``), one Jacobi pass of each family an iteration,
averaged by each particle's count of constraints of the family.

Written as gather, solve and ``index_add_`` over explicit constraint
lists worked out from the triangle mesh, not as the program's stencils.
"""
from __future__ import annotations

import numpy as np
import torch

from .xpbd import Scene, inv_counts, rotation_x

Tensor = torch.Tensor


def points(config: dict) -> np.ndarray:
    """Rest positions ``(H·W, 3)`` in the order ``i·W + j``: local ``(j·dx,
    i·dy, 0)`` rotated about x, as float32 (``SimulationModel.cpp:831``)."""
    w, h = config["width"], config["height"]
    sx, sy = config["scale"]
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    p = np.stack([jj * (sx / (w - 1)), ii * (sy / (h - 1)),
                  np.zeros(jj.shape)], axis=-1).reshape(-1, 3)
    p = p @ rotation_x(config.get("rotation_x_deg", 0.0)).T
    return p.astype(np.float32)


def triangles(config: dict) -> np.ndarray:
    """``(2(H−1)(W−1), 3)`` faces, each quad split along the diagonal
    that alternates with the parity of ``i + j``."""
    w, h = config["width"], config["height"]
    i, j = np.meshgrid(np.arange(h - 1), np.arange(w - 1), indexing="ij")
    i, j = i.ravel(), j.ravel()
    a, b, c, d = i * w + j, i * w + j + 1, (i + 1) * w + j, (i + 1) * w + j + 1
    same = (i % 2) == (j % 2)
    t1 = np.where(same[:, None], np.stack([a, b, d], 1),
                  np.stack([a, b, c], 1))
    t2 = np.where(same[:, None], np.stack([d, c, a], 1),
                  np.stack([d, c, b], 1))
    return np.concatenate([t1, t2])


def edges_and_stencils(faces: np.ndarray):
    """The mesh's unique edges ``(E, 2)`` and, for each edge that two
    faces share, the stencil ``(edge a, edge b, flap 0, flap 1)``."""
    keys, opp = [], []
    for k in range(3):
        e = np.sort(np.stack([faces[:, k], faces[:, (k + 1) % 3]], 1), 1)
        keys.append(e)
        opp.append(faces[:, (k + 2) % 3])
    keys, opp = np.concatenate(keys), np.concatenate(opp)
    edges, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                       return_counts=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(inverse, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    shared = np.nonzero(counts == 2)[0]
    first = order[starts[shared]]
    second = order[starts[shared] + 1]
    stencils = np.stack([edges[shared, 0], edges[shared, 1], opp[first],
                         opp[second]], 1)
    return edges, stencils


def bending_factor(p: np.ndarray) -> np.ndarray:
    """``S (C, 4)`` with the isometric bending Hessian ``Q = −S Sᵀ``
    (``XPBD.cpp:112-150``: ``Q = coef·K Kᵀ``, ``coef = −3/(2(A₀+A₁))``),
    float64, for stencils ``p (C, 4, 3)`` ordered (edge a, edge b, flap 0,
    flap 1)."""
    x0, x1, x2, x3 = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    e0, e1, e2, e3, e4 = x1 - x0, x2 - x0, x3 - x0, x2 - x1, x3 - x1

    def cot(u, v):
        return (u * v).sum(-1) / np.linalg.norm(np.cross(u, v), axis=-1)

    c01, c02, c03, c04 = cot(e0, e1), cot(e0, e2), cot(-e0, e3), cot(-e0, e4)
    area = 0.5 * (np.linalg.norm(np.cross(e0, e1), axis=-1)
                  + np.linalg.norm(np.cross(e0, e2), axis=-1))
    k = np.stack([c03 + c04, c01 + c02, -c01 - c03, -c02 - c04], 1)
    return np.sqrt(3.0 / (2.0 * area))[:, None] * k


def pinned(config: dict) -> list:
    return [int(i) for i in config["pinned"]]


def handle(config: dict) -> list:
    return [int(i) for i in config["mpc"]["handle"]]


def tracked(config: dict) -> list:
    return [int(i) for i in config["mpc"]["tracked"]]


class Cloth(Scene):
    """The configuration's cloth in ``dtype`` on ``device``."""

    def __init__(self, config: dict, device="cpu", dtype=torch.float32):
        x0 = points(config)
        n = len(x0)
        inv_mass = np.ones(n)
        inv_mass[pinned(config)] = 0.0
        super().__init__(config, x0, inv_mass, device, dtype)
        rest = x0.astype(np.float64)
        edges, stencils = edges_and_stencils(triangles(config))
        h2 = self.h * self.h
        self.ea, self.eb = (torch.as_tensor(edges[:, k], device=self.device)
                            for k in range(2))
        self.rest = self.tensor(np.linalg.norm(
            rest[edges[:, 0]] - rest[edges[:, 1]], axis=-1))
        self.alpha_d = 1.0 / (float(config["distance"]["stiffness"]) * h2)
        self.icd = self.tensor(inv_counts(edges, n))[:, None]
        self.sten = [torch.as_tensor(stencils[:, k], device=self.device)
                     for k in range(4)]
        self.s = self.tensor(bending_factor(rest[stencils]))
        self.alpha_b = 1.0 / (float(config["bending"]["stiffness"]) * h2)
        self.icb = self.tensor(inv_counts(stencils, n))[:, None]
        # a rollout's gathered edges take 12 bytes an edge and component
        self.chunk = max(1, int(4e8 // (len(edges) * 12)))

    def init_lambda(self, lead):
        z = dict(dtype=self.dtype, device=self.device)
        return (torch.zeros(*lead, len(self.rest), **z),
                torch.zeros(*lead, len(self.s), **z))

    def project(self, x: Tensor, lams):
        lam_d, lam_b = lams
        w = self.inv_mass
        # distance: C = |a − b| − rest
        pa, pb = x.index_select(-2, self.ea), x.index_select(-2, self.eb)
        wa, wb = w[self.ea], w[self.eb]
        n = pa - pb
        d = torch.linalg.vector_norm(n, dim=-1)
        k = wa + wb + self.alpha_d
        ok = (d > 1e-6) & (k.abs() > 1e-6)
        dlam = torch.where(ok, -(d - self.rest + self.alpha_d * lam_d) / k,
                           torch.zeros_like(d))
        corr = n / torch.clamp_min(d, 1e-6)[..., None] * dlam[..., None]
        acc = torch.zeros_like(x)
        acc.index_add_(x.dim() - 2, self.ea, wa[:, None] * corr)
        acc.index_add_(x.dim() - 2, self.eb, -wb[:, None] * corr)
        x = x + self.icd * acc
        # isometric bending: C = −½|t|², t = Σ Sⱼxⱼ, ∇ⱼC = −Sⱼ t
        ps = [x.index_select(-2, i) for i in self.sten]
        ws = [w[i] for i in self.sten]
        t = sum(self.s[:, j, None] * ps[j] for j in range(4))
        t2 = (t * t).sum(-1)
        kk = sum(ws[j] * self.s[:, j] ** 2 for j in range(4)) * t2 \
            + self.alpha_b
        ok = kk.abs() > 1e-9
        dlam_b = torch.where(ok, -(-0.5 * t2 + self.alpha_b * lam_b)
                             / torch.where(ok, kk, torch.ones_like(kk)),
                             torch.zeros_like(kk))
        acc = torch.zeros_like(x)
        for j in range(4):
            acc.index_add_(x.dim() - 2, self.sten[j],
                           -(ws[j] * self.s[:, j])[:, None]
                           * dlam_b[..., None] * t)
        x = x + self.icb * acc
        return x, (lam_d + dlam, lam_b + dlam_b)


def scene(config: dict, device="cpu", dtype=torch.float32) -> Cloth:
    return Cloth(config, device, dtype)
