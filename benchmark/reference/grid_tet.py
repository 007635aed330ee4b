"""Plain XPBD FEM solid of a regular tet bar (``Demos/BarDemo``): each hex
cell split into 5 tets, mirrored in odd cells so neighbours share faces
(``SimulationModel::addRegularTetModel``), the St. Venant–Kirchhoff
energy solved as one XPBD constraint a tet (method 3,
``XPBD.cpp:217-294``), one Jacobi pass an iteration averaged by each
vertex's tet count.

Written as gather, 3×3 products and ``index_add_`` over the tet list,
not as the program's corner stencils. λ accumulates the solve's ``Δλ``
as the JAX package and the program do; at one iteration a substep, as
every cell runs, λ is 0 in each solve and that choice has no effect.
"""
from __future__ import annotations

import numpy as np
import torch

from .xpbd import Scene, inv_counts

Tensor = torch.Tensor


def mm(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` of 3×3 matrices as a broadcast sum, which runs millions
    of them far faster than a batched GEMM does."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def points(config: dict) -> np.ndarray:
    """Rest positions ``(W·H·D, 3)`` in the order ``i·H·D + j·D + k``,
    the grid centred at the origin, as float32."""
    w, h, d = config["width"], config["height"], config["depth"]
    s = np.asarray(config["scale"], np.float64)
    i, j, k = np.meshgrid(np.arange(w), np.arange(h), np.arange(d),
                          indexing="ij")
    p = np.stack([i * s[0] / (w - 1), j * s[1] / (h - 1),
                  k * s[2] / (d - 1)], -1).reshape(-1, 3)
    return (p - 0.5 * s).astype(np.float32)


def tets(config: dict) -> np.ndarray:
    """``(5·cells, 4)`` vertex indices, 5 tets a cell."""
    w, h, d = config["width"], config["height"], config["depth"]
    i, j, k = np.meshgrid(np.arange(w - 1), np.arange(h - 1),
                          np.arange(d - 1), indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    hd = h * d
    c = [i * hd + j * d + k, i * hd + j * d + k + 1,
         (i + 1) * hd + j * d + k + 1, (i + 1) * hd + j * d + k,
         i * hd + (j + 1) * d + k, i * hd + (j + 1) * d + k + 1,
         (i + 1) * hd + (j + 1) * d + k + 1, (i + 1) * hd + (j + 1) * d + k]
    odd = [(2, 1, 6, 3), (6, 3, 4, 7), (4, 1, 6, 5), (3, 1, 4, 0),
           (6, 1, 4, 3)]
    even = [(0, 2, 5, 1), (7, 2, 0, 3), (5, 2, 7, 6), (7, 0, 5, 4),
            (0, 2, 7, 5)]

    def table(rows):
        return np.stack([np.stack([c[v] for v in r], 1) for r in rows], 1)

    is_odd = ((i + j + k) % 2 == 1)[:, None, None]
    return np.where(is_odd, table(odd), table(even)).reshape(-1, 4)


def pinned(config: dict) -> list:
    """The vertices of the ``i = 0`` face."""
    hd = config["height"] * config["depth"]
    return list(range(hd)) if config["pinned"] == "i0_face" else []


def handle(config: dict) -> list:
    h = config["mpc"]["handle"]
    return pinned(config) if h == "pinned" else [int(i) for i in h]


def tracked(config: dict) -> list:
    return [int(i) for i in config["mpc"]["tracked"]]


class Bar(Scene):
    """The configuration's bar in ``dtype`` on ``device``."""

    def __init__(self, config: dict, device="cpu", dtype=torch.float32):
        x0 = points(config)
        n = len(x0)
        inv_mass = np.ones(n)
        inv_mass[pinned(config)] = 0.0
        super().__init__(config, x0, inv_mass, device, dtype)
        t = tets(config)
        p = x0.astype(np.float64)[t]                       # (T, 4, 3)
        dm = np.stack([p[:, 0] - p[:, 3], p[:, 1] - p[:, 3],
                       p[:, 2] - p[:, 3]], -1)             # columns
        vol = np.abs((np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
                      * (p[:, 3] - p[:, 0])).sum(-1)) / 6.0
        self.tets = torch.as_tensor(t.reshape(-1), device=self.device)
        self.n_tets = len(t)
        self.dm_inv = self.tensor(np.linalg.inv(dm))
        self.vol = self.tensor(vol)
        self.ic = self.tensor(inv_counts(t, n))[:, None]
        self.w4 = self.inv_mass[self.tets].reshape(-1, 4)
        fem = config["solid"]
        nu, e = float(fem["poisson_ratio"]), float(fem["stiffness"])
        self.mu = 0.5 / (1.0 + nu)
        self.lame = nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        self.alpha = 1.0 / (e * self.h * self.h) if e > 0 else 0.0
        self.stiff = e > 0
        self.eye = torch.eye(3, dtype=self.dtype, device=self.device)
        # a rollout's (T, 3, 3, 3) product takes 108 bytes a tet
        self.chunk = max(1, int(1e9 // (self.n_tets * 108)))

    def init_lambda(self, lead):
        return torch.zeros(*lead, self.n_tets, dtype=self.dtype,
                           device=self.device)

    def project(self, x: Tensor, lam):
        lead = x.shape[:-2]
        p = x.index_select(-2, self.tets).reshape(*lead, self.n_tets, 4, 3)
        ds = (p[..., :3, :] - p[..., 3:, :]).transpose(-1, -2)
        f = mm(ds, self.dm_inv)                            # D_s D_m⁻¹
        eps = 0.5 * (mm(f.transpose(-1, -2), f) - self.eye)  # Green strain
        tr = eps.diagonal(dim1=-2, dim2=-1).sum(-1)
        stress = mm(f, 2.0 * self.mu * eps
                    + self.lame * tr[..., None, None] * self.eye)
        psi = self.mu * (eps * eps).sum((-1, -2)) + 0.5 * self.lame * tr * tr
        energy = self.vol * psi
        grad = self.vol[:, None, None] * mm(
            stress, self.dm_inv.transpose(-1, -2))         # columns ∇₀..∇₂
        g = torch.cat([grad, -grad.sum(-1, keepdim=True)], -1)  # (.., 3, 4)
        c = torch.sqrt(torch.clamp_min(2.0 * energy, 0.0))
        s = (self.w4 * (g * g).sum(-2)).sum(-1) + c * c * self.alpha
        ok = (s >= 1e-6) & self.stiff
        dlam = torch.where(ok, -c * (c + self.alpha * lam)
                           / torch.where(ok, s, torch.ones_like(s)),
                           torch.zeros_like(s))
        corr = (dlam[..., None, None] * self.w4[:, None, :] * g)
        corr = corr.transpose(-1, -2).reshape(*lead, -1, 3)
        acc = torch.zeros_like(x).index_add_(x.dim() - 2, self.tets, corr)
        return x + self.ic * acc, lam + dlam


def scene(config: dict, device="cpu", dtype=torch.float32) -> Bar:
    return Bar(config, device, dtype)
