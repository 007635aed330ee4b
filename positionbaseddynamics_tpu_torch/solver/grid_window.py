"""The XPBD cloth stencil on a window of grid rows, in plain PyTorch.

One regular H×W cloth grid, seen through a window of its rows: the
window's row 0 is global row ``row0``, and every constraint mask and the
triangulation parity ``helper(i,j) = (i%2 == j%2)``
(``SimulationModel.cpp:831-903``) come from the global row index, so the
window knows where the cloth's real top and bottom edges are. The stencil
algebra is the TPU kernel's (``grid_cloth_pallas.py:106-131``: the same
families, anchors and parity blends), written on whole planes with
circular shifts; rows that wrap lie outside every valid anchor's reach.
Pinned particles and the Jacobi weights ``icd``/``icb`` are data.

Two users, two ways to fill the rows beyond the window:

* :func:`window_substeps_reference`, the plain version of the cloth
  kernel's row-window mode (``grid_cloth_cuda.make_cloth_step`` with
  ``height_override``, ``global_height`` and ``external_params``, the
  counterpart of ``grid_cloth_pallas.py:161, 221, 554``): the window lies
  in zero rows of zero inverse mass, as it lies in the kernel's zero
  margins;
* ``parallel/intra_grid.py``: a rank's row block, whose one row above and
  below comes from its neighbours before every family pass, and whose
  halo rows' corrections go back to them (``intra_grid.py:152-170``).

Planes are ``(..., rows, W, k)``; any leading rollout shape broadcasts.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.mathutils import sqrt_rn
from .grid_cloth import _sum3

Tensor = torch.Tensor

# Stencil tables (grid_cloth_pallas.py:106-131). A blend is a list of
# (weight, (di, dj)): the point is the sum of weight * x[i+di, j+dj], the
# weight "p" (the parity), "q" (1 - parity) or "1".
DIST = {
    "h": {"mask": ("i<=H-1", "j<=W-2"),
          "a": [("1", (0, 0))], "b": [("1", (0, 1))]},
    "v": {"mask": ("i<=H-2", "j<=W-1"),
          "a": [("1", (0, 0))], "b": [("1", (1, 0))]},
    "d": {"mask": ("i<=H-2", "j<=W-2"),
          "a": [("p", (0, 0)), ("q", (0, 1))],
          "b": [("p", (1, 1)), ("q", (1, 0))]},
}
# bending points in the S-vector order [a, b, f0, f1]
BEND = {
    "bh": {"mask": ("1<=i<=H-2", "j<=W-2"),
           "pts": [[("1", (0, 0))], [("1", (0, 1))],
                   [("p", (1, 1)), ("q", (1, 0))],
                   [("p", (-1, 1)), ("q", (-1, 0))]]},
    "bv": {"mask": ("i<=H-2", "1<=j<=W-2"),
           "pts": [[("1", (0, 0))], [("1", (1, 0))],
                   [("p", (1, 1)), ("q", (0, 1))],
                   [("p", (1, -1)), ("q", (0, -1))]]},
    "bd": {"mask": ("i<=H-2", "j<=W-2"),
           "pts": [[("p", (0, 0)), ("q", (0, 1))],
                   [("p", (1, 1)), ("q", (1, 0))],
                   [("p", (0, 1)), ("q", (0, 0))],
                   [("p", (1, 0)), ("q", (1, 1))]]},
}


def _shift(p: Tensor, di: int, dj: int) -> Tensor:
    """The plane whose (i, j) entry is ``p[i+di, j+dj]`` (circular)."""
    if di:
        p = torch.roll(p, -di, -3)
    if dj:
        p = torch.roll(p, -dj, -2)
    return p


def _scatter(acc: Tensor, c: Tensor, di: int, dj: int) -> Tensor:
    """``acc[i+di, j+dj] += c[i, j]`` (circular)."""
    if di:
        c = torch.roll(c, di, -3)
    if dj:
        c = torch.roll(c, dj, -2)
    return acc + c


def _row_mask(spec: str, gi: Tensor, h: int) -> Tensor:
    if spec == "i<=H-1":
        return (gi >= 0) & (gi <= h - 1)
    if spec == "i<=H-2":
        return (gi >= 0) & (gi <= h - 2)
    return (gi >= 1) & (gi <= h - 2)            # "1<=i<=H-2"


def _col_mask(spec: str, gj: Tensor, w: int) -> Tensor:
    if spec == "j<=W-1":
        return gj <= w - 1
    if spec == "j<=W-2":
        return gj <= w - 2
    return (gj >= 1) & (gj <= w - 2)            # "1<=j<=W-2"


class RowWindow:
    """The stencil of one row window: ``w_ext (rows, W, 1)`` the inverse
    masses of its extended rows, whose row 0 is global row ``row0`` of a
    grid of ``global_height`` rows; ``params`` the cloth kernel's scalars
    (``grid_cloth_cuda.kernel_params``: rest lengths, compliances, S
    vectors, substep, gravity, damping). With ``own = (lo, hi)`` only the
    anchors of global rows ``lo <= i < hi`` are solved (the rows a rank
    owns); ``omega`` scales the Jacobi sums. Everything that does not
    depend on positions (masks, parity, the inverse-mass gathers, the S
    planes) is computed here, once."""

    def __init__(self, params: np.ndarray, w_ext: Tensor, row0: int,
                 global_height: int, own: Optional[Tuple[int, int]] = None,
                 omega: float = 1.0):
        p = np.asarray(params, np.float32)
        dev = w_ext.device
        rows, width = w_ext.shape[-3], w_ext.shape[-2]
        self.rest = dict(zip(DIST, (float(v) for v in p[0:3])))
        self.alpha_d = dict(zip(DIST, (float(v) for v in p[3:6])))
        s_par = p[6:18].reshape(3, 4)
        s_npar = p[18:30].reshape(3, 4)
        self.alpha_b = dict(zip(BEND, (float(v) for v in p[30:33])))
        self.h = float(p[33])
        self.gravity = torch.tensor(p[34:37], device=dev)
        self.damp = float(p[37]) if p[38] else None
        self.omega = float(omega)
        gi = (torch.arange(rows, dtype=torch.int32, device=dev)
              + row0)[:, None, None]
        gj = torch.arange(width, dtype=torch.int32, device=dev)[None, :, None]
        par = ((gi & 1) == (gj & 1)).to(torch.float32)
        self.par, self.qar = par, 1.0 - par
        own_m = (True if own is None
                 else (gi >= own[0]) & (gi < own[1]))
        self.masks = {
            f: (_row_mask(spec["mask"][0], gi, global_height) & own_m
                & _col_mask(spec["mask"][1], gj, width)).to(torch.float32)
            for f, spec in list(DIST.items()) + list(BEND.items())}
        self.shape = (rows, width, 1)
        self.dist_w = {f: (self._blend(w_ext, spec["a"]),
                           self._blend(w_ext, spec["b"]))
                       for f, spec in DIST.items()}
        self.sv, self.ws4, self.w_s2 = {}, {}, {}
        for k, (f, spec) in enumerate(BEND.items()):
            sv = [par * float(se) + (1.0 - par) * float(so)
                  for se, so in zip(s_par[k], s_npar[k])]
            ws4 = [self._blend(w_ext, blend) for blend in spec["pts"]]
            self.sv[f], self.ws4[f] = sv, ws4
            self.w_s2[f] = sum(ws4[j] * sv[j] * sv[j] for j in range(4))

    def _blend(self, plane: Tensor, blend) -> Tensor:
        acc = None
        for wname, (di, dj) in blend:
            term = _shift(plane, di, dj)
            if wname == "p":
                term = term * self.par
            elif wname == "q":
                term = term * self.qar
            acc = term if acc is None else acc + term
        return acc

    def _blend_scatter(self, acc: Tensor, c: Tensor, blend) -> Tensor:
        for wname, (di, dj) in blend:
            term = (c if wname == "1"
                    else c * (self.par if wname == "p" else self.qar))
            acc = _scatter(acc, term, di, dj)
        return acc

    def distance(self, x_ext: Tensor, lams: dict) -> Tensor:
        """The correction sums of one Jacobi pass of the 3 distance
        families (``XPBD.cpp:14-60``) over the extended rows; ``lams``
        is updated in place."""
        acc = torch.zeros_like(x_ext)
        for fam, spec in DIST.items():
            wa, wb = self.dist_w[fam]
            alpha = self.alpha_d[fam]
            n = self._blend(x_ext, spec["a"]) - self._blend(x_ext, spec["b"])
            d = sqrt_rn(_sum3(n * n))
            c = d - self.rest[fam]
            k = wa + wb + alpha
            valid = (d > 1e-6) & (torch.abs(k) > 1e-6)
            dlam = torch.where(
                valid, -(c + alpha * lams[fam])
                / torch.where(valid, k, torch.ones_like(k)),
                torch.zeros_like(d)) * self.masks[fam]
            lams[fam] = lams[fam] + dlam
            pt = n * (dlam / torch.clamp_min(d, 1e-6))
            acc = self._blend_scatter(acc, wa * pt, spec["a"])
            acc = self._blend_scatter(acc, -wb * pt, spec["b"])
        return acc

    def bending(self, x_ext: Tensor, lams: dict) -> Tensor:
        """The correction sums of one Jacobi pass of the 3 rank-1
        isometric-bending families (``XPBD.cpp:153-213``:
        ``t = Σⱼ Sⱼxⱼ``, ``C = −½|t|²``, ``∇ⱼC = −Sⱼt``)."""
        acc = torch.zeros_like(x_ext)
        for fam, spec in BEND.items():
            sv, ws4, alpha = self.sv[fam], self.ws4[fam], self.alpha_b[fam]
            t = torch.zeros_like(x_ext)
            for j4, blend in enumerate(spec["pts"]):
                t = t + sv[j4] * self._blend(x_ext, blend)
            t2 = _sum3(t * t)
            energy = -0.5 * t2
            kk = self.w_s2[fam] * t2 + alpha
            valid = torch.abs(kk) > 1e-9
            dlam = torch.where(
                valid, -(energy + alpha * lams[fam])
                / torch.where(valid, kk, torch.ones_like(kk)),
                torch.zeros_like(kk)) * self.masks[fam]
            lams[fam] = lams[fam] + dlam
            dt_p = dlam * t
            for j4 in range(4):
                acc = self._blend_scatter(acc, -ws4[j4] * sv[j4] * dt_p,
                                          spec["pts"][j4])
        return acc

    def substep(self, x: Tensor, v: Tensor, w: Tensor, icd: Tensor,
                icb: Tensor, iterations: int,
                extend: Callable[[Tensor], Tensor],
                reduce: Callable[[Tensor], Tensor]):
        """One substep of the window's own rows ``x``, ``v`` ``(..., r, W,
        3)`` with ``w``, ``icd``, ``icb`` ``(r, W, 1)``: integrate, then
        ``iterations`` Jacobi passes, each family pass on ``extend(x)``
        (the rows with their halo) and its sums brought back by
        ``reduce``, then the first-order velocity update and damping."""
        old = x
        dyn = (w > 0.0).to(torch.float32)
        v = torch.where(w > 0.0, v + self.h * self.gravity, v)
        x = x + self.h * dyn * v
        lams = {f: torch.zeros(self.shape, dtype=torch.float32,
                               device=x.device) for f in self.masks}
        for _ in range(iterations):
            x = x + self.omega * icd * reduce(self.distance(extend(x), lams))
            x = x + self.omega * icb * reduce(self.bending(extend(x), lams))
        v = torch.where(w > 0.0, (x - old) / self.h, v)
        if self.damp is not None:
            v = v * self.damp
        return x, v


def pad_rows(a: Tensor) -> Tensor:
    """``(..., r, W, k)`` with one zero row above and below."""
    return F.pad(a, (0, 0, 0, 0, 1, 1))


def strip_rows(a: Tensor) -> Tensor:
    """The inverse of :func:`pad_rows`."""
    return a[..., 1:-1, :, :]


def window_substeps_reference(params: np.ndarray, x: Tensor, v: Tensor,
                              w: Tensor, icd: Tensor, icb: Tensor, *,
                              row_offset: int, global_height: int,
                              max_iterations: int = 1, n: int = 1):
    """The plain version of the cloth kernel's row-window mode: ``n``
    substeps of the window ``x``, ``v`` ``(..., r, W, 3)``, whose row 0 is
    global row ``row_offset`` of a grid of ``global_height`` rows, with
    ``w``, ``icd``, ``icb`` ``(r, W, 1)``; rows beyond the window are
    zeros of zero inverse mass. ``params`` from
    ``grid_cloth_cuda.kernel_params``. Returns ``(x, v)``."""
    win = RowWindow(params, pad_rows(w), row_offset - 1, global_height)
    for _ in range(n):
        x, v = win.substep(x, v, w, icd, icb, max_iterations, pad_rows,
                           strip_rows)
    return x, v
