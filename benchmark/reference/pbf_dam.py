"""Plain position-based fluids of FluidDemo's breaking dam
(``Demos/FluidDemo``: ``TimeStepFluidModel.cpp:21-68``,
``PositionBasedFluids.cpp``, ``FluidModel.cpp:110-149``, the cubic kernel
of ``SPHKernels.h``), worked out from the configuration alone.

One step, as ``TimeStepFluidModel::step`` runs it:

1. the CFL step from the carried one, ``h = 0.4·diam / √max(0.1,
   max‖v + g·h_prev‖²)`` clamped to ``[min_dt, max_dt]``;
2. semi-implicit Euler, ``v += h·g``, ``x += h·v``;
3. one neighbourhood search on the predicted positions: every fluid pair
   and every fluid–boundary pair closer than the support ``4r``. The pair
   set is frozen for the step, as upstream's ``neighborhoodSearch`` runs
   once a step;
4. ``iterations`` density projections, all corrections of a pass applied
   together: ``ρᵢ = mᵢW(0) + Σ_f mⱼW(xᵢ−xⱼ) + Σ_b ψ_b W(xᵢ−x_b)``,
   ``C = max(ρ/ρ₀ − 1, 0)``, ``λᵢ = −C / (Σⱼ‖∇ⱼC‖² + ‖∇ᵢC‖² + ε)``,
   ``Δxᵢ = −Σ_f (λᵢ+λⱼ)∇ⱼC − Σ_b λᵢ∇_bC`` with ``∇ⱼC = −(wⱼ/ρ₀)∇W(xᵢ−xⱼ)``,
   ``wⱼ`` a fluid mass or a boundary ψ;
5. ``v = (x − old_x)/h``;
6. XSPH, ``vᵢ −= ν Σ_f (mⱼ/ρⱼ)(vᵢ − vⱼ)W(xᵢ−xⱼ)``, ``ρⱼ`` the last
   projection's densities.

Akinci's boundary weights ``ψ_b = ρ₀ / (W(0) + Σ W(x_b − x_b'))`` over
the boundary particles alone are worked out here. The search sorts each
set of particles by its cell key (the cell of side ``4r``, each axis's
cells ranked among those in use, exact wherever a particle flies) and
takes, for each particle, the 27 cells around its own; it has no cap on
a cell or on a particle's neighbours, and runs in blocks of particles.
Sums over a particle's neighbours are taken row by row in a padded table,
so the reference gives the same bits on every run. No step uses a matrix product, so TF32 never
applies.

Departures, each where upstream is undefined or the difference cannot
show:

* XSPH takes every velocity from before the pass (Jacobi). Upstream
  updates ``vᵢ`` in place inside an OpenMP loop, whose result depends on
  the order of its threads. Its pair set is the step's one set, frozen
  before the projection, as upstream's single search a step gives it and
  as the program takes it; the JAX package's TPU route freezes XSPH's set
  after the projection.
* ``ρⱼ`` in XSPH is read as ``max(ρⱼ, 1e-6)``. A fluid particle's density
  is at least ``m·W(0)``, so the guard never binds.
* The boundary is one layer of particles on the faces of the
  configuration's box, laid out on each axis by ``linspace`` at about one
  spacing (FluidDemo samples each wall of its own container); it is an
  input that both sides are given, made here from the configuration.
"""
from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

EPS = 1.0e-6                 # PBF's λ regulariser (PositionBasedFluids.cpp)
CFL_FACTOR = 0.4             # TimeStepFluidModel::updateTimeStepSizeCFL
MIN_SPEED2 = 0.1             # the CFL's floor on max‖v‖²
SEARCH_BLOCK = 1 << 14       # particles a block of the neighbourhood search

OFFSETS = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
           for c in (-1, 0, 1)]


def diameter(config: dict) -> float:
    return 2.0 * float(config["particle_radius"])


def support(config: dict) -> float:
    return float(config["support_factor"]) * float(config["particle_radius"])


def box_hi(config: dict) -> np.ndarray:
    """The box's far corner, float64; it spans from the origin."""
    return np.asarray(config["box_spacings"], np.float64) * diameter(config)


def fluid_points(config: dict, dtype=np.float32) -> np.ndarray:
    """The block of fluid ``(nx·ny·nz, 3)`` in ``dtype``, at one spacing
    ``diam`` from ``block_origin_spacings`` spacings, in the order
    ``(i·ny + j)·nz + k``."""
    d = diameter(config)
    lo = np.asarray(config["block_origin_spacings"], np.float64) * d
    ax = [np.arange(n) * d + l for n, l in zip(config["block"], lo)]
    g = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)
    return g.astype(dtype)


def boundary_points(config: dict, dtype=np.float32) -> np.ndarray:
    """One layer of boundary particles on the box's faces in ``dtype``: the
    points of a grid of ``⌊extent/diam⌋ + 1`` evenly spaced points an axis
    that lie within one spacing of a face, in the grid's order."""
    d = diameter(config)
    hi = box_hi(config)
    n = np.maximum((hi / d).astype(int) + 1, 2)
    ax = [np.linspace(0.0, hi[a], n[a]) for a in range(3)]
    g = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)
    rel = g / hi
    eps = d / hi
    shell = ((rel <= eps) | (rel >= 1.0 - eps)).any(axis=1)
    return g[shell].astype(dtype)


def pairs(xq: Tensor, xs: Tensor, h: float, same: bool,
          block: int = SEARCH_BLOCK):
    """Every pair ``(i, j)`` with ``‖xq[i] − xs[j]‖² < h²`` (and ``i ≠ j``
    where ``same``: ``xq`` and ``xs`` are one set), as two int64 vectors,
    ``i`` ascending. No cap: each particle's 27 cells are read whole. A
    cell is ``⌊x/h⌋`` in float64, each axis's cells numbered by their rank
    among the cells in use, so that the key is exact however far particles
    fly; a particle with a coordinate that is not finite has no pair."""
    dev = xq.device
    okq = torch.isfinite(xq).all(1).nonzero()[:, 0]
    oks = torch.isfinite(xs).all(1).nonzero()[:, 0]
    cq = torch.floor(xq[okq].double() / h).to(torch.int64)
    cs = torch.floor(xs[oks].double() / h).to(torch.int64)
    axes = [torch.unique(torch.cat([cq[:, a] - 1, cq[:, a], cq[:, a] + 1,
                                    cs[:, a]])) for a in range(3)]
    dims = [len(v) for v in axes]

    def key(c):
        r = [torch.searchsorted(axes[a], c[..., a].contiguous())
             for a in range(3)]
        return (r[0] * dims[1] + r[1]) * dims[2] + r[2]

    skey, order = torch.sort(key(cs), stable=True)
    order = oks[order]
    offs = torch.tensor(OFFSETS, dtype=torch.int64, device=dev)
    hh = h * h
    out_i, out_j = [], []
    for s in range(0, len(okq), block):
        k = key(cq[s:s + block, None, :] + offs).contiguous()  # (b, 27)
        start = torch.searchsorted(skey, k)
        count = (torch.searchsorted(skey, k, right=True) - start).reshape(-1)
        rows = torch.repeat_interleave(
            torch.arange(count.numel(), device=dev), count)
        first = torch.cumsum(count, 0) - count
        pos = start.reshape(-1)[rows] + (torch.arange(len(rows), device=dev)
                                         - first[rows])
        i, j = okq[rows // 27 + s], order[pos]
        d = xq[i] - xs[j]
        r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        keep = r2 < hh
        if same:
            keep &= i != j
        out_i.append(i[keep])
        out_j.append(j[keep])
    return torch.cat(out_i), torch.cat(out_j)


class Rows:
    """The first indices ``i`` (ascending) of a pair list, laid out to sum
    a value of each pair over each ``i`` in a fixed order: each pair's
    place in a padded ``(n, width)`` table."""

    def __init__(self, i: Tensor, n: int):
        self.i, self.n = i, n
        cnt = torch.bincount(i, minlength=n)
        self.width = int(cnt.max()) if len(i) else 0
        first = torch.cumsum(cnt, 0) - cnt
        self.rank = torch.arange(len(i), device=i.device) - first[i]

    def sum(self, vals: Tensor) -> Tensor:
        """``Σ_{pairs of i} vals`` for each of the ``n`` rows; ``vals``
        ``(P,)`` or ``(P, 3)``."""
        t = vals.new_zeros((self.n, self.width) + vals.shape[1:])
        t[self.i, self.rank] = vals
        return t.sum(1)


class Dam:
    """The configuration's dam in ``dtype`` on ``device``: the rest block
    ``x0``, the boundary ``xb`` and its ψ, the step's constants."""

    def __init__(self, config: dict, device="cpu", dtype=torch.float32):
        st = config["step"]
        self.device, self.dtype = torch.device(device), dtype
        self.diam = diameter(config)
        self.h = support(config)
        self.rho0 = float(config["density0"])
        self.nu = float(config["viscosity"])
        self.iterations = int(st["max_iterations"])
        self.min_dt, self.max_dt = float(st["min_dt"]), float(st["max_dt"])
        self.dt0 = self.tensor(float(st["dt"]))
        self.gravity = self.tensor(np.asarray(st["gravity"], np.float64))
        self.x0 = self.tensor(fluid_points(config))
        self.xb = self.tensor(boundary_points(config))
        # FluidModel::initMasses: 0.8·diam³·ρ₀ a particle
        self.mass = 0.8 * self.diam ** 3 * self.rho0
        self.k = 8.0 / (math.pi * self.h ** 3)
        self.l = 48.0 / (math.pi * self.h ** 3)
        self.w0 = self.k
        bi, bj = pairs(self.xb, self.xb, self.h, same=True)
        wsum = Rows(bi, len(self.xb)).sum(
            self.w(self.xb[bi] - self.xb[bj]))
        self.psi = self.rho0 / (self.w0 + wsum)

    def tensor(self, a) -> Tensor:
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=self.device, dtype=self.dtype)

    def w(self, d: Tensor) -> Tensor:
        """The cubic kernel ``W`` of displacements ``(P, 3)``."""
        q = _norm(d) / self.h
        near = self.k * (6.0 * q * q * q - 6.0 * q * q + 1.0)
        far = self.k * 2.0 * (1.0 - q) ** 3
        return torch.where(q <= 0.5, near,
                           torch.where(q <= 1.0, far, torch.zeros_like(q)))

    def grad_w(self, d: Tensor) -> Tensor:
        """``∇W`` of displacements ``(P, 3)``: 0 at ``r ≤ 1e-6`` and past
        the support."""
        r = _norm(d)
        q = r / self.h
        near = self.l * q * (3.0 * q - 2.0)
        far = -self.l * (1.0 - q) * (1.0 - q)
        c = torch.where(q <= 0.5, near, far) / torch.clamp_min(r * self.h,
                                                                1e-30)
        c = torch.where((r > 1e-6) & (q <= 1.0), c, torch.zeros_like(c))
        return c[:, None] * d

    def cfl(self, v: Tensor, dt: Tensor) -> Tensor:
        u = v + self.gravity * dt
        vel2 = u[:, 0] * u[:, 0] + u[:, 1] * u[:, 1] + u[:, 2] * u[:, 2]
        top = torch.clamp_min(vel2.max(), MIN_SPEED2)
        return torch.clamp(CFL_FACTOR * self.diam / torch.sqrt(top),
                           self.min_dt, self.max_dt)

    def step(self, x: Tensor, v: Tensor, dt: Tensor):
        """One step from ``(x, v)`` and the carried ``dt``. Returns ``(x,
        v, dt, old_x)``, ``old_x`` the positions the step started from."""
        old = x
        h = self.cfl(v, dt)
        v = v + h * self.gravity
        x = x + h * v
        n = len(x)
        fi, fj = pairs(x, x, self.h, same=True)
        bi, bj = pairs(x, self.xb, self.h, same=False)
        rf, rb = Rows(fi, n), Rows(bi, n)
        psi = self.psi[bj]
        rho = None
        for _ in range(self.iterations):
            df, db = x[fi] - x[fj], x[bi] - self.xb[bj]
            rho = (self.mass * self.w0 + rf.sum(self.mass * self.w(df))
                   + rb.sum(psi * self.w(db)))
            gf = -(self.mass / self.rho0) * self.grad_w(df)
            gb = -(psi / self.rho0)[:, None] * self.grad_w(db)
            sum2 = rf.sum(_sq(gf)) + rb.sum(_sq(gb))
            gi = -(rf.sum(gf) + rb.sum(gb))
            sum2 = sum2 + _sq(gi)
            c = torch.clamp_min(rho / self.rho0 - 1.0, 0.0)
            lam = torch.where(c > 0.0, -c / (sum2 + EPS),
                              torch.zeros_like(c))
            corr = -(rf.sum((lam[fi] + lam[fj])[:, None] * gf)
                     + rb.sum(lam[bi][:, None] * gb))
            x = x + corr
        v = (x - old) / h
        wf = self.w(x[fi] - x[fj])
        coef = self.mass / torch.clamp_min(rho[fj], 1e-6) * wf
        v = v - self.nu * rf.sum(coef[:, None] * (v[fi] - v[fj]))
        return x, v, h, old

    def frame(self, inputs: dict, start: bool, steps: int) -> dict:
        """``steps`` steps from a saved frame's inputs (``x``, ``v``,
        ``old_x``, ``dt``), or at the first frame from the rest block and
        the configuration's first ``dt`` with the saved ``v``; the outputs
        under the program's field names, ``overflow`` 0 (no cap here)."""
        def take(name):
            return inputs[name].to(self.device, self.dtype)

        x = self.x0 if start else take("x")
        dt = self.dt0 if start else take("dt")
        v = take("v")
        olds = [self.x0 if start else take("old_x")]
        for _ in range(steps):
            x, v, dt, old = self.step(x, v, dt)
            olds.append(old)
        return {"x": x, "v": v, "old_x": olds[-1], "last_x": olds[-2],
                "dt": dt, "overflow": torch.zeros((), device=self.device)}

    @staticmethod
    def numbers(out: dict, ref: dict) -> dict:
        """The number this kind adds to a frame's: ``overflow``, the
        program's count of the particles or cells its caps dropped, a
        running maximum since the window's start, whose limit is 0. The
        carried ``dt`` is not compared by itself: it follows the fastest
        particle alone, whose speed float32 rounding moves by some tenths
        of a percent, and the bfloat16 control's step lands as near on
        some seeds; a wrong step shows in the positions it moves
        (``mean_gap_m``)."""
        return {"overflow": float(out["overflow"])}


def _norm(d: Tensor) -> Tensor:
    return torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                      + d[:, 2] * d[:, 2])


def _sq(g: Tensor) -> Tensor:
    return g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2]


def scene(config: dict, device="cpu", dtype=torch.float32) -> Dam:
    return Dam(config, device, dtype)
