"""Cell-dense PBF pipeline — the counterpart of
``positionbaseddynamics_tpu/fluids/cellgrid.py``.

Once per step the fluid particles are sorted by cell id on a static
domain grid (cell = support radius) into a dense ``(n_cells, cap)`` slot
table, the occupied cells are compacted into a fixed-capacity active list,
and each active cell reads its 27 neighbor cells' rows. Pair sets are
frozen per step from the pre-projection positions (the reference's
once-per-step neighborhood, ``TimeStepFluidModel.cpp:30-38``). Boundary
particles are static: their per-cell tables and ψ weights are baked once
at scene build.

Layout: the position and velocity tables are one contiguous ``(3,
n_cells, cap)`` tensor each (the JAX package keeps a tuple of three
``(n_cells, cap)`` planes; ``xt[c]`` reads the same plane in both). The
boundary positions are ``(3, n_cells, capb)`` likewise.

The plain passes (:func:`density_lambda_reference`,
:func:`corrections_reference`, :func:`xsph_reference`) are the plain
versions of the CUDA kernels in ``cellgrid_cuda.py``; :func:`pbf_iterations`
and :func:`xsph_cell` are composed from them, so the math exists once. All
take an optional ``chunk``: the active cells are then processed ``chunk``
rows at a time, which bounds the ``(chunk, cap, 27·cap)`` pair planes and
leaves every cell's sums unchanged.

:func:`build_fluid_tables` never syncs the host: no ``.item()``, no
boolean indexing. JAX's ``.at[...].set(mode="drop")`` becomes a write into
one spare slot past the end that is then sliced off.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from . import sph

Tensor = torch.Tensor

EPS = 1.0e-6                    # λ denominator regulariser (PBF ε)

_OFFS = np.array([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dz in (-1, 0, 1)], np.int32)


def occupied_count(table: Tensor) -> Tensor:
    """Per-cell length of the occupied slot prefix of a ``(n_cells, cap)``
    mass or ψ table, int32: one past the last slot holding a value > 0.
    Packing by rank fills each cell's slots from 0, so every slot at or
    beyond the count is empty, and a pass that walks only the prefix sees
    every pair the plain version counts."""
    cap = table.shape[-1]
    ranks = torch.arange(1, cap + 1, dtype=torch.int32, device=table.device)
    return torch.amax((table > 0.0).to(torch.int32) * ranks,
                      dim=-1).to(torch.int32).contiguous()


@dataclass(frozen=True)
class BoundaryTables:
    """Static boundary-particle cell tables (compact; baked per scene)."""

    xt: Tensor          # (3, n_cells, capb) positions
    psit: Tensor        # (n_cells, capb) ψ weights, 0 on empty slots
    capb: int
    # (n_cells,) bool: the cell has a boundary particle in its
    # 27-neighborhood; near_frac is its mean (used by the occupancy
    # classes of a later slice)
    near: Optional[Tensor] = None
    near_frac: float = 1.0
    count: Optional[Tensor] = None    # (n_cells,) int32 occupied prefix

    def __post_init__(self):
        if self.count is None:
            object.__setattr__(self, "count", occupied_count(self.psit))

    def to(self, device) -> "BoundaryTables":
        return dataclasses.replace(
            self, xt=self.xt.to(device), psit=self.psit.to(device),
            near=None if self.near is None else self.near.to(device),
            count=self.count.to(device))


@dataclass(frozen=True)
class CellGridSpec:
    """Static fluid cell grid over a bounded domain."""

    origin: tuple
    dims: tuple           # (ncx, ncy, ncz)
    cell: float           # = support radius
    cap: int
    max_active: int
    boundary: Optional[BoundaryTables] = None

    @property
    def n_cells(self) -> int:
        ncx, ncy, ncz = self.dims
        return ncx * ncy * ncz

    def to(self, device) -> "CellGridSpec":
        return dataclasses.replace(
            self, boundary=None if self.boundary is None
            else self.boundary.to(device))

    @staticmethod
    def create(lo, hi, support, cap=12, boundary_x=None, boundary_psi=None,
               max_active=None, n_fluid_hint=None, device=None):
        """As the JAX ``CellGridSpec.create``, in numpy; the boundary
        tables are then copied to ``device`` (None means CUDA; without
        CUDA the call raises unless ``device="cpu"``). ``max_active``
        defaults to
        ``n_fluid/6`` (at least 512): valid for settled or pouring
        liquids. Occupied cells beyond it lose their interactions for the
        step and are counted in ``FluidState.overflow``, which every drive
        must check is 0."""
        device = resolve_device(device)
        lo = np.asarray(lo, np.float64) - support
        hi = np.asarray(hi, np.float64) + support
        dims = tuple(int(v) for v in
                     np.maximum(np.ceil((hi - lo) / support), 1))
        n_cells = int(np.prod(dims))
        if max_active is None:
            hint = n_fluid_hint if n_fluid_hint else n_cells
            max_active = int(min(n_cells, max(hint // 6, 512)))
        spec = CellGridSpec(origin=tuple(float(v) for v in lo),
                            dims=dims, cell=float(support), cap=int(cap),
                            max_active=max_active)
        if boundary_x is not None and len(boundary_x):
            bx = np.asarray(boundary_x, np.float64)
            cell = np.clip(((bx - lo) / support).astype(np.int64), 0,
                           np.asarray(dims) - 1)
            cid = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
            counts = np.bincount(cid, minlength=n_cells)
            capb = int(counts.max())
            order = np.argsort(cid, kind="stable")
            rank = np.arange(len(bx)) - (np.cumsum(counts)
                                         - counts)[cid[order]]
            slot = cid[order] * capb + rank
            xt = np.zeros((n_cells * capb, 3), np.float32)
            pt = np.zeros((n_cells * capb,), np.float32)
            xt[slot] = bx[order]
            pt[slot] = np.asarray(boundary_psi, np.float32)[order]
            # static boundary-adjacency (27-cell dilation of occupancy)
            occ = (pt.reshape(n_cells, capb) > 0).any(-1).reshape(dims)
            near = np.zeros(dims, bool)
            for d in _OFFS:
                dst = tuple(slice(max(-o, 0), n + min(-o, 0))
                            for o, n in zip(d, dims))
                src = tuple(slice(max(o, 0), n + min(o, 0))
                            for o, n in zip(d, dims))
                near[dst] |= occ[src]
            spec = dataclasses.replace(spec, boundary=boundary_tables(
                xt.T.reshape(3, n_cells, capb), pt.reshape(n_cells, capb),
                capb, near.reshape(-1), float(near.mean()), device))
        return spec


def boundary_tables(xt, psit, capb, near, near_frac, device
                    ) -> BoundaryTables:
    """``BoundaryTables`` from numpy arrays: ``xt`` ``(3, n_cells, capb)``
    (or a sequence of three ``(n_cells, capb)`` planes), ``psit``
    ``(n_cells, capb)``, ``near`` ``(n_cells,)``."""
    xt = np.ascontiguousarray(np.stack([np.asarray(p, np.float32)
                                        for p in xt]))
    return BoundaryTables(
        xt=torch.tensor(xt, device=device),
        psit=torch.tensor(np.asarray(psit, np.float32), device=device),
        capb=int(capb),
        near=None if near is None else torch.tensor(
            np.asarray(near, bool), device=device),
        near_frac=float(near_frac))


def scatter_planes(values: Tensor, slot: Tensor, kept: Tensor, nslots: int,
                   shape) -> Tensor:
    """Write per-particle ``values (N, 3)`` into zeroed component planes
    ``(3,) + shape`` at ``slot`` where ``kept``; the rest go to one spare
    element past the end, which is sliced off."""
    n = values.shape[0]
    dev = values.device
    planes = torch.arange(3, device=dev)[:, None] * nslots
    target = torch.where(kept[None, :], slot.to(torch.int64)[None, :]
                         + planes, 3 * nslots)
    flat = torch.zeros(3 * nslots + 1, dtype=values.dtype, device=dev)
    flat[target.reshape(-1)] = values.t().reshape(3 * n)
    return flat[:3 * nslots].view((3,) + tuple(shape))


def build_fluid_tables(spec: CellGridSpec, x: Tensor, mass: Tensor):
    """Sort fluid particles into cell slots and compact occupied cells.

    Returns ``(slot (N,) int32, kept (N,) bool, xt (3, n_cells, cap),
    mt (n_cells, cap), active (K,) int32, nbr (K, 27) int32, nbr_ok (K,
    27) bool, overflow)``. ``overflow`` (0-d int64) counts particles
    crowded out by ``cap`` plus occupied cells beyond ``max_active``.

    The sort by cell id is stable, as JAX's ``lax.sort_key_val``, so the
    slot layout, ``active``, ``nbr`` and ``nbr_ok`` equal the JAX
    package's."""
    n = x.shape[0]
    dev = x.device
    dims = spec.dims
    cap = spec.cap
    n_cells = spec.n_cells
    nslots = n_cells * cap
    i32 = torch.int32
    origin, size, dimt, offs = _grid_consts(spec.origin, spec.cell, dims,
                                            dev)
    cell = torch.floor((x - origin) / size).to(i32)
    cell = torch.minimum(torch.clamp_min(cell, 0), dimt - 1)
    cid = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    cid_s, order = torch.sort(cid, stable=True)
    first = torch.searchsorted(cid_s, cid_s, side="left")
    rank = torch.arange(n, device=dev) - first
    keep_s = rank < cap
    over_slots = torch.sum(~keep_s)
    slot_s = torch.where(keep_s, cid_s.to(torch.int64) * cap + rank,
                         nslots)

    xt = scatter_planes(x[order], slot_s, keep_s, nslots, (n_cells, cap))
    mflat = torch.zeros(nslots + 1, dtype=torch.float32, device=dev)
    mflat[slot_s] = mass[order]
    mt = mflat[:nslots].view(n_cells, cap)
    slot = torch.empty(n, dtype=i32, device=dev)
    slot[order] = torch.clamp_max(slot_s, nslots - 1).to(i32)
    kept = torch.empty(n, dtype=torch.bool, device=dev)
    kept[order] = keep_s

    # active-cell compaction: occupied cells first, in cell order
    occupied = torch.any(mt > 0.0, dim=-1)
    bits = max(n_cells - 1, 1).bit_length()
    assert bits + 1 <= 31, "cell count exceeds int32 packing"
    packed = (torch.where(occupied, 0, 1 << bits).to(i32)
              + torch.arange(n_cells, dtype=i32, device=dev))
    active = (torch.sort(packed).values[:spec.max_active]
              & ((1 << bits) - 1)).to(i32)                   # (K,)
    n_occ = torch.sum(occupied)
    overflow = over_slots + torch.clamp_min(n_occ - spec.max_active, 0)
    act_occ = occupied[active]

    # 27 neighbor cell ids per active cell (+ in-domain validity)
    az = active // (dims[1] * dims[2])
    rem = active - az * (dims[1] * dims[2])
    ay = rem // dims[2]
    ax_ = rem - ay * dims[2]
    nx = az[:, None] + offs[None, :, 0]
    ny = ay[:, None] + offs[None, :, 1]
    nz = ax_[:, None] + offs[None, :, 2]
    nbr_ok = ((nx >= 0) & (nx < dims[0]) & (ny >= 0) & (ny < dims[1])
              & (nz >= 0) & (nz < dims[2]) & act_occ[:, None])
    nbr = ((nx.clamp(0, dims[0] - 1) * dims[1]
            + ny.clamp(0, dims[1] - 1)) * dims[2]
           + nz.clamp(0, dims[2] - 1)).to(i32)
    return (slot, kept, xt, mt, active, nbr.contiguous(),
            nbr_ok.contiguous(), overflow)


@functools.lru_cache(maxsize=16)
def _grid_consts(origin, cell, dims, device):
    """The grid's constants as device tensors, made once per grid and
    device: a copy from the host at every step would sync it. The cell
    size is a 0-d device tensor so that CUDA divides by it and does not
    multiply by its reciprocal, as it does for a host scalar."""
    return (torch.tensor(origin, dtype=torch.float32, device=device),
            torch.tensor(cell, dtype=torch.float32, device=device),
            torch.tensor(dims, dtype=torch.int32, device=device),
            torch.tensor(_OFFS, device=device))


def _gather27(table: Tensor, nbr: Tensor, nbr_ok=None, fill=0.0) -> Tensor:
    """``table (n_cells, cap)`` gathered at ``nbr (K, 27)`` →
    ``(K, 27·cap)`` (whole cell rows)."""
    g = table[nbr.to(torch.int64)]                   # (K, 27, cap)
    if nbr_ok is not None:
        g = torch.where(nbr_ok[:, :, None], g, torch.full_like(g, fill))
    return g.reshape(g.shape[0], 27 * g.shape[2])


# ---------------------------------------------------------------------------
# the plain passes (the kernels of cellgrid_cuda.py compute the same)
# ---------------------------------------------------------------------------


def _chunked(fn, chunk, mt, active, nbr, nbr_ok):
    """Call ``fn(active, nbr, nbr_ok, w)`` on the occupied active cells, at
    most ``chunk`` at a time, and return its results ``(..., C, w)`` for
    all ``K`` active cells and ``cap`` slots, ``(..., K, cap)``. Every
    result of a pass is 0 in an empty slot, and packing by rank leaves
    every slot past the longest occupied prefix ``w`` empty in every cell;
    so the rows of unoccupied cells (the tail of ``active``) and the slots
    past ``w`` are zeros and are not computed, and ``fn`` cuts the tables
    to their first ``w`` slots. Finding the rows and ``w`` syncs the host,
    which the plain version may do."""
    w = max(int(occupied_count(mt).max()), 1)
    rows = torch.nonzero(torch.any(mt[active.to(torch.int64)] > 0.0,
                                   dim=-1)).squeeze(1)
    sub = (active[rows], nbr[rows], nbr_ok[rows])
    n = rows.shape[0]
    step = n if chunk is None else max(int(chunk), 1)
    outs = [fn(*(t[s:s + step] for t in sub), w)
            for s in range(0, n, step)]
    if not outs:                               # no occupied cell
        outs = [fn(*sub, w)]
    single = not isinstance(outs[0], tuple)
    parts = zip(*[(o,) if single else o for o in outs])
    full = []
    for part in parts:
        part = torch.cat(part, dim=-2)
        out = part.new_zeros(part.shape[:-2] + (active.shape[0],
                                                mt.shape[-1]))
        out[..., :w].index_copy_(part.dim() - 2, rows, part)
        full.append(out)
    return full[0] if single else tuple(full)


class _Pairs:
    """The fluid and boundary pair geometry of a list of active cells, on
    the tables' first ``w`` slots: the frozen pair masks from ``xt0`` and
    the current displacement planes ``(C, w, 27·w)`` (boundary ``(C, w,
    27·capb)``) from ``xt``, in the JAX cell path's order of operations."""

    def __init__(self, spec, xt, xt0, mt, active, nbr, nbr_ok, support, w,
                 boundary=True):
        h = support
        act = active.to(torch.int64)
        xt, xt0, mt = xt[..., :w], xt0[..., :w], mt[:, :w]
        self.ma = mt[act]                                   # (C, cap)
        self.m27 = _gather27(mt, nbr, nbr_ok)               # (C, 27cap)
        xa0 = [xt0[c][act] for c in range(3)]
        x270 = [_gather27(xt0[c], nbr) for c in range(3)]
        dc0 = [xa0[c][:, :, None] - x270[c][:, None, :] for c in range(3)]
        r2_0 = dc0[0] ** 2 + dc0[1] ** 2 + dc0[2] ** 2
        self.ok = ((self.m27[:, None, :] > 0.0) & (self.ma[..., None] > 0.0)
                   & (r2_0 > 1e-18) & (r2_0 < h * h))
        xa = [xt[c][act] for c in range(3)]
        self.dc = [xa[c][:, :, None] - _gather27(xt[c], nbr)[:, None, :]
                   for c in range(3)]
        self.bt = spec.boundary if boundary else None
        if self.bt is not None:
            bt = self.bt
            xb27 = [_gather27(bt.xt[c], nbr) for c in range(3)]
            self.pb27 = _gather27(bt.psit, nbr, nbr_ok)     # (C, 27capb)
            dcb0 = [xa0[c][:, :, None] - xb27[c][:, None, :]
                    for c in range(3)]
            r2b_0 = dcb0[0] ** 2 + dcb0[1] ** 2 + dcb0[2] ** 2
            self.okb = ((self.pb27[:, None, :] > 0.0)
                        & (self.ma[..., None] > 0.0) & (r2b_0 < h * h))
            self.dcb = [xa[c][:, :, None] - xb27[c][:, None, :]
                        for c in range(3)]


def _r2(dc):
    return dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2]


def density_lambda_reference(spec, xt, xt0, mt, active, nbr, nbr_ok,
                             density0, support, chunk=None):
    """Plain version of B3 over the listed active cells. Returns ``(lam,
    density)``, each ``(K, cap)``; both are 0 in empty slots."""
    h = support

    def run(active, nbr, nbr_ok, w):
        p = _Pairs(spec, xt, xt0, mt, active, nbr, nbr_ok, support, w)
        r2 = _r2(p.dc)
        rl = sph.sqrt(r2)
        wk = torch.where(p.ok, sph.w_r(rl, h), 0.0)
        density = p.ma * sph.w_zero(h, mt.device) + torch.sum(
            p.m27[:, None, :] * wk, -1)
        gc = -(p.m27[:, None, :] / density0) * sph.grad_w_coef(rl, h)
        gc = torch.where(p.ok, gc, 0.0)
        sum_grad2 = torch.sum(gc * gc * r2, -1)
        grad_i = [-torch.sum(gc * d, -1) for d in p.dc]
        if p.bt is not None:
            r2b = _r2(p.dcb)
            rlb = sph.sqrt(r2b)
            wkb = torch.where(p.okb, sph.w_r(rlb, h), 0.0)
            density = density + torch.sum(p.pb27[:, None, :] * wkb, -1)
            gcb = (-(p.pb27[:, None, :] / density0)
                   * sph.grad_w_coef(rlb, h))
            gcb = torch.where(p.okb, gcb, 0.0)
            sum_grad2 = sum_grad2 + torch.sum(gcb * gcb * r2b, -1)
            grad_i = [g - torch.sum(gcb * d, -1)
                      for g, d in zip(grad_i, p.dcb)]
        sum_grad2 = sum_grad2 + sum(g * g for g in grad_i)
        c_val = torch.clamp_min(density / density0 - 1.0, 0.0)
        lam = torch.where((c_val > 0.0) & (p.ma > 0.0),
                          -c_val / (sum_grad2 + EPS), 0.0)
        return lam, density

    return _chunked(run, chunk, mt, active, nbr, nbr_ok)


def corrections_reference(spec, xt, xt0, mt, lam_t, active, nbr, nbr_ok,
                          density0, support, chunk=None):
    """Plain version of B4 over the listed active cells, with λ read from
    the ``(n_cells, cap)`` table ``lam_t``. Returns the corrections ``(3,
    K, cap)``, 0 in empty slots."""
    h = support

    def run(active, nbr, nbr_ok, w):
        p = _Pairs(spec, xt, xt0, mt, active, nbr, nbr_ok, support, w)
        lam = lam_t[active.to(torch.int64), :w]
        lam27 = _gather27(lam_t[:, :w], nbr, nbr_ok)
        rl = sph.sqrt(_r2(p.dc))
        gc = torch.where(p.ok, -(p.m27[:, None, :] / density0)
                         * sph.grad_w_coef(rl, h), 0.0)
        coef = (lam[:, :, None] + lam27[:, None, :]) * gc
        corr = [-torch.sum(coef * d, -1) for d in p.dc]
        if p.bt is not None:
            rlb = sph.sqrt(_r2(p.dcb))
            gcb = torch.where(p.okb, -(p.pb27[:, None, :] / density0)
                              * sph.grad_w_coef(rlb, h), 0.0)
            coefb = lam[:, :, None] * gcb
            corr = [cc - torch.sum(coefb * d, -1)
                    for cc, d in zip(corr, p.dcb)]
        mfree = p.ma > 0.0
        return torch.stack([torch.where(mfree, cc, 0.0) for cc in corr])

    return _chunked(run, chunk, mt, active, nbr, nbr_ok)


def xsph_reference(spec, xt, xt0, vt, mt, density, active, nbr, nbr_ok,
                   support, chunk=None):
    """Plain version of B5 over the listed active cells: ``dvᵢ = Σⱼ
    mⱼ/max(ρⱼ, 1e-6)·W(xᵢ−xⱼ)·(vᵢ−vⱼ)`` over the fluid pairs, with ρ read
    from the ``(n_cells, cap)`` table ``density``. Returns ``dv (3, K,
    cap)``, 0 in empty slots; the caller applies ``v −= ν·dv``."""
    h = support

    def run(active, nbr, nbr_ok, w):
        p = _Pairs(spec, xt, xt0, mt, active, nbr, nbr_ok, support, w,
                   boundary=False)
        act = active.to(torch.int64)
        d27 = _gather27(density[:, :w], nbr, nbr_ok, fill=1.0)
        v = vt[..., :w]
        rl = sph.sqrt(sum(d ** 2 for d in p.dc))
        wk = torch.where(p.ok, sph.w_r(rl, h), 0.0)
        coef = (p.m27[:, None, :]
                / torch.clamp_min(d27[:, None, :], 1e-6) * wk)
        mfree = p.ma > 0.0
        out = []
        for c in range(3):
            dv = torch.sum(coef * (v[c][act][:, :, None]
                                   - _gather27(v[c], nbr)[:, None, :]), -1)
            out.append(torch.where(mfree, dv, 0.0))
        return torch.stack(out)

    return _chunked(run, chunk, mt, active, nbr, nbr_ok)


def pbf_iterations(spec: CellGridSpec, xt, mt, active, nbr, nbr_ok,
                   n_iter: int, density0, support, chunk=None):
    """Run ``n_iter`` density-projection iterations over the active cells
    with the plain passes. Returns ``(xt, density (n_cells, cap), xt0)``:
    ``xt0`` is the pre-projection table that freezes the step's pair set
    (the JAX function returns the pair mask itself; the mask of the 100k
    dam does not fit beside the passes, so every pass here recomputes it
    from ``xt0``, as the kernels do)."""
    xt0 = xt
    act = active.to(torch.int64)
    zeros = torch.zeros_like(mt)
    density = zeros
    for _ in range(n_iter):
        lam, dens = density_lambda_reference(
            spec, xt, xt0, mt, active, nbr, nbr_ok, density0, support,
            chunk=chunk)
        lam_t = zeros.index_copy(0, act, lam)
        corr = corrections_reference(
            spec, xt, xt0, mt, lam_t, active, nbr, nbr_ok, density0,
            support, chunk=chunk)
        xt = xt.index_add(1, act, corr)
        density = zeros.index_copy(0, act, dens)
    return xt, density, xt0


def xsph_cell(spec: CellGridSpec, xt, vt, mt, active, nbr, nbr_ok,
              density, viscosity, support, xt0, chunk=None):
    """XSPH viscosity over the active cells (fluid neighbors only), on the
    pair set frozen by the pre-projection table ``xt0`` (JAX passes the
    pair mask instead). Returns the new ``(3, n_cells, cap)`` velocity
    table."""
    dv = xsph_reference(spec, xt, xt0, vt, mt, density, active, nbr,
                        nbr_ok, support, chunk=chunk)
    return vt.index_add(1, active.to(torch.int64), -viscosity * dv)
