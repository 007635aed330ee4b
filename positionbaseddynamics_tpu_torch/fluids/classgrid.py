"""Occupancy-partitioned PBF iterations — the counterpart of
``positionbaseddynamics_tpu/fluids/classgrid.py``, in plain PyTorch.

The JAX package's default route for a cell grid whose cap exceeds 20
(``use_classes``): its dense ``(cap, 27·cap)`` pair blocks are sized for
impact compression while the median cell holds 8 particles, so the TPU
spends most of its lanes on empty pairs. This route removes them:

* active cells are partitioned by their 27-neighborhood max occupancy
  into a narrow class (pair block ``(·, capn, 27·capn)`` with
  ``capn = narrow_cap``) and a full-cap class; rank-based slot packing
  makes slicing the tables to ``[:, :capn]`` exact for cells whose whole
  neighborhood fits. Cells spill up (narrow → full) when the narrow list
  is out of capacity; cells that fit neither list are counted in the
  overflow.
* boundary (Akinci ψ) lanes run only for the compacted list of
  boundary-adjacent occupied cells (``BoundaryTables.near``); their
  density and ∇C partial sums go into per-cell tables that the class
  passes read before the λ solve.

The math and the per-step frozen pair sets are those of
``cellgrid.pbf_iterations`` (``PositionBasedFluids.cpp:8-141``,
``TimeStepFluidModel.cpp:30-38``). No TPU kernel exists for this route:
on either device it runs these plain passes. The port's CUDA kernels
(``cellgrid_cuda.py``) walk each cell's real occupancy and need no
classes; ``_fluid_step_cells(partition=True)`` asks for this route.

Layout as in ``cellgrid.py``: the position and velocity tables are one
``(3, n_cells, cap)`` tensor each. JAX runs every row of a class list
and drops what its padding rows write (``.at[...].set/add(mode="drop")``
at row ``n_cells``); here a pass runs the list's valid rows only, which
changes no value.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import sph
from .cellgrid import _grid_consts

Tensor = torch.Tensor
EPS = 1.0e-6                    # λ denominator regulariser (PBF ε)


def narrow_cap(spec) -> int:
    """Slot width of the narrow class: the settled-liquid occupancy band
    (rest is 8 particles a support cell; moderate compression reaches the
    mid-teens), clamped to the table cap."""
    return int(min(16, spec.cap))


def class_capacities(spec) -> tuple:
    """``(narrow, full, bnd_narrow, bnd_full)`` static list capacities
    (``classgrid.py:54-74``): the narrow list covers the whole active
    budget, the full list an eighth of it (at least 256); the boundary
    lists scale with three times the static near-boundary fraction."""
    k = spec.max_active
    frac = 1.0
    if spec.boundary is not None:
        frac = min(1.0, 3.0 * spec.boundary.near_frac)
    total_b = min(k, max(1024, int(k * frac)))
    return (k, max(256, k // 8), total_b, max(256, total_b // 4))


def _occupied(mt: Tensor) -> Tensor:
    """Per-cell particle count of a ``(n_cells, cap)`` mass table."""
    return torch.sum(mt > 0.0, dim=-1)


def _nbhd_max_occ(spec, mt: Tensor) -> Tensor:
    """Per-cell max occupancy over the 27-neighborhood, by three separable
    axis max-pools on the cell grid (zero beyond the domain)."""
    dims = spec.dims
    cnt = _occupied(mt).to(torch.int32).reshape(dims)
    for ax in range(3):
        pad = [0, 0] * (2 - ax) + [1, 1]
        p = F.pad(cnt, pad)
        lo = p.narrow(ax, 0, dims[ax])
        hi = p.narrow(ax, 2, dims[ax])
        cnt = torch.maximum(cnt, torch.maximum(lo, hi))
    return cnt.reshape(-1)


def _select(mask: Tensor, n: int, capacity: int):
    """Stable occupied-first selection of ids under ``mask``: the same
    packed int32 keys as JAX (``classgrid.py:91-99``), sorted, so the list
    equals JAX's element for element. Returns ``(ids, valid)``."""
    bits = max(n - 1, 1).bit_length()
    assert bits + 1 <= 31, "cell count exceeds int32 packing"
    dev = mask.device
    packed = (torch.where(mask, 0, 1 << bits).to(torch.int32)
              + torch.arange(n, dtype=torch.int32, device=dev))
    ids = (torch.sort(packed, stable=True).values[:capacity]
           & ((1 << bits) - 1)).to(torch.int32)
    valid = torch.arange(capacity, device=dev) < torch.sum(mask)
    return ids, valid


def _nbr_of(spec, cells: Tensor, valid: Tensor):
    """27 neighbor cell ids and their validity for a cell-id list."""
    dims = spec.dims
    offs = _grid_consts(spec.origin, spec.cell, dims, cells.device)[3]
    cx = cells // (dims[1] * dims[2])
    rem = cells - cx * (dims[1] * dims[2])
    cy = rem // dims[2]
    cz = rem - cy * dims[2]
    nx = cx[:, None] + offs[None, :, 0]
    ny = cy[:, None] + offs[None, :, 1]
    nz = cz[:, None] + offs[None, :, 2]
    ok = ((nx >= 0) & (nx < dims[0]) & (ny >= 0) & (ny < dims[1])
          & (nz >= 0) & (nz < dims[2]) & valid[:, None])
    nbr = ((nx.clamp(0, dims[0] - 1) * dims[1]
            + ny.clamp(0, dims[1] - 1)) * dims[2]
           + nz.clamp(0, dims[2] - 1)).to(torch.int32)
    return nbr, ok


def _split(sel_a: Tensor, sel_b: Tensor, cap_a: int, cap_b: int):
    """Spill-up partition: ``sel_a`` beyond ``cap_a`` joins ``sel_b``;
    ``sel_b`` beyond ``cap_b`` is dropped and counted."""
    rank_a = torch.cumsum(sel_a.to(torch.int32), 0) - 1
    spill = sel_a & (rank_a >= cap_a)
    a = sel_a & ~spill
    b = sel_b | spill
    rank_b = torch.cumsum(b.to(torch.int32), 0) - 1
    return a, b, torch.sum(b & (rank_b >= cap_b))


def partition_active(spec, mt: Tensor):
    """Partition occupied cells into (narrow, full) lists by neighborhood
    max occupancy, and compact the boundary-adjacent occupied cells.
    Returns ``(narrow, full, bnd, overflow)``, each list ``(cells, valid,
    nbr, nbr_ok)``; ``bnd`` is a pair of such lists, or None without
    boundary tables."""
    capn = narrow_cap(spec)
    cap_narrow, cap_full, cap_bn, cap_bf = class_capacities(spec)
    n_cells = spec.n_cells
    occ = torch.any(mt > 0.0, dim=-1)
    m = _nbhd_max_occ(spec, mt)
    sel_n, sel_f, over = _split(occ & (m <= capn), occ & (m > capn),
                                cap_narrow, cap_full)
    cells_n, valid_n = _select(sel_n, n_cells, cap_narrow)
    cells_f, valid_f = _select(sel_f, n_cells, cap_full)
    narrow = (cells_n, valid_n) + _nbr_of(spec, cells_n, valid_n)
    full = (cells_f, valid_f) + _nbr_of(spec, cells_f, valid_f)

    bnd = None
    bt = spec.boundary
    if bt is not None and bt.near is not None:
        # the boundary pass splits on the cell's own occupancy (its ψ lane
        # width is 27·capb in either class)
        cnt = _occupied(mt)
        occ_b = occ & bt.near
        sel_bn, sel_bf, over_b = _split(occ_b & (cnt <= capn),
                                        occ_b & (cnt > capn), cap_bn, cap_bf)
        over = over + over_b
        cells_bn, valid_bn = _select(sel_bn, n_cells, cap_bn)
        cells_bf, valid_bf = _select(sel_bf, n_cells, cap_bf)
        bnd = [(cells_bn, valid_bn) + _nbr_of(spec, cells_bn, valid_bn),
               (cells_bf, valid_bf) + _nbr_of(spec, cells_bf, valid_bf)]
    return narrow, full, bnd, over


def _slice_cap(t: Tensor, capc: int) -> Tensor:
    return t if capc == t.shape[-1] else t[:, :capc]


def _pad_rows(a: Tensor, cap: int) -> Tensor:
    """``(Kc, capc)`` → ``(Kc, cap)``, zero-padded: a narrow cell's slots
    past ``capc`` hold no particle."""
    capc = a.shape[-1]
    return a if capc == cap else F.pad(a, (0, cap - capc))


def _valid_rows(part):
    """A class list cut to its valid rows, which come first. JAX computes
    the padding rows too and drops what they write; their results are
    zeros, so leaving them out changes no value. Counting them syncs the
    host, as the plain passes of ``cellgrid.py`` do."""
    n = int(part[1].sum())
    return tuple(t[:n] for t in part)


class _ClassCtx:
    """Per-class frozen data: own slots, neighbor gathers of the
    pre-projection table, and the frozen pair mask, for the class list's
    valid rows."""

    def __init__(self, spec, xt, mt, part, capc, h):
        cells, _, nbr, nbr_ok = _valid_rows(part)
        self.cells = cells.to(torch.int64)
        self.nbr, self.nbr_ok = nbr.to(torch.int64), nbr_ok
        self.capc = capc
        self.ma = _slice_cap(mt, capc)[self.cells]          # (Kc, capc)
        self.mfree = self.ma > 0.0
        m27 = _slice_cap(mt, capc)[self.nbr]                # (Kc, 27, capc)
        m27 = torch.where(nbr_ok[:, :, None], m27, 0.0)
        self.m27 = m27.reshape(cells.shape[0], 27 * capc)
        xa0 = [self.own(xt[c]) for c in range(3)]
        x27_0 = [self.gather27(xt[c]) for c in range(3)]
        r2_0 = sum((xa0[c][:, :, None] - x27_0[c][:, None, :]) ** 2
                   for c in range(3))
        self.pair_ok = ((self.m27[:, None, :] > 0.0)
                        & self.mfree[..., None]
                        & (r2_0 > 1e-18) & (r2_0 < h * h))

    def gather27(self, plane: Tensor) -> Tensor:
        """Neighbor slots of a ``(n_cells, cap)`` plane, ``(Kc, 27·capc)``."""
        g = _slice_cap(plane, self.capc)[self.nbr]
        return g.reshape(g.shape[0], 27 * self.capc)

    def own(self, plane: Tensor) -> Tensor:
        return _slice_cap(plane, self.capc)[self.cells]


def _geometry(xa, x27):
    dc = [xa[c][:, :, None] - x27[c][:, None, :] for c in range(3)]
    return dc, dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2]


def _fluid_sums(ctx, xa, x27, density0, h):
    """Density, Σ‖∇C‖² and ∇Cᵢ partial sums of a class's fluid pairs. The
    correction pass recomputes the pair geometry rather than keep it
    across the λ solve, as JAX does."""
    dc, r2 = _geometry(xa, x27)
    rl = sph.sqrt(r2)
    wk = torch.where(ctx.pair_ok, sph.w_r(rl, h), 0.0)
    density = (ctx.ma * sph.w_zero(h, ctx.ma.device)
               + torch.sum(ctx.m27[:, None, :] * wk, -1))
    gc = -(ctx.m27[:, None, :] / density0) * sph.grad_w_coef(rl, h)
    gc = torch.where(ctx.pair_ok, gc, 0.0)
    s2 = torch.sum(gc * gc * r2, -1)
    gi = [-torch.sum(gc * d, -1) for d in dc]
    return density, s2, gi


def _fluid_corr(ctx, xa, x27, lam, lam27, density0, h):
    """Δx of a class's fluid pairs (recomputed geometry)."""
    dc, r2 = _geometry(xa, x27)
    gc = -(ctx.m27[:, None, :] / density0) * sph.grad_w_coef(sph.sqrt(r2),
                                                            h)
    gc = torch.where(ctx.pair_ok, gc, 0.0)
    coef = (lam[:, :, None] + lam27[:, None, :]) * gc
    return [-torch.sum(coef * d, -1) for d in dc]


class _BndCtx:
    """Boundary-adjacent compacted cells (own slots cut to ``capc``) with
    their frozen static ψ tables."""

    def __init__(self, spec, xt, mt, part, capc, h):
        bt = spec.boundary
        cells, _, nbr, nbr_ok = _valid_rows(part)
        self.cells = cells.to(torch.int64)
        self.capc = capc
        capb = bt.capb
        nb = nbr.to(torch.int64)
        self.xb27 = [bt.xt[c][nb].reshape(-1, 27 * capb) for c in range(3)]
        self.pb27 = torch.where(nbr_ok[:, :, None], bt.psit[nb],
                                0.0).reshape(-1, 27 * capb)
        self.mb = _slice_cap(mt, capc)[self.cells]
        xa0 = self.gather_own(xt)
        r2_0 = sum((xa0[c][:, :, None] - self.xb27[c][:, None, :]) ** 2
                   for c in range(3))
        self.ok = ((self.pb27[:, None, :] > 0.0)
                   & (self.mb[..., None] > 0.0) & (r2_0 < h * h))

    def gather_own(self, xt):
        return [_slice_cap(xt[c], self.capc)[self.cells] for c in range(3)]

    def sums(self, xa, density0, h):
        dc, r2 = _geometry(xa, self.xb27)
        rl = sph.sqrt(r2)
        wk = torch.where(self.ok, sph.w_r(rl, h), 0.0)
        density = torch.sum(self.pb27[:, None, :] * wk, -1)
        gc = -(self.pb27[:, None, :] / density0) * sph.grad_w_coef(rl, h)
        gc = torch.where(self.ok, gc, 0.0)
        s2 = torch.sum(gc * gc * r2, -1)
        gi = [-torch.sum(gc * d, -1) for d in dc]
        return density, s2, gi

    def corr(self, xa, lam_b, density0, h):
        dc, r2 = _geometry(xa, self.xb27)
        gc = -(self.pb27[:, None, :] / density0) \
            * sph.grad_w_coef(sph.sqrt(r2), h)
        gc = torch.where(self.ok, gc, 0.0)
        coefb = lam_b[:, :, None] * gc
        return [-torch.sum(coefb * d, -1) for d in dc]


def pbf_iterations_classes(spec, xt, mt, narrow, full, bnd, n_iter: int,
                           density0, support):
    """Occupancy-partitioned density projection, the math and contract of
    ``cellgrid.pbf_iterations``. ``xt`` is the ``(3, n_cells, cap)``
    table. Returns ``(xt, density (n_cells, cap), ctxs)``, ``ctxs``
    reusable by :func:`xsph_classes`."""
    h = support
    cap = spec.cap
    n_cells = spec.n_cells
    capn = narrow_cap(spec)
    ctxs = [_ClassCtx(spec, xt, mt, narrow, capn, h),
            _ClassCtx(spec, xt, mt, full, cap, h)]
    bctxs = ([_BndCtx(spec, xt, mt, bnd[0], capn, h),
              _BndCtx(spec, xt, mt, bnd[1], cap, h)]
             if bnd is not None else [])
    zeros = torch.zeros_like(mt)
    density = zeros
    for _ in range(n_iter):
        bnd_data = []
        if bctxs:
            bt_dens, bt_s2, bt_gi = zeros, zeros, [zeros] * 3
            for bctx in bctxs:
                xab = bctx.gather_own(xt)
                b_dens, b_s2, b_gi = bctx.sums(xab, density0, h)
                rows = bctx.cells
                bt_dens = bt_dens.index_copy(0, rows, _pad_rows(b_dens, cap))
                bt_s2 = bt_s2.index_copy(0, rows, _pad_rows(b_s2, cap))
                bt_gi = [t.index_copy(0, rows, _pad_rows(g, cap))
                         for t, g in zip(bt_gi, b_gi)]
                bnd_data.append(xab)

        lam_t, dens_t = zeros, zeros
        cls_data = []
        for ctx in ctxs:
            xa = [ctx.own(xt[c]) for c in range(3)]
            x27 = [ctx.gather27(xt[c]) for c in range(3)]
            dens, s2, gi = _fluid_sums(ctx, xa, x27, density0, h)
            if bctxs:
                dens = dens + ctx.own(bt_dens)
                s2 = s2 + ctx.own(bt_s2)
                gi = [g + ctx.own(t) for g, t in zip(gi, bt_gi)]
            s2 = s2 + sum(g * g for g in gi)
            c_val = torch.clamp_min(dens / density0 - 1.0, 0.0)
            lam = torch.where((c_val > 0.0) & ctx.mfree,
                              -c_val / (s2 + EPS), 0.0)
            lam_t = lam_t.index_copy(0, ctx.cells, _pad_rows(lam, cap))
            dens_t = dens_t.index_copy(0, ctx.cells, _pad_rows(dens, cap))
            cls_data.append((lam, xa, x27))

        new_xt = list(xt.unbind(0))
        for ctx, (lam, xa, x27) in zip(ctxs, cls_data):
            lam27 = ctx.gather27(lam_t)
            corr = _fluid_corr(ctx, xa, x27, lam, lam27, density0, h)
            for c in range(3):
                new_xt[c] = new_xt[c].index_add(0, ctx.cells, _pad_rows(
                    torch.where(ctx.mfree, corr[c], 0.0), cap))
        for bctx, xab in zip(bctxs, bnd_data):
            lam_b = _slice_cap(lam_t, bctx.capc)[bctx.cells]
            corr_b = bctx.corr(xab, lam_b, density0, h)
            for c in range(3):
                new_xt[c] = new_xt[c].index_add(0, bctx.cells, _pad_rows(
                    torch.where(bctx.mb > 0.0, corr_b[c], 0.0), cap))
        xt = torch.stack(new_xt)
        density = dens_t
    return xt, density, ctxs


def xsph_classes(spec, xt, vt, mt, ctxs, density, viscosity, support):
    """XSPH viscosity over the occupancy classes (fluid neighbors only,
    the frozen pair masks), the math of ``cellgrid.xsph_cell``. Returns
    the new ``(3, n_cells, cap)`` velocity table."""
    dmax = torch.clamp_min(density, 1e-6)
    out = list(vt.unbind(0))
    for ctx in ctxs:
        xa = [ctx.own(xt[c]) for c in range(3)]
        va = [ctx.own(vt[c]) for c in range(3)]
        x27 = [ctx.gather27(xt[c]) for c in range(3)]
        v27 = [ctx.gather27(vt[c]) for c in range(3)]
        d27 = torch.clamp_min(ctx.gather27(dmax), 1e-6)
        rl = sph.sqrt(sum((xa[c][:, :, None] - x27[c][:, None, :]) ** 2
                          for c in range(3)))
        wk = torch.where(ctx.pair_ok, sph.w_r(rl, support), 0.0)
        coef = ctx.m27[:, None, :] / d27[:, None, :] * wk
        for c in range(3):
            dv = torch.sum(coef * (va[c][:, :, None] - v27[c][:, None, :]),
                           -1)
            out[c] = out[c].index_add(0, ctx.cells, _pad_rows(
                torch.where(ctx.mfree, -viscosity * dv, 0.0),
                out[c].shape[-1]))
    return torch.stack(out)
