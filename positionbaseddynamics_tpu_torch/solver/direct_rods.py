"""Direct solver for stiff rods (Deul et al. 2018) — port of
``positionbaseddynamics_tpu/solver/direct_rods.py``.

Rod segments are rigid bodies; each constraint joins two segments with 3
zero-stretch rows at the shared connector and 3 Darboux bend/twist rows
(the rows of the iterative ``stretch_bending_twisting`` joint,
``PositionBasedElasticRods.cpp:1228-1363``). Each iteration solves all of
a rod's constraints at once, ``(J M⁻¹ Jᵀ + α) Δλ = −(C + αλ)``
(``PositionBasedElasticRods.cpp:735-1226``):

* :class:`DirectRodBatch`, chains: the system is block-tridiagonal with
  6×6 blocks. JAX solves it by a block-Thomas forward and backward
  ``lax.scan`` over the segments (``direct_rods.py:149-225``); here the
  same recurrences are a loop over the segments whose every operation is
  batched over the rods and the rollouts.
* :class:`DirectRodTreeBatch`, branched trees: the dense 6C×6C solve
  (``solver="dense"``, and ``"auto"`` up to ``_TREE_DENSE_MAX``
  constraints) or the fill-free tree-ordered block-LDLᵀ over the host
  schedule of :func:`_build_tree_schedule` (``"tree"``, and ``"auto"``
  above). JAX scans that schedule one pivot a step; here the pivots are
  grouped into levels of pivots that touch disjoint blocks
  (:func:`schedule_levels`), and each level is one batched operation, so
  a step costs a few launches a level, not a few a constraint. Every
  block and right-hand side takes the same updates in the same order as
  in JAX's scan, and the sums of several terms into one block or segment
  add them in JAX's order with no atomics, the same on every device.

No operation waits for the card: the solves and inverses are
``solve_ex`` / ``inv_ex`` with ``check_errors=False``, the schedules are
index tensors made at build time.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops import quaternion as quat
from ..utils import npquat
from .joints import _consts, _skew_t, darboux_jacobian1, darboux_omega

Tensor = torch.Tensor

#: below this constraint count ``solver="auto"`` takes the dense solve
_TREE_DENSE_MAX = 48


def _f32(a, dev) -> Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def _material(bodies, positions, x, q, radius, seg_len, youngs, torsion):
    """Connectors in the two segments' frames, rest Darboux vectors and
    stiffness ``K = (E I, 2 G I, E I)`` of constraints joining
    ``b0``/``b1`` (``direct_rods.py:66-100``), float64."""
    b0, b1 = bodies
    x = np.asarray(x, np.float64)
    q = np.asarray(q, np.float64)
    shape = b0.shape
    q0 = q[b0].reshape(-1, 4)
    q1 = q[b1].reshape(-1, 4)
    pos = np.asarray(positions, np.float64).reshape(-1, 3)
    l0 = npquat.rotate(npquat.conjugate(q0),
                       pos - x[b0].reshape(-1, 3)).reshape(shape + (3,))
    l1 = npquat.rotate(npquat.conjugate(q1),
                       pos - x[b1].reshape(-1, 3)).reshape(shape + (3,))
    sl = np.broadcast_to(np.asarray(seg_len, np.float64), shape)
    rel = npquat.multiply(npquat.conjugate(q0), q1).reshape(shape + (4,))
    rest = 2.0 / sl[..., None] * rel[..., 1:4]
    second = np.pi / 4.0 * np.broadcast_to(
        np.asarray(radius, np.float64), shape) ** 4
    bend = np.broadcast_to(np.asarray(youngs, np.float64), shape) * second
    twist = 2.0 * np.broadcast_to(np.asarray(torsion, np.float64),
                                  shape) * second
    return l0, l1, rest, sl, np.stack([bend, twist, bend], -1)


def _inv_dt2(dt) -> Tuple[float, float]:
    """``1/dt²`` and ``1e-10/dt²`` rounded as JAX computes them from its
    float32 ``dt``."""
    d = np.float32(dt)
    inv = np.float32(1.0) / (d * d)
    return float(inv), float(np.float32(1e-10) * inv)


def constraint_rows(x0, q0, x1, q1, l0, l1, rest, seg_len, stiff, dt):
    """Rows of SBT constraints over leading axes (``direct_rods.py:
    111-141``): ``(c (..., 6), J0 (..., 6, 6), J1 (..., 6, 6), alpha
    (..., 6))``, each row ``[linear | angular]`` of one body."""
    c0 = quat.rotate(q0, l0) + x0
    c1 = quat.rotate(q1, l1) + x1
    diff = c0 - c1
    omega = darboux_omega(q0, q1, seg_len)
    j1 = darboux_jacobian1(q0, q1, seg_len)
    lead = torch.broadcast_shapes(diff.shape[:-1], j1.shape[:-2])
    eye, neye = (e.expand(*lead, 3, 3) for e in _consts(diff.device)[:2])
    zero = torch.zeros_like(eye)
    j0 = torch.cat([torch.cat([eye, _skew_t(c0 - x0).expand_as(eye)], -1),
                    torch.cat([zero, -j1.expand_as(eye)], -1)], -2)
    j1m = torch.cat([torch.cat([neye, _skew_t(c1 - x1, True
                                              ).expand_as(eye)], -1),
                     torch.cat([zero, j1.expand_as(eye)], -1)], -2)
    inv, small = _inv_dt2(dt)
    bend = torch.full_like(seg_len, inv)[..., None] / (stiff
                                                       * seg_len[..., None])
    alpha = torch.cat([torch.full_like(bend, small), bend], -1)
    c = torch.cat([diff, omega - rest], -1)
    return c, j0, j1m, alpha.expand(*lead, 6)


def inverse_mass_blocks(inv_mass: Tensor, inv_iw: Tensor) -> Tensor:
    """``diag(w I3, I⁻¹)`` ``(..., 6, 6)`` of bodies with inverse masses
    ``(...)`` and world inverse inertias ``(..., 3, 3)``."""
    eye = _consts(inv_iw.device)[0]
    zero = torch.zeros_like(inv_iw)
    top = torch.cat([(inv_mass[..., None, None] * eye).expand_as(inv_iw),
                     zero], -1)
    return torch.cat([top, torch.cat([zero, inv_iw], -1)], -2)


def _sandwich(a: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """``a w bᵀ`` over leading axes."""
    return torch.matmul(torch.matmul(a, w), b.transpose(-1, -2))


def _mv(m: Tensor, v: Tensor) -> Tensor:
    return torch.matmul(m, v.unsqueeze(-1)).squeeze(-1)


def _solve(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.solve_ex(a, b, check_errors=False)[0]


def _gather_bodies(arrays, idx: Tensor, n_trail):
    """Each of ``arrays`` gathered at body indices ``idx`` along its body
    axis (``n_trail[i]`` trailing axes after it)."""
    flat = idx.reshape(-1)
    out = []
    for a, t in zip(arrays, n_trail):
        axis = a.dim() - 1 - t
        out.append(a.index_select(axis, flat).unflatten(axis,
                                                        tuple(idx.shape)))
    return out


@dataclass(frozen=True)
class DirectRodBatch:
    """``R`` rod chains of ``S`` segments each (``direct_rods.py:52-226``):
    segment ``b`` of rod ``r`` is body ``bodies[r, b]``; constraint ``j``
    joins segments ``j`` and ``j + 1``."""

    bodies: Tensor        # (R, S) int64
    local0: Tensor        # (R, S-1, 3) connector in segment j's frame
    local1: Tensor        # (R, S-1, 3) connector in segment j+1's frame
    rest_darboux: Tensor  # (R, S-1, 3)
    seg_len: Tensor       # (R, S-1)
    stiffness: Tensor     # (R, S-1, 3)

    @staticmethod
    def create(bodies, positions, x, q, average_radius,
               average_segment_length, youngs_modulus, torsion_modulus,
               device=None) -> "DirectRodBatch":
        """``bodies (R, S)``, ``positions (R, S-1, 3)`` world constraint
        positions, ``x``/``q`` the bodies' initial states; scalar material
        parameters broadcast (``init_DirectPositionBasedSolverForStiff
        RodsConstraint``, ``PositionBasedElasticRods.cpp:1009-1099``)."""
        dev = resolve_device(device)
        bodies = np.asarray(bodies, np.int32)
        if bodies.ndim == 1:
            bodies = bodies[None]
        l0, l1, rest, sl, stiff = _material(
            (bodies[:, :-1], bodies[:, 1:]), positions, x, q,
            average_radius, average_segment_length, youngs_modulus,
            torsion_modulus)
        return DirectRodBatch(
            bodies=torch.tensor(bodies, dtype=torch.int64, device=dev),
            local0=_f32(l0, dev), local1=_f32(l1, dev),
            rest_darboux=_f32(rest, dev), seg_len=_f32(sl, dev),
            stiffness=_f32(stiff, dev))

    @property
    def device(self) -> torch.device:
        return self.bodies.device

    def to(self, device) -> "DirectRodBatch":
        return DirectRodBatch(**{f.name: getattr(self, f.name).to(device)
                                 for f in dataclasses.fields(self)})

    def init_lambda(self) -> Tensor:
        return torch.zeros(tuple(self.seg_len.shape) + (6,),
                           dtype=torch.float32, device=self.device)

    def solve(self, rx, rq, inv_mass, inv_iw, lam, dt):
        """One exact solve of every chain. ``rx (..., Nb, 3)``, ``rq``,
        ``inv_mass (Nb,)``, ``inv_iw (..., Nb, 3, 3)``, ``lam (..., R,
        S-1, 6)``. Returns ``(corr_x (..., R, S, 3), ot (..., R, S, 3),
        new_lam)``."""
        b0, b1 = self.bodies[:, :-1], self.bodies[:, 1:]
        x0, q0 = _gather_bodies((rx, rq), b0, (1, 1))
        x1, q1 = _gather_bodies((rx, rq), b1, (1, 1))
        c, j0, j1m, alpha = constraint_rows(
            x0, q0, x1, q1, self.local0, self.local1, self.rest_darboux,
            self.seg_len, self.stiffness, dt)
        w_all = inverse_mass_blocks(*_gather_bodies(
            (inv_mass, inv_iw), self.bodies, (0, 2)))        # (..., R, S)
        w0, w1 = w_all[..., :-1, :, :], w_all[..., 1:, :, :]
        diag = (_sandwich(j0, w0, j0) + _sandwich(j1m, w1, j1m)
                + torch.diag_embed(alpha))
        upper = _sandwich(j1m[..., :-1, :, :], w1[..., :-1, :, :],
                          j0[..., 1:, :, :])                  # (..., C-1)
        rhs = -(c + alpha * lam)
        n_c = diag.shape[-3]
        # block Thomas, forward elimination (direct_rods.py:183-196)
        d_all, r_all = [diag[..., 0, :, :]], [rhs[..., 0, :]]
        for j in range(1, n_c):
            u_prev = upper[..., j - 1, :, :]
            l_mat = _solve(d_all[-1], u_prev).transpose(-1, -2)
            d_all.append(diag[..., j, :, :] - torch.matmul(l_mat, u_prev))
            r_all.append(rhs[..., j, :] - _mv(l_mat, r_all[-1]))
        # back substitution (direct_rods.py:198-208)
        lam_next = _solve(d_all[-1], r_all[-1].unsqueeze(-1)).squeeze(-1)
        dl = [lam_next]
        for j in range(n_c - 2, -1, -1):
            lam_next = _solve(d_all[j], (r_all[j] - _mv(
                upper[..., j, :, :], lam_next)).unsqueeze(-1)).squeeze(-1)
            dl.append(lam_next)
        dlam = torch.stack(dl[::-1], dim=-2)
        # segment b gets J_{b-1}^(1)ᵀ Δλ_{b-1} + J_b^(0)ᵀ Δλ_b
        imp = torch.nn.functional.pad(
            _mv(j0.transpose(-1, -2), dlam), (0, 0, 0, 1)) \
            + torch.nn.functional.pad(
                _mv(j1m.transpose(-1, -2), dlam), (0, 0, 1, 0))
        delta = _mv(w_all, imp)
        return delta[..., :3], delta[..., 3:], lam + dlam


def _build_tree_schedule(edges: np.ndarray, s_count: int):
    """Static elimination schedule of a tree's constraint graph, a copy of
    JAX's ``_build_tree_schedule`` (``direct_rods.py:366-518``; host numpy,
    equal to it array for array). Constraints are adjacent when they share
    a segment; the graph is chordal, and eliminating the deepest
    constraint first is fill-free, so the block LDLᵀ is a fixed list of
    6×6 operations."""
    c_count = len(edges)
    seg_edges = [[] for _ in range(s_count)]
    adj_seg = [[] for _ in range(s_count)]
    for ci, (u, v) in enumerate(edges):
        seg_edges[u].append((ci, v))
        seg_edges[v].append((ci, u))
        adj_seg[u].append(ci)
        adj_seg[v].append(ci)
    depth = np.full(s_count, -1, np.int64)
    depth[0] = 0
    dq = deque([0])
    while dq:
        u = dq.popleft()
        for ci, v in seg_edges[u]:
            if depth[v] < 0:
                depth[v] = depth[u] + 1
                dq.append(v)
    edepth = np.array([max(depth[u], depth[v]) for (u, v) in edges])
    order = np.argsort(-edepth, kind="stable")

    nbrs = [set() for _ in range(c_count)]
    for s in range(s_count):
        cs = adj_seg[s]
        for i in range(len(cs)):
            for j in range(i + 1, len(cs)):
                nbrs[cs[i]].add(cs[j])
                nbrs[cs[j]].add(cs[i])

    slot = {}

    def get_slot(a, b):
        key = (min(a, b), max(a, b))
        if key not in slot:
            slot[key] = len(slot)
        return slot[key]

    for c in range(c_count):
        get_slot(c, c)
    for c in range(c_count):
        for a in nbrs[c]:
            get_slot(c, a)

    eliminated = np.zeros(c_count, bool)
    steps = []
    for c in order:
        later = sorted(a for a in nbrs[c] if not eliminated[a])
        for i in range(len(later)):          # chordality: clique check
            for j in range(i + 1, len(later)):
                a, b = later[i], later[j]
                if b not in nbrs[a]:         # fill (non-tree input)
                    nbrs[a].add(b)
                    nbrs[b].add(a)
                    get_slot(a, b)
        pairs = [(i, j) for i in range(len(later))
                 for j in range(i, len(later))]
        steps.append((int(c), later, pairs))
        eliminated[c] = True

    dmax = max([len(l) for _, l, _ in steps] + [1])
    pmax = max([len(p) for _, _, p in steps] + [1])
    piv = np.array([c for c, _, _ in steps], np.int32)
    piv_slot = np.array([slot[(c, c)] for c, _, _ in steps], np.int32)
    nbr_idx = np.full((c_count, dmax), -1, np.int32)
    nbr_slot = np.zeros((c_count, dmax), np.int32)
    nbr_tr = np.zeros((c_count, dmax), bool)
    upd_ii = np.zeros((c_count, pmax), np.int32)
    upd_jj = np.zeros((c_count, pmax), np.int32)
    upd_slot = np.zeros((c_count, pmax), np.int32)
    upd_mask = np.zeros((c_count, pmax), np.float32)
    for k, (c, later, pairs) in enumerate(steps):
        for i, a in enumerate(later):
            nbr_idx[k, i] = a
            nbr_slot[k, i] = slot[(min(a, c), max(a, c))]
            nbr_tr[k, i] = a > c     # stored block is H[min,max]
        for p, (i, j) in enumerate(pairs):
            a, b = later[i], later[j]
            upd_ii[k, p] = i
            upd_jj[k, p] = j
            upd_slot[k, p] = slot[(a, b)]   # a <= b (later sorted)
            upd_mask[k, p] = 1.0

    con_slot, con_seg, con_a, con_sa, con_b, con_sb = [], [], [], [], [], []
    for (a, b), sl in slot.items():
        segs_a = {edges[a][0]: 0, edges[a][1]: 1}
        segs_b = {edges[b][0]: 0, edges[b][1]: 1}
        shared = set(segs_a) & set(segs_b)
        for s in shared:
            con_slot.append(sl)
            con_seg.append(s)
            con_a.append(a)
            con_sa.append(segs_a[s])
            con_b.append(b)
            con_sb.append(segs_b[s])
    return dict(
        n_slots=len(slot), dmax=int(dmax), pmax=int(pmax),
        piv=piv, piv_slot=piv_slot, nbr_idx=nbr_idx,
        nbr_slot=nbr_slot, nbr_tr=nbr_tr, upd_ii=upd_ii,
        upd_jj=upd_jj, upd_slot=upd_slot, upd_mask=upd_mask,
        con_slot=np.asarray(con_slot, np.int32),
        con_seg=np.asarray(con_seg, np.int32),
        con_a=np.asarray(con_a, np.int32),
        con_sa=np.asarray(con_sa, np.int32),
        con_b=np.asarray(con_b, np.int32),
        con_sb=np.asarray(con_sb, np.int32),
    )


def schedule_levels(sched) -> np.ndarray:
    """The level of each step of a schedule (numpy arrays of
    :func:`_build_tree_schedule`): one more than the highest level of an
    earlier step it conflicts with — whose later neighbours hold its pivot
    or share a neighbour with its own. Steps of one level read and write
    disjoint blocks and right-hand sides, so they run as one batched
    operation; conflicting steps keep JAX's order."""
    piv = np.asarray(sched["piv"])
    nbr = np.asarray(sched["nbr_idx"])
    later = [set(int(a) for a in row if a >= 0) for row in nbr]
    level = np.zeros(len(piv), np.int64)
    for k in range(len(piv)):
        lv = -1
        for kk in range(k):
            if int(piv[k]) in later[kk] or later[k] & later[kk]:
                lv = max(lv, int(level[kk]))
        level[k] = lv + 1
    return level


_LEVEL_FIELDS = ("piv", "piv_slot", "nbr_idx", "nbr_slot", "nbr_tr",
                 "upd_ii", "upd_jj", "upd_slot", "upd_mask")


def _level_tensors(sched, c_count: int, dev) -> Tuple[dict, ...]:
    """Per level, the steps' schedule rows as tensors on ``dev``, with
    ``nbr_spill`` (a neighbour index, ``c_count`` for none), ``nbr_safe``
    (0 for none), ``nmask`` (1.0 / 0.0) and the row numbers ``rows``."""
    level = schedule_levels(sched)
    out = []
    for lv in range(int(level.max()) + 1 if len(level) else 0):
        ks = np.nonzero(level == lv)[0]
        d = {k: np.asarray(sched[k])[ks] for k in _LEVEL_FIELDS}
        nbr = d["nbr_idx"]
        t = {k: torch.tensor(v, dtype=(torch.float32 if k == "upd_mask"
                                       else torch.bool if k == "nbr_tr"
                                       else torch.int64), device=dev)
             for k, v in d.items()}
        t["nbr_spill"] = torch.tensor(np.where(nbr >= 0, nbr, c_count),
                                      dtype=torch.int64, device=dev)
        t["nbr_safe"] = torch.tensor(np.where(nbr >= 0, nbr, 0),
                                     dtype=torch.int64, device=dev)
        t["nmask"] = torch.tensor((nbr >= 0).astype(np.float32), device=dev)
        t["rows"] = torch.arange(len(ks), device=dev)
        out.append(t)
    return tuple(out)


def _ordered_rows(keys: np.ndarray, n: int) -> np.ndarray:
    """``(n, D)`` row numbers of ``keys`` grouped by key, each key's rows
    in ascending order and padded with ``len(keys)`` (a zero row): the
    order in which a sequential scatter-add of the rows onto ``n`` targets
    adds them."""
    groups = [[] for _ in range(n)]
    for r, k in enumerate(keys):
        groups[int(k)].append(r)
    width = max([len(g) for g in groups] + [1])
    out = np.full((n, width), len(keys), np.int64)
    for k, g in enumerate(groups):
        out[k, :len(g)] = g
    return out


def _sum_rows(rows: Tensor, table: Tensor, dim: int) -> Tensor:
    """The rows of ``rows`` (along ``dim``, a zero row appended) summed per
    target as ``table`` orders them, left to right: the sequential
    scatter-add's order on every device, with no atomics."""
    pad = torch.zeros_like(rows.narrow(dim, 0, 1))
    rows = torch.cat([rows, pad], dim=dim)
    out = rows.index_select(dim, table[:, 0])
    for d in range(1, table.shape[1]):
        out = out + rows.index_select(dim, table[:, d])
    return out


@dataclass(frozen=True)
class DirectRodTreeBatch:
    """One stiff-rod segment tree of any branching (``direct_rods.py:
    229-363``): ``bodies (S,)`` the segments' bodies; constraint ``c``
    joins local segments ``edges[c, 0]`` and ``edges[c, 1]``. ``schedule``
    holds :func:`_build_tree_schedule`'s arrays as tensors (None: the
    dense solve only), ``levels`` their grouping by
    :func:`schedule_levels`; ``solver`` is ``"auto"``, ``"dense"`` or
    ``"tree"``, as JAX's."""

    bodies: Tensor        # (S,) int64
    edges: Tensor         # (C, 2) int64
    local0: Tensor        # (C, 3)
    local1: Tensor        # (C, 3)
    rest_darboux: Tensor  # (C, 3)
    seg_len: Tensor       # (C,)
    stiffness: Tensor     # (C, 3)
    schedule: Optional[dict] = None
    n_slots: int = field(default=0, metadata=dict(static=True))
    dmax: int = field(default=1, metadata=dict(static=True))
    pmax: int = field(default=1, metadata=dict(static=True))
    solver: str = field(default="auto", metadata=dict(static=True))
    levels: Tuple = field(default=(), metadata=dict(static=True))
    # (S, D) rows of the stacked [J0ᵀΔλ; J1ᵀΔλ] each segment sums, and
    # (n_slots, D) rows of the assembly each slot sums (_ordered_rows)
    sums: dict = field(default_factory=dict, metadata=dict(static=True))

    @staticmethod
    def create(bodies, edges, positions, x, q, average_radius,
               average_segment_length, youngs_modulus, torsion_modulus,
               device=None) -> "DirectRodTreeBatch":
        dev = resolve_device(device)
        bodies = np.asarray(bodies, np.int32).reshape(-1)
        edges = np.asarray(edges, np.int32).reshape(-1, 2)
        l0, l1, rest, sl, stiff = _material(
            (bodies[edges[:, 0]], bodies[edges[:, 1]]), positions, x, q,
            average_radius, average_segment_length, youngs_modulus,
            torsion_modulus)
        sched = _build_tree_schedule(edges, int(bodies.shape[0]))
        return DirectRodTreeBatch.from_arrays(
            dict(bodies=bodies, edges=edges, local0=l0, local1=l1,
                 rest_darboux=rest, seg_len=sl, stiffness=stiff), sched,
            device=dev)

    @staticmethod
    def from_arrays(arrays, schedule=None, solver="auto", device=None
                    ) -> "DirectRodTreeBatch":
        """The batch from numpy ``arrays`` (its tensor fields) and a
        schedule dict of numpy arrays with ``n_slots``, ``dmax`` and
        ``pmax`` (JAX's batch carries the same, its statics apart)."""
        dev = resolve_device(device)
        kw = {k: torch.tensor(
            np.asarray(v), device=dev,
            dtype=(torch.int64 if k in ("bodies", "edges") else
                   torch.float32)) for k, v in arrays.items()}
        edges = np.asarray(arrays["edges"]).reshape(-1, 2)
        s_count = int(np.asarray(arrays["bodies"]).size)
        sums = {"segments": torch.tensor(_ordered_rows(
            np.concatenate([edges[:, 0], edges[:, 1]]), s_count),
            device=dev)}
        if schedule is None:
            return DirectRodTreeBatch(**kw, solver=solver, sums=sums)
        sched = dict(schedule)
        statics = {k: int(sched.pop(k)) for k in ("n_slots", "dmax", "pmax")}
        c_count = edges.shape[0]
        sums["slots"] = torch.tensor(_ordered_rows(
            np.asarray(sched["con_slot"]), statics["n_slots"]), device=dev)
        tens = {k: torch.tensor(np.asarray(v), device=dev, dtype=(
            torch.bool if k == "nbr_tr" else torch.float32
            if k == "upd_mask" else torch.int64)) for k, v in sched.items()}
        return DirectRodTreeBatch(
            **kw, schedule=tens, solver=solver,
            levels=_level_tensors(sched, c_count, dev), sums=sums,
            **statics)

    @property
    def device(self) -> torch.device:
        return self.bodies.device

    def to(self, device) -> "DirectRodTreeBatch":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), Tensor)}
        sched = (None if self.schedule is None else
                 {k: v.to(device) for k, v in self.schedule.items()})
        levels = tuple({k: v.to(device) for k, v in lv.items()}
                       for lv in self.levels)
        return dataclasses.replace(
            self, schedule=sched, levels=levels,
            sums={k: v.to(device) for k, v in self.sums.items()}, **moved)

    def init_lambda(self) -> Tensor:
        return torch.zeros((self.edges.shape[0], 6), dtype=torch.float32,
                           device=self.device)

    @property
    def uses_tree(self) -> bool:
        """Whether :meth:`solve` takes the scheduled elimination."""
        c_count = self.edges.shape[0]
        return (self.solver == "tree"
                or (self.solver == "auto" and self.schedule is not None
                    and c_count > _TREE_DENSE_MAX))

    def solve(self, rx, rq, inv_mass, inv_iw, lam, dt):
        """One exact solve of the whole tree. Returns ``(corr_x (..., S,
        3), ot (..., S, 3), new_lam (..., C, 6))``."""
        g0 = self.bodies[self.edges[:, 0]]
        g1 = self.bodies[self.edges[:, 1]]
        x0, q0 = _gather_bodies((rx, rq), g0, (1, 1))
        x1, q1 = _gather_bodies((rx, rq), g1, (1, 1))
        c_vec, j0, j1m, alpha = constraint_rows(
            x0, q0, x1, q1, self.local0, self.local1, self.rest_darboux,
            self.seg_len, self.stiffness, dt)
        w_seg = inverse_mass_blocks(*_gather_bodies(
            (inv_mass, inv_iw), self.bodies, (0, 2)))         # (..., S)
        if self.uses_tree:
            if self.schedule is None:
                raise ValueError("solver='tree' needs the batch's schedule")
            dlam = self._solve_scheduled(c_vec, j0, j1m, alpha, w_seg, lam)
        else:
            dlam = self._solve_dense(c_vec, j0, j1m, alpha, w_seg, lam)
        # each segment's J0ᵀΔλ then J1ᵀΔλ terms, in constraint order
        imp = _sum_rows(torch.cat([_mv(j0.transpose(-1, -2), dlam),
                                   _mv(j1m.transpose(-1, -2), dlam)], -2),
                        self.sums["segments"], -2)           # (..., S, 6)
        delta = _mv(w_seg, imp)
        return delta[..., :3], delta[..., 3:], lam + dlam

    def _solve_dense(self, c_vec, j0, j1m, alpha, w_seg, lam):
        """The dense 6C×6C solve (``direct_rods.py:320-334``): the
        constraint-by-segment Jacobian blocks from one-hot selections,
        ``H = G W Gᵀ + diag(α)``."""
        c_count = self.edges.shape[0]
        s_count = self.bodies.shape[0]
        seg = torch.arange(s_count, device=self.device)
        oh0 = (self.edges[:, 0:1] == seg).to(j0.dtype)[..., None, None]
        oh1 = (self.edges[:, 1:2] == seg).to(j0.dtype)[..., None, None]
        g = oh0 * j0.unsqueeze(-3) + oh1 * j1m.unsqueeze(-3)  # (.., C, S)
        gw = torch.matmul(g, w_seg.unsqueeze(-4))
        h = torch.einsum("...csik,...dsjk->...cidj", gw, g)
        lead = h.shape[:-4]
        h = h.reshape(*lead, 6 * c_count, 6 * c_count) \
            + torch.diag_embed(alpha.reshape(*alpha.shape[:-2], -1))
        rhs = -(c_vec + alpha * lam)
        rhs = rhs.reshape(*rhs.shape[:-2], -1)
        dlam = _solve(h, rhs.unsqueeze(-1)).squeeze(-1)
        return dlam.unflatten(-1, (c_count, 6))

    def _solve_scheduled(self, c_vec, j0, j1m, alpha, w_seg, lam):
        """Tree-ordered block LDLᵀ over the schedule
        (``direct_rods.py:336-363``), one batched operation a level: the
        blocks of the slots assembled, then per level the pivots'
        inverses, the Schur updates of their later neighbours' blocks and
        right-hand sides; then the back substitution level by level in
        reverse."""
        sch = self.schedule
        c_count = self.edges.shape[0]
        jj = torch.stack([j0, j1m], dim=-3)                  # (..., C, 2)
        jsel_a = jj[..., sch["con_a"], sch["con_sa"], :, :]
        jsel_b = jj[..., sch["con_b"], sch["con_sb"], :, :]
        w_con = w_seg.index_select(-3, sch["con_seg"])
        contrib = _sandwich(jsel_a, w_con, jsel_b)
        lead = contrib.shape[:-3]
        blocks = _sum_rows(contrib, self.sums["slots"], -3)
        # the diagonal slots come first, in constraint order
        blocks = torch.cat([blocks[..., :c_count, :, :]
                            + torch.diag_embed(alpha).expand(
                                *lead, c_count, 6, 6),
                            blocks[..., c_count:, :, :]], dim=-3)
        rhs = -(c_vec + alpha * lam)
        rhs = torch.cat([rhs.expand(*lead, c_count, 6),
                         rhs.new_zeros(*lead, 1, 6)], dim=-2)  # spill row
        saved = []
        for lv in self.levels:
            hcc_inv = torch.linalg.inv_ex(
                blocks.index_select(-3, lv["piv_slot"]),
                check_errors=False)[0]                       # (..., n, 6, 6)
            g = blocks.index_select(-3, lv["nbr_slot"].reshape(-1)
                                    ).unflatten(-3, tuple(
                                        lv["nbr_slot"].shape))
            g = torch.where(lv["nbr_tr"][..., None, None],
                            g.transpose(-1, -2), g)
            g = g * lv["nmask"][..., None, None]             # H[a, c]
            l_blk = torch.matmul(g, hcc_inv.unsqueeze(-3))
            rhs_c = rhs.index_select(-2, lv["piv"])
            dr = _mv(l_blk, rhs_c.unsqueeze(-2))             # (..., n, D, 6)
            rhs = rhs.index_add(-2, lv["nbr_spill"].reshape(-1),
                                -dr.flatten(-3, -2))
            rows = lv["rows"][:, None]
            la = l_blk[..., rows, lv["upd_ii"], :, :]
            gb = g[..., rows, lv["upd_jj"], :, :]
            delta = torch.matmul(la, gb.transpose(-1, -2))   # (..., n, P)
            blocks = blocks.index_add(
                -3, lv["upd_slot"].reshape(-1),
                (-delta * lv["upd_mask"][..., None, None]).flatten(-4, -3))
            saved.append((hcc_inv, g, rhs_c))
        lam_acc = rhs.new_zeros(*lead, c_count, 6)
        for lv, (hcc_inv, g, rhs_c) in zip(reversed(self.levels),
                                           reversed(saved)):
            lam_nbr = (lam_acc.index_select(-2, lv["nbr_safe"].reshape(-1))
                       .unflatten(-2, tuple(lv["nbr_safe"].shape))
                       * lv["nmask"][..., None])
            s = rhs_c - torch.sum(_mv(g.transpose(-1, -2), lam_nbr), dim=-2)
            lam_c = _mv(hcc_inv, s)
            lam_acc = lam_acc.index_copy(-2, lv["piv"], lam_c)
        return lam_acc
