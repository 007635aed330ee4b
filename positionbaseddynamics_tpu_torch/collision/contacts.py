"""Velocity-level contact solve with restitution, penalty and Coulomb
friction — port of ``positionbaseddynamics_tpu/collision/contacts.py``,
the batched form of ``velocitySolve_RigidBodyContactConstraint`` and
``velocitySolve_ParticleRigidBodyContactConstraint``
(``PositionBasedRigidBodyDynamics.cpp:2290-2383, 2454-2560``).

Per contact row and iteration: impulse
``p = nKn⁻¹ (goal_uₙ − u_rel·n)``, clamped so that the accumulated sum stays ≥ 0; a penalty impulse ``−k ·
nKn⁻¹ · d`` for penetration depth ``d < 0``; friction ``clamp(μ pₙ,
±p_max) · t``. The Jacobi pass solves every row from the same velocities
and adds the corrections, each row weighted by 1/#active rows on its most
contended dynamic body; the sequential pass sweeps the rows one after
another in buffer order, the reference's in-place loop
(``TimeStepController.cpp:330-343``), and is meant for small row counts.

The public solves take contact buffers and states with the same leading
rollout axes; the ``_solve_*`` forms work on one flattened batch axis.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.mathutils import cross3, dot3
from .batched import flat_contacts, scatter_add, take
from .detection import ParticleRigidContacts, RigidContacts

Tensor = torch.Tensor


def _mv(m: Tensor, v: Tensor) -> Tensor:
    return torch.matmul(m, v[..., None])[..., 0]


def _impulse(c, u_rel, sum_impulses, stiffness, row_w=None):
    """Shared impulse logic of both contact families (``contacts.py:
    33-61``): ``(p (B, K, 3), new_sum (B, K))``; ``row_w`` is the Jacobi row
    weight."""
    u_rel_n = dot3(c.normal, u_rel)
    corr = c.nkn_inv * (c.goal_u_n - u_rel_n)
    corr = torch.maximum(corr, -sum_impulses)
    d = dot3(c.normal, c.cp0 - c.cp1)
    corr = corr - torch.where(d < 0.0, stiffness * c.nkn_inv * d,
                              torch.zeros_like(d))
    if row_w is not None:
        corr = corr * row_w
    new_sum = sum_impulses + corr * c.mask
    p = corr[..., None] * c.normal
    fpn = c.friction * corr
    ft = torch.where(fpn > c.p_max, c.p_max,
                     torch.where(fpn < -c.p_max, -c.p_max, fpn))
    if row_w is not None:
        ft = ft * row_w
    p = p - ft[..., None] * c.tangent
    return p * c.mask[..., None], new_sum


def _bodies(*arrays):
    """Body arrays ``(*lead, R, ...)`` flattened to ``(B, R, ...)``;
    ``rx``'s rank decides the lead (the rest carry one or two more
    trailing axes)."""
    nd = arrays[0].dim() - 2
    return nd, [a.reshape(-1, *a.shape[nd:]) for a in arrays]


def _unflat(lead, *arrays):
    return [a.reshape(tuple(lead) + tuple(a.shape[1:])) for a in arrays]


def _solve_rigid(c, rx, rv, rom, inv_mass, inv_iw, sum_impulses,
                 stiffness):
    """One Jacobi pass on flattened arrays (``contacts.py:64-90``)."""
    b0, b1 = c.body0, c.body1
    r0 = c.cp0 - take(rx, b0, 2)
    r1 = c.cp1 - take(rx, b1, 2)
    u_rel = (take(rv, b0, 2) + cross3(take(rom, b0, 2), r0)
             - take(rv, b1, 2) - cross3(take(rom, b1, 2), r1))
    cnt = torch.zeros(rv.shape[:2], dtype=torch.float32, device=rv.device)
    cnt = cnt.scatter_add(1, b0, c.mask).scatter_add(1, b1, c.mask)
    cnt = torch.where(inv_mass > 0.0, cnt, torch.ones_like(cnt))
    row_w = 1.0 / torch.clamp_min(
        torch.maximum(torch.gather(cnt, 1, b0), torch.gather(cnt, 1, b1)),
        1.0)
    p, sum_impulses = _impulse(c, u_rel, sum_impulses, stiffness, row_w)
    w0, w1 = inv_mass[b0], inv_mass[b1]
    dv0 = w0[..., None] * p
    dom0 = _mv(take(inv_iw, b0, 3), cross3(r0, p))
    dv1 = -w1[..., None] * p
    dom1 = _mv(take(inv_iw, b1, 3), cross3(r1, -p))
    rv = scatter_add(scatter_add(rv, b0, dv0), b1, dv1)
    rom = scatter_add(scatter_add(rom, b0, dom0), b1, dom1)
    return rv, rom, sum_impulses


def _row(c, k):
    """Row ``k`` of every field, ``(B, 1, ...)``."""
    return dataclasses.replace(c, **{
        f.name: getattr(c, f.name)[:, k:k + 1] for f in dataclasses.fields(c)
        if getattr(c, f.name) is not None and f.name != "overflow"})


def _solve_rigid_sequential(c, rx, rv, rom, inv_mass, inv_iw, sum_impulses,
                            stiffness):
    """Sequential pass on flattened arrays (``contacts.py:93-126``)."""
    sums = []
    for k in range(c.mask.shape[1]):
        r = _row(c, k)
        b0, b1 = r.body0, r.body1
        r0 = r.cp0 - take(rx, b0, 2)
        r1 = r.cp1 - take(rx, b1, 2)
        u_rel = (take(rv, b0, 2) + cross3(take(rom, b0, 2), r0)
                 - take(rv, b1, 2) - cross3(take(rom, b1, 2), r1))
        p, new_sum = _impulse(r, u_rel, sum_impulses[:, k:k + 1], stiffness)
        rv = scatter_add(rv, b0, inv_mass[b0][..., None] * p)
        rom = scatter_add(rom, b0, _mv(take(inv_iw, b0, 3), cross3(r0, p)))
        rv = scatter_add(rv, b1, -inv_mass[b1][..., None] * p)
        rom = scatter_add(rom, b1, _mv(take(inv_iw, b1, 3), cross3(r1, -p)))
        sums.append(new_sum)
    return rv, rom, torch.cat(sums, dim=1) if sums else sum_impulses


def _solve_particle_rigid(c, pv, p_inv_mass, rx, rv, rom, inv_mass, inv_iw,
                          sum_impulses, stiffness):
    """One Jacobi pass on flattened arrays (``contacts.py:159-186``)."""
    pi, b1 = c.particle, c.body1
    r1 = c.cp1 - take(rx, b1, 2)
    u_rel = take(pv, pi, 2) - (take(rv, b1, 2)
                               + cross3(take(rom, b1, 2), r1))
    cnt_p = torch.zeros(pv.shape[:2], dtype=torch.float32,
                        device=pv.device).scatter_add(1, pi, c.mask)
    cnt_b = torch.zeros(rv.shape[:2], dtype=torch.float32,
                        device=rv.device).scatter_add(1, b1, c.mask)
    cnt_b = torch.where(inv_mass > 0.0, cnt_b, torch.ones_like(cnt_b))
    cnt_p = torch.where(p_inv_mass > 0.0, cnt_p, torch.ones_like(cnt_p))
    row_w = 1.0 / torch.clamp_min(torch.maximum(
        torch.gather(cnt_p, 1, pi), torch.gather(cnt_b, 1, b1)), 1.0)
    p, sum_impulses = _impulse(c, u_rel, sum_impulses, stiffness, row_w)
    w0 = take(p_inv_mass, pi, 1)
    pv = scatter_add(pv, pi, w0[..., None] * p)
    rv = scatter_add(rv, b1, -inv_mass[b1][..., None] * p)
    rom = scatter_add(rom, b1, _mv(take(inv_iw, b1, 3), cross3(r1, -p)))
    return pv, rv, rom, sum_impulses


def _solve_particle_rigid_sequential(c, pv, p_inv_mass, rx, rv, rom,
                                     inv_mass, inv_iw, sum_impulses,
                                     stiffness):
    """Sequential pass on flattened arrays (``contacts.py:129-156``)."""
    sums = []
    for k in range(c.mask.shape[1]):
        r = _row(c, k)
        pi, b1 = r.particle, r.body1
        r1 = r.cp1 - take(rx, b1, 2)
        u_rel = take(pv, pi, 2) - (take(rv, b1, 2)
                                   + cross3(take(rom, b1, 2), r1))
        p, new_sum = _impulse(r, u_rel, sum_impulses[:, k:k + 1], stiffness)
        pv = scatter_add(pv, pi, take(p_inv_mass, pi, 1)[..., None] * p)
        rv = scatter_add(rv, b1, -inv_mass[b1][..., None] * p)
        rom = scatter_add(rom, b1, _mv(take(inv_iw, b1, 3), cross3(r1, -p)))
        sums.append(new_sum)
    return pv, rv, rom, torch.cat(sums, dim=1) if sums else sum_impulses


def solve_rigid_contacts(c: RigidContacts, rx, rv, rom, inv_mass, inv_iw,
                         sum_impulses, stiffness, sequential=False):
    """One pass over all rb–rb contact rows, Jacobi or (``sequential``)
    Gauss-Seidel. Returns ``(rv, rom, sum_impulses)``."""
    nd, (rx, rv, rom, inv_iw) = _bodies(rx, rv, rom, inv_iw)
    lead = sum_impulses.shape[:nd]
    solve = _solve_rigid_sequential if sequential else _solve_rigid
    rv2, rom2, s = solve(flat_contacts(c, nd), rx, rv, rom, inv_mass, inv_iw,
                         sum_impulses.reshape(-1, sum_impulses.shape[-1]),
                         stiffness)
    return tuple(_unflat(lead, rv2, rom2, s))


def solve_rigid_contacts_sequential(c: RigidContacts, rx, rv, rom,
                                    inv_mass, inv_iw, sum_impulses,
                                    stiffness):
    """Sequential (Gauss-Seidel) pass over the rb–rb rows in buffer
    order."""
    return solve_rigid_contacts(c, rx, rv, rom, inv_mass, inv_iw,
                                sum_impulses, stiffness, sequential=True)


def solve_particle_rigid_contacts(c: ParticleRigidContacts, px, pv,
                                  p_inv_mass, rx, rv, rom, inv_mass, inv_iw,
                                  sum_impulses, stiffness, sequential=False):
    """One pass over all particle–rigid contact rows, Jacobi or
    (``sequential``) Gauss-Seidel. Returns ``(pv, rv, rom,
    sum_impulses)``."""
    nd, (rx, rv, rom, inv_iw) = _bodies(rx, rv, rom, inv_iw)
    lead = sum_impulses.shape[:nd]
    pv2 = pv.reshape(-1, *pv.shape[nd:])
    w = p_inv_mass if p_inv_mass.dim() == 1 else p_inv_mass.reshape(
        -1, p_inv_mass.shape[-1])
    solve = (_solve_particle_rigid_sequential if sequential
             else _solve_particle_rigid)
    out = solve(flat_contacts(c, nd), pv2, w, rx, rv, rom, inv_mass, inv_iw,
                sum_impulses.reshape(-1, sum_impulses.shape[-1]), stiffness)
    return tuple(_unflat(lead, *out))


def solve_particle_rigid_contacts_sequential(
        c: ParticleRigidContacts, px, pv, p_inv_mass, rx, rv, rom, inv_mass,
        inv_iw, sum_impulses, stiffness):
    """Sequential particle–rigid contact sweep."""
    return solve_particle_rigid_contacts(
        c, px, pv, p_inv_mass, rx, rv, rom, inv_mass, inv_iw, sum_impulses,
        stiffness, sequential=True)
