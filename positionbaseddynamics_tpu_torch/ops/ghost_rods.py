"""Ghost-point elastic rod constraint solves (Umetani et al. 2014).

Port of ``positionbaseddynamics_tpu/ops/ghost_rods.py``, after
``PositionBasedElasticRods.cpp:82-257``: the perpendicular bisector, the
ghost-point edge distance and the Darboux-vector bend/twist of one rod
element. JAX takes the 5-point Darboux Jacobian from ``jax.jacfwd`` of the
element's Darboux function (``ghost_rods.py:96-109``); here it comes from
``torch.func.jacfwd`` under ``torch.func.vmap``, forward-mode derivatives
of the same function, exact where the reference hand-derives it
(``computeDarbouxGradient``). The functions take any leading shape; the
3×3 solve is ``torch.linalg.solve_ex(..., check_errors=False)``, which
never waits for the card.
"""
from __future__ import annotations

import torch

from .mathutils import cross

Tensor = torch.Tensor
EPS = 1e-6


def _normalize(v: Tensor) -> Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1,
                                                        keepdim=True), 1e-12)


def material_frame(p0: Tensor, p1: Tensor, p2: Tensor) -> Tensor:
    """Edge material frame ``(..., 3, 3)`` with columns (d1, d2, d3): d3
    along the edge, d2 ⟂ the (edge, ghost) plane
    (``computeMaterialFrame``; ``ghost_rods.py:31-38``)."""
    d3 = _normalize(p1 - p0)
    d2 = _normalize(cross(d3, p2 - p0))
    d1 = cross(d2, d3)
    return torch.stack([d1, d2, d3], dim=-1)


def _col_dot(da: Tensor, db: Tensor, i: int, j: int) -> Tensor:
    return torch.sum(da[..., :, i] * db[..., :, j], dim=-1)


def darboux_vector(da: Tensor, db: Tensor, mid_edge_length) -> Tensor:
    """Discrete Darboux vector of two material frames
    (``computeDarbouxVector``; ``ghost_rods.py:41-55``)."""
    # kept 1-D: forward-mode AD promotes a 0-D tensor's tangent to float64
    # when it meets a Python scalar
    factor = 1.0 + torch.sum(da * db, dim=-1).sum(-1, keepdim=True)
    factor = 2.0 / (mid_edge_length[..., None] * factor)
    om = torch.stack([
        _col_dot(da, db, 2, 1) - _col_dot(da, db, 1, 2),
        _col_dot(da, db, 0, 2) - _col_dot(da, db, 2, 0),
        _col_dot(da, db, 1, 0) - _col_dot(da, db, 0, 1)], dim=-1)
    return factor * om


def element_darboux(p0, p1, p2, g0, g1, mid_edge_length) -> Tensor:
    """Darboux vector of one rod element (points p0-p1-p2, ghosts g0,
    g1)."""
    return darboux_vector(material_frame(p0, p1, g0),
                          material_frame(p1, p2, g1), mid_edge_length)


def solve_perpendicular_bisector(p0, w0, p1, w1, p2, w2, stiffness):
    """Keep the ghost on the edge's perpendicular bisector, ``C = (p2 −
    pm)·(p1 − p0)`` (``ghost_rods.py:64-79``). Returns (corr0, corr1,
    corr2)."""
    pm = 0.5 * (p0 + p1)
    p0p2 = p0 - p2
    p2p1 = p2 - p1
    p1p0 = p1 - p0
    w_sum = (w0 * torch.sum(p0p2 * p0p2, dim=-1)
             + w1 * torch.sum(p2p1 * p2p1, dim=-1)
             + w2 * torch.sum(p1p0 * p1p0, dim=-1))
    c = torch.sum((p2 - pm) * p1p0, dim=-1)
    lam = torch.where(w_sum > EPS,
                      stiffness * c / torch.clamp_min(w_sum, EPS),
                      torch.zeros_like(w_sum))[..., None]
    return (-w0[..., None] * lam * p0p2, -w1[..., None] * lam * p2p1,
            -w2[..., None] * lam * p1p0)


def solve_ghost_edge_distance(p0, w0, p1, w1, p2, w2, stiffness, rest):
    """Keep the ghost at its rest distance from the edge midpoint
    (``ghost_rods.py:82-93``)."""
    pm = 0.5 * (p0 + p1)
    d = p2 - pm
    mag = torch.linalg.vector_norm(d, dim=-1)
    n = d / torch.clamp_min(mag, 1e-12)[..., None]
    w_sum = 0.25 * w0 + 0.25 * w1 + w2
    lam = torch.where(w_sum > EPS,
                      stiffness * (mag - rest) / torch.clamp_min(w_sum, EPS),
                      torch.zeros_like(w_sum))[..., None]
    return (0.5 * w0[..., None] * lam * n, 0.5 * w1[..., None] * lam * n,
            -w2[..., None] * lam * n)


def darboux_jacobians(p0, p1, p2, g0, g1, mid_edge_length):
    """``∂Ω/∂(p0, p1, p2, g0, g1)``: five ``(..., 3, 3)`` Jacobians of
    :func:`element_darboux`, by forward-mode differentiation
    (``torch.func.jacfwd``) vmapped over the flattened leading axes."""
    from torch.func import jacfwd, vmap

    args = torch.broadcast_tensors(p0, p1, p2, g0, g1)
    lead = args[0].shape[:-1]
    length = torch.as_tensor(mid_edge_length, dtype=args[0].dtype,
                             device=args[0].device).expand(lead)
    flat = [a.reshape(-1, 3) for a in args] + [length.reshape(-1)]
    jac = vmap(jacfwd(element_darboux, argnums=(0, 1, 2, 3, 4)))(*flat)
    return [j.to(args[0].dtype).reshape(*lead, 3, 3) for j in jac]


def solve_darboux_vector(p0, w0, p1, w1, p2, w2, g0, wg0, g1, wg1,
                         bending_twisting_ks, mid_edge_length,
                         rest_darboux):
    """Bend/twist of one rod element (``ghost_rods.py:96-109``): ``C = ks ∘
    (Ω − Ω̄)`` solved with ``Σ w_i G_i G_iᵀ + 1e-9·I`` where ``G_i =
    ∂Ω/∂p_i``. Returns the 5 position corrections."""
    grads = darboux_jacobians(p0, p1, p2, g0, g1, mid_edge_length)
    omega = element_darboux(p0, p1, p2, g0, g1, mid_edge_length)
    c = bending_twisting_ks * (omega - rest_darboux)
    ws = (w0, w1, w2, wg0, wg1)
    factor = None
    for w, g in zip(ws, grads):
        term = w[..., None, None] * torch.matmul(g, g.transpose(-1, -2))
        factor = term if factor is None else factor + term
    factor = factor + 1e-9 * torch.eye(3, dtype=factor.dtype,
                                       device=factor.device)
    y = torch.linalg.solve_ex(factor, c.unsqueeze(-1),
                              check_errors=False)[0]
    return tuple(-w[..., None] * torch.matmul(g.transpose(-1, -2),
                                              y).squeeze(-1)
                 for w, g in zip(ws, grads))
