"""Composable cost terms for sampling-based MPC — the counterpart of
``positionbaseddynamics_tpu/mpc/costs.py``.

Costs are plain functions evaluated after every rollout step (running) or
on the final state (terminal), so no ``(T, N, 3)`` trajectory is kept.
Every term returns a ``(state, u) -> cost`` (running) or ``state -> cost``
(terminal) closure; combine with :func:`combine`.

Each particle term reduces over the particle and coordinate axes and keeps
any leading rollout axis: it returns a 0-d tensor for one state and a
``(K,)`` tensor for a state of K rollouts (``x`` of shape ``(K, N, 3)``,
``u`` of shape ``(K, u_dim)``). JAX gets the same by vmapping the scalar
terms over K.

The rigid-body target waits for the rigid-body slice (6a), and the SDF
obstacle penalties for the collision slice (6b), which brings
``collision/sdf.py``'s ``SDFShape``; building one of them raises.
"""
from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor


def _sum3(a: Tensor) -> Tensor:
    """Sum over the trailing axis of 3, left to right, as ``jnp.sum``."""
    return (a[..., 0] + a[..., 1]) + a[..., 2]


def combine(*terms):
    """Sum of cost closures with identical signatures (0 without any)."""
    terms = [t for t in terms if t is not None]

    def total(*args):
        c = None
        for t in terms:
            c = t(*args) if c is None else c + t(*args)
        return torch.zeros((), dtype=torch.float32) if c is None else c

    return total


# ---------------------------------------------------------------------------
# Terminal / running target costs
# ---------------------------------------------------------------------------


def particle_target(indices, target, weight: float = 1.0) -> Callable:
    """Mean squared distance of the selected particles to ``target``
    ``(3,)`` (or ``(len(indices), 3)``). Terminal signature ``state ->
    cost``; wrap with :func:`as_running` to apply every step."""
    idx_list = [int(i) for i in indices]
    tgt = torch.as_tensor(target, dtype=torch.float32)

    def cost(state):
        x = state.particles.x
        idx = torch.as_tensor(idx_list, dtype=torch.int64, device=x.device)
        d = x.index_select(x.dim() - 2, idx) - tgt.to(x.device)
        return weight * torch.mean(_sum3(d * d), dim=-1)

    return cost


def rigid_target(body_index: int, target, weight: float = 1.0) -> Callable:
    """Squared distance of one rigid body's COM to ``target`` — needs the
    rigid-body slice (6a)."""
    raise NotImplementedError(
        "rigid_target reads rigid bodies, which come with the rigid-body "
        "slice (6a) of the port")


def velocity_penalty(weight: float = 1.0) -> Callable:
    """Mean squared particle velocity — damps wild plans (terminal)."""

    def cost(state):
        v = state.particles.v
        return weight * torch.mean(_sum3(v * v), dim=-1)

    return cost


def as_running(terminal_cost: Callable) -> Callable:
    """Lift a ``state -> cost`` terminal term to the running signature
    ``(state, u) -> cost``."""

    def cost(state, u):
        return terminal_cost(state)

    return cost


# ---------------------------------------------------------------------------
# Obstacle penalties
# ---------------------------------------------------------------------------


def sdf_obstacle(shapes, weight: float = 1.0, margin: float = 0.0,
                 translations=None, subset=None) -> Callable:
    """Penetration penalty of particles against SDF obstacles — needs
    ``collision/sdf.py``'s ``SDFShape``, the collision slice (6b)."""
    raise NotImplementedError(
        "sdf_obstacle needs collision/sdf.py's SDFShape, which comes with "
        "the collision slice (6b) of the port")


def rigid_sdf_obstacle(shapes, body_index: int, radius: float,
                       weight: float = 1.0, translations=None) -> Callable:
    """Penetration penalty of a rigid body's bounding sphere — needs
    ``collision/sdf.py``'s ``SDFShape``, the collision slice (6b)."""
    raise NotImplementedError(
        "rigid_sdf_obstacle needs collision/sdf.py's SDFShape, which comes "
        "with the collision slice (6b) of the port")


def control_effort(weight: float = 1.0) -> Callable:
    """``w · |u|²`` per step (running)."""

    def cost(state, u):
        return weight * torch.sum(u * u, dim=-1)

    return cost
