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

The SDF obstacle penalties evaluate ``collision/sdf.py``'s ``SDFShape``
(its tensors copied once to the state's device) on the same leading
rollout axis.
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
    """Squared distance of one rigid body's centre of mass to ``target``
    ``(3,)`` (``costs.py:56-64``). Terminal signature ``state -> cost``."""
    tgt = torch.as_tensor(target, dtype=torch.float32)
    on_device = {}

    def cost(state):
        x = state.rigid.x
        if x.device not in on_device:
            on_device[x.device] = tgt.to(x.device)
        d = x[..., body_index, :] - on_device[x.device]
        return weight * _sum3(d * d)

    return cost


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


class _OnDevice:
    """The obstacle shapes and their translations, copied once to each
    device a cost is evaluated on."""

    def __init__(self, shapes, translations):
        if translations is None:
            translations = [(0.0, 0.0, 0.0)] * len(shapes)
        self.shapes = list(shapes)
        self.translations = [torch.as_tensor(t, dtype=torch.float32)
                             for t in translations]
        self.cache = {}

    def __call__(self, device):
        if device not in self.cache:
            self.cache[device] = [
                (s.to(device), t.to(device))
                for s, t in zip(self.shapes, self.translations)]
        return self.cache[device]


def sdf_obstacle(shapes, weight: float = 1.0, margin: float = 0.0,
                 translations=None, subset=None) -> Callable:
    """Quadratic penetration penalty ``Σ max(0, margin − φ(x))²`` over (a
    subset of) particles against static world-frame SDF obstacles, each
    placed at its translation (``costs.py:92-113``). Running signature."""
    on = _OnDevice(shapes, translations)
    sub = None if subset is None else [int(i) for i in subset]
    subs = {}

    def cost(state, u):
        x = state.particles.x
        if sub is not None:
            if x.device not in subs:
                subs[x.device] = torch.as_tensor(sub, dtype=torch.int64,
                                                 device=x.device)
            x = x.index_select(x.dim() - 2, subs[x.device])
        c = torch.zeros(x.shape[:-2], dtype=torch.float32, device=x.device)
        for shape, t in on(x.device):
            pen = torch.clamp_min(margin - shape.distance(x - t), 0.0)
            c = c + torch.sum(pen * pen, dim=-1)
        return weight * c

    return cost


def rigid_sdf_obstacle(shapes, body_index: int, radius: float,
                       weight: float = 1.0, translations=None) -> Callable:
    """Penetration penalty of one rigid body's bounding sphere against
    static obstacles (``costs.py:116-133``). Running signature."""
    on = _OnDevice(shapes, translations)

    def cost(state, u):
        p = state.rigid.x[..., body_index, :]
        c = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
        for shape, t in on(p.device):
            pen = torch.clamp_min(radius - shape.distance(p - t), 0.0)
            c = c + pen * pen
        return weight * c

    return cost


def control_effort(weight: float = 1.0) -> Callable:
    """``w · |u|²`` per step (running)."""

    def cost(state, u):
        return weight * torch.sum(u * u, dim=-1)

    return cost
