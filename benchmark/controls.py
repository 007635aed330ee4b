"""The MPPI cells' actuator, written to the program's control protocol
(``u_dim``, ``apply(state, u, dt)``, ``mpc/controls.py``): one velocity
command ``u (3,)``, or ``(K, 3)`` for K rollouts, moves every vertex of
the configuration's handle by ``u·dt``, clamped to ``max_speed`` by its
norm with ``PinVelocityControl``'s arithmetic. On a handle of one vertex
it is ``PinVelocityControl((i,), max_speed)``; on the bar it grips the
whole static face as one."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class HandleVelocity:
    indices: tuple
    max_speed: float
    _on: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def u_dim(self) -> int:
        return 3

    def apply(self, state, u, dt):
        p = state.particles
        speed = torch.sqrt((u[..., 0:1] * u[..., 0:1]
                            + u[..., 1:2] * u[..., 1:2])
                           + u[..., 2:3] * u[..., 2:3])
        vel = u * torch.clamp_max(
            self.max_speed / torch.clamp_min(speed, 1e-9), 1.0)
        idx = self._on.get(p.x.device)
        if idx is None:
            idx = self._on[p.x.device] = torch.as_tensor(
                self.indices, dtype=torch.int64, device=p.x.device)
        delta = (vel * dt)[..., None, :].expand(
            *p.x.shape[:-2], len(self.indices), 3)
        x = p.x.index_add(p.x.dim() - 2, idx, delta)
        return dataclasses.replace(
            state, particles=dataclasses.replace(p, x=x))
