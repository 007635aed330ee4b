"""One receding-horizon MPPI period in plain PyTorch (Williams et al.,
the information-theoretic weighting ``exp(−(J − J*)/λ)``): K rollouts of
the nominal plus its perturbations, each step's velocity command moving
the handle's vertices by ``u·dt`` before the step (clamped by its norm),
the running cost ``w·|u|²`` of the command as sampled, the terminal cost
the tracked vertices' mean squared distance to the target, softmin
weights, and the nominal moved by their weighted perturbation."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def apply_handle(x: Tensor, u: Tensor, handle: Tensor, max_speed: float,
                 dt: float) -> Tensor:
    """``x (…, N, 3)`` with the ``handle`` vertices moved by ``u (…, 3)``,
    clamped to ``max_speed`` by its norm, over ``dt``."""
    speed = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    u = u * torch.clamp_max(max_speed / torch.clamp_min(speed, 1e-9), 1.0)
    delta = (u * dt)[..., None, :].expand(*x.shape[:-2], len(handle), 3)
    return x.index_add(x.dim() - 2, handle, delta)


class Planner:
    """The period of a configuration's reference ``scene`` under the
    mix's MPPI settings (``mpc`` of the configuration, the mix's
    ``num_samples``, ``horizon``, ``sigma``, ``temperature`` and
    ``control_effort``)."""

    def __init__(self, scene, handle, tracked, target, mix: dict,
                 max_speed: float, dt: float):
        self.scene = scene
        dev = scene.device
        self.handle = torch.as_tensor(handle, device=dev)
        self.tracked = torch.as_tensor(tracked, device=dev)
        self.target = scene.tensor(target)
        self.effort = float(mix["control_effort"])
        self.temperature = float(mix["temperature"])
        self.max_speed, self.dt = max_speed, dt

    def apply(self, x: Tensor, u: Tensor) -> Tensor:
        return apply_handle(x, u.to(x.dtype), self.handle, self.max_speed,
                            self.dt)

    def rollouts(self, x: Tensor, v: Tensor, controls: Tensor):
        """``(costs (K,), final positions (K, N, 3))`` of ``controls (K,
        T, 3)`` from one scene's ``x``, ``v``, the rollouts in the scene's
        chunks."""
        costs, finals = [], []
        k = controls.shape[0]
        for i in range(0, k, self.scene.chunk):
            u = controls[i:i + self.scene.chunk]
            xs = x.expand(u.shape[0], *x.shape).clone()
            vs = v.expand(u.shape[0], *v.shape).clone()
            acc = torch.zeros(u.shape[0], dtype=x.dtype, device=x.device)
            for t in range(u.shape[1]):
                xs = self.apply(xs, u[:, t])
                xs, vs, _, _ = self.scene.step(xs, vs)
                acc = acc + self.effort * (u[:, t] * u[:, t]).sum(-1)
            d = xs.index_select(1, self.tracked) - self.target
            costs.append(acc + (d * d).sum(-1).mean(-1))
            finals.append(xs)
        return torch.cat(costs), torch.cat(finals)

    def weighted(self, nominal: Tensor, eps: Tensor, costs: Tensor):
        """The nominal moved by the perturbations ``eps (K, T, 3)``
        weighted by the softmin of ``costs (K,)``, in the costs' dtype."""
        w = torch.exp(-(costs - costs.min()) / self.temperature)
        w = w / w.sum()
        nominal, eps = nominal.to(w.dtype), eps.to(w.dtype)
        return nominal + (w[:, None, None] * eps).sum(0)

    def update(self, x: Tensor, v: Tensor, nominal: Tensor, eps: Tensor):
        """``(new nominal (T, 3), costs (K,))`` of one MPPI iteration."""
        nominal, eps = (a.to(self.scene.dtype) for a in (nominal, eps))
        costs = self.rollouts(x, v, nominal + eps)[0]
        return self.weighted(nominal, eps, costs), costs
