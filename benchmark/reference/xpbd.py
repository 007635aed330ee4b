"""What the reference's scenes share: the substep loop of
``TimeStepController`` with semi-implicit Euler and the first-order
velocity update (``TimeIntegration.cpp:7-19, 42-51``), Jacobi projection,
and the rollout chunking that keeps a plain step of many rollouts within
the card's memory."""
from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor


def rotation_x(degrees: float) -> np.ndarray:
    """The rotation by ``degrees`` about the x axis, float64."""
    a = math.radians(degrees)
    c, s = math.cos(a), math.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def inv_counts(indices: np.ndarray, n: int) -> np.ndarray:
    """``1 / max(count, 1)`` of how many rows of ``indices`` name each of
    ``n`` particles: the Jacobi average's weights."""
    cnt = np.bincount(indices.reshape(-1), minlength=n).astype(np.float64)
    return 1.0 / np.maximum(cnt, 1.0)


class Scene:
    """A scene of ``n`` particles under the configuration's step: ``x0``,
    ``inv_mass`` and a ``project(x, lams, it) -> (x, lams)`` supplied by
    the kind's module. All tensors in ``dtype`` on ``device``."""

    def __init__(self, config: dict, x0: np.ndarray, inv_mass: np.ndarray,
                 device, dtype):
        st = config["step"]
        self.device, self.dtype = torch.device(device), dtype
        self.substeps = int(st["substeps"])
        self.iterations = int(st["max_iterations"])
        self.h = float(st["dt"]) / self.substeps
        self.x0 = self.tensor(x0)
        self.inv_mass = self.tensor(inv_mass)
        self.active = (self.inv_mass > 0)[:, None]
        self.gravity = self.tensor(np.asarray(st["gravity"], np.float64))
        # rollouts stepped at once; the kind sets it from its sizes
        self.chunk = 64

    def tensor(self, a) -> Tensor:
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=self.device, dtype=self.dtype)

    def init_lambda(self, lead):
        raise NotImplementedError

    def project(self, x: Tensor, lams):
        raise NotImplementedError

    def substep(self, x: Tensor, v: Tensor):
        """Integrate, ``iterations`` Jacobi passes, velocity update."""
        h = self.h
        v1 = torch.where(self.active, v + h * self.gravity, v)
        x1 = torch.where(self.active, x + h * v1, x)
        lams = self.init_lambda(x.shape[:-2])
        for _ in range(self.iterations):
            x1, lams = self.project(x1, lams)
        v2 = torch.where(self.active, (x1 - x) / h, v1)
        return x1, v2

    def _step(self, x: Tensor, v: Tensor):
        inputs = []
        for _ in range(self.substeps):
            inputs.append(x)
            x, v = self.substep(x, v)
        last = inputs[-2] if len(inputs) > 1 else None
        return x, v, inputs[-1], last

    def step(self, x: Tensor, v: Tensor):
        """One step of ``(N, 3)`` or ``(K, N, 3)`` positions and
        velocities, the rollouts in chunks. Returns ``(x, v, old_x,
        last_x)``: ``old_x`` and ``last_x`` the inputs of the last and the
        second-last substep."""
        if x.dim() == 2:
            return self._step(x, v)
        parts = [self._step(x[i:i + self.chunk], v[i:i + self.chunk])
                 for i in range(0, x.shape[0], self.chunk)]
        return tuple(None if p[0] is None else torch.cat(p)
                     for p in zip(*parts))
