"""SPH cubic spline kernel — the counterpart of
``positionbaseddynamics_tpu/fluids/sph.py`` (the reference's
``CubicKernel``, ``PositionBasedDynamics/SPHKernels.h:13-97``):

``W(q) = k·(6q³ − 6q² + 1)`` for ``q ≤ ½``, ``k·2(1−q)³`` for ``½ < q ≤ 1``
with ``k = 8/(π h³)``; the gradient uses ``l = 48/(π h³)``. Each function
computes the JAX expression term by term in float32.

PyTorch's vectorised CPU ``sqrt`` can miss the correctly rounded float32
root by an ulp, so on CPU tensors :func:`sqrt` takes the root in float64
(as ``solver/grid_cloth.py`` does)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor
_PI = 3.14159265358979323846


def sqrt(a: Tensor) -> Tensor:
    """Correctly rounded float32 square root on every device."""
    if a.device.type == "cpu":
        return torch.sqrt(a.double()).float()
    return torch.sqrt(a)


def norm3(rvec: Tensor) -> Tensor:
    """``‖rvec‖`` over the last axis of size 3, the squares added left to
    right."""
    return sqrt(rvec[..., 0] * rvec[..., 0] + rvec[..., 1] * rvec[..., 1]
                + rvec[..., 2] * rvec[..., 2])


def w(rvec: Tensor, h) -> Tensor:
    """Kernel value for displacement vectors ``(..., 3)``."""
    return w_r(norm3(rvec), h)


def w_zero(h, device=None) -> Tensor:
    """``W(0)`` (``CubicKernel::W_zero``), a 0-d float32 tensor."""
    return torch.full((), 8.0 / (_PI * h**3), dtype=torch.float32,
                      device=device)


def grad_w(rvec: Tensor, h) -> Tensor:
    """Kernel gradient ``∇W(r)`` for displacement vectors ``(..., 3)``."""
    l = 48.0 / (_PI * h**3)
    rl = norm3(rvec)
    q = torch.clamp_max(rl / h, 1.0)
    gradq = rvec / torch.clamp_min(rl * h, 1e-30)[..., None]
    near = (l * q * (3.0 * q - 2.0))[..., None] * gradq
    factor = 1.0 - q
    far = (l * (-factor * factor))[..., None] * gradq
    g = torch.where((q <= 0.5)[..., None], near, far)
    return torch.where((rl > 1.0e-6)[..., None], g, 0.0)


def w_r(rl: Tensor, h) -> Tensor:
    """Kernel value from distances ``rl``."""
    k = 8.0 / (_PI * h**3)
    q = torch.clamp_max(rl / h, 1.0)
    near = k * (6.0 * q**3 - 6.0 * q**2 + 1.0)
    far = k * 2.0 * (1.0 - q) ** 3
    return torch.where(q <= 0.5, near, far)


def grad_w_coef(rl: Tensor, h) -> Tensor:
    """Scalar ``s(r)`` with ``∇W(rvec) = s(‖rvec‖)·rvec`` (see
    :func:`grad_w`); zero at the origin."""
    l = 48.0 / (_PI * h**3)
    q = torch.clamp_max(rl / h, 1.0)
    coefq = torch.where(q <= 0.5, l * q * (3.0 * q - 2.0),
                        -l * (1.0 - q) ** 2)
    s = coefq / torch.clamp_min(rl * h, 1e-30)
    return torch.where(rl > 1.0e-6, s, 0.0)
