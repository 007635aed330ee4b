"""The rod-lattice path: B identical Cosserat rods as ``(B, n)``
component planes — port of ``positionbaseddynamics_tpu/solver/
grid_rods.py``.

A batch of identical rods is a regular lattice on which every rod family
is a shift-by-one stencil along the segment axis: positions are 3 planes
``(B, n_p)``, orientations 4 planes ``(B, n_q)`` (``[w, x, y, z]``);
stretch-shear (edge i: particles i, i+1, quaternion i) and bend-twist
(quaternions i, i+1) become slice arithmetic with the quaternion products
unrolled over the component planes, and the Jacobi sums two shifted adds
over build-time count planes. The math is ``ops/rods.py``'s
(``PositionBasedElasticRods.cpp:20-81``); the tests hold it to JAX's
lattice and to the port's unstructured batches. Preconditions (else the
builder takes the unstructured batches): equal segment counts, uniform
rest length, isotropic uniform stretch stiffness, uniform bend-twist
stiffness, consecutive particle and quaternion layout. Jacobi semantics
only. Positions and quaternions may carry leading rollout axes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from .constraints import rest_darboux_np

Tensor = torch.Tensor

EPS = 1e-6


def _qmul(a, b):
    """Component-plane quaternion product (``[w, x, y, z]`` 4-tuples)."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw)


def _shift_add(lo: Tensor, hi: Tensor) -> Tensor:
    """``d`` of one more entry along the last axis than ``lo`` and ``hi``,
    ``d[:-1] += lo`` then ``d[1:] += hi``, from zeros (the order of JAX's
    two ``.at[].add``)."""
    return F.pad(lo, (0, 1)) + F.pad(hi, (1, 0))


@dataclass(frozen=True)
class RodLatticeBatch:
    """B uniform rods: particles ``offset_p + r·n_p + i`` and quaternions
    ``offset_q + r·n_q + i`` (the builder's layout for identical line
    models added one after another)."""

    rest_darboux: Tensor   # (B, n_q - 1, 4) rest Darboux (w, x, y, z)
    rest_length: Tensor    # scalar
    stretch_k: Tensor      # scalar (isotropic)
    bend_ks: Tensor        # (3,) per-axis bend/twist stiffness
    inv_cnt_p: Tensor      # (B, n_p, 1) 1 / stretch-shear edges a particle
    inv_cnt_q_bt: Tensor   # (B, n_q, 1) 1 / bend-twist edges a quaternion
    n_rods: int = field(metadata=dict(static=True))
    n_p: int = field(metadata=dict(static=True))
    n_q: int = field(metadata=dict(static=True))
    offset_p: int = field(metadata=dict(static=True))
    offset_q: int = field(metadata=dict(static=True))

    @staticmethod
    def create(n_rods, n_p, offset_p, offset_q, q0, rest_length,
               stretch_k, bend_ks, device=None) -> "RodLatticeBatch":
        """``q0``: the scene's whole initial quaternion array ``(M, 4)``
        (``grid_rods.py:91-136``); the rest Darboux quaternions and their
        double-cover pick in float64 on the host."""
        dev = resolve_device(device)
        n_q = n_p - 1
        q = np.asarray(q0, np.float64)[
            offset_q:offset_q + n_rods * n_q].reshape(n_rods, n_q, 4)
        rest = rest_darboux_np(q[:, :-1], q[:, 1:])
        cnt_p = np.full((n_rods, n_p), 2.0)
        cnt_p[:, 0] = cnt_p[:, -1] = 1.0
        cnt_q_bt = np.full((n_rods, n_q), 2.0)
        cnt_q_bt[:, 0] = cnt_q_bt[:, -1] = 1.0

        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)

        return RodLatticeBatch(
            rest_darboux=f32(rest), rest_length=f32(rest_length),
            stretch_k=f32(stretch_k), bend_ks=f32(bend_ks),
            inv_cnt_p=f32(1.0 / cnt_p[..., None]),
            inv_cnt_q_bt=f32(1.0 / cnt_q_bt[..., None]),
            n_rods=int(n_rods), n_p=int(n_p), n_q=int(n_q),
            offset_p=int(offset_p), offset_q=int(offset_q))

    @property
    def device(self) -> torch.device:
        return self.rest_darboux.device

    def to(self, device) -> "RodLatticeBatch":
        """The same batch with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if not f.metadata.get("static")})

    def _planes(self, a: Tensor, offset: int, n: int, comps: int):
        """``comps`` planes ``(..., B, n)`` of the rows ``[offset, offset
        + B·n)`` of ``a (..., N, comps)``, or one plane of ``a (..., N)``
        when ``comps`` is 0."""
        rows = a[..., offset:offset + self.n_rods * n, :] if comps else \
            a[..., offset:offset + self.n_rods * n]
        if not comps:
            return rows.unflatten(-1, (self.n_rods, n))
        rows = rows.unflatten(-2, (self.n_rods, n))
        return [rows[..., c] for c in range(comps)]

    def _write(self, a: Tensor, offset: int, planes) -> Tensor:
        block = torch.stack(planes, dim=-1).flatten(-3, -2)
        if offset == 0 and block.shape == a.shape:
            return block
        out = a.expand(*block.shape[:-2], *a.shape[-2:]).clone()
        out[..., offset:offset + block.shape[-2], :] = block
        return out

    def project(self, x: Tensor, inv_mass: Tensor, q: Tensor,
                inv_mass_q: Tensor, omega: float = 1.0
                ) -> Tuple[Tensor, Tensor]:
        """One Jacobi pass, stretch-shear then bend-twist, both as plane
        stencils with the build-time count denominators, the quaternions
        renormalised after each (``grid_rods.py:138-196``)."""
        op, oq = self.offset_p, self.offset_q
        l0 = self.rest_length
        xg = self._planes(x, op, self.n_p, 3)
        wg = self._planes(inv_mass, op, self.n_p, 0)
        qg = self._planes(q, oq, self.n_q, 4)
        wq = self._planes(inv_mass_q, oq, self.n_q, 0)

        # stretch-shear (PositionBasedElasticRods.cpp:20-55)
        qw, qx, qy, qz = qg
        d3 = (2.0 * (qx * qz + qw * qy),
              2.0 * (qy * qz - qw * qx),
              qw * qw - qx * qx - qy * qy + qz * qz)
        w0 = wg[..., :-1]
        w1 = wg[..., 1:]
        denom = (w0 + w1) / l0 + wq * 4.0 * l0 + EPS
        gam = [((xg[c][..., 1:] - xg[c][..., :-1]) / l0 - d3[c])
               / denom * self.stretch_k for c in range(3)]
        # corrq = 2 wq L · (0, γ) ⊗ (q ⊗ ē3); q ⊗ ē3 = [qz, −qy, qx, −qw]
        e = (qz, -qy, qx, -qw)
        cq = _qmul((torch.zeros_like(gam[0]),) + tuple(gam), e)
        s = 2.0 * wq * l0
        icp = self.inv_cnt_p[..., 0]
        xg = [xg[c] + omega * icp * _shift_add(w0 * gam[c], -w1 * gam[c])
              for c in range(3)]
        qg = [qg[c] + omega * (s * cq[c]) for c in range(4)]
        nrm = torch.sqrt(sum(c * c for c in qg) + 1e-30)
        qg = [c / nrm for c in qg]

        # bend-twist (PositionBasedElasticRods.cpp:57-81)
        if self.n_q > 1:
            qa = [c[..., :-1] for c in qg]
            qb = [c[..., 1:] for c in qg]
            om = _qmul((qa[0], -qa[1], -qa[2], -qa[3]), tuple(qb))
            rd = [self.rest_darboux[..., c] for c in range(4)]
            d_minus2 = sum((om[c] - rd[c]) ** 2 for c in range(4))
            d_plus2 = sum((om[c] + rd[c]) ** 2 for c in range(4))
            use_plus = d_minus2 > d_plus2
            delta = [torch.where(use_plus, om[c] + rd[c], om[c] - rd[c])
                     for c in range(4)]
            wq0 = wq[..., :-1]
            wq1 = wq[..., 1:]
            inv = 1.0 / (wq0 + wq1 + 1e-6)
            delta = [torch.zeros_like(delta[0])] + [
                delta[c + 1] * (self.bend_ks[c] * inv) for c in range(3)]
            c0 = _qmul(tuple(qb), tuple(delta))
            c1 = _qmul(tuple(qa), tuple(delta))
            icq = self.inv_cnt_q_bt[..., 0]
            qg = [qg[c] + omega * icq * _shift_add(wq0 * c0[c],
                                                   -wq1 * c1[c])
                  for c in range(4)]
            nrm = torch.sqrt(sum(c * c for c in qg) + 1e-30)
            qg = [c / nrm for c in qg]

        return self._write(x, op, xg), self._write(q, oq, qg)
