"""Batched rigid-body joints — port of
``positionbaseddynamics_tpu/solver/joints.py``, after the reference's
joint classes (``Simulation/Constraints.cpp:83-1220``: BallJoint,
BallOnLineJoint, HingeJoint, UniversalJoint, SliderJoint, the four motor
joints, RigidBodyParticleBallJoint, DistanceJoint / RigidBodySpring,
DamperJoint) and the stiff rods' StretchBendingTwistingConstraint.

One :class:`JointBatch` holds every joint of one kind as struct-of-arrays.
Local connectors and rotational projections ``Pr`` are made at build time
in float64 numpy (the reference's ``init_X``); world-space quantities come
from the current body transforms inside the solve (its ``update_X``). The
solve is the masked 6-row form of ``ops/rigidbody.py``, over every joint
of the batch at once: JAX ``vmap``-s one joint, here each row-preparing
function takes the leading ``(C,)`` or ``(K, C)`` axes of the gathered
bodies, with the per-joint data ``(C, ...)`` shared by the K rollouts.

Motor targets are functions of simulation time: the reference sets
``MotorJoint::setTarget`` from its (time, value) sequence at the end of a
step with the time already advanced (``TimeStepController.cpp:200-236``),
which is the sequence at the start of the next step, so
``current_target(time)`` is pure. The interpolation follows
``jnp.interp`` (numpy's clamping at both ends) with ``torch.searchsorted``,
and time stays a 0-d tensor: nothing in a step reads it on the host.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops import quaternion as quat, rigidbody as rb
from ..ops.mathutils import cross, dot3, norm3
from ..utils import npquat
from .coloring import greedy_color

Tensor = torch.Tensor

POSITION_KINDS = (
    "ball", "ball_on_line", "hinge", "universal", "slider",
    "target_position_motor_slider", "target_velocity_motor_slider",
    "target_angle_motor_hinge", "target_velocity_motor_hinge",
    "distance", "damper", "rb_particle_ball",
    "stretch_bending_twisting",
)
VELOCITY_KINDS = ("target_velocity_motor_slider",
                  "target_velocity_motor_hinge")

#: ``np.spacing`` of float32's epsilon: ``jnp.interp``'s zero-width knot
#: threshold.
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _skew_t_table() -> np.ndarray:
    """``(3, 9)``: ``r @ table`` is ``[r]×ᵀ`` row-major, whose row i is
    ``r × e_i``."""
    t = np.zeros((3, 9), np.float32)
    for (i, j), (k, sign) in {(0, 1): (2, 1), (0, 2): (1, -1),
                              (1, 0): (2, -1), (1, 2): (0, 1),
                              (2, 0): (1, 1), (2, 1): (0, -1)}.items():
        t[k, 3 * i + j] = sign
    return t


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """``(eye3, −eye3, skew table, its negative, zero rows (6, 3))`` on
    ``device``, made once: a constant copied from the host inside a step
    would make the host wait for the card."""
    eye = torch.eye(3, dtype=torch.float32, device=device)
    skew = torch.tensor(_skew_t_table(), device=device)
    return (eye, -eye, skew, -skew,
            torch.zeros((6, 3), dtype=torch.float32, device=device))


def _zeros(like: Tensor, k: int) -> Tensor:
    """Zero rows ``(..., k, 3)`` in ``like``'s batch shape, as a view of a
    constant (no launch)."""
    return _consts(like.device)[4][:k].expand(like.shape[:-1] + (k, 3))


@functools.lru_cache(maxsize=None)
def _row_masks(n: int, device: torch.device):
    """``solve_rows``' mask constants of a joint whose first ``n`` rows are
    active: the mask, its outer product and ``diag(1 − m) + 1e-9·I``."""
    m = (torch.arange(6, device=device) < n).to(torch.float32)
    return (m, m[:, None] * m[None, :],
            torch.diag(1.0 - m) + 1e-9 * torch.eye(6, device=device))


def _skew_t(r: Tensor, negative: bool = False) -> Tensor:
    """``[r]×ᵀ`` ``(..., 3, 3)`` (or its negative), whose row i is ``r ×
    e_i`` — the arms' rows of a positional row in direction ``e_i``
    (exact: one signed component an entry)."""
    return torch.matmul(r, _consts(r.device)[3 if negative else 2]
                        ).unflatten(-1, (3, 3))


# ---------------------------------------------------------------------------
# Rows. A block of k rows is ``(c (..., k), l0, a0, l1, a1 (..., k, 3))``;
# ``_rows6`` concatenates blocks and pads them to the 6-row layout
# (``joints.py:54-79``).
# ---------------------------------------------------------------------------


def _eye_rows(like: Tensor, negative: bool = False) -> Tensor:
    """Identity directions ``(..., 3, 3)`` (or their negative) in
    ``like``'s batch shape."""
    eye = _consts(like.device)[1 if negative else 0]
    return eye.expand(like.shape[:-1] + (3, 3))


def _ball_rows(diff: Tensor, r0: Tensor, r1: Tensor):
    """The three positional rows ``(diff[i], pos_row(e_i, r0, r1))``: the
    arms' rows ``r × e_i`` are the rows of ``[r]×ᵀ``."""
    return (diff, _eye_rows(diff), _skew_t(r0), _eye_rows(diff, True),
            _skew_t(r1, True))


def _com_rows(c: Tensor, p: Tensor):
    """Positional rows at the centres of mass, ``pos_row_com`` of each
    direction row of ``p (..., k, 3)``."""
    z = _zeros(c, p.shape[-2])
    return c, p, z, -p, z


def _rot_rows(pr: Tensor, q0: Tensor, q1: Tensor, c_shift=None):
    """The rotational rows ``(C[i], rot_row(t[i]))`` of the projection
    ``pr`` (``rb.rotational_rows``), ``c_shift`` (``(..., 1)``) subtracted
    from the first row's value."""
    c, p = rb._rotational_terms(pr, q0, q1)
    if c_shift is not None:
        c = torch.cat([c[..., :1] - c_shift, c[..., 1:]], dim=-1)
    z = _zeros(c, c.shape[-1])
    return c, z, -p, z, p


def _rows6(*blocks):
    """The blocks concatenated and padded with zero rows to 6, one
    ``cat`` an array. Returns ``(c (..., 6), l0, a0, l1, a1 (..., 6,
    3))``."""
    lead = torch.broadcast_shapes(*[b[0].shape[:-1] for b in blocks])
    pad = 6 - sum(b[0].shape[-1] for b in blocks)
    zeros = _consts(blocks[0][0].device)[4][:pad]
    c = [b[0].expand(lead + b[0].shape[-1:]) for b in blocks]
    out = [torch.cat(c + [zeros[:, 0].expand(lead + (pad,))], dim=-1)]
    for i in range(1, 5):
        out.append(torch.cat(
            [b[i].expand(lead + b[i].shape[-2:]) for b in blocks]
            + [zeros.expand(lead + (pad, 3))], dim=-2))
    return tuple(out)


def _mask_tensor(active, device) -> Tensor:
    """A row mask as a tensor, ``(6,)`` or ``(..., 6)``."""
    return (_row_masks(active, device)[0] if isinstance(active, int)
            else active)


def _connectors(local0, local1, x0, q0, x1, q1):
    return quat.rotate(q0, local0) + x0, quat.rotate(q1, local1) + x1


def _rdiv(a: float, t: Tensor) -> Tensor:
    """``a / t`` rounded once, as JAX divides (PyTorch's ``a / t`` is
    ``reciprocal(t) * a``, two roundings)."""
    return torch.full_like(t, a) / t


# ---------------------------------------------------------------------------
# Per-kind row preparation (``joints.py:96-330``). Each returns
# ``(rows (c, l0, a0, l1, a1), alpha (..., 6) or None, active)``: alpha None
# means no compliance; active is the number of leading active rows
# (``_row_masks`` makes its constants once), or a float ``(..., 6)`` mask
# where a row's activity depends on the state.
# ---------------------------------------------------------------------------


def _prep_ball(d, x0, q0, x1, q1, dt, target):
    """``solve_BallJoint`` (``PositionBasedRigidBodyDynamics.cpp:212-262``)."""
    c0, c1 = _connectors(d["local0"], d["local1"], x0, q0, x1, q1)
    return _rows6(_ball_rows(c0 - c1, c0 - x0, c1 - x1)), None, \
        3


def _prep_ball_on_line(d, x0, q0, x1, q1, dt, target):
    """``solve_BallOnLineJoint`` (``:501-560``): connector 0 slides along
    the line; rows in the two normal directions."""
    c0, c1 = _connectors(d["local0"], d["local1"], x0, q0, x1, q1)
    dirw = quat.rotate(q0, d["aux0"])
    n1w = quat.rotate(q0, d["aux1"])
    n2w = cross(dirw, n1w)
    c0p = c0 + dirw * dot3(c1 - c0, dirw)[..., None]
    r0, r1 = c0p - x0, c1 - x1
    n = torch.stack([n1w, n2w], dim=-2)
    rows = (dot3(n, (c0p - c1)[..., None, :]), n,
            cross(r0[..., None, :], n), -n,
            -cross(r1[..., None, :], n))
    return _rows6(rows), None, 2


def _prep_hinge(d, x0, q0, x1, q1, dt, target):
    """``solve_HingeJoint`` (``:565-690``): 3 positional rows and the
    rotational rows of the projection ``Pr (2, 4)``."""
    c0, c1 = _connectors(d["local0"], d["local1"], x0, q0, x1, q1)
    return (_rows6(_ball_rows(c0 - c1, c0 - x0, c1 - x1),
                   _rot_rows(d["pr"], q0, q1)), None,
            3 + d["pr"].shape[-2])


def _prep_universal(d, x0, q0, x1, q1, dt, target):
    """``solve_UniversalJoint`` (``:868-975``): 3 positional rows and one
    angular row along ``u = axis0 × axis1`` with ``C = axis0·axis1``."""
    c0, c1 = _connectors(d["local0"], d["local1"], x0, q0, x1, q1)
    axis0 = quat.rotate(q0, d["aux0"])
    axis1 = quat.rotate(q1, d["aux1"])
    u = cross(axis0, axis1)[..., None, :]
    z = _zeros(axis0, 1)
    return (_rows6(_ball_rows(c0 - c1, c0 - x0, c1 - x1),
                   (dot3(axis0, axis1)[..., None], z, u, z, -u)), None,
            4)


def _slider_frame(d, q0):
    """World rotation matrix of the slider frame, ``R(q0 ⊗ frame_q)``."""
    return quat.to_matrix(quat.multiply(q0, d["frame_q"]))


def _prep_slider(d, x0, q0, x1, q1, dt, target):
    """``solve_SliderJoint`` (``:1049-1150``): 2 positional rows in the
    plane ⟂ the slider axis (at the centres of mass) and 3 rotational
    rows."""
    p = _slider_frame(d, q0)[..., :, 1:3].transpose(-1, -2)
    c = dot3(p, (x0 - x1)[..., None, :]) - d["aux0"][..., 0:2]
    return _rows6(_com_rows(c, p), _rot_rows(d["pr"], q0, q1)), None, \
        5


def _prep_target_position_motor_slider(d, x0, q0, x1, q1, dt, target):
    """``solve_TargetPositionMotorSliderJoint`` (``:1225-1331``): the full
    centre-of-mass difference with the target offset along the axis, and
    3 rotational rows."""
    axis = quat.rotate(q0, d["aux0"])
    cvec = (x0 - x1) - d["aux1"] + target[..., None] * axis
    return (_rows6(_com_rows(cvec, _eye_rows(cvec)),
                   _rot_rows(d["pr"], q0, q1)), None, 6)


def _prep_target_angle_motor_hinge(d, x0, q0, x1, q1, dt, target):
    """``solve_TargetAngleMotorHingeJoint`` (``:1579-1708``): hinge rows
    with a 3-row projection whose first row is driven to
    ``sin(target/2)``."""
    c0, c1 = _connectors(d["local0"], d["local1"], x0, q0, x1, q1)
    return (_rows6(_ball_rows(c0 - c1, c0 - x0, c1 - x1),
                   _rot_rows(d["pr"], q0, q1,
                             torch.sin(0.5 * target)[..., None])),
            None, 6)


def _compliance(stiff: Tensor, dt) -> Tensor:
    """``1/(k dt²)`` where ``k ≠ 0``, else 0."""
    return torch.where(stiff != 0.0,
                       1.0 / torch.clamp_min(stiff * dt * dt, 1e-30),
                       torch.zeros_like(stiff))


def _prep_distance(d, x0, q0, x1, q1, dt, target):
    """``solve_DistanceJoint`` (``:320-430``), and the RigidBodySpring when
    ``stiffness > 0`` (an XPBD row with a persistent λ)."""
    c0, c1 = _connectors(d["local0"], d["local1"], x0, q0, x1, q1)
    r0, r1 = c0 - x0, c1 - x1
    diff = c0 - c1
    length = norm3(diff)
    direction = (diff / torch.clamp_min(length, 1e-5)[..., None])
    rows = tuple(a[..., None, :] for a in rb.pos_row(direction, r0, r1))
    alpha = F.pad(_compliance(d["stiffness"], dt)[..., None], (0, 5))
    active = F.pad((length > 1e-5).to(length.dtype)[..., None], (0, 5))
    return _rows6(((length - d["rest"])[..., None],) + rows), alpha, active


def _prep_damper(d, x0, q0, x1, q1, dt, target):
    """``solve_DamperJoint`` (``:2030-2126``): slider-frame translation rows
    and 3 rotational rows; XPBD compliance on the slider-axis row only."""
    r0m = _slider_frame(d, q0)
    p = r0m.transpose(-1, -2)
    cvec = rb._mv(p, x0 - x1) - d["aux0"]
    alpha = F.pad(_compliance(d["stiffness"], dt)[..., None], (0, 5))
    return _rows6(_com_rows(cvec, p), _rot_rows(d["pr"], q0, q1)), alpha, \
        6


def _prep_rb_particle_ball(d, x0, q0, x1, q1, dt, target):
    """``solve_RigidBodyParticleBallJoint`` (``:2128-2216``): the rigid
    connector pinned to a particle (``q1`` unused)."""
    c0 = quat.rotate(q0, d["local0"]) + x0
    rows = (c0 - x1, _eye_rows(c0), _skew_t(c0 - x0), _eye_rows(c0, True),
            _zeros(c0, 3))
    return _rows6(rows), None, 3


def darboux_omega(q0: Tensor, q1: Tensor, length) -> Tensor:
    """Darboux vector ``ω = (2/L) vec(q̄0 ⊗ q1)`` (``computeDarbouxVector``,
    ``PositionBasedElasticRods.cpp:636-641``)."""
    length = length[..., None] if isinstance(length, Tensor) else length
    return 2.0 / length * quat.multiply(quat.conjugate(q0), q1)[..., 1:4]


def darboux_jacobian1(q0: Tensor, q1: Tensor, length) -> Tensor:
    """World-frame angular Jacobian ``(..., 3, 3)`` of the Darboux vector
    with respect to body 1, ``J1 θ = (1/L) vec(q̄0 ⊗ (0, θ) ⊗ q1)``, built
    by applying it to the basis (``joints.py:289-301``); body 0's is its
    negative."""
    basis = quat.from_vec(_consts(q1.device)[0])              # (3, 4)
    cols = quat.multiply(quat.conjugate(q0)[..., None, :],
                         quat.multiply(basis, q1[..., None, :]))[..., 1:4]
    length = length[..., None, None] if isinstance(length, Tensor) \
        else length
    return (cols / length).transpose(-1, -2)


def _prep_stretch_bending_twisting(d, x0, q0, x1, q1, dt, target):
    """``solve_StretchBendingTwistingConstraint``
    (``PositionBasedElasticRods.cpp:1228-1363``): 3 zero-stretch rows at
    the shared connector and 3 Darboux bend/twist rows in one 6×6 XPBD
    system; stretch α = 1e-10/dt², bend/twist α = 1/(K dt² L) (``:1176-
    1205``)."""
    c0, c1 = _connectors(d["local0"], d["local1"], x0, q0, x1, q1)
    length = d["rest"]
    j1 = darboux_jacobian1(q0, q1, length)
    bend_c = darboux_omega(q0, q1, length) - d["rest3"]
    inv_dt2 = 1.0 / (dt * dt)
    b_alpha = _rdiv(inv_dt2, d["stiffness3"] * length[..., None])
    alpha = torch.cat([torch.full_like(b_alpha, 1.0e-10 * inv_dt2),
                       b_alpha], dim=-1)
    z = _zeros(bend_c, 3)
    return (_rows6(_ball_rows(c0 - c1, c0 - x0, c1 - x1),
                   (bend_c, z, -j1, z, j1)), alpha, 6)


_PREPARE = {
    "ball": _prep_ball,
    "ball_on_line": _prep_ball_on_line,
    "hinge": _prep_hinge,
    "universal": _prep_universal,
    "slider": _prep_slider,
    "target_position_motor_slider": _prep_target_position_motor_slider,
    "target_velocity_motor_slider": _prep_slider,   # position part: slider
    "target_angle_motor_hinge": _prep_target_angle_motor_hinge,
    "target_velocity_motor_hinge": _prep_hinge,     # position part: hinge
    "distance": _prep_distance,
    "damper": _prep_damper,
    "rb_particle_ball": _prep_rb_particle_ball,
    "stretch_bending_twisting": _prep_stretch_bending_twisting,
}


def _omega_rows(dom: Tensor):
    """Rows ``(dom[i], 0, e_i, 0, −e_i)`` of a relative angular velocity."""
    z = _zeros(dom, 3)
    return dom, z, _eye_rows(dom), z, _eye_rows(dom, True)


def _prep_vel_motor_slider(d, x0, q0, v0, om0, x1, q1, v1, om1, target):
    """``velocitySolve_TargetVelocityMotorSliderJoint`` (``:1380-1460``):
    relative centre-of-mass velocity to ``target·axis``, relative ω to
    zero. The reference assembles the angular K block from ``t = −Pr(...)``
    but applies identity angular rows: ``ka0 / ka1`` carry ``t`` to
    :func:`ops.rigidbody.solve_rows`. Returns ``(rows, ka0, ka1)``."""
    axis = _slider_frame(d, q0)[..., :, 0]
    cv = (v0 - v1) + target[..., None] * axis
    rows = _rows6(_com_rows(cv, _eye_rows(cv)), _omega_rows(om0 - om1))
    _, p = rb._rotational_terms(d["pr"], q0, q1)
    z = _zeros(q0, 3).expand(p.shape)
    return rows, torch.cat([z, -p], dim=-2), torch.cat([z, p], dim=-2)


def _prep_vel_motor_hinge(d, x0, q0, v0, om0, x1, q1, v1, om1, target):
    """``velocitySolve_TargetVelocityMotorHingeJoint`` (``:1852-1962``):
    relative connector velocity to zero and relative ω to ``−target·axis``
    (``C = Δω + target·axis``). Returns ``(rows, ka0, ka1)``."""
    c0, c1 = _connectors(d["local0"], d["local1"], x0, q0, x1, q1)
    axis = quat.rotate(q0, d["aux0"])
    dom = (om0 - om1) + target[..., None] * axis
    rows = _rows6(_ball_rows(v0 - v1, c0 - x0, c1 - x1), _omega_rows(dom))
    return rows, rows[2], rows[4]


_PREPARE_VEL = {
    "target_velocity_motor_slider": _prep_vel_motor_slider,
    "target_velocity_motor_hinge": _prep_vel_motor_hinge,
}

#: The per-joint tensor fields, in ``JointBatch._data`` order.
_DATA_FIELDS = ("local0", "local1", "aux0", "aux1", "frame_q", "pr",
                "rest", "rest3", "stiffness", "stiffness3")
_OPTIONAL_FIELDS = _DATA_FIELDS + ("target", "seq_times", "seq_values",
                                   "seq_repeat")


def _mod(a: Tensor, b: Tensor) -> Tensor:
    """``jnp.mod``: the truncated remainder moved to the divisor's sign."""
    r = torch.fmod(a, b)
    return torch.where((r != 0.0) & ((r < 0.0) != (b < 0.0)), r + b, r)


def interp(t: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``jnp.interp`` of each row: ``t (C,)`` against the knots ``xp (C,
    S)`` (non-decreasing) and values ``fp (C, S)``, clamped to ``fp``'s end
    values outside ``[xp[0], xp[-1]]``; a knot pair closer than
    ``_INTERP_EPS`` takes the left value (``lax_numpy._interp``)."""
    s = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp, t[..., None].contiguous(),
                                       right=True), 1, s - 1)
    im1 = torch.remainder(i - 1, s)
    x_lo, x_hi = xp.gather(-1, im1)[..., 0], xp.gather(-1, i)[..., 0]
    f_lo, f_hi = fp.gather(-1, im1)[..., 0], fp.gather(-1, i)[..., 0]
    dx = x_hi - x_lo
    dx0 = torch.abs(dx) <= _INTERP_EPS
    f = torch.where(dx0, f_lo, f_lo + ((t - x_lo) / torch.where(
        dx0, torch.ones_like(dx), dx)) * (f_hi - f_lo))
    f = torch.where(t < xp[..., 0], fp[..., 0], f)
    return torch.where(t > xp[..., -1], fp[..., -1], f)


# ---------------------------------------------------------------------------
# The batch
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class JointBatch:
    """Every joint of one ``kind`` (struct-of-arrays, ``joints.py:343-
    489``). ``bodies (C, 2)`` holds rigid-body indices, except for
    ``rb_particle_ball``, whose column 1 is a particle index."""

    bodies: Tensor                         # (C, 2) int64
    color: Tensor                          # (C,) int32
    kind: str = field(metadata=dict(static=True))
    num_colors: int = field(metadata=dict(static=True))
    local0: Optional[Tensor] = None        # (C, 3)
    local1: Optional[Tensor] = None        # (C, 3)
    aux0: Optional[Tensor] = None          # (C, 3)
    aux1: Optional[Tensor] = None          # (C, 3)
    frame_q: Optional[Tensor] = None       # (C, 4)
    pr: Optional[Tensor] = None            # (C, p, 4)
    rest: Optional[Tensor] = None          # (C,)
    rest3: Optional[Tensor] = None         # (C, 3) rest Darboux vector
    stiffness: Optional[Tensor] = None     # (C,)
    stiffness3: Optional[Tensor] = None    # (C, 3) SBT coefficients
    target: Optional[Tensor] = None        # (C,)
    seq_times: Optional[Tensor] = None     # (C, S)
    seq_values: Optional[Tensor] = None    # (C, S)
    seq_repeat: Optional[Tensor] = None    # (C,) bool

    def __post_init__(self):
        if self.kind not in POSITION_KINDS:
            raise ValueError(f"unknown joint kind {self.kind!r}")
        # the index columns and the colour masks, made once on the
        # batch's device
        object.__setattr__(self, "_b0", self.bodies[:, 0].contiguous())
        object.__setattr__(self, "_b1", self.bodies[:, 1].contiguous())
        object.__setattr__(self, "_color_masks", tuple(
            self.color == c for c in range(self.num_colors)))
        # the colours as factors of (C, 2, d) corrections, and the factor
        # that zeroes rb_particle_ball's particle column of corr_q
        object.__setattr__(self, "_color_factors", tuple(
            m.to(torch.float32)[:, None, None] for m in self._color_masks))
        object.__setattr__(self, "_first_only", torch.tensor(
            [[1.0], [0.0]], device=self.bodies.device))

    @property
    def n(self) -> int:
        return self.bodies.shape[0]

    @property
    def device(self) -> torch.device:
        return self.bodies.device

    @property
    def couples_particles(self) -> bool:
        return self.kind == "rb_particle_ball"

    @property
    def has_velocity_solve(self) -> bool:
        return self.kind in VELOCITY_KINDS

    @property
    def color_masks(self):
        """``(C,)`` bool mask of each colour, in colour order."""
        return self._color_masks

    def to(self, device) -> "JointBatch":
        """The same batch with every tensor on ``device``."""
        moved = {k: getattr(self, k).to(device)
                 for k in ("bodies", "color") + _OPTIONAL_FIELDS
                 if getattr(self, k) is not None}
        return dataclasses.replace(self, **moved)

    def init_lambda(self) -> Tensor:
        """Per-joint 6-row λ sum, zeroed before each projection
        (``initConstraintBeforeProjection``, ``Constraints.cpp:2496``)."""
        return torch.zeros((self.n, 6), dtype=torch.float32,
                           device=self.device)

    def current_target(self, time: Tensor) -> Optional[Tensor]:
        """Motor target at ``time`` (0-d tensor): the static target, or the
        (time, value) sequence interpolated, wrapped around its duration
        when ``seq_repeat`` (``TimeStepController.cpp:200-236``). None for
        a kind without a target (JAX's zeros, which no row reads)."""
        if self.target is None:
            return None
        if self.seq_times is None:
            return self.target
        times = self.seq_times
        start = times[:, 0]
        duration = times[:, -1] - start
        t = torch.where(
            self.seq_repeat & (duration > 0.0),
            start + _mod(time - start, torch.clamp_min(duration, 1e-30)),
            time.expand_as(start))
        return interp(t, times, self.seq_values)

    def _data(self) -> dict:
        return {k: getattr(self, k) for k in _DATA_FIELDS
                if getattr(self, k) is not None}

    def _gather(self, x, q, w, iw, px, pw):
        """Both bodies' ``(x, q, w, iw)``, the rollout axes of ``x`` kept."""
        b0, b1 = self._b0, self._b1
        x0, q0 = x.index_select(-2, b0), q.index_select(-2, b0)
        w0, iw0 = w.index_select(-1, b0), iw.index_select(-3, b0)
        if self.couples_particles:
            x1 = px.index_select(-2, b1)
            q1 = torch.zeros_like(q0)
            q1[..., 0] = 1.0
            w1 = pw.index_select(-1, b1)
            iw1 = torch.zeros_like(iw0)
        else:
            x1, q1 = x.index_select(-2, b1), q.index_select(-2, b1)
            w1, iw1 = w.index_select(-1, b1), iw.index_select(-3, b1)
        return (x0, q0, w0, iw0), (x1, q1, w1, iw1)

    def solve_position(self, x, q, w, iw, time, dt, lam, px=None, pw=None):
        """Every joint's position-level solve (``joints.py:423-457``).
        ``x (..., R, 3)``, ``q (..., R, 4)``, ``w (R,)``, ``iw (..., R, 3,
        3)`` masked world inverse inertias, ``lam (..., C, 6)``; for
        ``rb_particle_ball`` the particles' ``px (..., N, 3)`` and ``pw
        (N,)``. Returns ``(corr_x (..., C, 2, 3), corr_q (..., C, 2, 4),
        new_lam (..., C, 6))``; for ``rb_particle_ball`` column 1 of
        ``corr_x`` is the particle's correction and of ``corr_q`` zero."""
        (x0, q0, w0, iw0), (x1, q1, w1, iw1) = self._gather(
            x, q, w, iw, px, pw)
        rows, alpha, active = _PREPARE[self.kind](
            self._data(), x0, q0, x1, q1, dt, self.current_target(time))
        masks = (_row_masks(active, x.device) if isinstance(active, int)
                 else None)
        dlam, dx0, ot0, dx1, ot1 = rb.solve_rows(
            *rows, w0, iw0, w1, iw1, alpha, lam,
            _mask_tensor(active, x.device), masks=masks)
        # both bodies' rotation corrections in one product
        corr_q = rb.rotation_correction(torch.stack([ot0, ot1], dim=-2),
                                        torch.stack([q0, q1], dim=-2))
        if self.couples_particles:
            corr_q = corr_q * self._first_only
        return torch.stack([dx0, dx1], dim=-2), corr_q, lam + dlam

    def residual(self, x, q, time, dt, px=None):
        """Each joint's constraint error on a state: ``(positional (...,
        C), angular (..., C))``, the largest ``|C|`` of its active rows that
        move a centre or a connector (a gap, in length) and of those that
        only turn (an axis or angle error, in the rows' own measure; for a
        motor, its distance from the target)."""
        zero_w = torch.zeros(x.shape[-2], dtype=x.dtype, device=x.device)
        iw = torch.zeros(x.shape[:-1] + (3, 3), dtype=x.dtype,
                         device=x.device)
        pw = None if px is None else torch.zeros(
            px.shape[-2], dtype=x.dtype, device=x.device)
        (x0, q0, _, _), (x1, q1, _, _) = self._gather(x, q, zero_w, iw, px,
                                                      pw)
        (c, l0, _, _, _), _, active = _PREPARE[self.kind](
            self._data(), x0, q0, x1, q1, dt, self.current_target(time))
        err = torch.abs(c) * _mask_tensor(active, x.device)
        linear = (l0 != 0.0).any(dim=-1)
        zero = torch.zeros_like(err)
        return (torch.where(linear, err, zero).amax(dim=-1),
                torch.where(linear, zero, err).amax(dim=-1))

    def solve_velocity(self, x, q, v, omega, w, iw, time):
        """Every velocity motor's velocity-level solve (``joints.py:459-
        489``). Returns ``(corr_v (..., C, 2, 3), corr_omega (..., C, 2,
        3))``."""
        (x0, q0, w0, iw0), (x1, q1, w1, iw1) = self._gather(
            x, q, w, iw, None, None)
        b0, b1 = self._b0, self._b1
        rows, ka0, ka1 = _PREPARE_VEL[self.kind](
            self._data(), x0, q0, v.index_select(-2, b0),
            omega.index_select(-2, b0), x1, q1, v.index_select(-2, b1),
            omega.index_select(-2, b1), self.current_target(time))
        masks = _row_masks(6, x.device)
        _, dv0, dom0, dv1, dom1 = rb.solve_rows(
            *rows, w0, iw0, w1, iw1, None, None, masks[0], k_a0=ka0,
            k_a1=ka1, masks=masks)
        return (torch.stack([dv0, dv1], dim=-2),
                torch.stack([dom0, dom1], dim=-2))


# ---------------------------------------------------------------------------
# Build-time factories (numpy float64, mirroring the init_X functions;
# ``joints.py:495-654``)
# ---------------------------------------------------------------------------


def _color(bodies: np.ndarray, conflict_ids: np.ndarray):
    return greedy_color(conflict_ids)


def _local_connectors(x0, q0, x1, q1, pos):
    """Local connector coordinates of a common world anchor
    (``init_BallJoint``, ``PositionBasedRigidBodyDynamics.cpp:160-185``)."""
    l0 = npquat.rotate(npquat.conjugate(q0), pos - x0)
    l1 = npquat.rotate(npquat.conjugate(q1), pos - x1)
    return l0, l1


def make_joint_batch(kind: str, bodies, conflict_ids, x, q, *,
                     positions=None, positions1=None, directions=None,
                     directions1=None, stiffness=None, rest=None,
                     target=None, seq_times=None, seq_values=None,
                     seq_repeat=None, particle_x=None,
                     device=None) -> JointBatch:
    """A :class:`JointBatch` of ``kind`` from world-space anchors, on
    ``device`` (None means CUDA).

    ``bodies (C, 2)`` body indices (column 1 a particle index for
    ``rb_particle_ball``); ``x (R, 3)``, ``q (R, 4)`` the bodies' initial
    state; ``positions`` / ``directions`` the world anchors and axes each
    kind needs. Every precomputation is the JAX package's in float64
    (``joints.py:526-654``), cast to float32 once."""
    dev = resolve_device(device)
    if kind not in POSITION_KINDS:
        raise ValueError(f"unknown joint kind {kind!r}")
    bodies = np.asarray(bodies, np.int32).reshape(-1, 2)
    c = bodies.shape[0]
    x = np.asarray(x, np.float64)
    q = np.asarray(q, np.float64)
    x0, q0 = x[bodies[:, 0]], q[bodies[:, 0]]
    if kind == "rb_particle_ball":
        x1 = np.asarray(particle_x, np.float64)[bodies[:, 1]]
        q1 = np.broadcast_to(np.array([1.0, 0, 0, 0]), q0.shape)
    else:
        x1, q1 = x[bodies[:, 1]], q[bodies[:, 1]]
    color, num_colors = _color(bodies, conflict_ids)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    kw = dict(bodies=torch.tensor(bodies, dtype=torch.int64, device=dev),
              color=torch.tensor(color, device=dev), kind=kind,
              num_colors=num_colors)

    def norm(v):
        v = np.asarray(v, np.float64).reshape(c, 3)
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                              1e-300)

    def projections(d, rows):
        return f32(np.stack([npquat.rotational_projection(q0[i], q1[i],
                                                          d[i], rows)
                             for i in range(c)]))

    def local_axis(d):
        return f32(np.einsum("cij,cj->ci",
                             npquat.to_matrix(npquat.conjugate(q0)), d))

    if kind in ("ball", "hinge", "universal", "target_angle_motor_hinge",
                "target_velocity_motor_hinge", "ball_on_line"):
        pos = np.asarray(positions, np.float64).reshape(c, 3)
        l0, l1 = _local_connectors(x0, q0, x1, q1, pos)
        kw["local0"], kw["local1"] = f32(l0), f32(l1)

    if kind == "ball_on_line":
        # init_BallOnLineJoint (:432-463): the line's local frame
        frames = npquat.orthonormal_basis(norm(directions))
        kw["aux0"] = local_axis(frames[..., 0])
        kw["aux1"] = local_axis(frames[..., 1])
    elif kind in ("hinge", "target_velocity_motor_hinge"):
        d = norm(directions)
        kw["pr"] = projections(d, 2)
        if kind == "target_velocity_motor_hinge":
            kw["aux0"] = local_axis(d)
    elif kind == "target_angle_motor_hinge":
        kw["pr"] = projections(norm(directions), 3)
    elif kind == "universal":
        # init_UniversalJoint (:793-846): both axes body-local
        kw["aux0"] = local_axis(norm(directions))
        kw["aux1"] = f32(np.einsum(
            "cij,cj->ci", npquat.to_matrix(npquat.conjugate(q1)),
            norm(directions1)))
    elif kind in ("slider", "target_velocity_motor_slider", "damper"):
        # init_SliderJoint (:977-1024) / init_DamperJoint (:1966-2014):
        # local frame quaternion, rest offset in the frame, Pr (3, 4)
        d = norm(directions)
        frames = npquat.orthonormal_basis(d)
        qr0 = npquat.from_matrix(frames)
        kw["frame_q"] = f32(npquat.multiply(npquat.conjugate(q0), qr0))
        dvec = np.einsum("cji,cj->ci", frames, x0 - x1)   # R0ᵀ (x0 − x1)
        if kind == "damper":
            kw["aux0"] = f32(dvec)
        else:
            kw["aux0"] = f32(np.concatenate(
                [dvec[:, 1:3], np.zeros((c, 1))], axis=1))
        kw["pr"] = projections(d, 3)
    elif kind == "target_position_motor_slider":
        # init_TargetPositionMotorSliderJoint (:1155-1202)
        d = norm(directions)
        kw["aux0"] = local_axis(d)
        kw["aux1"] = f32(x0 - x1)
        kw["pr"] = projections(d, 3)
    elif kind == "distance":
        # init_DistanceJoint (:267-294): an anchor on each body
        p0 = np.asarray(positions, np.float64).reshape(c, 3)
        p1 = np.asarray(positions1, np.float64).reshape(c, 3)
        kw["local0"] = f32(npquat.rotate(npquat.conjugate(q0), p0 - x0))
        kw["local1"] = f32(npquat.rotate(npquat.conjugate(q1), p1 - x1))
        kw["rest"] = f32(np.broadcast_to(np.asarray(
            rest if rest is not None
            else np.linalg.norm(p0 - p1, axis=-1)), (c,)))
        kw["stiffness"] = f32(np.broadcast_to(np.asarray(
            0.0 if stiffness is None else stiffness), (c,)))
    elif kind == "rb_particle_ball":
        # init_RigidBodyParticleBallJoint (:2128-2146)
        kw["local0"] = f32(npquat.rotate(npquat.conjugate(q0), x1 - x0))
    elif kind == "stretch_bending_twisting":
        # init_StretchBendingTwistingConstraint
        # (PositionBasedElasticRods.cpp:1136-1174): connectors at the shared
        # position; K = (EI, 2GI, EI), I = π/4 r⁴; the rest Darboux vector
        # of the initial rotations. ``rest`` is the average segment length
        # and ``directions`` packs (radius, youngs, torsion) per joint.
        pos = np.asarray(positions, np.float64).reshape(c, 3)
        l0, l1 = _local_connectors(x0, q0, x1, q1, pos)
        kw["local0"], kw["local1"] = f32(l0), f32(l1)
        seg_len = np.broadcast_to(np.asarray(rest, np.float64), (c,))
        kw["rest"] = f32(seg_len)
        params = np.asarray(directions, np.float64).reshape(c, 3)
        second_moment = np.pi / 4.0 * params[:, 0] ** 4
        bend_k = params[:, 1] * second_moment
        twist_k = 2.0 * params[:, 2] * second_moment
        kw["stiffness3"] = f32(np.stack([bend_k, twist_k, bend_k], axis=1))
        rel = npquat.multiply(npquat.conjugate(q0), q1)
        kw["rest3"] = f32(2.0 / seg_len[:, None] * rel[:, 1:4])

    if kind == "damper":
        kw["stiffness"] = f32(np.broadcast_to(np.asarray(
            0.0 if stiffness is None else stiffness), (c,)))

    if kind in ("target_position_motor_slider",
                "target_velocity_motor_slider",
                "target_angle_motor_hinge", "target_velocity_motor_hinge"):
        kw["target"] = f32(np.broadcast_to(np.asarray(
            0.0 if target is None else target), (c,)))
        if seq_times is not None:
            kw["seq_times"] = f32(seq_times)
            kw["seq_values"] = f32(seq_values)
            rep = (np.broadcast_to(np.asarray(seq_repeat), (c,))
                   if seq_repeat is not None else np.zeros((c,), bool))
            kw["seq_repeat"] = torch.tensor(rep.astype(bool), device=dev)

    return JointBatch(**kw)
