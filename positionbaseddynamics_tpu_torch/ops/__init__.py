"""Stateless kernels on tensors (port of ``positionbaseddynamics_tpu.ops``)."""

from . import integration, mathutils, pbd, quaternion, rigidbody, xpbd
