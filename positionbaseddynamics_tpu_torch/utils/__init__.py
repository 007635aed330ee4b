"""Build-time numpy helpers (port of ``positionbaseddynamics_tpu.utils``):
quaternions in float64 for joint frames, and mass properties of closed
meshes. The loaders, timing, logging and checkpoint helpers come with the
I/O slice (8)."""

from . import massprops, npquat
