"""Utilities (port of ``positionbaseddynamics_tpu.utils``), the
``Utils/`` layer equivalents:

* :mod:`.loaders` — OBJ/PLY/TetGen mesh ingestion (numpy copies)
* :mod:`.massprops` — polyhedral mass/COM/inertia integrals
* :mod:`.timing` — phase timers (``Utils/Timing.h``)
* :mod:`.log` — sink-based logging (``Utils/Logger.h``)
* :mod:`.checkpoint` — state save/load, in JAX's npz layout
* :mod:`.npquat` — host-side quaternion helpers
"""
from . import npquat
from .checkpoint import load_state, save_state
from .loaders import load_mesh, load_obj, load_ply, load_tetgen
from .massprops import mass_properties, principal_frame
from .timing import PhaseTimers

__all__ = [
    "npquat", "load_state", "save_state", "load_mesh", "load_obj",
    "load_ply", "load_tetgen", "mass_properties", "principal_frame",
    "PhaseTimers",
]
