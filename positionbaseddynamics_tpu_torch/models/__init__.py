"""Scene builders (port of ``positionbaseddynamics_tpu.models``)."""

from .mesh import TriangleMesh
from .builders import SceneBuilder, TriModelHandle, regular_triangle_grid
