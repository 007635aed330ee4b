"""Scene builders (port of ``positionbaseddynamics_tpu.models``)."""

from .mesh import TetMesh, TriangleMesh, face_normals, vertex_normals
from .builders import (SceneBuilder, TetModelHandle, TriModelHandle,
                       regular_tet_grid, regular_triangle_grid)
