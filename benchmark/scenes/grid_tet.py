"""A ``grid_tet`` configuration built through the program's
``SceneBuilder`` (the regular tet model, its static face, XPBD FEM tet
constraints)."""
from __future__ import annotations

from benchmark.reference.grid_tet import pinned


def build(config: dict, device):
    """``(state, constraint set)`` of the configuration on ``device``."""
    from positionbaseddynamics_tpu_torch.models import SceneBuilder

    solid = config["solid"]
    b = SceneBuilder()
    tm = b.add_regular_tet_model(config["width"], config["height"],
                                 config["depth"], scale=tuple(config["scale"]))
    for i in pinned(config):
        b.set_mass(tm.offset + i, 0.0)
    b.add_solid_constraints(tm, method=solid["method"],
                            stiffness=solid["stiffness"],
                            poisson_ratio=solid["poisson_ratio"],
                            inversion_handling=solid["inversion_handling"])
    return b.build(device=device)
