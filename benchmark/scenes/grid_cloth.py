"""A ``grid_cloth`` configuration built through the program's
``SceneBuilder`` (the regular triangle model, its static particles,
XPBD distance and isometric bending constraints)."""
from __future__ import annotations

from benchmark.reference.grid_cloth import pinned
from benchmark.reference.xpbd import rotation_x


def build(config: dict, device):
    """``(state, constraint set)`` of the configuration on ``device``."""
    from positionbaseddynamics_tpu_torch.models import SceneBuilder

    b = SceneBuilder()
    tm = b.add_regular_triangle_model(
        config["width"], config["height"],
        rotation=rotation_x(config.get("rotation_x_deg", 0.0)),
        scale=tuple(config["scale"]))
    for i in pinned(config):
        b.set_mass(tm.offset + i, 0.0)
    b.add_cloth_constraints(tm, method=config["distance"]["method"],
                            distance_stiffness=config["distance"]["stiffness"])
    b.add_bending_constraints(tm, method=config["bending"]["method"],
                              stiffness=config["bending"]["stiffness"])
    return b.build(device=device)
