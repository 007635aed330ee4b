"""A ``pbf_dam`` configuration built through the program's fluid entry
points (``fluids.model``: ``block_positions``, ``box_boundary``,
``FluidScene.create`` with a domain, ``FluidState.create``) and stepped by
``make_fluid_step_fn``, the program's public stepper for fluids, through
this kind's :class:`Drive`."""
from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.pbf_dam import box_hi, diameter


def build(config: dict, device):
    """``(state, scene)`` of the configuration on ``device``."""
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    d = diameter(config)
    st = config["step"]
    fluid = fm.block_positions(
        tuple(o * d for o in config["block_origin_spacings"]),
        tuple(config["block"]), d)
    lo, hi = (0.0, 0.0, 0.0), tuple(box_hi(config).tolist())
    scene = fm.FluidScene.create(
        len(fluid), fm.box_boundary(lo, hi, d),
        density0=config["density0"], particle_radius=config["particle_radius"],
        viscosity=config["viscosity"], iterations=st["max_iterations"],
        cap_per_cell=config["cell_slots"], min_dt=st["min_dt"],
        max_dt=st["max_dt"], gravity=tuple(st["gravity"]), domain=(lo, hi),
        device=device)
    return fm.FluidState.create(fluid, dt0=st["dt"], device=device), scene


class Drive:
    """How the sim loop steps a fluid scene (``loops.SimLoop``'s
    ``drive``): ``make_fluid_step_fn``'s step, the state's own ``x``, no
    static particle, one scene a loop. A frame keeps every field the step
    reads or carries: ``dt`` (the CFL step follows it) and ``overflow``
    (the cell tables' running count of what their caps dropped), beside
    ``x``, ``v``, ``old_x`` and ``last_x``. The step builds a new state and
    leaves its input as it was, so the loop may hold the last frame's input
    and judge that frame too: ``overflow`` is then read at the window's
    end."""

    entry = "make_fluid_step_fn"
    substeps = 1
    judges_last = True
    FIELDS = ("x", "v", "old_x", "last_x", "dt", "overflow")

    def __init__(self, config, mix, state, scene, device):
        from positionbaseddynamics_tpu_torch.fluids import make_fluid_step_fn

        if int(mix.get("rollouts", 1)) != 1:
            raise ValueError("a fluid scene steps one rollout; the mix asks "
                             f"for {mix['rollouts']}")
        self.fn = make_fluid_step_fn(scene, device)
        self.iterations = scene.iterations

    @staticmethod
    def positions(state):
        return state.x

    @staticmethod
    def free(state):
        return torch.ones(state.x.shape[0], dtype=torch.bool,
                          device=state.x.device)

    @staticmethod
    def start(state, v):
        return dataclasses.replace(state, v=v)

    def save_in(self, state) -> dict:
        return {f: getattr(state, f).clone() for f in self.FIELDS}

    def save_out(self, state) -> dict:
        return {f: getattr(state, f).clone() for f in self.FIELDS if f != "x"}
