"""``device_ops_per_step.sim``, layer "kernel wrapper"
(``solver/grid_cloth_cuda.py``, ``solver/grid_tet_cuda.py``:
``run_substeps``, ``to_planes``, ``from_planes``;
``fluids/cellgrid_cuda.py``: ``pbf_step_cuda``): the device operations
(kernels, copies, memsets) of the traced slice over its steps. Moves
``sim_steps_per_s``."""


def read(run):
    if run.loop != "sim" or run.trace is None or not run.trace.ops:
        return None
    return len(run.trace.ops) / run.window.steps
