"""``fluid_tables_ms.sim``, layer "fluid tables" (``fluids/cellgrid.py``:
``build_fluid_tables``, ``scatter_planes``; ``fluids/cellgrid_cuda.py``:
``pbf_step_cuda``'s table copies; ``fluids/model.py``: the CFL step, the
integration and the gathers back to particle order): the device
milliseconds a step in operations other than the PBF kernels (names
holding ``PATTERN``) and the frames' copies of the positions to the host.
Read only where the trace holds a PBF kernel. Moves ``sim_steps_per_s``."""

PATTERN = "pbf_"
TO_HOST = "DtoH"


def read(run):
    if run.loop != "sim" or run.trace is None:
        return None
    ops = run.trace.ops
    if not any(PATTERN in n for n, _c, _t, _d in ops):
        return None
    other = sum(d for n, _c, _t, d in ops
                if PATTERN not in n and TO_HOST not in n)
    return other * 1e-3 / run.window.steps
