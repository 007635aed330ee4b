"""``step_host_ms.sim``, layer "step route" (``solver/step.py``:
``make_step_fn``, ``kernel_plan``, ``_kernel_substeps``; for fluids
``fluids/model.py``: ``make_fluid_step_fn``, ``fluid_step``): the host
milliseconds inside each call of the step function, on the harness's
host clock without a sync, over an untraced slice of the traced run.
Moves ``sim_steps_per_s``."""


def read(run):
    t = run.step_host_s
    return 1e3 * sum(t) / len(t) if t else None
